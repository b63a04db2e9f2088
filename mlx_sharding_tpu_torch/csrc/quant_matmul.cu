// Products with MLX grouped-affine 4- and 8-bit weights kept packed in
// device memory, written for Hopper (sm_90a). Both kernels compute
//
//   out[m, o] = sum_i x[m, i] * (code(q)[o, i] * s[o, i / gs] + b[o, i / gs])
//
// accumulated in fp32 and rounded once to x's dtype. q is (OUT, IN*bits/32)
// 32-bit words holding 32/bits codes each, least-significant bits first (the
// checkpoint's layout, read as unsigned words whatever their torch dtype);
// scales and biases are (OUT, IN/gs) in fp32, bf16 or fp16; x is (M, IN) in
// bf16 or fp32. Group sizes 32, 64 and 128; bits 4 and 8.
//
// quant_gemv_kernel replaces the Pallas TPU kernel
// mlx_sharding_tpu/ops/quant_matmul.py::quant_gemv_pipelined (_gemv_kernel),
// the decode product for M <= 8. What bounds it on an H100: bytes. At M = 1
// it does 2 operations per weight and reads 0.5625 bytes of it (a 4-bit code
// plus an fp16 scale and bias per 64 codes), far below the 295 operations per
// byte where the tensor cores become the limit. What the design does:
//   - each warp owns 4 output rows and walks IN with 16-byte loads of
//     words (32 codes a load at 4 bits), neighbouring lanes on neighbouring
//     addresses; the next chunk's words are in flight while this chunk is
//     unpacked, and 4 rows per warp give 4 loads per lane per step;
//   - x is staged once per block (32 rows) in shared memory, in IN tiles of
//     4096, each 16-byte chunk padded by 16 bytes so that the 8 lanes of a
//     shared-load phase hit different banks; the x values a lane reads
//     serve its 4 rows, so at M = 8 shared-memory traffic stays below the
//     rate the weight stream needs;
//   - a code becomes a float with one OR and one subtraction (2^23 + code,
//     exactly) instead of an integer conversion, which runs at a quarter of
//     the fp32 rate; the weight code * s + b stays in fp32;
//   - the lanes' partial sums meet in a warp-shuffle reduction.
// Not done yet: cp.async/TMA pipelining, and a split of IN across blocks for
// the layers whose OUT gives fewer blocks than the card has SMs.
//
// quant_matmul_kernel replaces the Pallas TPU kernel
// mlx_sharding_tpu/ops/quant_matmul.py::quant_matmul_pallas (_kernel), the
// product for M > 8 (prefill chunks). What bounds it on an H100: tensor-core
// operations (at M = 256 and bf16 it does ~455 operations per byte it must
// move). What the design does:
//   - one block of 8 warps owns a 64 x 128 (M x OUT) output tile and loops
//     over IN 64 at a time; the next tile's x and packed words are loaded
//     into registers while the tensor cores work on this tile;
//   - the weight tile is dequantized once into shared memory as bf16 (the
//     same rounding as the dequantize-on-load path, which stores
//     dequantize(..., bf16)); x is copied as it is; rows are padded by 16
//     bytes so WMMA fragment loads do not conflict on banks;
//   - products on the tensor cores through WMMA (mma.sync, bf16 in, fp32
//     accumulate), each warp a 32 x 32 tile; fp32 inputs (tests only) take
//     an FMA loop over the same shared tiles, with the weight in fp32;
//   - ragged M, OUT and IN edges are masked on load and store.
// Not done yet: wgmma, TMA, a ring of shared stages and a persistent grid.
//
// The TPU kernels split the codes into nibble planes, expand scales from
// groups to words with an iota-built matmul and pre-permute x to word-major
// order, all to satisfy Mosaic's layout rules; none of that is needed here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

struct Params {
  const void* x;
  const uint32_t* q;
  const void* scales;
  const void* biases;
  void* out;
  int M, IN, OUT, group_size;
  int param_code;  // scales/biases: 0 = float32, 1 = bfloat16, 2 = float16
};

__device__ __forceinline__ float load_param(const void* p, int code, long long i) {
  if (code == 0) return static_cast<const float*>(p)[i];
  if (code == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// Code j of a word as a float: 2^23 + code is exact in fp32, so the OR and
// the subtraction give the code with no integer-to-float conversion.
template <int BITS>
__device__ __forceinline__ float code_at(uint32_t word, int j) {
  constexpr uint32_t MASK = (1u << BITS) - 1;
  return __uint_as_float(0x4B000000u | ((word >> (j * BITS)) & MASK)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// N consecutive elements from shared memory as floats (N * sizeof(T) is 8,
// 16 or 32 bytes, and p is aligned to min(16, that)).
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&out)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 bf16 values");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);             // low half: element 2i
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high half: element 2i + 1
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

cudaError_t allow_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ------------------------------------------------------------ decode GEMV
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_ROWS = 4;                              // rows per warp
constexpr int GEMV_BLOCK_OUT = GEMV_WARPS * GEMV_ROWS;    // rows per block
constexpr int GEMV_TILE_IN = 4096;                        // x elements staged per tile

template <typename T, int BITS>
struct GemvLayout {
  static constexpr int PER_WORD = 32 / BITS;
  static constexpr int CHUNK = 4 * PER_WORD;              // codes behind one 16-byte load
  static constexpr int CHUNK_STRIDE = CHUNK + 16 / (int)sizeof(T);  // + 16 bytes of padding
  static constexpr int ROW_STRIDE = GEMV_TILE_IN / CHUNK * CHUNK_STRIDE;
};

template <typename T, int BITS, int MT>
size_t gemv_shared_bytes() {
  return (size_t)MT * GemvLayout<T, BITS>::ROW_STRIDE * sizeof(T);
}

template <typename T, int BITS, int MT>
__global__ void __launch_bounds__(GEMV_THREADS) quant_gemv_kernel(Params p) {
  using L = GemvLayout<T, BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * GEMV_BLOCK_OUT + warp * GEMV_ROWS;
  const long long words_per_row = p.IN / L::PER_WORD;
  const long long groups = p.IN / p.group_size;

  float acc[MT][GEMV_ROWS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) acc[m][r] = 0.f;

  uint4 w_next[GEMV_ROWS];
  float s_next[GEMV_ROWS], b_next[GEMV_ROWS];
  auto fetch = [&](int kc) {  // the words, scale and bias of the chunk at IN index kc
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) {
      const int row = row0 + r;
      if (row < p.OUT) {
        w_next[r] = __ldg(reinterpret_cast<const uint4*>(p.q + row * words_per_row + kc / L::PER_WORD));
        s_next[r] = load_param(p.scales, p.param_code, row * groups + kc / p.group_size);
        b_next[r] = load_param(p.biases, p.param_code, row * groups + kc / p.group_size);
      } else {
        w_next[r] = make_uint4(0, 0, 0, 0);
        s_next[r] = 0.f;
        b_next[r] = 0.f;
      }
    }
  };

  for (int k0 = 0; k0 < p.IN; k0 += GEMV_TILE_IN) {
    const int kt = min(GEMV_TILE_IN, p.IN - k0);
    // stage x[:, k0 : k0 + kt] in 16-byte vectors; rows past M are zeros
    constexpr int VEC = 16 / sizeof(T);
    const int vecs = kt / VEC;
    for (int i = threadIdx.x; i < MT * vecs; i += GEMV_THREADS) {
      const int m = i / vecs, e = (i % vecs) * VEC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < p.M) v = *reinterpret_cast<const uint4*>(x + (long long)m * p.IN + k0 + e);
      *reinterpret_cast<uint4*>(xs + m * L::ROW_STRIDE + e / L::CHUNK * L::CHUNK_STRIDE +
                                e % L::CHUNK) = v;
    }
    __syncthreads();
    const int chunks = kt / L::CHUNK;
    if (lane < chunks) fetch(k0 + lane * L::CHUNK);
    for (int c = lane; c < chunks; c += 32) {
      uint4 w[GEMV_ROWS];
      float s[GEMV_ROWS], b[GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) {
        w[r] = w_next[r];
        s[r] = s_next[r];
        b[r] = b_next[r];
      }
      if (c + 32 < chunks) fetch(k0 + (c + 32) * L::CHUNK);  // in flight during the math below
      const T* xc = xs + c * L::CHUNK_STRIDE;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float xv[MT][L::PER_WORD];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_f32(xc + m * L::ROW_STRIDE + k * L::PER_WORD, xv[m]);
#pragma unroll
        for (int r = 0; r < GEMV_ROWS; ++r) {
          const uint32_t word = word_of(w[r], k);
#pragma unroll
          for (int j = 0; j < L::PER_WORD; ++j) {
            const float wv = fmaf(code_at<BITS>(word, j), s[r], b[r]);
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][r] = fmaf(xv[m][j], wv, acc[m][r]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) {
      float v = acc[m][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
      acc[m][r] = v;
    }
  if (lane == 0) {
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r) {
      const int row = row0 + r;
      if (row >= p.OUT) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < p.M) out[(long long)m * p.OUT + row] = from_f32<T>(acc[m][r]);
    }
  }
}

template <typename T, int BITS, int MT>
cudaError_t launch_gemv(const Params& p, cudaStream_t stream) {
  const size_t smem = gemv_shared_bytes<T, BITS, MT>();
  cudaError_t err = allow_shared((const void*)quant_gemv_kernel<T, BITS, MT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.OUT + GEMV_BLOCK_OUT - 1) / GEMV_BLOCK_OUT);
  quant_gemv_kernel<T, BITS, MT><<<grid, GEMV_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BITS>
long long gemv_shared_bytes_for_m(int M) {
  return (long long)(M <= 1   ? gemv_shared_bytes<T, BITS, 1>()
                     : M <= 2 ? gemv_shared_bytes<T, BITS, 2>()
                     : M <= 4 ? gemv_shared_bytes<T, BITS, 4>()
                              : gemv_shared_bytes<T, BITS, 8>());
}

template <typename T, int BITS>
cudaError_t gemv_for_m(const Params& p, cudaStream_t stream) {
  if (p.M <= 1) return launch_gemv<T, BITS, 1>(p, stream);
  if (p.M <= 2) return launch_gemv<T, BITS, 2>(p, stream);
  if (p.M <= 4) return launch_gemv<T, BITS, 4>(p, stream);
  return launch_gemv<T, BITS, 8>(p, stream);
}

// ------------------------------------------------- prefill dequant-matmul
constexpr int MM_BM = 64;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;
constexpr int MM_THREADS = 256;  // 8 warps: 2 along M x 4 along OUT, 32 x 32 each

template <typename T, int BITS>
struct MmLayout {
  static constexpr int LD = MM_BK + 16 / (int)sizeof(T);  // padded row of a shared tile
  static constexpr int PER_WORD = 32 / BITS;
  static constexpr int CHUNK = 4 * PER_WORD;             // codes behind one 16-byte load
  static constexpr int X_VEC = 16 / sizeof(T);
  static constexpr int X_LOADS = MM_BM * MM_BK / X_VEC / MM_THREADS;   // per thread
  static constexpr int W_LOADS = MM_BN * MM_BK / CHUNK / MM_THREADS;   // per thread
  static constexpr int LDC = MM_BN + 4;                  // fp32 epilogue tile
  static constexpr size_t TILE_BYTES = (size_t)(MM_BM + MM_BN) * LD * sizeof(T);
  static constexpr size_t C_BYTES = std::is_same<T, float>::value ? 0 : (size_t)MM_BM * LDC * 4;
  static constexpr size_t SHARED_BYTES = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  static_assert(X_LOADS >= 1 && W_LOADS >= 1, "every thread loads whole vectors");
};

template <typename T, int BITS>
__global__ void __launch_bounds__(MM_THREADS) quant_matmul_kernel(Params p) {
  using L = MmLayout<T, BITS>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [MM_BM][LD]
  T* ws = xs + MM_BM * L::LD;            // [MM_BN][LD], dequantized
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const long long words_per_row = p.IN / L::PER_WORD;
  const long long groups = p.IN / p.group_size;

  uint4 xr[L::X_LOADS], wr[L::W_LOADS];
  float sr[L::W_LOADS], br[L::W_LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < L::X_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int m = v / (MM_BK / L::X_VEC), kk = v % (MM_BK / L::X_VEC) * L::X_VEC;
      xr[i] = make_uint4(0, 0, 0, 0);
      if (m0 + m < p.M && k0 + kk < p.IN)
        xr[i] = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m0 + m) * p.IN + k0 + kk));
    }
#pragma unroll
    for (int i = 0; i < L::W_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int n = v / (MM_BK / L::CHUNK), kk = v % (MM_BK / L::CHUNK) * L::CHUNK;
      const long long row = n0 + n;
      wr[i] = make_uint4(0, 0, 0, 0);
      sr[i] = 0.f;
      br[i] = 0.f;
      if (row < p.OUT && k0 + kk < p.IN) {
        wr[i] = __ldg(reinterpret_cast<const uint4*>(p.q + row * words_per_row + (k0 + kk) / L::PER_WORD));
        sr[i] = load_param(p.scales, p.param_code, row * groups + (k0 + kk) / p.group_size);
        br[i] = load_param(p.biases, p.param_code, row * groups + (k0 + kk) / p.group_size);
      }
    }
  };
  auto stage = [&]() {  // registers -> shared, the weights dequantized on the way
#pragma unroll
    for (int i = 0; i < L::X_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int m = v / (MM_BK / L::X_VEC), kk = v % (MM_BK / L::X_VEC) * L::X_VEC;
      *reinterpret_cast<uint4*>(xs + m * L::LD + kk) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < L::W_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int n = v / (MM_BK / L::CHUNK), kk = v % (MM_BK / L::CHUNK) * L::CHUNK;
      T* dst = ws + n * L::LD + kk;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t word = word_of(wr[i], k);
#pragma unroll
        for (int j = 0; j < L::PER_WORD; j += 2) {
          const float a = fmaf(code_at<BITS>(word, j), sr[i], br[i]);
          const float b = fmaf(code_at<BITS>(word, j + 1), sr[i], br[i]);
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(dst + k * L::PER_WORD + j) = make_float2(a, b);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst + k * L::PER_WORD + j) =
                __floats2bfloat162_rn(a, b);
          }
        }
      }
    }
  };

  if constexpr (std::is_same<T, float>::value) {
    // FMA path: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    fetch(0);
    for (int k0 = 0; k0 < p.IN; k0 += MM_BK) {
      stage();
      __syncthreads();
      if (k0 + MM_BK < p.IN) fetch(k0 + MM_BK);
#pragma unroll 8
      for (int k = 0; k < MM_BK; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * L::LD + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[(tx + 16 * j) * L::LD + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m < p.M && n < p.OUT) out[(long long)m * p.OUT + n] = acc[i][j];
      }
  } else {
    using namespace nvcuda;
    const int warp = tid / 32;
    const int wm = warp / 4 * 32, wn = warp % 4 * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    fetch(0);
    for (int k0 = 0; k0 < p.IN; k0 += MM_BK) {
      stage();
      __syncthreads();
      if (k0 + MM_BK < p.IN) fetch(k0 + MM_BK);
#pragma unroll
      for (int kk = 0; kk < MM_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * L::LD + kk, L::LD);
        // the weight tile is (OUT, IN) row-major, i.e. W^T column-major
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + (wn + 16 * j) * L::LD + kk, L::LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // epilogue through shared fp32 (over the tiles, which are done), then
    // rounded once to bf16 with the ragged edges masked
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm + 16 * i) * L::LDC + wn + 16 * j, acc[i][j], L::LDC,
                                wmma::mem_row_major);
    __syncthreads();
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    for (int i = tid; i < MM_BM * MM_BN; i += MM_THREADS) {
      const int m = i / MM_BN, n = i % MM_BN;
      if (m0 + m < p.M && n0 + n < p.OUT)
        out[(long long)(m0 + m) * p.OUT + n0 + n] = __float2bfloat16_rn(cs[m * L::LDC + n]);
    }
  }
}

template <typename T, int BITS>
cudaError_t launch_matmul(const Params& p, cudaStream_t stream) {
  const size_t smem = MmLayout<T, BITS>::SHARED_BYTES;
  cudaError_t err = allow_shared((const void*)quant_matmul_kernel<T, BITS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.OUT + MM_BN - 1) / MM_BN, (p.M + MM_BM - 1) / MM_BM);
  quant_matmul_kernel<T, BITS><<<grid, MM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* q, const void* scales, const void* biases,
                   void* out, int param_code, int M, int IN, int OUT, int group_size) {
  Params p;
  p.x = x;
  p.q = static_cast<const uint32_t*>(q);
  p.scales = scales;
  p.biases = biases;
  p.out = out;
  p.M = M;
  p.IN = IN;
  p.OUT = OUT;
  p.group_size = group_size;
  p.param_code = param_code;
  return p;
}

}  // namespace

extern "C" {

// x_code: 0 = float32, 1 = bfloat16; param_code: 0 = float32, 1 = bfloat16,
// 2 = float16. The caller has checked shapes, alignment (16 bytes for x and
// q, IN a multiple of group_size in {32, 64, 128}) and M <= 8. Returns the
// cudaError_t of the launch (0 on success).
int mst_quant_gemv(const void* x, const void* q, const void* scales, const void* biases, void* out,
                   int x_code, int param_code, int bits, int M, int IN, int OUT, int group_size,
                   void* stream) {
  const Params p = make_params(x, q, scales, biases, out, param_code, M, IN, OUT, group_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 8) return (int)cudaErrorInvalidValue;
  if (x_code == 0 && bits == 4) return (int)gemv_for_m<float, 4>(p, s);
  if (x_code == 0 && bits == 8) return (int)gemv_for_m<float, 8>(p, s);
  if (x_code == 1 && bits == 4) return (int)gemv_for_m<__nv_bfloat16, 4>(p, s);
  if (x_code == 1 && bits == 8) return (int)gemv_for_m<__nv_bfloat16, 8>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The same contract for any M >= 1.
int mst_quant_matmul(const void* x, const void* q, const void* scales, const void* biases,
                     void* out, int x_code, int param_code, int bits, int M, int IN, int OUT,
                     int group_size, void* stream) {
  const Params p = make_params(x, q, scales, biases, out, param_code, M, IN, OUT, group_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == 0 && bits == 4) return (int)launch_matmul<float, 4>(p, s);
  if (x_code == 0 && bits == 8) return (int)launch_matmul<float, 8>(p, s);
  if (x_code == 1 && bits == 4) return (int)launch_matmul<__nv_bfloat16, 4>(p, s);
  if (x_code == 1 && bits == 8) return (int)launch_matmul<__nv_bfloat16, 8>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory of one launch, so the caller can report it.
long long mst_quant_shared_bytes(int kernel, int x_code, int bits, int M) {
  if (kernel == 0) {  // gemv
    if (x_code == 0) return bits == 4 ? gemv_shared_bytes_for_m<float, 4>(M)
                                      : gemv_shared_bytes_for_m<float, 8>(M);
    return bits == 4 ? gemv_shared_bytes_for_m<__nv_bfloat16, 4>(M)
                     : gemv_shared_bytes_for_m<__nv_bfloat16, 8>(M);
  }
  if (x_code == 0) return bits == 4 ? MmLayout<float, 4>::SHARED_BYTES : MmLayout<float, 8>::SHARED_BYTES;
  return bits == 4 ? MmLayout<__nv_bfloat16, 4>::SHARED_BYTES : MmLayout<__nv_bfloat16, 8>::SHARED_BYTES;
}

}  // extern "C"
