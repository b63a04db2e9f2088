// Products with MLX grouped-affine 2-, 4- and 8-bit weights kept packed in
// device memory, written for Hopper (sm_90a). Both kernels compute
//
//   out[m, o] = sum_i x[m, i] * (code(q)[o, i] * s[o, i / gs] + b[o, i / gs])
//
// accumulated in fp32 and rounded once to x's dtype. q is (OUT, IN*bits/32)
// 32-bit words holding 32/bits codes each, least-significant bits first (the
// checkpoint's layout, read as unsigned words whatever their torch dtype);
// scales and biases are (OUT, IN/gs) in fp32, bf16 or fp16; x is (M, IN) in
// bf16 or fp32. Group sizes 32, 64 and 128; bits 2, 4 and 8.
//
// quant_gemv_tc_kernel replaces the Pallas TPU kernel
// mlx_sharding_tpu/ops/quant_matmul.py::quant_gemv_pipelined (_gemv_kernel),
// the decode product for M <= 8 with bf16 x. What bounds it on an H100:
// bytes. At M = 1 to 8 it does 2M operations per weight and reads 0.5625
// bytes of it (a 4-bit code plus an fp16 scale and bias per 64 codes), far
// below the 295 operations per byte where the tensor cores become the
// limit. What the design does:
//   - the product runs on the tensor cores at every M (mma.sync m16n8k16:
//     16 OUT rows of codes as A, x^T as B with M padded to 8 columns, fp32
//     accumulators), so a code costs no FMA per row of x and x is not read
//     again for every weight row. The mma's k order is free: a lane's four
//     A slots are four codes it takes from one word (one lop3 into the
//     mantissa of bf16 128.0 at 2 and 4 bits, exact; a prmt through fp32 at
//     8 bits), and its B slots are x at the same IN indices;
//   - the bias is folded per group, as the TPU kernel folds it:
//     sum_k x_k (c_k s + b) = s sum_k x_k c_k + b sum_k x_k. Each group runs
//     into zeroed fragments, its x sums come from an mma against ones, and
//     the mma's 128 + c is taken out with the bias; integer-valued operands
//     stay exact;
//   - a block of 8 warps owns 32 rows: two warps along OUT, each 16 rows,
//     and four along IN, each 128 bytes of every row of a stage, their sums
//     added in a fixed order at the end. A stage is 512 contiguous bytes of
//     each of the 32 rows (128 bytes of 64 rows streamed slower); a 3-stage
//     ring of shared memory is filled by cp.async (16-byte, .cg) with the
//     next two stages' words, x and scales/biases, in flight from the first
//     cycle (no weight load waits for x);
//   - group size is a template constant, so a warp's walk over a stage
//     unrolls and its shared loads and mma chains overlap;
//   - when the row blocks leave half the SMs idle and IN is long enough
//     (ops/quant_matmul.py::plan_gemv: layers of 2048 rows or fewer whose
//     IN is over 4096; no Llama-3.1-8B shape), the walk over IN is split
//     across blocks on group boundaries; the
//     splits' fp32 partials are added in split order by
//     quant_gemv_reduce_kernel, with no atomics, so two runs give the same
//     bits;
//   - the shared-memory attribute is set once per instantiation.
// What holds it back now: at M = 1 the extraction of codes, the mma and the
// group folds take about as long as the loads, and the two overlap only in
// part. Not done yet: wgmma/TMA, load-time autotuning of the geometry and
// the split, and the launch latency that bounds the small shapes.
// fp32 x (tests only) takes quant_gemv_fma_kernel, the first version's FMA
// walk.
//
// quant_matmul_wgmma_kernel replaces the Pallas TPU kernel
// mlx_sharding_tpu/ops/quant_matmul.py::quant_matmul_pallas (_kernel), the
// product for M > 8 (prefill chunks) with bf16 x. What bounds it on an
// H100: tensor-core operations at M = 256 (2 M operations per weight
// against 0.5625 bytes of it, ~900 per byte); at the 600-token prompt's
// M = 88 tail both, since the ridge of 295 operations per byte sits at ~83
// tokens for 0.5625 bytes per weight. What the design does:
//   - the operands are swapped, out^T = W x^T, on wgmma m64nNk16: the
//     weights are A, dequantized into registers (each lane's slots of a k16
//     step are codes 2t, 2t+1, 2t+8, 2t+9 of rows g and g+8, taken from one
//     word each with a shift), so they never pass through shared memory;
//     the token tile of x is B, read by the tensor cores from shared memory
//     with the 128-byte swizzle. The token count is wgmma's N: the kernel is
//     built for tiles of 32, 64, ..., 256 tokens, so a tail of 88 tokens
//     runs as N = 96 (ops/quant_matmul.py::plan_matmul picks the tile);
//   - a block of two product warpgroups (64 OUT rows each) and one producer
//     warp, 288 threads at up to 224 registers each (no setmaxnreg: the lone
//     producer warp holds 11% of the register file). The producer fills a
//     ring of 3 to 8 stages (as many as 192 KB hold) with TMA: x as a
//     (64 IN, N tokens) box and the words as a (64 IN, 128 rows) box, each
//     stage on its own mbarrier; boxes past M, OUT or IN arrive as zeros,
//     so the ragged edges need no masks until the store. 2-bit rows that
//     are not a multiple of 16 bytes (and splits that start inside one) are
//     copied by the producer's lanes with 4-byte cp.async instead;
//   - code * s + b is an fp32 FMA rounded once to bf16, as today's kernel
//     and dequantize(..., bf16) round it (fp16 scales are not rounded to
//     bf16 first); on integer-valued operands every product and sum is
//     exact, so the kernel equals the plain version bit for bit. A lane's
//     scales and biases come from global memory a stage ahead of their use;
//   - the walk over IN is split across blocks when the OUT tiles alone
//     leave SMs idle (plan_matmul, from the shapes alone); the splits' fp32
//     partials are added in split order by quant_gemv_reduce_kernel, with
//     no atomics, so two runs give the same bits. The accumulators go out
//     transposed through shared memory in 16-byte runs of a token row.
// What holds it back (PERF.md): the dequantization and the products do not
// overlap. ptxas serializes the products whenever their A registers are
// written inside the walk (C7513), whatever the buffering (two A buffers,
// three products in flight, a copy into spare registers); at M = 256 the
// products alone take ~2/3 of the kernel's time and the dequantization
// ~1/3, and the kernel takes about their sum. Dequantizing into shared
// memory instead (by the product warpgroups or by a warpgroup of its own)
// and issuing both operands from there avoided the serialization and ran
// slower. Not done yet: a persistent (stream-K) grid, TMA multicast of x
// across a cluster, an fp32 scale/bias ring.
// fp32 x (tests only) takes quant_matmul_fma_kernel, the first version's
// FMA walk.
//
// The TPU kernels split the codes into nibble planes, expand scales from
// groups to words with an iota-built matmul and pre-permute x to word-major
// order, all to satisfy Mosaic's layout rules; none of that is needed here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

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

// Sets a kernel's dynamic shared-memory limit once per instantiation (the
// first launch), never per launch: the attribute call costs host time on a
// path that launches 129 GEMVs a decode step.
template <typename K>
cudaError_t allow_shared_once(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------ decode GEMV, fp32 x (tests)
// The first version's FMA kernel, kept for fp32 x only (no caller on the
// main path): each warp owns 4 rows and walks IN with one load of words per
// lane and row (16 bytes, or 8 at 2 bits so that a load never spans two
// groups), x staged in shared memory in IN tiles of 4096.
constexpr int FMA_WARPS = 8;
constexpr int FMA_THREADS = FMA_WARPS * 32;
constexpr int FMA_ROWS = 4;                            // rows per warp
constexpr int FMA_BLOCK_OUT = FMA_WARPS * FMA_ROWS;    // rows per block
constexpr int FMA_TILE_IN = 4096;                      // x elements staged per tile

template <int BITS>
struct FmaLayout {
  static constexpr int PER_WORD = 32 / BITS;
  static constexpr int LOAD_WORDS = BITS == 2 ? 2 : 4;
  static constexpr int CHUNK = LOAD_WORDS * PER_WORD;  // codes behind one load
  static constexpr int CHUNK_STRIDE = CHUNK + 4;       // + 16 bytes of padding
  static constexpr int ROW_STRIDE = FMA_TILE_IN / CHUNK * CHUNK_STRIDE;
};

template <int BITS, int MT>
constexpr size_t fma_shared_bytes() {
  return (size_t)MT * FmaLayout<BITS>::ROW_STRIDE * sizeof(float);
}

template <int BITS, int MT>
__global__ void __launch_bounds__(FMA_THREADS) quant_gemv_fma_kernel(Params p) {
  using L = FmaLayout<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * FMA_BLOCK_OUT + warp * FMA_ROWS;
  const long long words_per_row = p.IN / L::PER_WORD;
  const long long groups = p.IN / p.group_size;

  float acc[MT][FMA_ROWS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) acc[m][r] = 0.f;

  uint4 w_next[FMA_ROWS];
  float s_next[FMA_ROWS], b_next[FMA_ROWS];
  auto fetch = [&](int kc) {  // the words, scale and bias of the chunk at IN index kc
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int row = row0 + r;
      w_next[r] = make_uint4(0, 0, 0, 0);
      s_next[r] = 0.f;
      b_next[r] = 0.f;
      if (row < p.OUT) {
        const uint32_t* src = p.q + row * words_per_row + kc / L::PER_WORD;
        if constexpr (L::LOAD_WORDS == 4) {
          w_next[r] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          const uint2 w2 = __ldg(reinterpret_cast<const uint2*>(src));
          w_next[r] = make_uint4(w2.x, w2.y, 0, 0);
        }
        s_next[r] = load_param(p.scales, p.param_code, row * groups + kc / p.group_size);
        b_next[r] = load_param(p.biases, p.param_code, row * groups + kc / p.group_size);
      }
    }
  };

  for (int k0 = 0; k0 < p.IN; k0 += FMA_TILE_IN) {
    const int kt = min(FMA_TILE_IN, p.IN - k0);
    // stage x[:, k0 : k0 + kt] in 16-byte vectors; rows past M are zeros
    const int vecs = kt / 4;
    for (int i = threadIdx.x; i < MT * vecs; i += FMA_THREADS) {
      const int m = i / vecs, e = (i % vecs) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < p.M) v = *reinterpret_cast<const float4*>(x + (long long)m * p.IN + k0 + e);
      *reinterpret_cast<float4*>(xs + m * L::ROW_STRIDE + e / L::CHUNK * L::CHUNK_STRIDE +
                                 e % L::CHUNK) = v;
    }
    __syncthreads();
    const int chunks = kt / L::CHUNK;
    if (lane < chunks) fetch(k0 + lane * L::CHUNK);
    for (int c = lane; c < chunks; c += 32) {
      uint4 w[FMA_ROWS];
      float s[FMA_ROWS], b[FMA_ROWS];
#pragma unroll
      for (int r = 0; r < FMA_ROWS; ++r) {
        w[r] = w_next[r];
        s[r] = s_next[r];
        b[r] = b_next[r];
      }
      if (c + 32 < chunks) fetch(k0 + (c + 32) * L::CHUNK);  // in flight during the math below
      const float* xc = xs + c * L::CHUNK_STRIDE;
#pragma unroll
      for (int k = 0; k < L::LOAD_WORDS; ++k) {
        float xv[MT][L::PER_WORD];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_f32(xc + m * L::ROW_STRIDE + k * L::PER_WORD, xv[m]);
#pragma unroll
        for (int r = 0; r < FMA_ROWS; ++r) {
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
    for (int r = 0; r < FMA_ROWS; ++r) {
      float v = acc[m][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
      acc[m][r] = v;
    }
  if (lane == 0) {
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int row = row0 + r;
      if (row >= p.OUT) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < p.M) out[(long long)m * p.OUT + row] = acc[m][r];
    }
  }
}

template <int BITS, int MT>
cudaError_t launch_gemv_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fma_shared_bytes<BITS, MT>();
  static const cudaError_t attr = allow_shared_once(quant_gemv_fma_kernel<BITS, MT>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.OUT + FMA_BLOCK_OUT - 1) / FMA_BLOCK_OUT);
  quant_gemv_fma_kernel<BITS, MT><<<grid, FMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ decode GEMV, bf16 x (the path)
// mma.sync m16n8k16 with the weights as A (16 OUT rows x 16 k) and x^T as B
// (16 k x 8 columns, M padded to 8), accumulated in fp32. Lane (g, t) of a
// warp (g = lane / 4, t = lane % 4) holds A's rows g and g + 8 at k slots
// 2t, 2t+1, 2t+8, 2t+9 and B's column g at the same slots. The k order is
// free if A and B agree, so a lane's slots are mapped onto codes it extracts
// from one word of each row it holds, and its B values are read from x at
// the same IN indices. Two mma k-steps take a "chunk" of 32 codes of a row,
// which lies inside one group at any group size.
constexpr int TC_WARPS_OUT = 2;  // warps along OUT, 16 rows each
constexpr int TC_WARPS_K = 4;    // warps along a stage's IN range
constexpr int TC_WARPS = TC_WARPS_OUT * TC_WARPS_K;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = TC_WARPS_OUT * 16;  // OUT rows per block
constexpr int TC_STAGES = 3;                // the cp.async ring
constexpr int TC_WARP_BYTES = 128;          // weight bytes of a row one warp takes per stage
constexpr int TC_ROW_BYTES = TC_WARP_BYTES * TC_WARPS_K;  // and the block
constexpr int TC_CHUNK = 32;                // codes of a row per two mma steps
constexpr uint32_t BF16_ONES = 0x3F803F80u;
constexpr uint32_t BF16_128 = 0x43004300u;  // 128.0 in both halves

template <int BITS>
struct TcLayout {
  static constexpr int TILE_K = TC_ROW_BYTES * 8 / BITS;   // codes of a row per stage
  static constexpr int WARP_K = TC_WARP_BYTES * 8 / BITS;  // of them, one warp's
  // padded rows: the words a warp reads at once fall in distinct banks
  static constexpr int W_STRIDE = TC_ROW_BYTES + (BITS == 8 ? 32 : 16);
  static constexpr int X_STRIDE = TILE_K * 2 + 64;
  // bytes of one weight copy: 16, or 8 at 2 bits, whose rows and split
  // boundaries are whole 16-byte words only when IN is a multiple of 64
  static constexpr int PIECE = BITS == 2 ? 8 : 16;
  // 2 and 4 bits: a code c enters the mma as 128 + c (exact in bf16); the
  // offset is taken out with the bias. 8 bits: the code itself
  static constexpr float OFFSET = BITS == 8 ? 0.f : 128.f;
};

// Byte offsets of one ring stage: the weights of TC_ROWS rows, x's MT rows,
// then each row's scales and biases of the stage's groups, copied as the
// 4-byte words that hold them (one word more for 2-byte types, whose first
// entry may sit in the upper half of a word).
template <int BITS, int MT>
struct TcStage {
  int pwords, x, s, b, bytes;
  __host__ __device__ TcStage(int group_size, int param_size) {
    using L = TcLayout<BITS>;
    pwords = (L::TILE_K / group_size * param_size + 3) / 4 + (param_size < 4 ? 1 : 0);
    x = TC_ROWS * L::W_STRIDE;
    s = x + MT * L::X_STRIDE;
    b = s + TC_ROWS * pwords * 4;
    bytes = (b + TC_ROWS * pwords * 4 + 15) / 16 * 16;
  }
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Codes j and j + 4 (4 bits) or j and j + 8 (2 bits, shift = 2j) of a word
// as the bf16 pair (128 + low, 128 + high): the mask puts each code in the
// mantissa of 128.0, whose step is 1 (one lop3).
__device__ __forceinline__ uint32_t pair4(uint32_t w, int j) {
  return ((w >> (4 * j)) & 0x000F000Fu) | BF16_128;
}
__device__ __forceinline__ uint32_t pair2(uint32_t w, int shift) {
  return ((w >> shift) & 0x00030003u) | BF16_128;
}
// Bytes 2j and 2j + 1 of a word as a bf16 pair: each byte into the mantissa
// of 2^23 (one prmt), less 2^23, then both rounded to bf16, exactly (an
// 8-bit code has 8 significant bits).
__device__ __forceinline__ uint32_t pair8(uint32_t w, int j) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + 2 * j)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541 + 2 * j)) - 8388608.0f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float stage_param(const unsigned char* p, int code, int i) {
  if (code == 0) return reinterpret_cast<const float*>(p)[i];
  if (code == 1) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(reinterpret_cast<const __half*>(p)[i]);
}

// One block owns TC_ROWS rows and the IN range [kb, kb + split) of
// blockIdx.y. Warp (wo, wk) owns 16 of the rows and the wk-th WARP_K codes
// of each stage; with TC_WARPS_K > 1 the warps' sums are added in wk order
// at the end. With one split the block writes the output; with more, its
// fp32 partial sums, which quant_gemv_reduce_kernel adds in split order.
// Every thread's share of a stage's copies is fixed for the block and set
// up once, and group sizes (32, 64, 128) enter as shifts: a runtime
// division per copy costs more instruction slots than the math of the bytes it
// moves.
template <int BITS, int MT, int GS>
__global__ void __launch_bounds__(TC_THREADS) quant_gemv_tc_kernel(Params p, int split,
                                                                   float* part) {
  using L = TcLayout<BITS>;
  constexpr int CPG = GS / TC_CHUNK;            // chunks per group
  constexpr int NCH = L::WARP_K / TC_CHUNK;     // chunks of a warp per stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int psize = p.param_code == 0 ? 4 : 2;
  const TcStage<BITS, MT> S(GS, psize);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t = lane % 4;
  const int wo = warp % TC_WARPS_OUT, wk = warp / TC_WARPS_OUT;
  const int row0 = blockIdx.x * TC_ROWS;
  const int kb = blockIdx.y * split, ke = min(p.IN, kb + split);
  const int ntiles = (ke - kb + L::TILE_K - 1) / L::TILE_K;
  constexpr int gshift = GS == 32 ? 5 : GS == 64 ? 6 : 7;
  const int groups = p.IN >> gshift;
  const int epw_mask = psize == 2 ? 1 : 0;  // parameters per 4-byte word, less one

  // weights: thread tid copies piece tid % PPR of rows tid / PPR + j ROWS_PER
  constexpr int PPR = TC_ROW_BYTES / L::PIECE;  // pieces per row of a stage
  constexpr int ROWS_PER = TC_THREADS / PPR;    // rows one pass of the block covers
  constexpr int W_PASSES = TC_ROWS / ROWS_PER;
  static_assert(TC_THREADS % PPR == 0 && TC_ROWS % ROWS_PER == 0, "whole passes");
  const int wc = tid % PPR;
  const char* w_src[W_PASSES];
  bool w_live[W_PASSES];
#pragma unroll
  for (int j = 0; j < W_PASSES; ++j) {
    const int row = row0 + tid / PPR + j * ROWS_PER;
    w_live[j] = row < p.OUT;
    w_src[j] = reinterpret_cast<const char*>(p.q) +
               (long long)min(row, p.OUT - 1) * (p.IN / 8 * BITS) + wc * L::PIECE;
  }
  // scales (the first TC_ROWS of each 2 TC_ROWS threads) and biases (the
  // second) of row tid % TC_ROWS, every TC_WARPS_K-th 4-byte word
  constexpr int P_THREADS = 2 * TC_ROWS;
  const bool is_scale = tid % P_THREADS < TC_ROWS;
  const int prow = row0 + tid % TC_ROWS;
  const bool p_live = prow < p.OUT;
  const int p_first = min(prow, p.OUT - 1) * groups;  // the row's first entry
  const char* p_src = static_cast<const char*>(is_scale ? p.scales : p.biases);
  const int p_bytes = p.OUT * groups * psize;  // of the whole tensor
  const int p_dst = (is_scale ? S.s : S.b) + (tid % TC_ROWS) * S.pwords * 4;
  const int p_word0 = tid / P_THREADS;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);

  // the copies of tile i (IN [kb + i TILE_K, ...)) into ring slot `slot`
  auto load_tile = [&](int i, int slot) {
    unsigned char* st = smem + slot * S.bytes;
    const int k0 = kb + i * L::TILE_K;
    const int klen = min(L::TILE_K, ke - k0);
    const int rb = klen / 8 * BITS;  // weight bytes of the tile's row
    const int off = k0 / 8 * BITS;
    const bool piece_live = wc * L::PIECE < rb;
#pragma unroll
    for (int j = 0; j < W_PASSES; ++j) {
      const bool live = w_live[j] && piece_live;
      cp_async(st + (tid / PPR + j * ROWS_PER) * L::W_STRIDE + wc * L::PIECE,
               w_src[j] + (live ? off : 0), L::PIECE, live ? L::PIECE : 0);
    }
    for (int v = tid; v * 8 < klen; v += TC_THREADS) {
      for (int m = 0; m < p.M; ++m)
        cp_async(st + S.x + m * L::X_STRIDE + v * 16, x + (long long)m * p.IN + k0 + v * 8, 16, 16);
    }
    const int e = p_first + (k0 >> gshift);      // the tile's first entry of the row
    const int e_end = e + (klen >> gshift);
    const int lead = e & ~epw_mask;              // the word that holds it
    for (int c = p_word0; c < S.pwords; c += TC_WARPS_K) {
      const int byte = (lead + c * (epw_mask + 1)) * psize;
      const bool live = p_live && lead + c * (epw_mask + 1) < e_end;
      cp_async(st + p_dst + c * 4, p_src + (live ? byte : 0), 4,
               live ? min(4, p_bytes - byte) : 0);
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    cp_async_commit();
  }
  const int r_lo = wo * 16 + gid, r_hi = r_lo + 8;  // this lane's rows in the block
  const int e_lo = min(row0 + r_lo, p.OUT - 1) * groups;
  const int e_hi = min(row0 + r_hi, p.OUT - 1) * groups;
  const int kw = wk * L::WARP_K;                     // this warp's first code of a stage
  const int g_w = kw >> gshift;                      // and its first group
  const bool has_col = gid < p.M;                    // B column g is a row of x
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile it visible; every warp is done with the slot refilled below
    if (it + TC_STAGES - 1 < ntiles) load_tile(it + TC_STAGES - 1, (it + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();

    const unsigned char* st = smem + (it % TC_STAGES) * S.bytes;
    const int k0 = kb + it * L::TILE_K;
    const int chunks = max(0, min(L::WARP_K, ke - k0 - kw)) / TC_CHUNK;
    const unsigned char* w_lo = st + r_lo * L::W_STRIDE + wk * TC_WARP_BYTES;
    const unsigned char* w_hi = st + r_hi * L::W_STRIDE + wk * TC_WARP_BYTES;
    const unsigned char* xr = st + S.x + gid * L::X_STRIDE + kw * 2;
    // this lane's rows' parameters in the stage, at the tile's first group
    const unsigned char* s_lo = st + S.s + r_lo * S.pwords * 4;
    const unsigned char* s_hi = st + S.s + r_hi * S.pwords * 4;
    const unsigned char* b_lo = st + S.b + r_lo * S.pwords * 4;
    const unsigned char* b_hi = st + S.b + r_hi * S.pwords * 4;
    const int lead_lo = ((e_lo + (k0 >> gshift)) & epw_mask) + g_w;
    const int lead_hi = ((e_hi + (k0 >> gshift)) & epw_mask) + g_w;
    float tmp[4], xsum[4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= chunks) break;  // the walk's last tile may be short
      if (c % CPG == 0) {  // a new group: fresh fragments
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[e] = xsum[e] = 0.f;
      }
      uint32_t b[4] = {0u, 0u, 0u, 0u};  // B of the two steps; zero past M
      if constexpr (BITS == 2) {
        // the lane's codes 4h..4h+3 and 4h+8..4h+11 of word t / 2 (h = t % 2)
        const uint32_t w_l = *reinterpret_cast<const uint32_t*>(w_lo + (2 * c + t / 2) * 4);
        const uint32_t w_h = *reinterpret_cast<const uint32_t*>(w_hi + (2 * c + t / 2) * 4);
        if (has_col) {
          const int o = (c * TC_CHUNK + 16 * (t / 2) + 4 * (t % 2)) * 2;
          const uint2 lo = *reinterpret_cast<const uint2*>(xr + o);
          const uint2 hi = *reinterpret_cast<const uint2*>(xr + o + 16);
          b[0] = __byte_perm(lo.x, hi.x, 0x5410);
          b[1] = __byte_perm(lo.x, hi.x, 0x7632);
          b[2] = __byte_perm(lo.y, hi.y, 0x5410);
          b[3] = __byte_perm(lo.y, hi.y, 0x7632);
        }
        const int sb = 8 * (t % 2);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma_bf16(tmp, pair2(w_l, sb + 4 * s), pair2(w_h, sb + 4 * s), pair2(w_l, sb + 4 * s + 2),
                   pair2(w_h, sb + 4 * s + 2), b[2 * s], b[2 * s + 1]);
          mma_bf16(xsum, BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[2 * s], b[2 * s + 1]);
        }
      } else if constexpr (BITS == 4) {
        // the lane's word 4c + t: codes 8t .. 8t+7 of the chunk
        const uint32_t w_l = *reinterpret_cast<const uint32_t*>(w_lo + (4 * c + t) * 4);
        const uint32_t w_h = *reinterpret_cast<const uint32_t*>(w_hi + (4 * c + t) * 4);
        if (has_col) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr + (c * TC_CHUNK + 8 * t) * 2);
          b[0] = __byte_perm(v.x, v.z, 0x5410);  // (x0, x4)
          b[1] = __byte_perm(v.x, v.z, 0x7632);  // (x1, x5)
          b[2] = __byte_perm(v.y, v.w, 0x5410);  // (x2, x6)
          b[3] = __byte_perm(v.y, v.w, 0x7632);  // (x3, x7)
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma_bf16(tmp, pair4(w_l, 2 * s), pair4(w_h, 2 * s), pair4(w_l, 2 * s + 1),
                   pair4(w_h, 2 * s + 1), b[2 * s], b[2 * s + 1]);
          mma_bf16(xsum, BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[2 * s], b[2 * s + 1]);
        }
      } else {
        // the lane's words 8c + 2t and 8c + 2t + 1: codes 8t .. 8t+7
        const uint2 w_l = *reinterpret_cast<const uint2*>(w_lo + (8 * c + 2 * t) * 4);
        const uint2 w_h = *reinterpret_cast<const uint2*>(w_hi + (8 * c + 2 * t) * 4);
        if (has_col) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr + (c * TC_CHUNK + 8 * t) * 2);
          b[0] = v.x;
          b[1] = v.y;
          b[2] = v.z;
          b[3] = v.w;
        }
        mma_bf16(tmp, pair8(w_l.x, 0), pair8(w_h.x, 0), pair8(w_l.x, 1), pair8(w_h.x, 1), b[0], b[1]);
        mma_bf16(xsum, BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[0], b[1]);
        mma_bf16(tmp, pair8(w_l.y, 0), pair8(w_h.y, 0), pair8(w_l.y, 1), pair8(w_h.y, 1), b[2], b[3]);
        mma_bf16(xsum, BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[2], b[3]);
      }
      if ((c + 1) % CPG == 0) {
        // the group is done: sum_k x_k (c_k s + b) = s sum_k x_k c_k + b sum_k x_k,
        // with the mma's 128 + c taken out through the bias
        const int g = c / CPG;
        const float sl = stage_param(s_lo, p.param_code, lead_lo + g);
        const float sh = stage_param(s_hi, p.param_code, lead_hi + g);
        const float bl = fmaf(-L::OFFSET, sl, stage_param(b_lo, p.param_code, lead_lo + g));
        const float bh = fmaf(-L::OFFSET, sh, stage_param(b_hi, p.param_code, lead_hi + g));
        acc[0] = fmaf(bl, xsum[0], fmaf(sl, tmp[0], acc[0]));
        acc[1] = fmaf(bl, xsum[1], fmaf(sl, tmp[1], acc[1]));
        acc[2] = fmaf(bh, xsum[0], fmaf(sh, tmp[2], acc[2]));
        acc[3] = fmaf(bh, xsum[1], fmaf(sh, tmp[3], acc[3]));
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (TC_WARPS_K > 1) {
    // the k warps' sums of the same rows, added in wk order over the ring
    __syncthreads();
    float4* red = reinterpret_cast<float4*>(smem);
    if (wk > 0) red[((wk - 1) * TC_WARPS_OUT + wo) * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int j = 1; j < TC_WARPS_K; ++j) {
      const float4 v = red[((j - 1) * TC_WARPS_OUT + wo) * 32 + lane];
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }

  // lane (g, t) holds rows g and g + 8 of its warp's 16, columns 2t and 2t + 1
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 2 * t + (e & 1);
    const int row = row0 + (e < 2 ? r_lo : r_hi);
    if (m >= p.M || row >= p.OUT) continue;
    if (gridDim.y == 1) {
      static_cast<__nv_bfloat16*>(p.out)[(long long)m * p.OUT + row] = __float2bfloat16_rn(acc[e]);
    } else {
      part[((long long)blockIdx.y * p.M + m) * p.OUT + row] = acc[e];
    }
  }
}

// The splits' partial sums of each output, added in split order (so two
// runs give the same bits) and rounded once to bf16.
__global__ void __launch_bounds__(256) quant_gemv_reduce_kernel(const float* part, int splits,
                                                                 int n, __nv_bfloat16* out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(long long)s * n + i];
  out[i] = __float2bfloat16_rn(v);
}

template <int BITS, int MT>
size_t tc_shared_bytes(int group_size, int param_size) {
  return (size_t)TC_STAGES * TcStage<BITS, MT>(group_size, param_size).bytes;
}

// F(std::integral_constant<int, GS>) for the group size of the launch
template <typename F>
auto for_group(int group_size, const F& f) {
  if (group_size == 32) return f(std::integral_constant<int, 32>{});
  if (group_size == 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

template <int BITS, int MT, int GS>
cudaError_t launch_gemv_tc(const Params& p, int split, float* part, cudaStream_t stream) {
  // the larger ring of the two scale widths
  static const cudaError_t attr =
      allow_shared_once(quant_gemv_tc_kernel<BITS, MT, GS>, tc_shared_bytes<BITS, MT>(GS, 4));
  if (attr != cudaSuccess) return attr;
  const size_t smem = tc_shared_bytes<BITS, MT>(GS, p.param_code == 0 ? 4 : 2);
  const int len = split > 0 ? split : p.IN;
  const int splits = (p.IN + len - 1) / len;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((p.OUT + TC_ROWS - 1) / TC_ROWS, splits);
  quant_gemv_tc_kernel<BITS, MT, GS><<<grid, TC_THREADS, smem, stream>>>(p, len, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = p.M * p.OUT;
  quant_gemv_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, splits, n, static_cast<__nv_bfloat16*>(p.out));
  return cudaGetLastError();
}

// F(std::integral_constant<int, BITS>, std::integral_constant<int, MT>) for
// the instantiation that serves (bits, M)
template <typename F>
auto for_bits_m(int bits, int M, const F& f) {
  auto by_m = [&](auto b) {
    if (M <= 1) return f(b, std::integral_constant<int, 1>{});
    if (M <= 2) return f(b, std::integral_constant<int, 2>{});
    if (M <= 4) return f(b, std::integral_constant<int, 4>{});
    return f(b, std::integral_constant<int, 8>{});
  };
  if (bits == 2) return by_m(std::integral_constant<int, 2>{});
  if (bits == 4) return by_m(std::integral_constant<int, 4>{});
  return by_m(std::integral_constant<int, 8>{});
}

// ------------------------------------------- prefill dequant-matmul, fp32 x
// Tests only (no caller on the main path): the first version's FMA walk. A
// block of 256 threads owns a 64 x 128 (M x OUT) tile and loops over IN 64
// at a time; the next step's x and words are loaded into registers while
// this step's tiles, the weight dequantized in fp32, are multiplied from
// shared memory.
constexpr int MM_BM = 64;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;
constexpr int MM_THREADS = 256;

template <int BITS>
struct FmaMmLayout {
  static constexpr int LD = MM_BK + 4;  // padded row of a shared tile
  static constexpr int PER_WORD = 32 / BITS;
  // words behind one weight load: 16 bytes, or 8 at 2 bits, so that a
  // load's codes (32) never span two groups
  static constexpr int LOAD_WORDS = BITS == 2 ? 2 : 4;
  static constexpr int CHUNK = LOAD_WORDS * PER_WORD;  // codes behind one load
  static constexpr int X_LOADS = MM_BM * MM_BK / 4 / MM_THREADS;      // float4s per thread
  static constexpr int W_LOADS = MM_BN * MM_BK / CHUNK / MM_THREADS;  // per thread
  static constexpr size_t SHARED_BYTES = (size_t)(MM_BM + MM_BN) * LD * sizeof(float);
  static_assert(X_LOADS >= 1 && W_LOADS >= 1, "every thread loads whole vectors");
};

template <int BITS>
__global__ void __launch_bounds__(MM_THREADS) quant_matmul_fma_kernel(Params p) {
  using L = FmaMmLayout<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [MM_BM][LD]
  float* ws = xs + MM_BM * L::LD;               // [MM_BN][LD], dequantized
  const float* __restrict__ x = static_cast<const float*>(p.x);
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
      const int m = v / (MM_BK / 4), kk = v % (MM_BK / 4) * 4;
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
        const uint32_t* src = p.q + row * words_per_row + (k0 + kk) / L::PER_WORD;
        if constexpr (L::LOAD_WORDS == 4) {
          wr[i] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          const uint2 w2 = __ldg(reinterpret_cast<const uint2*>(src));
          wr[i] = make_uint4(w2.x, w2.y, 0, 0);
        }
        sr[i] = load_param(p.scales, p.param_code, row * groups + (k0 + kk) / p.group_size);
        br[i] = load_param(p.biases, p.param_code, row * groups + (k0 + kk) / p.group_size);
      }
    }
  };
  auto stage = [&]() {  // registers -> shared, the weights dequantized on the way
#pragma unroll
    for (int i = 0; i < L::X_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int m = v / (MM_BK / 4), kk = v % (MM_BK / 4) * 4;
      *reinterpret_cast<uint4*>(xs + m * L::LD + kk) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < L::W_LOADS; ++i) {
      const int v = tid + i * MM_THREADS;
      const int n = v / (MM_BK / L::CHUNK), kk = v % (MM_BK / L::CHUNK) * L::CHUNK;
      float* dst = ws + n * L::LD + kk;
#pragma unroll
      for (int k = 0; k < L::LOAD_WORDS; ++k) {
        const uint32_t word = word_of(wr[i], k);
#pragma unroll
        for (int j = 0; j < L::PER_WORD; ++j)
          dst[k * L::PER_WORD + j] = fmaf(code_at<BITS>(word, j), sr[i], br[i]);
      }
    }
  };

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
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
}

template <int BITS>
cudaError_t launch_matmul_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = FmaMmLayout<BITS>::SHARED_BYTES;
  static const cudaError_t attr = allow_shared_once(quant_matmul_fma_kernel<BITS>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.OUT + MM_BN - 1) / MM_BN, (p.M + MM_BM - 1) / MM_BM);
  quant_matmul_fma_kernel<BITS><<<grid, MM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------- prefill dequant-matmul, bf16 x
// out^T = W x^T on wgmma m64nNk16 (see the header): a block owns WG_ROWS
// OUT rows, N tokens and the IN range of blockIdx.z. Product warpgroup c
// holds OUT rows [64 c, 64 c + 64) of the block as wgmma's A, dequantized
// into registers from the stage's words; the token tile of x is B, read by
// the tensor cores from the stage. One producer warp fills a ring of
// stages with TMA: x as a (64 IN, N tokens) box with the 128-byte swizzle,
// the words as a (64 IN, WG_ROWS rows) box.
constexpr int WG_CONSUMERS = 2;                      // product warpgroups of 64 OUT rows
constexpr int WG_ROWS = 64 * WG_CONSUMERS;           // OUT rows per block
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // and one producer warp
constexpr int WG_BK = 64;                            // IN per stage: one 128-byte row of x
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_RING_BYTES = 192 * 1024;  // what the ring may take of the 227 KB
constexpr int WG_EPI_LD = WG_ROWS + 4;     // floats per token row of the epilogue tile

template <int BITS, int N>
struct WgLayout {
  static constexpr int X_BYTES = N * WG_BK * 2;              // a multiple of 1024
  static constexpr int ROW_BYTES = WG_BK * BITS / 8;         // a weight row's words per stage
  static constexpr int STAGE = X_BYTES + WG_ROWS * ROW_BYTES;  // a multiple of 1024
  static constexpr int STAGES =
      WG_RING_BYTES / STAGE < WG_MAX_STAGES ? WG_RING_BYTES / STAGE : WG_MAX_STAGES;
  static constexpr int EPI = N * WG_EPI_LD * 4;  // the fp32 epilogue tile, over the ring
  static constexpr int BARS = STAGES * STAGE > EPI ? STAGES * STAGE : EPI;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + the alignment of the base
  static_assert(STAGES >= 3, "a ring of three stages at least");
  static_assert(BYTES <= 232448, "one block's shared memory");
};

struct WgArgs {
  const uint32_t* q;  // the words, for 4-byte copies when a row is not a multiple of 16 bytes
  const void* scales;
  const void* biases;
  void* out;    // (M, OUT) bf16: a walk in one split
  float* part;  // (splits, M, OUT) fp32 partial sums: a walk in more
  int M, IN, OUT;
  int gshift;      // log2 of the group size
  int param_code;  // scales/biases: 0 = float32, 1 = bfloat16, 2 = float16
  int split;       // IN elements per block along the walk
  int words_tma;   // 1: the words come by TMA; 0: by cp.async
};

template <int N>
struct Wgmma;  // d += a b: A (64 x 16 bf16) from registers, B (16 x N) from shared memory

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<224> {
  static __device__ __forceinline__ void mma(float (&d)[112], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// The descriptor of a K-major B tile with the 128-byte swizzle at shared
// address addr: rows of 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Codes at bits [0, BITS) and [BITS, 2 BITS) of v as the bf16 pair
// (c0 s + b, c1 s + b): each an fp32 FMA rounded once to bf16, as
// dequantize(..., bf16) rounds. 2^23 + c is exact in fp32, so the OR and
// the subtraction give the code with no conversion instruction.
template <int BITS>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, float s, float b) {
  constexpr uint32_t MASK = (1u << BITS) - 1;
  const float c0 = __uint_as_float(0x4B000000u | (v & MASK)) - 8388608.0f;
  const float c1 = __uint_as_float(0x4B000000u | ((v >> BITS) & MASK)) - 8388608.0f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaf(c0, s, b), fmaf(c1, s, b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int BITS, int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
    quant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap, const WgArgs p) {
  using L = WgLayout<BITS, N>;
  constexpr int PER_WORD = 32 / BITS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const unsigned bars = smem_u32(smem + L::BARS);  // full[s] at + 8 s, empty[s] at + 8 (STAGES + s)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * WG_ROWS, m0 = blockIdx.y * N;
  const int kb = blockIdx.z * p.split, ke = min(p.IN, kb + p.split);
  const int steps = (ke - kb + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      // full: the producer's expect_tx, and with copied words each producer
      // lane's cp.async arrival; empty: one arrival per product warp
      mbar_init(bars + 8 * s, p.words_tma ? 1 : 33);
      mbar_init(bars + 8 * (L::STAGES + s), 4 * WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG_CONSUMERS) {
    // the producer: each stage's boxes as soon as its slot is free
    const int words_per_row = p.IN / PER_WORD;
    for (int it = 0; it < steps; ++it) {
      const int s = it % L::STAGES;
      if (it >= L::STAGES) mbar_wait(bars + 8 * (L::STAGES + s), (it / L::STAGES - 1) & 1);
      const int k0 = kb + it * WG_BK;
      unsigned char* st = smem + s * L::STAGE;
      const unsigned full = bars + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(full, L::X_BYTES + (p.words_tma ? WG_ROWS * L::ROW_BYTES : 0));
        tma_load_2d(smem_u32(st), &xmap, k0, m0, full);
        if (p.words_tma) tma_load_2d(smem_u32(st + L::X_BYTES), &wmap, k0 / PER_WORD, n0, full);
      }
      if (!p.words_tma) {
        // rows or split starts that are not on 16 bytes (2 bits, IN or the
        // split an odd multiple of 32): 4-byte copies, words past a row's
        // end and rows past OUT as zeros
        constexpr int RW = L::ROW_BYTES / 4;
        for (int i = lane; i < WG_ROWS * RW; i += 32) {
          const int r = n0 + i / RW, w = k0 / PER_WORD + i % RW;
          const bool ok = r < p.OUT && w < words_per_row;
          cp_async(st + L::X_BYTES + i * 4, p.q + (ok ? (long long)r * words_per_row + w : 0), 4,
                   ok ? 4 : 0);
        }
        cp_async_mbar_arrive(full);
      }
    }
    return;
  }

  // ---- the product warpgroups
  const int g = lane / 4, t = lane % 4;
  const int r_lo = warp / 4 * 64 + warp % 4 * 16 + g, r_hi = r_lo + 8;  // rows in the block
  const int groups = p.IN >> p.gshift;
  const long long e_lo = (long long)min(n0 + r_lo, p.OUT - 1) * groups;
  const long long e_hi = (long long)min(n0 + r_hi, p.OUT - 1) * groups;
  // the scales and biases of the lane's two rows for each 32-wide half of
  // the stage at k0 (a k16 step never spans two groups)
  auto params = [&](int k0, float (&s)[2][2], float (&b)[2][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && p.gshift > 5) {  // a group of 64 or 128 holds the whole stage
        s[1][0] = s[0][0];
        s[1][1] = s[0][1];
        b[1][0] = b[0][0];
        b[1][1] = b[0][1];
        break;
      }
      const int gi = min((k0 + 32 * h) >> p.gshift, groups - 1);
      s[h][0] = load_param(p.scales, p.param_code, e_lo + gi);
      s[h][1] = load_param(p.scales, p.param_code, e_hi + gi);
      b[h][0] = load_param(p.biases, p.param_code, e_lo + gi);
      b[h][1] = load_param(p.biases, p.param_code, e_hi + gi);
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];  // A of this k16 step and the last, which may still be in flight
  float sc[2][2], bi[2][2], sc_next[2][2], bi_next[2][2];
  params(kb, sc, bi);
  for (int it = 0; it < steps; ++it) {
    const int s = it % L::STAGES;
    const int k0 = kb + it * WG_BK;
    const int kvalid = min(WG_BK, ke - k0);  // a multiple of 32
    if (it + 1 < steps) params(k0 + WG_BK, sc_next, bi_next);  // in flight during the stage
    mbar_wait(bars + 8 * s, (it / L::STAGES) & 1);
    const unsigned char* st = smem + s * L::STAGE;
    const uint32_t* w_lo = reinterpret_cast<const uint32_t*>(st + L::X_BYTES + r_lo * L::ROW_BYTES);
    const uint32_t* w_hi = reinterpret_cast<const uint32_t*>(st + L::X_BYTES + r_hi * L::ROW_BYTES);
    const unsigned x_addr = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if (kk * 16 >= kvalid) break;
      // the lane's A slots: rows g and g + 8 at k = 16 kk + 2t + 8j + {0, 1}
      // (j = 0, 1), two codes of one word each
      uint32_t(&f)[4] = a[kk & 1];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kq = 16 * kk + 2 * t + 8 * j;
        const int wi = kq / PER_WORD, sh = kq % PER_WORD * BITS;
        f[2 * j] = dequant_pair<BITS>(w_lo[wi] >> sh, sc[kk / 2][0], bi[kk / 2][0]);
        f[2 * j + 1] = dequant_pair<BITS>(w_hi[wi] >> sh, sc[kk / 2][1], bi[kk / 2][1]);
      }
      wgmma_fence();
      Wgmma<N>::mma(acc, f, desc_sw128(x_addr + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the last step's product is done: its A may be rewritten
      // (ptxas serializes the products here all the same; see the header)
      // and every product of the previous stage is done: its slot may be refilled
      if (kk == 0 && it > 0 && lane == 0) mbar_arrive(bars + 8 * (L::STAGES + (it - 1) % L::STAGES));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sc[h][r] = sc_next[h][r];
        bi[h][r] = bi_next[h][r];
      }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // epilogue: out^T's fragments transposed through shared memory (over the
  // ring, free once every warpgroup's products are done), then written in
  // 16-byte runs of a token row: rounded once to bf16, or as the split's
  // fp32 partial sums
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG_CONSUMERS) : "memory");
  float* epi = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    // fragment j: rows r_lo / r_hi, tokens 8j + 2t and 8j + 2t + 1
    const int m = 8 * j + 2 * t;
    epi[m * WG_EPI_LD + r_lo] = acc[4 * j];
    epi[(m + 1) * WG_EPI_LD + r_lo] = acc[4 * j + 1];
    epi[m * WG_EPI_LD + r_hi] = acc[4 * j + 2];
    epi[(m + 1) * WG_EPI_LD + r_hi] = acc[4 * j + 3];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG_CONSUMERS) : "memory");
  const int rows = min(N, p.M - m0), cols = min(WG_ROWS, p.OUT - n0);
  const bool vec = p.OUT % 4 == 0;  // every run of 4 lies inside its row, 8- or 16-byte aligned
  const bool whole = gridDim.z == 1;
  for (int i = threadIdx.x; i < rows * (WG_ROWS / 4); i += 128 * WG_CONSUMERS) {
    const int m = i / (WG_ROWS / 4), c = i % (WG_ROWS / 4) * 4;
    if (c >= cols) continue;
    const float4 v = *reinterpret_cast<const float4*>(epi + m * WG_EPI_LD + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
    const long long o = (long long)(m0 + m) * p.OUT + n0 + c;
    if (whole) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + o;
      if (vec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                    *reinterpret_cast<const uint32_t*>(&hi));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) dst[q] = __float2bfloat16_rn(e[q]);
      }
    } else {
      float* dst = p.part + (long long)blockIdx.z * p.M * p.OUT + o;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) dst[q] = e[q];
      }
    }
  }
}

// F(std::integral_constant<int, N>) for a token tile the kernel is built
// for, or cudaErrorInvalidValue
template <typename F>
cudaError_t for_tile(int n, const F& f) {
  switch (n) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 224: return f(std::integral_constant<int, 224>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

// F(std::integral_constant<int, BITS>)
template <typename F>
cudaError_t for_bits(int bits, const F& f) {
  if (bits == 2) return f(std::integral_constant<int, 2>{});
  if (bits == 4) return f(std::integral_constant<int, 4>{});
  if (bits == 8) return f(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

template <int BITS, int N>
cudaError_t launch_matmul_wgmma(const Params& p, int split, float* part, cudaStream_t stream) {
  using L = WgLayout<BITS, N>;
  static const cudaError_t attr = allow_shared_once(quant_matmul_wgmma_kernel<BITS, N>, L::BYTES);
  if (attr != cudaSuccess) return attr;
  const int len = split > 0 ? split : p.IN;
  const int splits = (p.IN + len - 1) / len;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  cudaError_t err = tensor_map_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.M, p.IN,
                                  (long long)p.IN * 2, WG_BK, N, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const long long pitch = (long long)p.IN * BITS / 8;
  const bool words_tma = pitch % 16 == 0 && (long long)len * BITS / 8 % 16 == 0;
  wm = xm;  // unused when the words are copied
  if (words_tma)
    err = tensor_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT32, p.q, p.OUT, p.IN * BITS / 32, pitch,
                        L::ROW_BYTES / 4, WG_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  WgArgs a;
  a.q = p.q;
  a.scales = p.scales;
  a.biases = p.biases;
  a.out = p.out;
  a.part = part;
  a.M = p.M;
  a.IN = p.IN;
  a.OUT = p.OUT;
  a.gshift = p.group_size == 32 ? 5 : p.group_size == 64 ? 6 : 7;
  a.param_code = p.param_code;
  a.split = len;
  a.words_tma = words_tma ? 1 : 0;
  const dim3 grid((p.OUT + WG_ROWS - 1) / WG_ROWS, (p.M + N - 1) / N, splits);
  quant_matmul_wgmma_kernel<BITS, N><<<grid, WG_THREADS, L::BYTES, stream>>>(xm, wm, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = p.M * p.OUT;
  quant_gemv_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, splits, n, static_cast<__nv_bfloat16*>(p.out));
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
// 2 = float16; bits 2, 4 or 8. The caller has checked shapes, alignment (16
// bytes for x and q, 4 for scales and biases, IN a multiple of group_size in
// {32, 64, 128}) and M <= 8. split: IN elements per block of the bf16
// kernel's walk, a multiple of group_size, or 0 for the whole of IN; with
// more than one split, part holds ceil(IN / split) * M * OUT floats. fp32 x
// walks whole. Returns the cudaError_t of the launches (0 on success).
int mst_quant_gemv(const void* x, const void* q, const void* scales, const void* biases, void* out,
                   int x_code, int param_code, int bits, int M, int IN, int OUT, int group_size,
                   int split, void* part, void* stream) {
  const Params p = make_params(x, q, scales, biases, out, param_code, M, IN, OUT, group_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 8 || (bits != 2 && bits != 4 && bits != 8) || split < 0 ||
      (split > 0 && split % group_size))
    return (int)cudaErrorInvalidValue;
  if (x_code == 0)
    return (int)for_bits_m(bits, M, [&](auto b, auto m) {
      return launch_gemv_fma<decltype(b)::value, decltype(m)::value>(p, s);
    });
  if (x_code == 1)
    return (int)for_bits_m(bits, M, [&](auto b, auto m) {
      return for_group(group_size, [&](auto g) {
        return launch_gemv_tc<decltype(b)::value, decltype(m)::value, decltype(g)::value>(
            p, split, static_cast<float*>(part), s);
      });
    });
  return (int)cudaErrorInvalidValue;
}

// The same contract for any M >= 1. bf16 x runs the wgmma kernel with a
// token tile of `tile` rows (32, 64, ..., 256) and `split` IN elements per
// block of the walk (a multiple of group_size, or 0 for all of IN); with
// more than one split, part holds ceil(IN / split) * M * OUT floats. fp32 x
// takes the FMA kernel, whole, and ignores both.
int mst_quant_matmul(const void* x, const void* q, const void* scales, const void* biases,
                     void* out, int x_code, int param_code, int bits, int M, int IN, int OUT,
                     int group_size, int tile, int split, void* part, void* stream) {
  const Params p = make_params(x, q, scales, biases, out, param_code, M, IN, OUT, group_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || split < 0 || (split > 0 && split % group_size)) return (int)cudaErrorInvalidValue;
  if (x_code == 0)
    return (int)for_bits(bits, [&](auto b) { return launch_matmul_fma<decltype(b)::value>(p, s); });
  if (x_code == 1)
    return (int)for_bits(bits, [&](auto b) {
      return for_tile(tile, [&](auto n) {
        return launch_matmul_wgmma<decltype(b)::value, decltype(n)::value>(
            p, split, static_cast<float*>(part), s);
      });
    });
  return (int)cudaErrorInvalidValue;
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The bf16 matmul's instantiation for (bits, tile): out = {shared bytes
// per block, registers per thread, resident blocks per SM, local (spill)
// bytes per thread}, as the runtime reports them on the current card.
int mst_quant_matmul_info(int bits, int tile, long long* out) {
  return (int)for_bits(bits, [&](auto b) {
    return for_tile(tile, [&](auto n) {
      constexpr int B = decltype(b)::value, N = decltype(n)::value;
      const auto kernel = quant_matmul_wgmma_kernel<B, N>;
      const int smem = WgLayout<B, N>::BYTES;
      cudaError_t err = allow_shared_once(kernel, smem);
      if (err != cudaSuccess) return err;
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WG_THREADS, smem);
      out[0] = smem;
      out[1] = attr.numRegs;
      out[2] = blocks;
      out[3] = (long long)attr.localSizeBytes;
      return err;
    });
  });
}

// The bf16 GEMV instantiation that serves (bits, M) with these group size
// and scale type: out = {shared bytes per block, registers per thread,
// resident blocks per SM, local (spill) bytes per thread}, as the runtime
// reports them on the current card.
int mst_quant_gemv_info(int bits, int M, int group_size, int param_code, long long* out) {
  return (int)for_bits_m(bits, M, [&](auto b, auto m) {
    return for_group(group_size, [&](auto g) {
    constexpr int B = decltype(b)::value, MT = decltype(m)::value, GS = decltype(g)::value;
    const size_t smem = tc_shared_bytes<B, MT>(GS, param_code == 0 ? 4 : 2);
    cudaError_t err = allow_shared_once(quant_gemv_tc_kernel<B, MT, GS>, tc_shared_bytes<B, MT>(GS, 4));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, quant_gemv_tc_kernel<B, MT, GS>);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, quant_gemv_tc_kernel<B, MT, GS>,
                                                        TC_THREADS, smem);
    out[0] = (long long)smem;
    out[1] = attr.numRegs;
    out[2] = blocks;
    out[3] = (long long)attr.localSizeBytes;
    return err;
    });
  });
}

}  // extern "C"
