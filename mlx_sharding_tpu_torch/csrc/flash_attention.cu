// Causal GQA flash attention for prefill chunks, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlx_sharding_tpu/ops/flash_attention.py
// (flash_attention -> _kernel). It computes the same function: query row i
// of the chunk sits at absolute position offset + i and attends to every key
// at a position <= its own, over the full-capacity dense KV cache
// (B, S, Hkv, D). Query head h reads KV head h / (Hq / Hkv). The softmax is
// the online (running max, normaliser, accumulator) recurrence in fp32, so
// no (T, S) score matrix ever reaches device memory. Masked scores are
// -1e30, as in the TPU kernel.
//
// What bounds it on an H100: at the main path's shapes (T = 256, Hq = 32,
// Hkv = 8, D = 128, bf16) a launch reads a few MB and does 0.5 to 17 GFLOP,
// so a chunk near the start of the cache is bound by bytes and a chunk deep
// in it by tensor-core operations. What the design does about it:
//   - bytes: each K/V row of the causal prefix is read once per query tile
//     and never past the tile's last position (the loop bound below is the
//     counterpart of the TPU kernel's lax.cond skip); q/k/v are read in
//     place through strides, with no transpose copy; tiles are copied with
//     cp.async, the next tile's copy in flight during this tile's compute
//     wherever two stages fit in shared memory;
//   - operations: both products (Q K^T and P V) run on the tensor cores
//     through WMMA (mma.sync, bf16 in, fp32 accumulate); the fp32 variant,
//     which only tests use, runs on plain FMA;
//   - latency: each warp keeps its 16 rows' running max and normaliser in
//     registers and reduces all 16 rows at once, so the shuffle chains
//     overlap; every shared tile row is padded by 16 bytes, so the 8 rows a
//     WMMA fragment load touches fall in different banks.
// Not done yet, the next steps for speed: TMA and wgmma, more than one
// block per SM, and the accumulator in registers instead of shared memory
// (WMMA fragments hide which row an element belongs to, so the per-row
// rescale runs on a shared fp32 copy).
//
// One thread block of 4 warps owns one (batch, query head, 64-row query
// tile). Each warp owns 16 query rows, so the softmax and the accumulator
// update need only warp-level synchronisation; the block synchronises only
// around the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BLOCK_Q / WARPS;  // 16 rows per warp: one WMMA row tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// every shared tile row is padded by 16 bytes: 4 fp32 or 8 bf16 elements
constexpr int PAD_F32 = 4;
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / sizeof(T); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, S, Hq, Hkv, Dk, Dv;
  // element strides of the batch, sequence and head dims (last dim is dense)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int offset;
  float scale;
};

template <typename T>
struct Tile;
// fp32 tiles are twice the bytes; a 32-key tile keeps D = 256 inside the
// 227 KB a block may use
template <>
struct Tile<float> {
  static constexpr int BLOCK_K = 32;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BLOCK_K = 64;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Start copying `rows` rows of `cols` elements from device memory (row
// stride `stride` elements) into a shared tile with row stride `ld`, 16
// bytes per cp.async. Rows at or past `valid` are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int ld, const T* src, long long stride,
                                                int rows, int valid, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs_per_row = cols / VEC;
  for (int i = threadIdx.x; i < rows * vecs_per_row; i += THREADS) {
    const int r = i / vecs_per_row;
    const int c = (i % vecs_per_row) * VEC;
    const bool ok = r < valid;
    const T* s = src + (ok ? r : 0) * stride + c;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(s),
                 "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// S[this warp's rows, 0:BK] = Q K^T on the tensor cores.
template <int BK>
__device__ void scores(const __nv_bfloat16* sQ, const __nv_bfloat16* sK, float* sS, int Dk,
                       int ld, int lds, int warp, int lane) {
  using namespace nvcuda;
  for (int j = 0; j < BK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      // K is stored [key][d], which is K^T in column-major order
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + warp * ROWS * ld + kk, ld);
      wmma::load_matrix_sync(b, sK + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + warp * ROWS * lds + j * 16, acc, lds, wmma::mem_row_major);
  }
}

// fp32 variant on plain FMA: lane j owns key column j.
template <int BK>
__device__ void scores(const float* sQ, const float* sK, float* sS, int Dk, int ld, int lds,
                       int warp, int lane) {
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    for (int j = lane; j < BK; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < Dk; ++d) s = fmaf(sQ[row * ld + d], sK[j * ld + d], s);
      sS[row * lds + j] = s;
    }
  }
}

// O[this warp's rows, :] += P V on the tensor cores; O lives in shared
// memory as fp32 and is loaded as the accumulator.
template <int BK>
__device__ void accumulate(const __nv_bfloat16* sP, int ldp, const __nv_bfloat16* sV, int ldv,
                           float* sO, int ldo, int Dv, int warp, int lane) {
  using namespace nvcuda;
  for (int n = 0; n < Dv; n += 16) {
    float* o_tile = sO + warp * ROWS * ldo + n;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o_tile, ldo, wmma::mem_row_major);
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + warp * ROWS * ldp + kk, ldp);
      wmma::load_matrix_sync(b, sV + kk * ldv + n, ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_tile, acc, ldo, wmma::mem_row_major);
  }
}

template <int BK>
__device__ void accumulate(const float* sP, int ldp, const float* sV, int ldv, float* sO,
                           int ldo, int Dv, int warp, int lane) {
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    for (int n = lane; n < Dv; n += 32) {
      float acc = sO[row * ldo + n];
      for (int j = 0; j < BK; ++j) acc = fmaf(sP[row * ldp + j], sV[j * ldv + n], acc);
      sO[row * ldo + n] = acc;
    }
  }
}

// Shared memory of one block: Q, STAGES K/V tile pairs, P (in T), S and O
// (fp32), all with padded rows.
template <typename T, int STAGES>
size_t shared_bytes(int Dk, int Dv) {
  constexpr int BK = Tile<T>::BLOCK_K;
  constexpr int P = pad<T>();
  return (size_t)(BLOCK_Q * (Dk + P) + STAGES * BK * (Dk + P + Dv + P) + BLOCK_Q * (BK + P)) *
             sizeof(T) +
         (size_t)(BLOCK_Q * (BK + PAD_F32) + BLOCK_Q * (Dv + PAD_F32)) * sizeof(float);
}

template <typename T, int STAGES>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int BK = Tile<T>::BLOCK_K;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dk = p.Dk, Dv = p.Dv;
  // padded row strides; every region starts on a 128-byte boundary and
  // every WMMA tile on a 32-byte one, since Dk and Dv are multiples of 64
  const int ldk = Dk + pad<T>(), ldv = Dv + pad<T>();
  constexpr int ldp = BK + pad<T>(), lds = BK + PAD_F32;
  const int ldo = Dv + PAD_F32;
  const int stage_elems = BK * (ldk + ldv);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + BLOCK_Q * ldk;  // stage s: K at s * stage_elems, V after it
  T* sP = sKV + STAGES * stage_elems;
  float* sS = reinterpret_cast<float*>(sP + BLOCK_Q * ldp);
  float* sO = sS + BLOCK_Q * lds;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_valid = min(BLOCK_Q, p.T - q0);
  // The causal bound: no key past the tile's last query position is read.
  const int kv_end = min(p.S, p.offset + q0 + q_valid);
  const int n_tiles = (kv_end + BK - 1) / BK;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + q0 * p.q_st + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto copy_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    const int k_valid = min(BK, kv_end - k0);
    T* sK = sKV + stage * stage_elems;
    copy_tile_async(sK, ldk, k + k0 * p.k_ss, p.k_ss, BK, k_valid, Dk);
    copy_tile_async(sK + BK * ldk, ldv, v + k0 * p.v_ss, p.v_ss, BK, k_valid, Dv);
  };

  copy_tile_async(sQ, ldk, q, p.q_st, BLOCK_Q, q_valid, Dk);
  copy_kv(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < BLOCK_Q * ldo; i += THREADS) sO[i] = 0.0f;

  // this warp's rows; every lane holds every row's running max and
  // normaliser (the butterfly reductions leave the same value in all lanes)
  float* sSw = sS + warp * ROWS * lds;
  T* sPw = sP + warp * ROWS * ldp;
  float* sOw = sO + warp * ROWS * ldo;
  const int q_pos0 = p.offset + q0 + warp * ROWS;  // position of the warp's row 0
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = STAGES == 2 ? (it & 1) : 0;
    if (STAGES == 2 && it + 1 < n_tiles) {
      copy_kv(it + 1, stage ^ 1);  // in flight during this tile's compute
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, first time, Q and the zeroed O) visible
    const T* sK = sKV + stage * stage_elems;
    const T* sV = sK + BK * ldk;
    const int k0 = it * BK;
    const int k_valid = min(BK, kv_end - k0);

    scores<BK>(sQ, sK, sS, Dk, ldk, lds, warp, lane);
    __syncwarp();

    // online softmax over the warp's 16 rows at once; lane owns columns
    // lane + 32 i
    float x[ROWS][BK / 32], mx[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mx[r] = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const int c = lane + 32 * i;
        const float s = sSw[r * lds + c] * p.scale;
        x[r][i] = (c < k_valid && k0 + c <= q_pos0 + r) ? s : NEG_INF;
        mx[r] = fmaxf(mx[r], x[r][i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], o));
    }
    float corr[ROWS], sum[ROWS];
    bool rescale = false;  // the same in every lane
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      rescale |= m_new != m[r];
      m[r] = m_new;
      sum[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float pr = expf(x[r][i] - m_new);
        sPw[r * ldp + lane + 32 * i] = from_float<T>(pr);
        sum[r] += pr;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], o);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) l[r] = l[r] * corr[r] + sum[r];
    if (rescale) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        for (int c = lane; c < Dv; c += 32) sOw[r * ldo + c] *= corr[r];
      }
    }
    __syncwarp();
    accumulate<BK>(sP, ldp, sV, ldv, sO, ldo, Dv, warp, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (STAGES == 1 && it + 1 < n_tiles) {
      copy_kv(it + 1, 0);
      cp_async_commit();
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.o_sb + q0 * p.o_st + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    if (row < q_valid) {
      for (int c = lane; c < Dv; c += 32) {
        o[row * p.o_st + c] = from_float<T>(sOw[r * ldo + c] / fmaxf(l[r], 1e-30f));
      }
    }
  }
}

int max_shared_per_block() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// Two K/V stages where they fit (D <= 128 in bf16), else one.
template <typename T>
int stages_for(int Dk, int Dv) {
  return shared_bytes<T, 2>(Dk, Dv) <= (size_t)max_shared_per_block() ? 2 : 1;
}

template <typename T, int STAGES>
cudaError_t launch_stages(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = shared_bytes<T, STAGES>(p.Dk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BLOCK_Q - 1) / BLOCK_Q, p.Hq, B);
  flash_fwd_kernel<T, STAGES><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  return stages_for<T>(p.Dk, p.Dv) == 2 ? launch_stages<T, 2>(p, B, stream)
                                        : launch_stages<T, 1>(p, B, stream);
}

template <typename T>
long long launch_shared_bytes(int Dk, int Dv) {
  return (long long)(stages_for<T>(Dk, Dv) == 2 ? shared_bytes<T, 2>(Dk, Dv)
                                                 : shared_bytes<T, 1>(Dk, Dv));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in the
// order q (b, t, h), k (b, s, h), v (b, s, h), o (b, t, h). Returns the
// cudaError_t of the launch (0 on success); the caller checks it.
int mst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                            int B, int T, int S, int Hq, int Hkv, int Dk, int Dv,
                            const long long* strides, int offset, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Dk = Dk;
  p.Dv = Dv;
  p.q_sb = strides[0];
  p.q_st = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_st = strides[10];
  p.o_sh = strides[11];
  p.offset = offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory one launch asks for, so the caller can report it.
long long mst_flash_attention_shared_bytes(int dtype, int Dk, int Dv) {
  return dtype == 0 ? launch_shared_bytes<float>(Dk, Dv)
                    : launch_shared_bytes<__nv_bfloat16>(Dk, Dv);
}

}  // extern "C"
