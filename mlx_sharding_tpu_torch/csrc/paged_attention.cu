// Ragged paged decode attention, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlx_sharding_tpu/ops/paged_attention.py
// (_paged_attention_kernel -> _kernel_body, _kernel, _kernel_int8). It
// computes the same function: slot m's one query token, in the G = Hq / Hkv
// query heads of KV head h, attends to positions 0 .. lengths[m]-1 of its
// own page-table row. Position p lives at pool page tables[m][p / page],
// row p % page. Scores are taken in fp32 and scaled; the softmax is the
// online (running max, normaliser, fp32 accumulator) recurrence; length 0
// writes zeros; the output is in q's dtype. An int8 pool multiplies each
// K/V row by its fp32 per-row-per-head scale as the row is read.
//
// What bounds it on an H100: bytes. A decode step reads every live K/V row
// of the layer once and does 4·G·D operations per row and head: at the main
// path's shapes (G = 4, D = 128, bf16) that is 4 operations per byte read,
// far below the ~20 of fp32 FMA, so the tensor cores are not needed. Eight
// slots at ~500 positions read ~17 MB a launch, ~5 us at 3.35 TB/s. What
// the design does about it:
//   - the block reads the page table and the length itself (the counterpart
//     of scalar prefetch) and never touches a page past ceil(length / page):
//     the scratch tail of a table row costs nothing. The table is read once
//     per key: a tile's pool rows are staged in shared memory before its
//     copies are issued;
//   - K/V tiles are copied with 16-byte cp.async, coalesced along each row,
//     the next tile's copy in flight during this tile's compute;
//   - an int8 pool moves D + 4 bytes per row and head instead of 2D;
//   - every shared tile row is padded by 16 bytes per thread that shares a
//     row, so a phase of 8 lanes reading 16 bytes each hits distinct banks;
//   - the page walk is split across blocks (flash-decoding): a block takes
//     at most `split` positions of one (slot, KV head), so a long slot does
//     not leave the launch waiting on one block while most SMs idle (8
//     slots x 8 KV heads are only 64 blocks for 132 SMs). Each block writes
//     its unnormalised fp32 accumulator with its running max and
//     normaliser; a second kernel merges a row's splits. Splits past a
//     slot's length return at once and are not read. With one split the
//     walk writes the output itself.
//
// Any GQA group G >= 1: G of 1, 2, 4, 8 or 16 runs on a build that knows it
// at compile time; any other G runs on a padded build of the next size up
// (4, 8 or 16), its padded heads zero on read and never written, and G > 16
// in chunks of 16 heads, one block each, every chunk re-reading its KV
// head's pages.
//
// One block of 4 warps owns one (KV head, head chunk, slot, split). Scores: TPK threads
// share a key row, each taking every TPK-th 16-byte chunk of it against the
// G query rows held in shared memory as fp32, then summing over the TPK
// lanes with shuffles. P.V: thread t owns the column pair 2(t % (Dv/2)) for
// all G heads and every (THREADS / (Dv/2))-th key of the tile; the key
// subsets are summed once at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Params {
  const void* q;       // (M, Hq, Dk)
  const void* k;       // (P+1, page, Hkv, Dk)
  const void* v;       // (P+1, page, Hkv, Dv)
  const float* k_scale;  // (P+1, page, Hkv, 1), int8 pools only
  const float* v_scale;
  const int* tables;   // (M, SPG)
  const int* lengths;  // (M,)
  void* o;             // (M, Hq, Dv)
  float* part_acc;     // (M, Hq, splits, Dv) fp32, when the walk is split
  float* part_ml;      // (M, Hq, splits, 2): running max and normaliser
  int Hq, Hkv, Dk, Dv, page, spg;
  int G;               // query heads per KV head (Hq / Hkv), any G >= 1
  int split;           // positions per block of the walk
  float scale;
};

// keys per tile: fp32 rows are twice the bytes, so half the keys keep two
// stages of D = 256 inside the 227 KB a block may use
template <typename T>
struct Tile {
  static constexpr int KEYS = 64;
};
template <>
struct Tile<float> {
  static constexpr int KEYS = 32;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes of a chunk as VEC floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of an fp32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& raw, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
  }
}

// two consecutive elements of a shared row as floats
__device__ __forceinline__ float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared-memory layout of one block, in bytes
template <typename TKV>
struct Layout {
  static constexpr int KEYS = Tile<TKV>::KEYS;
  static constexpr int TPK = THREADS / KEYS;  // threads sharing a key row
  int ldk, ldv, stage, scales, q, p, red, rows;

  __host__ __device__ Layout(int G, int Dk, int Dv) {
    ldk = Dk * (int)sizeof(TKV) + 16 * TPK;
    ldv = Dv * (int)sizeof(TKV) + 16 * TPK;
    stage = KEYS * (ldk + ldv);
    scales = 2 * stage;                    // [stage][k|v][KEYS] floats
    q = scales + 2 * 2 * KEYS * 4;         // [G][Dk] floats
    p = q + G * Dk * 4;                    // [G][KEYS] floats
    red = p + G * KEYS * 4;                // [2][WARPS][G] floats
    rows = red + 2 * WARPS * G * 4;        // [stage][KEYS] ints: pool rows
  }
  __host__ __device__ int bytes() const { return rows + 2 * KEYS * 4; }
};

// G is the group the kernel is built for (1, 2, 4, 8 or 16): a block owns
// G query heads of one KV head. PAD builds serve a group p.G off those
// sizes: the heads past p.G are zeros on read and are never written. The
// exact builds (PAD false) know the group at compile time.
template <typename TQ, typename TKV, int G, bool PAD>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Params p) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int KEYS = Tile<TKV>::KEYS;
  constexpr int TPK = THREADS / KEYS;
  constexpr int VEC = 16 / sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  // a group wider than 16 runs on the 16-head instantiation in chunks of
  // 16 heads along blockIdx.x; the narrower ones have one chunk
  constexpr bool CHUNKED = PAD && G == 16;
  const int group = PAD ? p.G : G;  // query heads per KV head
  const int chunks = CHUNKED ? (group + G - 1) / G : 1;
  const int h = CHUNKED ? blockIdx.x / chunks : blockIdx.x;  // KV head
  const int g0 = CHUNKED ? blockIdx.x % chunks * G : 0;      // the chunk's first head
  const int m = blockIdx.y;
  const bool partial = gridDim.z > 1;
  // the table's reach bounds the walk: a longer length (a finished slot
  // still decoding to the end of its block) reads no further
  const int len = min(max(p.lengths[m], 0), p.spg * p.page);
  const int begin = blockIdx.z * p.split;
  // a split past the slot's length adds nothing; the merge reads only the
  // splits below the length
  if (partial && begin >= len) return;
  const int end = min(len, begin + p.split);
  const int n_tiles = (max(end - begin, 0) + KEYS - 1) / KEYS;

  const Layout<TKV> L(G, p.Dk, p.Dv);
  float* sScale = reinterpret_cast<float*>(smem + L.scales);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sP = reinterpret_cast<float*>(smem + L.p);
  float* sMax = reinterpret_cast<float*>(smem + L.red);
  float* sSum = sMax + WARPS * G;
  int* sRow = reinterpret_cast<int*>(smem + L.rows);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Dk = p.Dk, Dv = p.Dv;
  const int* table = p.tables + (size_t)m * p.spg;
  const TKV* kpool = static_cast<const TKV*>(p.k);
  const TKV* vpool = static_cast<const TKV*>(p.v);

  // the chunk's query heads; heads past the group are zeros
  const TQ* q = static_cast<const TQ*>(p.q) + ((size_t)m * p.Hq + (size_t)h * group + g0) * Dk;
  const int real = min(G, group - g0) * Dk;
  for (int i = tid; i < G * Dk; i += THREADS)
    sQ[i] = !PAD || i < real ? to_float(q[i]) : 0.0f;

  // the pool row (page id * page + row in page) * Hkv + h of each key of a
  // tile, -1 past the walk: one table read per key
  auto stage_rows = [&](int tile, int stage) {
    for (int r = tid; r < KEYS; r += THREADS) {
      const int pos = begin + tile * KEYS + r;
      sRow[stage * KEYS + r] =
          pos < end ? (table[pos / p.page] * p.page + pos % p.page) * p.Hkv + h : -1;
    }
  };
  // thread t copies 16-byte chunk t % chunks of rows t / chunks, then every
  // THREADS / chunks rows further (threads past a whole number of rows idle)
  const int kvec = Dk / VEC, vvec = Dv / VEC;
  const int kc = tid % kvec, kr = tid / kvec, kstep = THREADS / kvec;
  const int vc = tid % vvec, vr = tid / vvec, vstep = THREADS / vvec;
  auto copy_tile = [&](int stage) {
    unsigned char* dK = smem + stage * L.stage;
    unsigned char* dV = dK + KEYS * L.ldk;
    const int* rows = sRow + stage * KEYS;
    for (int r = kr; kr < kstep && r < KEYS; r += kstep) {
      const int row = rows[r];
      cp_async16(dK + r * L.ldk + kc * 16, kpool + (size_t)max(row, 0) * Dk + kc * VEC, row >= 0);
    }
    for (int r = vr; vr < vstep && r < KEYS; r += vstep) {
      const int row = rows[r];
      cp_async16(dV + r * L.ldv + vc * 16, vpool + (size_t)max(row, 0) * Dv + vc * VEC, row >= 0);
    }
    if (QUANT) {
      for (int i = tid; i < 2 * KEYS; i += THREADS) {
        const int row = rows[i % KEYS];
        cp_async4(sScale + stage * 2 * KEYS + i, (i < KEYS ? p.k_scale : p.v_scale) + max(row, 0),
                  row >= 0);
      }
    }
  };

  // running max and normaliser of each head, the same in every thread
  float m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.0f;
  }
  // P.V ownership: a column pair for all heads, every KS-th key
  const int NP = Dv / 2;
  const int KS = THREADS / NP;
  const int dp = tid % NP, ks = tid / NP;
  const bool pv_thread = tid < NP * KS;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.0f;

  if (n_tiles > 0) {
    stage_rows(0, 0);
    __syncthreads();
    copy_tile(0);
    cp_async_commit();
  }
  const int key = tid / TPK, part = tid % TPK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows(it + 1, stage ^ 1);
      __syncthreads();  // the rows visible to every copying thread
      copy_tile(stage ^ 1);  // in flight during this tile's compute
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, the first time, sQ) visible
    const unsigned char* sK = smem + stage * L.stage;
    const unsigned char* sV = sK + KEYS * L.ldk;
    const float* scl = sScale + stage * 2 * KEYS;
    const int k_valid = min(KEYS, end - (begin + it * KEYS));
    const bool valid = key < k_valid;

    // scores of this thread's key row for the G heads
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.0f;
    for (int c = part; c < Dk / VEC; c += TPK) {
      const uint4 raw = *reinterpret_cast<const uint4*>(sK + key * L.ldk + c * 16);
      float kf[VEC];
      unpack<TKV>(raw, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = sQ + g * Dk + c * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[g] = fmaf(qg[e], kf[e], s[g]);
      }
    }
#pragma unroll
    for (int o = 1; o < TPK; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(FULL_MASK, s[g], o);
    }
    const float kscale = QUANT ? scl[key] * p.scale : p.scale;
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = valid ? s[g] * kscale : NEG_INF;
      mx[g] = s[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL_MASK, mx[g], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) sMax[warp * G + g] = mx[g];
    }
    __syncthreads();
    float corr[G], sum[G];
    const float vscale = QUANT ? scl[KEYS + key] : 1.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m_run[g];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m_new = fmaxf(m_new, sMax[w * G + g]);
      corr[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      const float pr = valid ? expf(s[g] - m_new) : 0.0f;
      if (part == 0) sP[g * KEYS + key] = pr * vscale;  // V's scale rides on p
      sum[g] = part == 0 ? pr : 0.0f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) sum[g] += __shfl_xor_sync(FULL_MASK, sum[g], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) sSum[warp * G + g] = sum[g];
    }
    __syncthreads();  // p and the sums visible
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += sSum[w * G + g];
      l_run[g] = l_run[g] * corr[g] + t;
      acc[g][0] *= corr[g];
      acc[g][1] *= corr[g];
    }
    if (pv_thread) {
      const TKV* vcol = reinterpret_cast<const TKV*>(sV) + 2 * dp;
      const int ldv = L.ldv / (int)sizeof(TKV);
      for (int j = ks; j < k_valid; j += KS) {
        const float2 vv = pair(vcol + j * ldv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = sP[g * KEYS + j];
          acc[g][0] = fmaf(pr, vv.x, acc[g][0]);
          acc[g][1] = fmaf(pr, vv.y, acc[g][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // sum the key subsets (the tile buffers are free now) and write out
  float* sAcc = reinterpret_cast<float*>(smem);
  if (KS > 1) {
    if (pv_thread && ks > 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sAcc[((ks - 1) * G + g) * Dv + 2 * dp] = acc[g][0];
        sAcc[((ks - 1) * G + g) * Dv + 2 * dp + 1] = acc[g][1];
      }
    }
    __syncthreads();
  }
  if (pv_thread && ks == 0) {
    const size_t head0 = (size_t)m * p.Hq + (size_t)h * group + g0;
    TQ* o = static_cast<TQ*>(p.o) + head0 * Dv;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (PAD && g0 + g >= group) break;  // a padded head: nothing to write
      float a0 = acc[g][0], a1 = acc[g][1];
      for (int s2 = 1; s2 < KS; ++s2) {
        a0 += sAcc[((s2 - 1) * G + g) * Dv + 2 * dp];
        a1 += sAcc[((s2 - 1) * G + g) * Dv + 2 * dp + 1];
      }
      if (partial) {
        const size_t row = (head0 + g) * gridDim.z + blockIdx.z;
        p.part_acc[row * Dv + 2 * dp] = a0;
        p.part_acc[row * Dv + 2 * dp + 1] = a1;
        if (dp == 0) {
          p.part_ml[2 * row] = m_run[g];
          p.part_ml[2 * row + 1] = l_run[g];
        }
      } else {
        // length 0: l stays 0 and the accumulator 0, so the row is zeros
        const float inv = 1.0f / fmaxf(l_run[g], 1e-30f);
        o[g * Dv + 2 * dp] = from_float<TQ>(a0 * inv);
        o[g * Dv + 2 * dp + 1] = from_float<TQ>(a1 * inv);
      }
    }
  }
}

// Merge the splits of one (slot, query head): rescale each split's
// accumulator and normaliser to the common max, add, divide. Only the
// splits below the slot's length were written; length 0 gives zeros.
template <typename TQ>
__global__ void __launch_bounds__(THREADS) paged_merge_kernel(Params p, int splits) {
  const int head = blockIdx.x;  // m * Hq + query head
  const int m = head / p.Hq;
  const int len = min(max(p.lengths[m], 0), p.spg * p.page);
  const int n = (len + p.split - 1) / p.split;
  const float* ml = p.part_ml + (size_t)head * splits * 2;
  const float* acc = p.part_acc + (size_t)head * splits * p.Dv;
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.0f;
  for (int s = 0; s < n; ++s) l += expf(ml[2 * s] - mx) * ml[2 * s + 1];
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  TQ* o = static_cast<TQ*>(p.o) + (size_t)head * p.Dv;
  for (int c = threadIdx.x; c < p.Dv; c += THREADS) {
    float a = 0.0f;
    for (int s = 0; s < n; ++s) a += expf(ml[2 * s] - mx) * acc[(size_t)s * p.Dv + c];
    o[c] = from_float<TQ>(a * inv);
  }
}

// The instantiation's dynamic shared-memory limit, set to what the launch
// asks for only when that differs from the last launch's (a model's head
// dims do not change, so serving sets it once rather than per launch).
template <typename TQ, typename TKV, int G, bool PAD>
cudaError_t allow_shared(int smem) {
  static int set = -1;
  if (smem == set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, G, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

template <typename TQ, typename TKV, int G, bool PAD>
cudaError_t launch_group(const Params& p, int M, int splits, cudaStream_t stream) {
  const int smem = Layout<TKV>(G, p.Dk, p.Dv).bytes();
  cudaError_t err = allow_shared<TQ, TKV, G, PAD>(smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p.G + G - 1) / G;
  paged_decode_kernel<TQ, TKV, G, PAD><<<dim3(p.Hkv * chunks, M, splits), THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_merge_kernel<TQ><<<M * p.Hq, THREADS, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const Params& p, int M, int G, int splits, cudaStream_t stream) {
  switch (G) {  // the group sizes the kernel is built for
    case 1: return launch_group<TQ, TKV, 1, false>(p, M, splits, stream);
    case 2: return launch_group<TQ, TKV, 2, false>(p, M, splits, stream);
    case 4: return launch_group<TQ, TKV, 4, false>(p, M, splits, stream);
    case 8: return launch_group<TQ, TKV, 8, false>(p, M, splits, stream);
    case 16: return launch_group<TQ, TKV, 16, false>(p, M, splits, stream);
  }
  // any other group on the next size up, padded; wider than 16 in chunks of
  // 16 heads
  if (G < 4) return launch_group<TQ, TKV, 4, true>(p, M, splits, stream);
  if (G < 8) return launch_group<TQ, TKV, 8, true>(p, M, splits, stream);
  return launch_group<TQ, TKV, 16, true>(p, M, splits, stream);
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (then k_scale and v_scale are given). split: positions per block
// of the page walk, a multiple of 64, or 0 for one block per (slot, KV
// head); with more than one split, part_acc and part_ml hold
// M * Hq * mst_paged_attention_splits(...) * Dv and * 2 floats. Every tensor
// is contiguous. Returns the cudaError_t of the launches (0 on success);
// the caller checks it.
int mst_paged_attention_splits(int page, int spg, int split) {
  return split > 0 ? (page * spg + split - 1) / split : 1;
}

int mst_paged_attention(const void* q, const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* tables, const void* lengths, void* o,
                        void* part_acc, void* part_ml, int q_dtype, int kv_dtype, int M, int Hq,
                        int Hkv, int Dk, int Dv, int page, int spg, int split, float scale,
                        void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Dk % 64 || Dv % 64 || Dk > 256 || Dv > 256 || page <= 0 ||
      spg <= 0 || M <= 0 || split < 0 || split % 64)
    return (int)cudaErrorInvalidValue;
  const int splits = mst_paged_attention_splits(page, spg, split);
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Dk = Dk;
  p.Dv = Dv;
  p.page = page;
  p.spg = spg;
  p.split = splits > 1 ? split : page * spg;
  p.scale = scale;
  const int G = Hq / Hkv;
  p.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch<float, float>(p, M, G, splits, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, M, G, splits, s);
  if (q_dtype == 0 && kv_dtype == 2) return (int)launch<float, int8_t>(p, M, G, splits, s);
  if (q_dtype == 1 && kv_dtype == 2) return (int)launch<__nv_bfloat16, int8_t>(p, M, G, splits, s);
  return (int)cudaErrorInvalidValue;
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory one launch asks for, so the caller can report it.
long long mst_paged_attention_shared_bytes(int kv_dtype, int G, int Dk, int Dv) {
  G = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;  // the instantiation that serves G
  if (kv_dtype == 0) return Layout<float>(G, Dk, Dv).bytes();
  if (kv_dtype == 1) return Layout<__nv_bfloat16>(G, Dk, Dv).bytes();
  return Layout<int8_t>(G, Dk, Dv).bytes();
}

}  // extern "C"
