// Ragged paged decode attention, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlx_sharding_tpu/ops/paged_attention.py
// (_paged_attention_kernel -> _kernel_body, _kernel, _kernel_int8). It
// computes the same function: slot m's one query token, in the G = Hq / Hkv
// query heads of KV head h, attends to positions 0 .. lengths[m]-1 of its
// own page-table row. Position p lives at pool page tables[m][p / page],
// row p % page. Scores are taken in fp32 and scaled; the softmax is the
// online (running max, normaliser, fp32 accumulator) recurrence, in log2
// units with scale * log2(e) folded into the scores; length 0 writes zeros;
// the output is in q's dtype. An int8 pool multiplies each K/V row by its
// fp32 per-row-per-head scale. Lengths past the table's reach are clipped
// to it, and no page past ceil(length / page) is touched.
//
// What bounds it on an H100: bytes. A decode step reads every live K/V row
// of the layer once and does 4·G·D operations per row and head, ~4 per byte
// at G = 4. Eight slots at ~500 positions read ~17 MB, ~5 us at 3.35 TB/s.
// The first version (kept below as the FMA kernel, for f32 q and pages that
// are not a multiple of 8) ran at a sixth of that: each tile of its walk
// read the page table, then copied, then passed five block barriers, with
// one tile in flight and scalar FMA math on 4 warps per SM, and a second
// launch merged the split partials. What the bf16-q kernel (paged_tc_kernel)
// does about it:
//   - one launch: a (slot, KV head, head chunk) row whose walk is split
//     writes fp32 partials and takes a ticket (one acquire-release atomic on
//     an int32 counter of the row); the block with the last ticket merges
//     the partials in split order, so the result is the same bits from run
//     to run, and sets the counter back to 0. The counters are zero again
//     when the launch ends: no memset per call, and a CUDA graph can hold
//     the call. A row walked by one block writes its output directly;
//   - a persistent grid: as many blocks as the card holds at once, from the
//     shapes alone. Each block counts the work items in the lengths (one per
//     row and split that has positions, one per row of an empty slot) and
//     walks items blockIdx.x, + gridDim.x, ...: no block is launched only to
//     find its split empty, and the setup is paid once per block;
//   - the walk: the host plans positions per item from the shapes alone
//     (ops/paged_attention.py::plan_paged_split: up to 512, so that a
//     full-length walk gives every SM an item). A producer warp reads two
//     tiles' page-table entries in one round trip and copies every tile of
//     64 rows with TMA (the pools seen as ((P+1)·page, Hkv·D) tensors, boxes
//     of 64 columns × the rows of one page run, one mbarrier per stage)
//     into a ring of 64 KB (two stages of bf16 rows at D = 128, four of
//     int8); it runs ahead into the next item while the math merges this
//     one. The int8 scales ride 4-byte cp.async onto the same barrier;
//   - four consumer warps each walk their own 16 rows of every tile with
//     their own running max and normaliser, waiting on the tile's barrier
//     only (no block barrier per tile), and merge once per item in shared
//     memory;
//   - scores and P·V on mma.sync m16n8k16 with S, P and O in registers: the
//     G heads of the item are the 16 rows of the tile (padded past G; G >
//     16 runs in chunks of 16 heads). K comes from ldmatrix and V from
//     ldmatrix.trans on the TMA's 128-byte (bf16) or 64-byte (int8) swizzle,
//     so the rows a ldmatrix reads fall in distinct banks;
//   - an int8 pool runs the products in fp16: a code c becomes 1152 + c by
//     a byte permute into fp16 1024's mantissa, minus 1152, exactly. q is
//     scaled by a power of two into fp16's range; K's row scale multiplies
//     its score column after the mma, and V's rides on P, over a running
//     reference scale that keeps P in [0, 1].
// What still holds it back (PERF.md): per item, the wait for its first tile
// and the merge of the warps and of the splits; and per launch, the setup.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int THREADS = 128;  // the FMA kernel's block; the TC kernel's consumers
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;  // query heads per block: the mma's 16 rows
constexpr int MAX_HEAD_DIM = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Params {
  const void* q;         // (M, Hq, Dk)
  const void* k;         // (P+1, page, Hkv, Dk)
  const void* v;         // (P+1, page, Hkv, Dv)
  const float* k_scale;  // (P+1, page, Hkv, 1), int8 pools only
  const float* v_scale;
  const int* tables;     // (M, SPG)
  const int* lengths;    // (M,)
  void* o;               // (M, Hq, Dv)
  float* part_acc;       // (M, Hq, splits, Dv) fp32, when the walk is split
  float* part_ml;        // (M, Hq, splits, 2): running max (log2 units), normaliser
  int* counters;         // (M, Hkv * chunks) tickets, zero between launches
  int Hq, Hkv, Dk, Dv, page, spg;
  int G;       // query heads per KV head (Hq / Hkv)
  int chunks;  // blocks of GMAX heads per KV head
  int split;   // positions per block of the walk
  int splits;  // blocks along the walk (gridDim.z)
  int box_rows;  // TC kernel: rows of one TMA box (divides the page and 64)
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the named barrier of the block's 128 consumer threads (the whole FMA block)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------ the one-launch merge

// After a block has written its partials (heads head0 .. head0 + nh of slot
// m, split z; head g's partial of split s is row ((m Hq + head0) splits +
// g splits + s) of part_acc and part_ml): take a ticket on the row's counter
// (counters[row]) with one acquire-release atomic; the block with the last
// ticket merges the n partials in split order and sets the counter back to
// 0. The merge runs a warp per head, each lane holding 4 columns (8 when
// Dv > 128), and reads chunks of splits with every load of a chunk in
// flight at once, rescaling its running sums to each chunk's larger max.
// Run by the 128 consumer threads; MAXDV bounds Dv.
template <typename TQ, int MAXDV>
__device__ void merge_splits(const Params& p, int m, int row, int head0, int nh, int n,
                             int* sFlag) {
  const int tid = threadIdx.x;
  const int Dv = p.Dv;
  TQ* out = static_cast<TQ*>(p.o) + ((size_t)m * p.Hq + head0) * Dv;
  const size_t row0 = ((size_t)m * p.Hq + head0) * p.splits;
  consumer_sync();  // every partial written before the release below
  int* counter = p.counters + row;
  if (tid == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(ticket) : "l"(counter) : "memory");
    *sFlag = ticket == n - 1;
  }
  consumer_sync();
  if (!*sFlag) return;

  // the last block: the other blocks' partials are visible after the
  // acquire above; they are read from L2
  constexpr int PJ = (MAXDV / 4 + 31) / 32;  // 16-byte pieces of a head's row per lane
  constexpr int CH = 16 / PJ;                // splits per chunk
  const int warp = tid / 32, lane = tid % 32;
  const int pieces = Dv / 4;
  const float4* acc4 = reinterpret_cast<const float4*>(p.part_acc);
  const float2* ml2 = reinterpret_cast<const float2*>(p.part_ml);
  for (int g = warp; g < nh; g += WARPS) {
    const size_t hrow = row0 + (size_t)g * p.splits;  // split s is row hrow + s
    float4 a[PJ];
#pragma unroll
    for (int j = 0; j < PJ; ++j) a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float run = NEG_INF, norm = 0.0f;
    for (int s0 = 0; s0 < n; s0 += CH) {
      const int cnt = min(CH, n - s0);
      const float2 ml = lane < cnt ? __ldcg(ml2 + hrow + s0 + lane) : make_float2(NEG_INF, 0.0f);
      float4 x[CH][PJ];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int piece = lane + 32 * j;
          x[c][j] = c < cnt && piece < pieces
                        ? __ldcg(acc4 + (hrow + s0 + c) * pieces + piece)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
      float mx = fmaxf(run, ml.x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
      const float r = exp2f(run - mx);
      norm *= r;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        a[j].x *= r;
        a[j].y *= r;
        a[j].z *= r;
        a[j].w *= r;
      }
      run = mx;
      const float wl = lane < cnt ? exp2f(ml.x - mx) : 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {  // in split order
        const float w = __shfl_sync(FULL_MASK, wl, c);
        const float l = __shfl_sync(FULL_MASK, ml.y, c);
        if (c < cnt) {
          norm = fmaf(w, l, norm);
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            a[j].x = fmaf(w, x[c][j].x, a[j].x);
            a[j].y = fmaf(w, x[c][j].y, a[j].y);
            a[j].z = fmaf(w, x[c][j].z, a[j].z);
            a[j].w = fmaf(w, x[c][j].w, a[j].w);
          }
        }
      }
    }
    const float inv = 1.0f / fmaxf(norm, 1e-30f);
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int piece = lane + 32 * j;
      if (piece < pieces) {
        TQ* dst = out + g * Dv + 4 * piece;
        dst[0] = from_float<TQ>(a[j].x * inv);
        dst[1] = from_float<TQ>(a[j].y * inv);
        dst[2] = from_float<TQ>(a[j].z * inv);
        dst[3] = from_float<TQ>(a[j].w * inv);
      }
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// ------------------------------------------------ the FMA kernel (f32 q)

// The first version's design, for f32 q (over f32 or int8 pools) and for
// pages that are not a multiple of 8: one block of 4 warps per (KV head,
// head chunk, slot, split), GMAX heads padded past the group. Scores: TPK
// threads share a key row, each taking every TPK-th 16-byte chunk of it
// against the heads' query rows held in shared memory as fp32. P.V: thread
// t owns the column pair 2(t % (Dv/2)) for all heads and every
// (THREADS / (Dv/2))-th key of the tile.

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

// shared-memory layout of one FMA block, in bytes
template <typename TKV>
struct Layout {
  static constexpr int KEYS = Tile<TKV>::KEYS;
  static constexpr int TPK = THREADS / KEYS;  // threads sharing a key row
  int ldk, ldv, stage, scales, q, p, red, rows, walk;
  // after the walk, from 0: the key subsets' sums, the heads' accumulators,
  // max, normaliser and the ticket flag
  int acc, ml, flag, total;

  __host__ __device__ Layout(int Dk, int Dv) {
    ldk = Dk * (int)sizeof(TKV) + 16 * TPK;
    ldv = Dv * (int)sizeof(TKV) + 16 * TPK;
    stage = KEYS * (ldk + ldv);
    scales = 2 * stage;                 // [stage][k|v][KEYS] floats
    q = scales + 2 * 2 * KEYS * 4;      // [GMAX][Dk] floats
    p = q + GMAX * Dk * 4;              // [GMAX][KEYS] floats
    red = p + GMAX * KEYS * 4;          // [2][WARPS][GMAX] floats
    rows = red + 2 * WARPS * GMAX * 4;  // [stage][KEYS] ints: pool rows
    walk = rows + 2 * KEYS * 4;
    const int subsets = THREADS / (Dv / 2);
    acc = (subsets - 1) * GMAX * Dv * 4;
    ml = acc + GMAX * Dv * 4;
    flag = ml + 2 * GMAX * 4;
    total = flag + 16 > walk ? flag + 16 : walk;
  }
  __host__ __device__ int bytes() const { return total; }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS) paged_fma_kernel(Params p) {
  constexpr int G = GMAX;
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int KEYS = Tile<TKV>::KEYS;
  constexpr int TPK = THREADS / KEYS;
  constexpr int VEC = 16 / sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb = blockIdx.x;  // KV head * chunks + chunk
  const int h = cb / p.chunks;
  const int g0 = cb % p.chunks * G;  // the chunk's first head of the group
  const int nh = min(G, p.G - g0);
  const int m = blockIdx.y, z = blockIdx.z;
  // the table's reach bounds the walk: a longer length (a finished slot
  // still decoding to the end of its block) reads no further
  const int len = min(max(p.lengths[m], 0), p.spg * p.page);
  const int n = (len + p.split - 1) / p.split;  // blocks with work for slot m
  if (z >= max(n, 1)) return;
  const int begin = z * p.split;
  const int end = min(len, begin + p.split);
  const int n_tiles = (max(end - begin, 0) + KEYS - 1) / KEYS;

  const Layout<TKV> L(p.Dk, p.Dv);
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
  const float scale_log2 = p.scale * LOG2E;

  // the chunk's query heads; heads past the group are zeros
  const int head0 = h * p.G + g0;
  const TQ* q = static_cast<const TQ*>(p.q) + ((size_t)m * p.Hq + head0) * Dk;
  for (int i = tid; i < G * Dk; i += THREADS) sQ[i] = i < nh * Dk ? to_float(q[i]) : 0.0f;

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

  // running max (log2 units) and normaliser of each head, the same in every thread
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
    const float kscale = QUANT ? scl[key] * scale_log2 : scale_log2;
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
      corr[g] = exp2f(m_run[g] - m_new);
      m_run[g] = m_new;
      const float pr = valid ? exp2f(s[g] - m_new) : 0.0f;
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
  if (n_tiles == 0) __syncthreads();  // nothing walked: sQ written before the reuse below

  // sum the key subsets (the tile buffers are free now), then finish the row
  float* sPart = reinterpret_cast<float*>(smem);
  float* sAcc = reinterpret_cast<float*>(smem + L.acc);
  float* sM = reinterpret_cast<float*>(smem + L.ml);
  float* sL = sM + G;
  if (pv_thread && ks > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sPart[((ks - 1) * G + g) * Dv + 2 * dp] = acc[g][0];
      sPart[((ks - 1) * G + g) * Dv + 2 * dp + 1] = acc[g][1];
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sM[g] = m_run[g];
      sL[g] = l_run[g];
    }
  }
  __syncthreads();
  if (pv_thread && ks == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a0 = acc[g][0], a1 = acc[g][1];
      for (int s2 = 1; s2 < KS; ++s2) {
        a0 += sPart[((s2 - 1) * G + g) * Dv + 2 * dp];
        a1 += sPart[((s2 - 1) * G + g) * Dv + 2 * dp + 1];
      }
      sAcc[g * Dv + 2 * dp] = a0;
      sAcc[g * Dv + 2 * dp + 1] = a1;
    }
  }
  __syncthreads();
  // one split: O / l (length 0: l and the accumulator are 0, so zeros);
  // else this split's partial, and the merge if it is the row's last
  TQ* out = static_cast<TQ*>(p.o) + ((size_t)m * p.Hq + head0) * Dv;
  const size_t row0 = ((size_t)m * p.Hq + head0) * p.splits;
  for (int i = tid; i < nh * Dv; i += THREADS) {
    const int g = i / Dv;
    if (n <= 1) out[i] = from_float<TQ>(sAcc[i] / fmaxf(sL[g], 1e-30f));
    else p.part_acc[(row0 + (size_t)g * p.splits + z) * Dv + i - g * Dv] = sAcc[i];
  }
  if (n > 1) {
    if (tid < nh) {
      float* ml = p.part_ml + 2 * (row0 + (size_t)tid * p.splits + z);
      ml[0] = sM[tid];
      ml[1] = sL[tid];
    }
    merge_splits<TQ, MAX_HEAD_DIM>(p, m, m * gridDim.x + cb, head0, nh, n,
                                   reinterpret_cast<int*>(smem + L.flag));
  }
}

// -------------------------------------- the tensor-core kernel (bf16 q)

constexpr int TILE = 64;       // rows of a stage
constexpr int RING_BYTES = 64 * 1024;  // copies in flight per block, at most (2 blocks an SM)
constexpr int MAX_STAGES = 4;          // and at least two stages
constexpr int CONSUMERS = 4;   // warps of math, 16 rows of every tile each
constexpr int TC_THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int BOX_COLS = 64;   // columns of one TMA box

// shared-memory layout of one TC block, in bytes from a 1024-aligned base
template <typename TKV>
struct TcLayout {
  // a box row: 64 columns, 128 bytes of bf16 (128-byte swizzle) or 64 of
  // int8 (64-byte swizzle); a column block of a stage holds TILE of them
  static constexpr int ROW = BOX_COLS * (int)sizeof(TKV);
  static constexpr int BOX = TILE * ROW;
  int ldo, stage, stages;
  int so, scales, qf, wml, flag, red, pre, bars, total;

  // heads: query heads of a block (min(G, GMAX)); slots: M
  __host__ __device__ TcLayout(int dk, int dv, int heads, int slots) {
    ldo = dv + 8;  // padded rows: a warp's stores spread over the banks
    stage = (dk + dv) / BOX_COLS * BOX;
    stages = RING_BYTES / stage;  // a ring of tiles: more of them when rows are narrow
    stages = stages < 2 ? 2 : stages > MAX_STAGES ? MAX_STAGES : stages;
    so = stages * stage;                   // each warp's O rows [CONSUMERS][heads][ldo]
    scales = so + CONSUMERS * heads * ldo * 4;  // [stages][k|v][TILE] floats
    qf = scales + stages * 2 * TILE * 4;   // Q as mma A fragments: [Dk/16][32 lanes][4]
    wml = qf + dk / 16 * 32 * 16;          // [CONSUMERS][GMAX][m, l]
    flag = wml + CONSUMERS * GMAX * 2 * 4;  // the ticket's verdict
    red = flag + 16;                       // [CONSUMERS] floats
    pre = red + CONSUMERS * 4;             // [slots + 1] ints: items before each slot,
    bars = pre + (2 * slots + 1) * 4;      // then [slots] lengths; full[stages], empty[stages]
    bars = (bars + 7) / 8 * 8;
    total = bars + 2 * stages * 8;
  }
  // what a launch asks for: the layout and the alignment of its base
  __host__ __device__ int bytes() const { return total + 1024; }
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile, bf16 or fp16 operands, fp32 accumulator
template <bool HALF>
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  if constexpr (HALF) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ unsigned pack_half(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two int8 codes of a word (bytes `sel`: 0x4240 takes bytes 0 and 2,
// 0x4341 bytes 1 and 3) as an fp16 pair, exactly: the code's bits xor 0x80
// in the low byte of fp16 0x6400 (1024) give 1024 + 128 + c; 1152 comes off.
__device__ __forceinline__ unsigned codes_to_half2(unsigned w, unsigned sel) {
  const unsigned x = __byte_perm(w ^ 0x80808080u, 0x64646464u, sel);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&x),
                            __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
  return *reinterpret_cast<const unsigned*>(&h);
}

// The byte offset of 16-byte chunk c of row r of a column block, under the
// TMA's swizzle: 128-byte rows xor the chunk with r % 8, 64-byte rows with
// (r / 2) % 4.
template <typename TKV>
__device__ __forceinline__ unsigned swz(int r, int c) {
  if constexpr (sizeof(TKV) == 2) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// One work item: a (slot, KV head, head chunk) row's split, or the whole
// row of an empty slot (which writes zeros).
struct Item {
  int m, cb, h, g0, nh, n, z, begin, end, n_tiles;
};

// Items run slot by slot, row by row, split fastest; sPre[m] counts the
// items before slot m and sLen its clipped length.
__device__ __forceinline__ Item decode_item(const Params& p, const int* sPre, const int* sLen,
                                            int M, int item) {
  const int rows_per_slot = p.Hkv * p.chunks;
  int lo = 0, hi = M - 1;  // the slot: the last m with sPre[m] <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (sPre[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  Item it;
  it.m = lo;
  const int per_row = (sPre[lo + 1] - sPre[lo]) / rows_per_slot;
  it.cb = (item - sPre[lo]) / per_row;  // KV head * chunks + chunk
  it.z = (item - sPre[lo]) % per_row;   // the split
  it.h = it.cb / p.chunks;
  it.g0 = it.cb % p.chunks * GMAX;
  it.nh = min(GMAX, p.G - it.g0);  // heads of the item
  const int len = sLen[lo];
  it.n = (len + p.split - 1) / p.split;  // splits with work for the row
  it.begin = it.z * p.split;
  it.end = min(len, it.begin + p.split);
  it.n_tiles = (max(it.end - it.begin, 0) + TILE - 1) / TILE;
  return it;
}

// Persistent blocks of TC_THREADS threads: warps 0-3 do the math, warp 4
// issues the copies. Each block counts the items the lengths hold and takes
// items blockIdx.x, + gridDim.x, ...; the producer runs ahead of the math
// by the ring's tiles, so the next item's copies are in flight
// during this item's merge. The grid comes from the shapes alone. DV is
// the value head dim.
template <typename TKV, int DV>
__global__ void __launch_bounds__(TC_THREADS, DV > 128 ? 1 : 2)
    paged_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Params p, int M) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  using L_t = TcLayout<TKV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const L_t L(p.Dk, DV, min(p.G, GMAX), M);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_per_slot = p.Hkv * p.chunks;
  const int reach = p.spg * p.page;
  const int Dk = p.Dk;

  // items before each slot: a slot of length len has max(ceil(len / split),
  // 1) items per row
  int* sPre = reinterpret_cast<int*>(smem + L.pre);
  int* sLen = sPre + M + 1;  // the lengths clipped to the table's reach
  for (int i = threadIdx.x; i < M; i += TC_THREADS) {
    const int len = min(max(p.lengths[i], 0), reach);
    sLen[i] = len;
    sPre[i + 1] = rows_per_slot * max((len + p.split - 1) / p.split, 1);
  }
  const int stages = L.stages;
  const unsigned bars = smem_u32(smem + L.bars);  // full[s] at bars + 8 s, empty[s] at + 8 (stages + s)
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // full: the producer's expect_tx, and with an int8 pool each producer
      // lane's cp.async arrival; empty: one arrival per consumer warp
      mbar_init(bars + 8 * s, QUANT ? 33 : 1);
      mbar_init(bars + 8 * (stages + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < M; base += 32) {
      int x = base + lane < M ? sPre[base + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += y;
      }
      if (base + lane < M) sPre[base + lane + 1] = carry + x;
      carry += __shfl_sync(FULL_MASK, x, 31);
    }
    if (lane == 0) sPre[0] = 0;
  }
  __syncthreads();
  const int total = sPre[M];
  float* sScale = reinterpret_cast<float*>(smem + L.scales);

  if (warp == CONSUMERS) {
    // the producer: each pair of tiles' page-table entries in one round
    // trip (lanes 0-15 the first tile's pages, 16-31 the second's), then
    // the copies, as soon as the tile's stage is free
    const int R = p.box_rows;
    const int kboxes = Dk / BOX_COLS, boxes = kboxes + DV / BOX_COLS;
    int T = 0;  // tiles issued by this block
    for (int item = blockIdx.x; item < total; item += gridDim.x) {
      const Item it = decode_item(p, sPre, sLen, M, item);
      const int* table = p.tables + (size_t)it.m * p.spg;
      int entry = 0;
      for (int t = 0; t < it.n_tiles; ++t, ++T) {
        const int s = T % stages;
        const int t0 = it.begin + t * TILE;
        const int half = (t & 1) * 16;
        if ((t & 1) == 0) {
          const int tt = t + (lane >> 4), first = (it.begin + tt * TILE) / p.page;
          const int j = first + (lane & 15);
          entry = tt < it.n_tiles && j * p.page < min(it.end, it.begin + (tt + 1) * TILE)
                      ? table[j] : 0;
        }
        if (T >= stages) mbar_wait(bars + 8 * (stages + s), (T / stages - 1) & 1);
        const int rows = min(TILE, (it.end - t0 + R - 1) / R * R);  // whole boxes of one page run
        if (lane == 0) mbar_expect_tx(bars + 8 * s, rows * (Dk + DV) * (int)sizeof(TKV));
        __syncwarp();
        const unsigned dst0 = smem_u32(smem + s * L.stage);
        const int first = t0 / p.page;
        const int nbox = rows / R * boxes;
        for (int base = 0; base < nbox; base += 32) {
          const int i = base + lane;
          const int rg = i / boxes, col = i - rg * boxes;
          const int pos = t0 + rg * R;
          const int page_id = __shfl_sync(FULL_MASK, entry, half + min(pos / p.page - first, 15));
          if (i < nbox) {
            const bool is_k = col < kboxes;
            const int c = is_k ? col : col - kboxes;
            tma_load_2d(dst0 + col * L_t::BOX + rg * R * L_t::ROW, is_k ? &kmap : &vmap,
                        it.h * (is_k ? Dk : DV) + c * BOX_COLS, page_id * p.page + pos % p.page,
                        bars + 8 * s);
          }
        }
        if constexpr (QUANT) {
#pragma unroll
          for (int k = 0; k < TILE / 32; ++k) {
            const int r = lane + 32 * k;
            const int pos = t0 + r;
            const int page_id = __shfl_sync(FULL_MASK, entry, half + min(pos / p.page - first, 15));
            if (r < rows) {
              const size_t prow = ((size_t)page_id * p.page + pos % p.page) * p.Hkv + it.h;
              cp_async4(sScale + (s * 2) * TILE + r, p.k_scale + prow, true);
              cp_async4(sScale + (s * 2 + 1) * TILE + r, p.v_scale + prow, true);
            }
          }
          cp_async_mbar_arrive(bars + 8 * s);
        }
      }
    }
    return;
  }

  // ---- the consumers
  const int tid = threadIdx.x;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t4 = lane & 3;  // its column pair within an 8-column tile
  unsigned* sQf = reinterpret_cast<unsigned*>(smem + L.qf);
  float* sWml = reinterpret_cast<float*>(smem + L.wml);
  float* sRed = reinterpret_cast<float*>(smem + L.red);
  float* sO = reinterpret_cast<float*>(smem + L.so);
  const int ldo = L.ldo;
  const uint4* qf4 = reinterpret_cast<const uint4*>(sQf) + lane;

  // Q of an item: each thread loads its 16-byte pieces of the heads' rows
  // at once (one round trip), the next item's during this item's merge
  constexpr int QV = GMAX * MAX_HEAD_DIM / 8 / THREADS;  // pieces per thread at most
  uint4 qv[QV];
  auto load_q = [&](const Item& it) {
    const uint4* q = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) +
                                                    ((size_t)it.m * p.Hq + it.h * p.G + it.g0) * Dk);
#pragma unroll
    for (int k = 0; k < QV; ++k) {
      const int i = tid + k * THREADS;
      qv[k] = i < it.nh * Dk / 8 ? q[i] : make_uint4(0, 0, 0, 0);
    }
  };
  int T = 0;  // tiles consumed by this block
  if (blockIdx.x < total) load_q(decode_item(p, sPre, sLen, M, blockIdx.x));
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const Item it = decode_item(p, sPre, sLen, M, item);
    const int nh = it.nh;
    const bool hi = nh > 8;  // rows 8-15 hold heads
    const int n_vec = nh * Dk / 8;

    // Q as the A fragments of every 16-wide k step, in the order a lane
    // reads them: register r of lane (g, t4) holds row g + 8 (r & 1). bf16:
    // columns 2 t4 (+8 for r >= 2) and the next. int8 (fp16 products): the
    // k order follows the codes' bytes (see the K loads), columns 4 t4 + r /
    // 2 and 2 further, scaled by a power of two into fp16's range. Rows past
    // the heads stay zero. (The last item's walk and merge are done: the
    // merge ends with a barrier.)
    for (int i = tid; i < Dk * 2; i += THREADS) reinterpret_cast<uint4*>(sQf)[i] = make_uint4(0, 0, 0, 0);
    float qs = 1.0f;
    if constexpr (QUANT) {
      float amax = 0.0f;
#pragma unroll
      for (int k = 0; k < QV; ++k) {
        const unsigned w[4] = {qv[k].x, qv[k].y, qv[k].z, qv[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL_MASK, amax, o));
      if (lane == 0) sRed[warp] = amax;
      consumer_sync();  // and sQf zeroed
      amax = fmaxf(fmaxf(sRed[0], sRed[1]), fmaxf(sRed[2], sRed[3]));
      if (amax > 0.0f) {
        int e;
        frexpf(amax, &e);
        qs = ldexpf(1.0f, 14 - e);  // amax * qs in [2^13, 2^14)
      }
    } else {
      consumer_sync();  // sQf zeroed
    }
#pragma unroll
    for (int k = 0; k < QV; ++k) {
      const int i = tid + k * THREADS;
      if (i < n_vec) {
        const int row = i * 8 / Dk, d0 = i * 8 % Dk;  // elements d0 .. d0 + 7 of the row
        const int kk = d0 >> 4, slot = (row & 7) * 4, rlo = row >> 3;
        unsigned* dst = sQf + kk * 128 + rlo;
        const unsigned w[4] = {qv[k].x, qv[k].y, qv[k].z, qv[k].w};
        if constexpr (QUANT) {
          float f[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            f[2 * e] = x.x * qs;
            f[2 * e + 1] = x.y * qs;
          }
          // two groups of 4 columns: t4 = (d0 % 16) / 4 and the next; pairs
          // (0, 2) in registers 0/1 and (1, 3) in registers 2/3
#pragma unroll
          for (int grp = 0; grp < 2; ++grp) {
            const int t4q = ((d0 & 15) >> 2) + grp;
            dst[(slot + t4q) * 4 + 0] = pack_half(f[4 * grp], f[4 * grp + 2]);
            dst[(slot + t4q) * 4 + 2] = pack_half(f[4 * grp + 1], f[4 * grp + 3]);
          }
        } else {
          // pairs (d, d + 1): column d = 8 rhi + 2 t4 within the k step
          const int rhi = (d0 & 15) >> 3;
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(slot + e) * 4 + 2 * rhi] = w[e];
        }
      }
    }
    consumer_sync();

    const float score_scale = p.scale * LOG2E / qs;
    float o[DV / 8][4];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    // running max (log2 units) and this lane's share of the normaliser of
    // rows g and g + 8; int8: the reference scale of V that O is counted in
    float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.0f, 0.0f};
    float vref = 0.0f;
    const int begin = it.begin, end = it.end;

    for (int t = 0; t < it.n_tiles; ++t, ++T) {
      const int s = T % stages;
      const int key0 = begin + t * TILE + 16 * warp;  // this warp's first key
      const int valid = min(16, end - key0);
      // keys only grow with t, so a warp with none here has none later in
      // the item; the producer refills a stage only after every warp passed it
      if (valid > 0) {
        mbar_wait(bars + 8 * s, (T / stages) & 1);
        const unsigned kbase = smem_u32(smem + s * L.stage);
        const unsigned vbase = kbase + Dk / BOX_COLS * L_t::BOX;
        const int r0 = 16 * warp;  // the warp's rows of the tile

        // S = Q K^T: 16 heads x 16 keys, n tiles of keys 0-7 and 8-15
        // (even and odd k steps in two accumulators: half the chain of mmas)
        float sc[2][4], sd[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
          sd[j][0] = sd[j][1] = sd[j][2] = sd[j][3] = 0.0f;
        }
        if constexpr (QUANT) {
          // a 16-byte chunk of a row is one k step; ldmatrix gives lane (g,
          // t4) bytes 4 t4 .. 4 t4 + 3 of key g, taken as k slots (2 t4, 2 t4
          // + 1) <- bytes (0, 2) and (2 t4 + 8, 2 t4 + 9) <- bytes (1, 3)
          const int kr = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll 2
          for (int kk = 0; kk < Dk / 16; kk += 2) {
            const uint4 qa = qf4[kk * 32], qb = qf4[(kk + 1) * 32];
            const unsigned a0[4] = {qa.x, qa.y, qa.z, qa.w}, a1[4] = {qb.x, qb.y, qb.z, qb.w};
            unsigned kf[4];
            ldsm_x4(kf, kbase + (kk / 4) * L_t::BOX + swz<TKV>(kr, (kk & 3) + (lane >> 4)));
            mma16816<true>(sc[0], a0, codes_to_half2(kf[0], 0x4240), codes_to_half2(kf[0], 0x4341));
            mma16816<true>(sc[1], a0, codes_to_half2(kf[1], 0x4240), codes_to_half2(kf[1], 0x4341));
            mma16816<true>(sd[0], a1, codes_to_half2(kf[2], 0x4240), codes_to_half2(kf[2], 0x4341));
            mma16816<true>(sd[1], a1, codes_to_half2(kf[3], 0x4240), codes_to_half2(kf[3], 0x4341));
          }
        } else {
          // matrices (keys 0-7 | 8-15) x (d 0-7, 8-15) of one k step
          const int kr = r0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll 2
          for (int kk = 0; kk < Dk / 16; kk += 2) {
            const uint4 qa = qf4[kk * 32], qb = qf4[(kk + 1) * 32];
            const unsigned a0[4] = {qa.x, qa.y, qa.z, qa.w}, a1[4] = {qb.x, qb.y, qb.z, qb.w};
            unsigned kf[4], kg[4];
            ldsm_x4(kf, kbase + (kk / 4) * L_t::BOX + swz<TKV>(kr, 2 * (kk & 3) + ((lane >> 3) & 1)));
            ldsm_x4(kg, kbase + (kk / 4) * L_t::BOX + swz<TKV>(kr, 2 * (kk & 3) + 2 + ((lane >> 3) & 1)));
            mma16816<false>(sc[0], a0, kf[0], kf[1]);
            mma16816<false>(sc[1], a0, kf[2], kf[3]);
            mma16816<false>(sd[0], a1, kg[0], kg[1]);
            mma16816<false>(sd[1], a1, kg[2], kg[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += sd[j][e];
        }

        // online softmax in log2 units; this lane holds rows g and g + 8,
        // keys 8 j + 2 t4 + {0, 1}
        float ks[2][2], vs[2][2];
        if constexpr (QUANT) {
          const float* sk = sScale + s * 2 * TILE + r0;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 kv = *reinterpret_cast<const float2*>(sk + 8 * j + 2 * t4);
            const float2 vv = *reinterpret_cast<const float2*>(sk + TILE + 8 * j + 2 * t4);
            ks[j][0] = kv.x * score_scale;
            ks[j][1] = kv.y * score_scale;
            vs[j][0] = vv.x;
            vs[j][1] = vv.y;
          }
        }
        float mx[2] = {NEG_INF, NEG_INF};
        float vmax = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = 8 * j + 2 * t4 + (e & 1) < valid;
            const float x = ok ? sc[j][e] * (QUANT ? ks[j][e & 1] : score_scale) : NEG_INF;
            sc[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
            if (QUANT && ok) vmax = fmaxf(vmax, vs[j][e & 1]);
          }
        }
        float mu[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r == 1 && !hi) {  // rows 8-15 hold no head
            mu[1] = 0.0f;
            corr[1] = 1.0f;
            continue;
          }
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
          const float mn = fmaxf(mrow[r], mx[r]);
          mu[r] = mn == NEG_INF ? 0.0f : mn;
          corr[r] = exp2_approx(mrow[r] - mu[r]);
          mrow[r] = mn;
        }
        float ocorr[2] = {corr[0], corr[1]};
        float vinv = 1.0f;
        if constexpr (QUANT) {
          // V's scale rides on P, counted in units of the largest V scale
          // seen, so P * scale / vref stays in [0, 1]
          vmax = fmaxf(vmax, __shfl_xor_sync(FULL_MASK, vmax, 1));
          vmax = fmaxf(vmax, __shfl_xor_sync(FULL_MASK, vmax, 2));
          const float vnew = fmaxf(fmaxf(vref, vmax), 1e-30f);
          ocorr[0] *= vref / vnew;
          ocorr[1] *= vref / vnew;
          vref = vnew;
          vinv = 1.0f / vnew;
        }
        // P as the A operand of P V, in place of S (rows 8-15 only when they
        // hold heads)
        unsigned pa[4];
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[e] = (e < 2 || hi) ? exp2_approx(sc[j][e] - mu[e >> 1]) : 0.0f;
            sum[e >> 1] += pr[e];
            if constexpr (QUANT) {
              const bool ok = 8 * j + 2 * t4 + (e & 1) < valid;
              pr[e] = ok ? pr[e] * (vs[j][e & 1] * vinv) : 0.0f;
            }
          }
          pa[2 * j] = QUANT ? pack_half(pr[0], pr[1]) : pack_bf16(pr[0], pr[1]);
          pa[2 * j + 1] = QUANT ? pack_half(pr[2], pr[3]) : pack_bf16(pr[2], pr[3]);
        }
        // a0: (row g, keys 2 t4..), a1: row g + 8, a2/a3: keys 8 + 2 t4..
        const unsigned pf[4] = {pa[0], pa[1], pa[2], pa[3]};
#pragma unroll
        for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + sum[r];
        if (__any_sync(FULL_MASK, ocorr[0] != 1.0f || (hi && ocorr[1] != 1.0f))) {
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            o[j][0] *= ocorr[0];
            o[j][1] *= ocorr[0];
            o[j][2] *= ocorr[1];
            o[j][3] *= ocorr[1];
          }
        }

        // O += P V; keys 8-15 of a warp with 8 or fewer may be rows no box
        // copied, so their V fragments are zeroed
        const bool upper = valid > 8;
        if constexpr (QUANT) {
          // lane (g, t4) of a .trans matrix holds keys 2 t4, 2 t4 + 1 of
          // columns 2 g, 2 g + 1 of a 16-byte chunk: n tile 2 c + par takes
          // column 16 c + 2 g + par, so its lane holds 16 c + 4 t4 + par (+2)
          const int vr = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int c2 = 0; c2 < DV / 32; ++c2) {
            unsigned vf[4];
            ldsm_x4_trans(vf, vbase + (c2 / 2) * L_t::BOX + swz<TKV>(vr, 2 * (c2 & 1) + (lane >> 4)));
            if (!upper) vf[1] = vf[3] = 0u;  // codes of 0
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = 4 * c2 + 2 * half;
              mma16816<true>(o[j], pf, codes_to_half2(vf[2 * half], 0x4240),
                             codes_to_half2(vf[2 * half + 1], 0x4240));
              mma16816<true>(o[j + 1], pf, codes_to_half2(vf[2 * half], 0x4341),
                             codes_to_half2(vf[2 * half + 1], 0x4341));
            }
          }
        } else {
          // matrices (keys 0-7, 8-15) x (dv 0-7 | 8-15) of a 16-column group
          const int vr = r0 + (lane & 15);
#pragma unroll
          for (int jj = 0; jj < DV / 16; ++jj) {
            unsigned vf[4];
            ldsm_x4_trans(vf, vbase + (jj / 4) * L_t::BOX + swz<TKV>(vr, 2 * (jj & 3) + (lane >> 4)));
            if (!upper) vf[1] = vf[3] = 0u;
            mma16816<false>(o[2 * jj], pf, vf[0], vf[1]);
            mma16816<false>(o[2 * jj + 1], pf, vf[2], vf[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (stages + s));  // the stage may be refilled
    }
    if (item + gridDim.x < total) load_q(decode_item(p, sPre, sLen, M, item + gridDim.x));

    // each warp's rows to shared memory, in natural column order, O counted
    // in V's units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(FULL_MASK, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(FULL_MASK, lrow[r], 2);
    }
    const float vfin = QUANT ? vref : 1.0f;
    float* sOw = sO + warp * nh * ldo;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = g + 8 * e2;
      if (row < nh) {
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          if constexpr (QUANT) {
            const int col = 16 * (j >> 1) + 4 * t4 + (j & 1);
            sOw[row * ldo + col] = o[j][2 * e2] * vfin;
            sOw[row * ldo + col + 2] = o[j][2 * e2 + 1] * vfin;
          } else {
            *reinterpret_cast<float2*>(sOw + row * ldo + 8 * j + 2 * t4) =
                make_float2(o[j][2 * e2], o[j][2 * e2 + 1]);
          }
        }
      }
    }
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sWml[(warp * GMAX + g + 8 * r) * 2] = mrow[r];
        sWml[(warp * GMAX + g + 8 * r) * 2 + 1] = lrow[r];
      }
    }
    consumer_sync();
    // the warps' rows merged, each output on its own: the weight of a
    // warp's row is exp2(its max - the largest); one split writes O / l,
    // else the split's partial, and the merge if it is the row's last
    const int head0 = it.h * p.G + it.g0;
    const size_t row0 = ((size_t)it.m * p.Hq + head0) * p.splits;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + ((size_t)it.m * p.Hq + head0) * DV;
    auto warp_weights = [&](int row, float (&w)[CONSUMERS]) {
      float mx = NEG_INF;
#pragma unroll
      for (int k = 0; k < CONSUMERS; ++k) mx = fmaxf(mx, sWml[(k * GMAX + row) * 2]);
#pragma unroll
      for (int k = 0; k < CONSUMERS; ++k) w[k] = exp2_approx(sWml[(k * GMAX + row) * 2] - mx);
      return mx;
    };
    for (int i = tid; i < nh * DV; i += THREADS) {
      const int row = i / DV, at = row * ldo + i - row * DV;
      float w[CONSUMERS];
      warp_weights(row, w);
      float a = 0.0f, l = 0.0f;
#pragma unroll
      for (int k = 0; k < CONSUMERS; ++k) {
        a = fmaf(w[k], sO[k * nh * ldo + at], a);
        l = fmaf(w[k], sWml[(k * GMAX + row) * 2 + 1], l);
      }
      // length 0: l and the accumulator are 0, so the row is zeros
      if (it.n <= 1) out[i] = __float2bfloat16(a / fmaxf(l, 1e-30f));
      else p.part_acc[(row0 + (size_t)row * p.splits + it.z) * DV + i - row * DV] = a;
    }
    if (it.n > 1) {
      if (tid < nh) {
        float w[CONSUMERS];
        const float mx = warp_weights(tid, w);
        float l = 0.0f;
#pragma unroll
        for (int k = 0; k < CONSUMERS; ++k) l = fmaf(w[k], sWml[(k * GMAX + tid) * 2 + 1], l);
        float* ml = p.part_ml + 2 * (row0 + (size_t)tid * p.splits + it.z);
        ml[0] = mx;
        ml[1] = l;
      }
      merge_splits<__nv_bfloat16, DV>(p, it.m, it.m * rows_per_slot + it.cb, head0, nh, it.n,
                                      reinterpret_cast<int*>(smem + L.flag));
    }
  }
}

// ---------------------------------------------------------------- launches

// A kernel's dynamic shared-memory limit, set when a launch asks for more
// than the last (a model's head dims do not change, so serving sets it once)
template <typename K>
cudaError_t allow_shared(K kernel, int smem, int& set) {
  if (smem <= set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

template <typename TQ, typename TKV>
cudaError_t launch_fma(const Params& p, int M, cudaStream_t stream) {
  static int set = 48 * 1024;
  const int smem = Layout<TKV>(p.Dk, p.Dv).bytes();
  cudaError_t err = allow_shared(paged_fma_kernel<TQ, TKV>, smem, set);
  if (err != cudaSuccess) return err;
  paged_fma_kernel<TQ, TKV><<<dim3(p.Hkv * p.chunks, M, p.splits), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TKV, int DV>
cudaError_t tc_prepare(int dk, int heads, int slots, int* smem_out) {
  static int set = 48 * 1024;
  const int smem = TcLayout<TKV>(dk, DV, heads, slots).bytes();
  *smem_out = smem;
  return allow_shared(paged_tc_kernel<TKV, DV>, smem, set);
}

// Blocks of the persistent grid: as many as the card holds at once (the
// occupancy of this build at this shared size), found once per size
template <typename TKV, int DV>
cudaError_t tc_resident(int smem, int* blocks) {
  static int known_smem = -1, known = 0;
  if (smem != known_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_tc_kernel<TKV, DV>,
                                                          TC_THREADS, smem);
    if (err != cudaSuccess) return err;
    known = sms * per_sm;
    known_smem = smem;
  }
  *blocks = known;
  return cudaSuccess;
}

template <typename TKV, int DV>
cudaError_t launch_tc(const Params& p, const CUtensorMap& km, const CUtensorMap& vm, int M,
                      cudaStream_t stream) {
  int smem = 0, resident = 0;
  cudaError_t err = tc_prepare<TKV, DV>(p.Dk, p.G < GMAX ? p.G : GMAX, M, &smem);
  if (err == cudaSuccess) err = tc_resident<TKV, DV>(smem, &resident);
  if (err != cudaSuccess) return err;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const long long items = (long long)M * p.Hkv * p.chunks * p.splits;  // at most
  const int blocks = (int)(items < resident ? items : resident);
  paged_tc_kernel<TKV, DV><<<blocks, TC_THREADS, smem, stream>>>(km, vm, p, M);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t launch_tc_dv(const Params& p, const CUtensorMap& km, const CUtensorMap& vm, int M,
                         cudaStream_t stream) {
  switch (p.Dv) {
    case 64: return launch_tc<TKV, 64>(p, km, vm, M, stream);
    case 128: return launch_tc<TKV, 128>(p, km, vm, M, stream);
    case 192: return launch_tc<TKV, 192>(p, km, vm, M, stream);
    case 256: return launch_tc<TKV, 256>(p, km, vm, M, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TKV, int DV>
cudaError_t tc_info(int dk, int slots, long long* out) {
  int smem = 0;
  cudaError_t err = tc_prepare<TKV, DV>(dk, 4, slots, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, paged_tc_kernel<TKV, DV>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, paged_tc_kernel<TKV, DV>,
                                                      TC_THREADS, smem);
  out[0] = smem;
  out[1] = a.numRegs;
  out[2] = blocks;
  out[3] = (long long)a.localSizeBytes;
  return err;
}

template <typename TKV>
cudaError_t tc_info_dv(int dk, int dv, int slots, long long* out) {
  switch (dv) {
    case 64: return tc_info<TKV, 64>(dk, slots, out);
    case 128: return tc_info<TKV, 128>(dk, slots, out);
    case 192: return tc_info<TKV, 192>(dk, slots, out);
    case 256: return tc_info<TKV, 256>(dk, slots, out);
  }
  return cudaErrorInvalidValue;
}

// One pool as a (rows, cols) tensor of bf16 or int8 (as uint8), boxes of
// 64 columns x box_rows rows, swizzled for ldmatrix
cudaError_t pool_map(CUtensorMap* map, const void* pool, bool int8, long long rows, int cols,
                     int box_rows) {
  return tensor_map_2d(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       pool, rows, cols, (long long)cols * (int8 ? 1 : 2), BOX_COLS, box_rows,
                       int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// Blocks along the page walk for `split` positions per block (0: one).
int num_splits(int page, int spg, int split) {
  return split > 0 ? (page * spg + split - 1) / split : 1;
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (then k_scale and v_scale are given). pool_pages: P+1. split:
// positions per block of the page walk, a multiple of 64, or 0 for one
// block per (slot, KV head, head chunk). With splits = ceil(page * spg /
// split) > 1, part_acc and part_ml hold M * Hq * splits * Dv and * 2
// floats, and counters M * Hkv * ceil(G / 16) ints that are zero (the
// launch leaves them zero). bf16 q over a bf16 or int8 pool with pages of
// a multiple of 8 rows runs the tensor-core kernel, the rest the FMA one. Every tensor is contiguous. Returns the
// cudaError_t of the launch (0 on success); the caller checks it.
int mst_paged_attention(const void* q, const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* tables, const void* lengths, void* o,
                        void* part_acc, void* part_ml, void* counters, int q_dtype, int kv_dtype,
                        int M, int Hq, int Hkv, int Dk, int Dv, int pool_pages, int page, int spg,
                        int split, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Dk % 64 || Dv % 64 || Dk > 256 || Dv > 256 || page <= 0 ||
      spg <= 0 || M <= 0 || pool_pages <= 0 || split < 0 || split % 64)
    return (int)cudaErrorInvalidValue;
  const int splits = num_splits(page, spg, split);
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
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
  p.counters = static_cast<int*>(counters);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Dk = Dk;
  p.Dv = Dv;
  p.page = page;
  p.spg = spg;
  p.G = Hq / Hkv;
  p.chunks = (p.G + GMAX - 1) / GMAX;
  p.splits = splits;
  p.split = splits > 1 ? split : page * spg;
  p.box_rows = gcd_int(page, 64);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2) && p.box_rows >= 8) {
    const bool int8 = kv_dtype == 2;
    const long long rows = (long long)pool_pages * page;
    CUtensorMap km, vm;
    cudaError_t err = pool_map(&km, k, int8, rows, Hkv * Dk, p.box_rows);
    if (err == cudaSuccess) err = pool_map(&vm, v, int8, rows, Hkv * Dv, p.box_rows);
    if (err != cudaSuccess) return (int)err;
    return int8 ? (int)launch_tc_dv<int8_t>(p, km, vm, M, s)
                : (int)launch_tc_dv<__nv_bfloat16>(p, km, vm, M, s);
  }
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch_fma<float, float>(p, M, s);
  if (q_dtype == 0 && kv_dtype == 2) return (int)launch_fma<float, int8_t>(p, M, s);
  if (q_dtype == 1 && kv_dtype == 1) return (int)launch_fma<__nv_bfloat16, __nv_bfloat16>(p, M, s);
  if (q_dtype == 1 && kv_dtype == 2) return (int)launch_fma<__nv_bfloat16, int8_t>(p, M, s);
  return (int)cudaErrorInvalidValue;
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The bf16-q tensor-core kernel over a kv_dtype pool (1 = bfloat16, 2 =
// int8) at (Dk, Dv), 4 heads a block, for M slots: out[0..3] = shared bytes per block,
// registers per thread, resident blocks per SM, local (spill) bytes per
// thread. Returns the cudaError_t of the queries.
int mst_paged_attention_kernel_info(int kv_dtype, int Dk, int Dv, int M, long long* out) {
  if (kv_dtype == 1) return (int)tc_info_dv<__nv_bfloat16>(Dk, Dv, M, out);
  if (kv_dtype == 2) return (int)tc_info_dv<int8_t>(Dk, Dv, M, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
