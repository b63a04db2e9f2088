// Causal GQA flash attention for prefill chunks, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlx_sharding_tpu/ops/flash_attention.py
// (flash_attention -> _kernel). It computes the same function: query row i
// of the chunk sits at absolute position offset + i and attends to every key
// at a position <= its own, over the full-capacity dense KV cache
// (B, S, Hkv, D), read in place through strides. Query head h reads KV head
// h / (Hq / Hkv). The softmax is the online (running max, normaliser,
// accumulator) recurrence in fp32, so no (T, S) score matrix ever reaches
// device memory. Masked scores are -1e30, as in the TPU kernel.
//
// Gemma-2's two options (JAX's plain path, mlx_sharding_tpu/ops/attention.py
// causal_attention, which its Pallas kernel does not take) are computed in
// JAX's order: the scores are scaled, then softcapped, cap * tanh(s / cap),
// in fp32 with the accurate tanhf (tanh.approx errs by ~2^-11, up to ~0.025
// on a score at cap 50, as much as the near-tie gaps seen in served
// streams), then masked to keys k with q_pos - window < k <= q_pos. A row
// tile's walk starts at the first key any of its rows sees, so key tiles
// wholly before every row's window are skipped, not masked, and a split
// walk is cut from that start (no empty or wasted split). The bf16 kernel
// is built twice: with the options (OPT) and without, so that a call
// without them runs the code it ran before they existed (the options'
// per-score branch and mask cost it ~30% at D = 128).
//
// What bounds it on an H100 at the main path's shapes (Llama-3.1-8B: T =
// 256, Hq = 32, Hkv = 8, D = 128, bf16, a 4096-row cache): a chunk at
// offsets 0-512 moves ~6 MB and does 0.5-2 GFLOP, so the bound is ~2 us of
// bytes and what the time really pays is latency: a short walk per block,
// too few blocks to hide it, and the kernel's own round trips through shared
// memory. At offset 3840 a chunk does 16.6 GFLOP against ~10 MB: it is bound
// by tensor-core operations, and a block's walk of 61-64 key tiles in a row
// is what leaves the card idle. What each part of the bf16 design does:
//   - fragments in registers: both products run as mma.sync m16n8k16 (bf16
//     in, fp32 accumulate) with operands from ldmatrix (.trans for V). Each
//     warp owns 16 rows and keeps Q (for Dk <= 128), S, P and its 16 x Dv
//     accumulator in registers; the m16n8 accumulator layout says which row
//     an element belongs to, so the per-row rescale and the final 1/l run in
//     registers, and P becomes the A operand of P V by converting the S
//     accumulator to bf16 pairs in place. No S, P or O buffer exists in
//     shared memory (the output is staged through the free K/V ring once,
//     at the end, for 16-byte stores);
//   - shared memory holds Q and a two-stage ring of K/V tiles copied with
//     16-byte cp.async, the next tile in flight during this one's compute.
//     Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in
//     distinct banks. 87,040 bytes per block at D = 128: two blocks per SM;
//   - GQA packing: a block owns one (batch, KV head) and 64 rows of the
//     flattened (query position, head of the group) set, row r being
//     position q0 + r / G and head kvh * G + r % G. Each K/V tile is read
//     once for the G heads that share it, instead of once per head;
//   - a split key walk: when the grid of (row tiles x KV heads x batch) does
//     not fill the card, the host (ops/flash_attention.py::plan_split)
//     splits the walk over [0, kv_end) into chunks; each block writes fp32
//     partials (accumulator, running max, normaliser) and a merge kernel
//     rescales them to the common max, as the paged decode's merge does. A
//     chunk that starts at or past a row tile's causal end returns at once;
//   - the causal bound: no key past a row tile's last position is read (the
//     counterpart of the TPU kernel's lax.cond skip), and only the tiles that
//     cross a row's position or the chunk's end pay for the mask;
//   - the softmax runs on exp2 with scale * log2(e) folded into the scores
//     once (ex2.approx), and each thread keeps partial row sums that are
//     reduced across the row's four lanes once, after the walk.
// Templated on Dk and Dv (multiples of 64 up to 256), so the fragment loops
// unroll; Dk + Dv > 256 takes 32-key tiles to stay off spills.
//
// DeepSeek-V2's compressed MLA layout (Dk = rank + rope = 576, Dv = rank =
// 512, one KV head, GQA groups of 16 to 128) has its own build, VS = 4: V is
// the first 512 columns of each K row (the caller passes v as a strided view
// of k), so no V tile is copied and P V reads its fragments from the K tile
// in shared memory. A 16 x 512 fp32 accumulator would need 256 registers a
// thread before S and P, so the output columns are split over VS blocks:
// each block owns 128 of them, computes the whole S = Q K^T over Dk = 576
// (4x the QK^T operations of one block, the price of staying in registers)
// and its slice of P V. Q (64 x 576) and two 32-key K stages take 149,504
// bytes, one block an SM. Reading each K tile once for both products, with O
// in shared memory, is the next step for speed. Not done yet,
// the next step for speed: wgmma with TMA-fed tiles, for when the rate
// of mma.sync instructions is what limits the deep chunks.
//
// The dense continuous-batching engine keeps M + 1 slot caches in one
// (M + 1, S, Hkv, D) buffer and prefills one slot at a time. Its captured
// chunk must serve every slot, so the slot reaches the kernel as a device
// value: kv_batch, when set, holds for each query batch row the batch row
// of K and V it reads (one 8-byte load a block); null reads row b, as before.
//
// The fp32 variant, which only the tests and checks run, is the first
// version's kernel kept as it was: one block per (batch, query head, 64
// query rows), the scores and the accumulator in shared memory, plain FMA.
// Its MLA build (VK) reads Q from device memory and V from the K tile, one
// stage: Q, K, V and O of 576 / 512 in fp32 would not fit in 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WARP_ROWS = 16;  // one m16 row tile per warp
// rows of a block: packed (query position, group head) rows in bf16, query
// rows of one head in fp32
constexpr int ROWS = WARPS * WARP_ROWS;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;  // (B, T, Hq, Dk)
  const void* k;
  const void* v;
  void* o;
  float* part_o;   // split partials: accumulators, (.., ROWS, Dv)
  float* part_ml;  // and running max (log2 units) and normaliser, (.., ROWS, 2)
  int T, S, Hq, Hkv, Dk, Dv;  // Dv: the whole value width (VS slices of a build's DV)
  // element strides of the batch, sequence and head dims (last dim is dense)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  // the K/V batch row of each query batch row, on the device; null: the same row
  const long long* kv_batch;
  int offset;
  float scale;
  float softcap;  // cap * tanh(s / cap) on the scaled scores; 0: none
  int window;     // keys k > q_pos - window only; 0: none
  int split;   // keys per block of the walk (>= S when the walk is whole)
  int splits;  // blocks along the walk
};

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

// ------------------------------------------------------------ bf16 kernel

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// c += a b for one m16n8k16 tile: a is the 16x16 row-major A fragment, b0
// and b1 the 16x8 column-major B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The shared layout of one (Dk, Dv) variant: Q (ROWS rows), then two K/V
// stages of BN keys; every row padded by 8 elements (16 bytes). VK: V is read
// from the K tile, so a stage holds K alone.
template <int DK, int DV, bool VK = false>
struct Bf16Layout {
  static constexpr int BN = DK + DV > 256 ? 32 : 64;
  static constexpr int LDK = DK + 8;
  static constexpr int LDV = DV + 8;
  static constexpr int STAGE = BN * (LDK + (VK ? 0 : LDV));
  static constexpr int BYTES = (ROWS * LDK + 2 * STAGE) * (int)sizeof(bf16);
  static_assert(ROWS * LDK + 2 * STAGE >= ROWS * (DV + 8),
                "shared memory must hold the output tile");
};

// Packed rows of one (batch, KV head): row R is query position R / G and
// head kvh * G + R % G. Returns the causal end (exclusive) of row tile `tile`.
__host__ __device__ __forceinline__ int tile_kv_end(const Params& p, int G, int tile) {
  const int rows_left = p.T * G - tile * ROWS;
  const int rows_valid = rows_left < ROWS ? rows_left : ROWS;
  const int end = p.offset + (tile * ROWS + rows_valid - 1) / G + 1;
  return end < p.S ? end : p.S;
}

// The first key row tile `tile` reads: 0, or with a window the first key of
// its first row's window (later rows' windows start later)
__host__ __device__ __forceinline__ int tile_kv_begin(const Params& p, int G, int tile) {
  const int first = p.offset + tile * ROWS / G - p.window + 1;
  return p.window > 0 && first > 0 ? first : 0;
}

// The scores of one tile in log2 units: scaled (and softcapped in natural
// units first, when the call has a cap)
__device__ __forceinline__ float score_log2(float s, const Params& p, float scale_log2) {
  if (p.softcap > 0.0f) return p.softcap * tanhf(s * p.scale / p.softcap) * LOG2E;
  return s * scale_log2;
}

// grid (splits, row tiles, batch * Hkv * VS); blocks with the longest walks
// first. OPT: the call has a softcap or a window (else both are ignored). VS
// > 1: V is K's first VS * DV columns, and the block computes the output
// columns [slice * DV, (slice + 1) * DV).
template <int DK, int DV, bool OPT, int VS = 1>
__global__ void __launch_bounds__(THREADS, 2) flash_bf16_kernel(Params p) {
  constexpr bool VK = VS > 1;
  constexpr int DVF = DV * VS;  // the whole value width
  using L = Bf16Layout<DK, DV, VK>;
  constexpr int BN = L::BN, LDK = L::LDK;
  constexpr int LDV = VK ? LDK : L::LDV;  // V's row stride in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + ROWS * LDK;  // stage s at s * STAGE: K, then V

  const int G = p.Hq / p.Hkv;
  const int rows_total = p.T * G;
  const int n_row_tiles = (rows_total + ROWS - 1) / ROWS;
  const int tile = n_row_tiles - 1 - blockIdx.y;
  const int chunk = blockIdx.x;
  const int bh = blockIdx.z / VS;     // batch * Hkv + KV head
  const int slice = blockIdx.z % VS;  // the block's output columns
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int r0 = tile * ROWS;
  const int rows_valid = min(ROWS, rows_total - r0);
  const int kv_end = tile_kv_end(p, G, tile);
  // chunks are cut from the tile's first key (0 without a window)
  const int kb = (OPT ? tile_kv_begin(p, G, tile) : 0) + chunk * p.split;
  if (kb >= kv_end) return;  // the chunk starts past this tile's causal end
  const int ke = min(kb + p.split, kv_end);
  const int n_tiles = (ke - kb + BN - 1) / BN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t4 = lane & 3;  // its column pair within an 8-column tile

  const long long kvb = p.kv_batch ? p.kv_batch[b] : b;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + kvb * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + kvb * p.v_sb + kvh * p.v_sh;

  // Q: packed rows gathered from their (position, head); each row is DK
  // contiguous elements, copied as 16-byte vectors
  {
    constexpr int VPR = DK / 8;
    for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
      const int r = i / VPR;
      const int c = (i % VPR) * 8;
      const int R = r0 + r;
      const bool ok = r < rows_valid;
      const bf16* src = ok ? q + (R / G) * p.q_st + (kvh * G + R % G) * p.q_sh + c : q;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(sQ + r * LDK + c)),
                   "l"(src), "r"(ok ? 16 : 0));
    }
  }
  auto copy_kv = [&](int it, int stage) {
    const int k0 = kb + it * BN;
    const int valid = min(BN, ke - k0);
    bf16* sK = sKV + stage * L::STAGE;
    copy_tile_async(sK, LDK, k + k0 * p.k_ss, p.k_ss, BN, valid, DK);
    if (!VK) copy_tile_async(sK + BN * LDK, LDV, v + k0 * p.v_ss, p.v_ss, BN, valid, DV);
  };
  copy_kv(0, 0);
  cp_async_commit();

  const int wr = r0 + warp * WARP_ROWS;  // the warp's first packed row
  // positions of this lane's rows g and g + 8
  const int pos[2] = {p.offset + (wr + g) / G, p.offset + (wr + g + 8) / G};
  // and the last key outside each one's window (-1: none)
  const int lo[2] = {p.window > 0 ? pos[0] - p.window : -1, p.window > 0 ? pos[1] - p.window : -1};
  const int warp_first_pos = p.offset + wr / G;
  const int warp_last_pos = p.offset + (wr + WARP_ROWS - 1) / G;
  const float scale_log2 = p.scale * LOG2E;

  // ldmatrix row addresses of this lane. A (Q): matrices (rows 0-7, 8-15) x
  // (cols 0-7, 8-15). B from K, two 8-key tiles: (keys 0-7 | 8-15) x (d 0-7,
  // 8-15). B from V, transposed: (keys 0-7, 8-15) x (d 0-7 | 8-15).
  const unsigned q_addr =
      smem_addr(sQ + (warp * WARP_ROWS + (lane & 15)) * LDK + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LDV + (lane >> 4) * 8;
  // V fragments loaded at once, ahead of their products
  constexpr int VG = (DV / 16) % 8 == 0 ? 8 : 4;

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  // running max (log2 units) and this lane's share of the normaliser of
  // rows g and g + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();
    // tile it (and, first time, Q) visible to every warp, and every warp
    // done with tile it - 1, whose stage the next copy refills
    __syncthreads();
    if (it + 1 < n_tiles) {
      copy_kv(it + 1, stage ^ 1);  // in flight during this tile's compute
      cp_async_commit();
    }
    const bf16* sK = sKV + stage * L::STAGE;
    const unsigned k_base = smem_addr(sK + k_off);
    // V: its own tile, or the slice's columns of the K tile
    const unsigned v_base = smem_addr(VK ? sK + slice * DV + v_off : sK + BN * LDK + v_off);

    // S = Q K^T, 16 rows x BN keys per warp; the fragments of step kk + 1
    // are loaded before the products of step kk
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    unsigned qa[2][4], kf[2][BN / 16][4];
    ldsm_x4(qa[0], q_addr);
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) ldsm_x4(kf[0][jj], k_base + jj * 16 * LDK * 2);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < DK / 16) {
        ldsm_x4(qa[cur ^ 1], q_addr + (kk + 1) * 32);
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
          ldsm_x4(kf[cur ^ 1][jj], k_base + (jj * 16 * LDK + (kk + 1) * 16) * 2);
      }
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj) {
        mma_bf16(s[2 * jj], qa[cur], kf[cur][jj][0], kf[cur][jj][1]);
        mma_bf16(s[2 * jj + 1], qa[cur], kf[cur][jj][2], kf[cur][jj][3]);
      }
    }

    // online softmax in log2 units; this lane holds rows g and g + 8,
    // columns 8 j + 2 t4 + {0, 1}
    const int k0 = kb + it * BN;
    const bool masked = k0 + BN > ke || k0 + BN - 1 > warp_first_pos ||
                        (OPT && p.window > 0 && k0 <= warp_last_pos - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = OPT ? score_log2(s[j][e], p, scale_log2) : s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          if (key >= ke || key > pos[e >> 1] || (OPT && key <= lo[e >> 1])) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      // a row with no key yet (a chunk before its position, or a tile
      // before its window) keeps p = 0
      mu[h] = mn == NEG_INF ? 0.0f : mn;
      corr[h] = exp2_approx(m[h] - mu[h]);
      m[h] = mn;
    }
    unsigned pf[BN / 16][4];  // P as the A operand of P V, in place of S
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p00 = exp2_approx(s[j][0] - mu[0]), p01 = exp2_approx(s[j][1] - mu[0]);
      const float p10 = exp2_approx(s[j][2] - mu[1]), p11 = exp2_approx(s[j][3] - mu[1]);
      sum[0] += p00 + p01;
      sum[1] += p10 + p11;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p00, p01);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V, VG fragments of V loaded ahead of their products
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int j0 = 0; j0 < DV / 16; j0 += VG) {
        unsigned vf[VG][4];
#pragma unroll
        for (int jj = 0; jj < VG; ++jj)
          ldsm_x4_trans(vf[jj], v_base + (kk * 16 * LDV + (j0 + jj) * 16) * 2);
#pragma unroll
        for (int jj = 0; jj < VG; ++jj) {
          mma_bf16(o[2 * (j0 + jj)], pf[kk], vf[jj][0], vf[jj][1]);
          mma_bf16(o[2 * (j0 + jj) + 1], pf[kk], vf[jj][2], vf[jj][3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(FULL_MASK, l[h], 2);
  }
  if (p.splits == 1) {
    // the whole walk: O / l, staged in shared memory (free once every warp
    // is past its last tile), then 16-byte stores
    constexpr int LDO = DV + 8;
    bf16* sO = sQ;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * WARP_ROWS + g + 8 * h;
      const float inv = 1.0f / fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        *reinterpret_cast<unsigned*>(sO + row * LDO + 8 * j + 2 * t4) =
            pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      }
    }
    __syncwarp();  // a warp stores only its own rows
    constexpr int VPR = DV / 8;
    bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + slice * DV;
    for (int i = lane; i < WARP_ROWS * VPR; i += 32) {
      const int r = warp * WARP_ROWS + i / VPR;
      const int c = (i % VPR) * 8;
      if (r < rows_valid) {
        const int R = r0 + r;
        *reinterpret_cast<uint4*>(out + (R / G) * p.o_st + (kvh * G + R % G) * p.o_sh + c) =
            *reinterpret_cast<const uint4*>(sO + r * LDO + c);
      }
    }
  } else {
    const size_t base = ((size_t)(bh * n_row_tiles + tile) * p.splits + chunk) * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * WARP_ROWS + g + 8 * h;
      if (row >= rows_valid) continue;
      float* dst = p.part_o + (base + row) * DVF + slice * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      }
      if (t4 == 0 && slice == 0) {  // every slice holds the same max and sum
        p.part_ml[2 * (base + row)] = m[h];
        p.part_ml[2 * (base + row) + 1] = l[h];
      }
    }
  }
}

// Merge the chunks of a few rows of one (row tile, batch, KV head), one
// row per Dv / 4 threads: rescale each chunk's accumulator and normaliser to
// the common max, add, divide. Only the chunks below the tile's causal end
// were written; every row sees its own key, so the common max is finite, and
// a chunk that holds none of a row's keys (max -1e30, sum 0) weighs 0.
// grid (row tiles x blocks per tile, batch * Hkv).
__host__ __device__ constexpr int merge_rows_per_block(int Dv) { return THREADS / (Dv / 4); }

__global__ void __launch_bounds__(THREADS) flash_merge_kernel(Params p) {
  const int G = p.Hq / p.Hkv;
  const int rows_total = p.T * G;
  const int n_row_tiles = (rows_total + ROWS - 1) / ROWS;
  const int per_row = p.Dv / 4;  // threads per row, 4 columns each
  const int rows_per_block = merge_rows_per_block(p.Dv);
  const int blocks_per_tile = (ROWS + rows_per_block - 1) / rows_per_block;
  const int tile = blockIdx.x / blocks_per_tile;
  const int r = (blockIdx.x % blocks_per_tile) * rows_per_block + threadIdx.x / per_row;
  const int r0 = tile * ROWS;
  if (threadIdx.x >= rows_per_block * per_row || r >= min(ROWS, rows_total - r0)) return;
  const int b = blockIdx.y / p.Hkv;
  const int kvh = blockIdx.y % p.Hkv;
  const int n = (tile_kv_end(p, G, tile) - tile_kv_begin(p, G, tile) + p.split - 1) / p.split;
  const int c = (threadIdx.x % per_row) * 4;
  const size_t first = ((size_t)blockIdx.y * n_row_tiles + tile) * p.splits * ROWS + r;
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, p.part_ml[2 * (first + (size_t)s * ROWS)]);
  float l = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int s = 0; s < n; ++s) {
    const size_t row = first + (size_t)s * ROWS;
    const float w = exp2_approx(p.part_ml[2 * row] - mx);
    l += w * p.part_ml[2 * row + 1];
    const float4 x = *reinterpret_cast<const float4*>(p.part_o + row * p.Dv + c);
    a0 += w * x.x;
    a1 += w * x.y;
    a2 += w * x.z;
    a3 += w * x.w;
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  const int R = r0 + r;
  uint2 packed;
  packed.x = pack_bf16(a0 * inv, a1 * inv);
  packed.y = pack_bf16(a2 * inv, a3 * inv);
  bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb;
  *reinterpret_cast<uint2*>(out + (R / G) * p.o_st + (kvh * G + R % G) * p.o_sh + c) = packed;
}

template <int DK, int DV, bool OPT, int VS = 1>
cudaError_t prepare_bf16() {
  return cudaFuncSetAttribute(flash_bf16_kernel<DK, DV, OPT, VS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Bf16Layout<DK, DV, (VS > 1)>::BYTES);
}

cudaError_t launch_merge(const Params& p, int B, int row_tiles, cudaStream_t stream) {
  const int per_tile = (ROWS + merge_rows_per_block(p.Dv) - 1) / merge_rows_per_block(p.Dv);
  flash_merge_kernel<<<dim3(row_tiles * per_tile, B * p.Hkv), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 build with the options (OPT) or without
template <bool OPT>
struct LaunchBf16 {
  const Params& p;
  int B;
  cudaStream_t stream;
  template <int DK, int DV>
  cudaError_t run() const {
    cudaError_t err = prepare_bf16<DK, DV, OPT>();
    if (err != cudaSuccess) return err;
    const int row_tiles = (p.T * (p.Hq / p.Hkv) + ROWS - 1) / ROWS;
    const dim3 grid(p.splits, row_tiles, B * p.Hkv);
    flash_bf16_kernel<DK, DV, OPT><<<grid, THREADS, Bf16Layout<DK, DV>::BYTES, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.splits == 1) return err;
    return launch_merge(p, B, row_tiles, stream);
  }
};

// The MLA build (values from K, Dk 576, Dv 512 in VS = 4 slices of 128)
constexpr int MLA_DK = 576, MLA_DV = 512, MLA_VS = 4;

// A split build compiles the MLA and fp32 launches in its main part alone
// (a function that launches a template kernel instantiates it)
#if !(defined(MST_PART_PLAIN) || defined(MST_PART_OPT))
cudaError_t launch_mla(const Params& p, int B, cudaStream_t stream) {
  constexpr int DV = MLA_DV / MLA_VS;
  using L = Bf16Layout<MLA_DK, DV, true>;
  cudaError_t err = prepare_bf16<MLA_DK, DV, false, MLA_VS>();
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.T * (p.Hq / p.Hkv) + ROWS - 1) / ROWS;
  const dim3 grid(p.splits, row_tiles, B * p.Hkv * MLA_VS);
  flash_bf16_kernel<MLA_DK, DV, false, MLA_VS><<<grid, THREADS, L::BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_merge(p, B, row_tiles, stream);
}
#endif

// Shared bytes, registers per thread, resident blocks per SM and local
// bytes per thread of a variant (with the options or without).
template <bool OPT>
struct InfoBf16 {
  long long* out;
  template <int DK, int DV>
  cudaError_t run() const {
    const auto kernel = flash_bf16_kernel<DK, DV, OPT>;
    cudaError_t err = prepare_bf16<DK, DV, OPT>();
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                        Bf16Layout<DK, DV>::BYTES);
    out[0] = Bf16Layout<DK, DV>::BYTES;
    out[1] = attr.numRegs;
    out[2] = blocks;
    out[3] = (long long)attr.localSizeBytes;
    return err;
  }
};

template <int DK, typename F>
cudaError_t for_dv(int Dv, const F& f) {
  switch (Dv) {
    case 64: return f.template run<DK, 64>();
    case 128: return f.template run<DK, 128>();
    case 192: return f.template run<DK, 192>();
    case 256: return f.template run<DK, 256>();
    default: return cudaErrorInvalidValue;
  }
}

// Calls f.run<Dk, Dv>() for the variant of these head dims.
template <typename F>
cudaError_t for_dims(int Dk, int Dv, const F& f) {
  switch (Dk) {
    case 64: return for_dv<64>(Dv, f);
    case 128: return for_dv<128>(Dv, f);
    case 192: return for_dv<192>(Dv, f);
    case 256: return for_dv<256>(Dv, f);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- fp32 kernel (tests only)

constexpr int F32_BK = 32;  // keys per tile: keeps D = 256 inside 227 KB
constexpr int F32_PAD = 4;  // every shared row padded by 16 bytes

// S[this warp's rows, 0:BK] = Q K^T; lane j owns key column j. Q's row r
// is at Q + min(r, q_rows - 1) * ldq (shared memory, or device memory in the
// MLA build, where rows past the chunk must not be read).
__device__ void scores_f32(const float* Q, long long ldq, int q_rows, const float* sK,
                           float* sS, int Dk, int ld, int lds, int warp, int lane) {
  for (int r = 0; r < WARP_ROWS; ++r) {
    const int row = warp * WARP_ROWS + r;
    const float* qr = Q + min(row, q_rows - 1) * ldq;
    for (int j = lane; j < F32_BK; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < Dk; ++d) s = fmaf(qr[d], sK[j * ld + d], s);
      sS[row * lds + j] = s;
    }
  }
}

// O[this warp's rows, :] += P V, O in shared memory.
__device__ void accumulate_f32(const float* sP, int ldp, const float* sV, int ldv, float* sO,
                               int ldo, int Dv, int warp, int lane) {
  for (int r = 0; r < WARP_ROWS; ++r) {
    const int row = warp * WARP_ROWS + r;
    for (int n = lane; n < Dv; n += 32) {
      float acc = sO[row * ldo + n];
      for (int j = 0; j < F32_BK; ++j) acc = fmaf(sP[row * ldp + j], sV[j * ldv + n], acc);
      sO[row * ldo + n] = acc;
    }
  }
}

// Shared memory of one fp32 block: Q, STAGES K/V tile pairs, P, S and O,
// all with padded rows (VK: no Q, and K tiles alone).
template <int STAGES, bool VK = false>
size_t f32_shared_bytes(int Dk, int Dv) {
  constexpr int P = F32_PAD;
  return (size_t)((VK ? 0 : ROWS * (Dk + P)) + STAGES * F32_BK * (Dk + P + (VK ? 0 : Dv + P)) +
                  ROWS * (F32_BK + P) + ROWS * (F32_BK + P) +
                  ROWS * (Dv + P)) *
         sizeof(float);
}

// One block of 4 warps per (batch, query head, 64-row query tile). VK: V is
// K's first Dv columns (read from the K tile) and Q is read in place.
template <int STAGES, bool VK = false>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(Params p) {
  constexpr int BK = F32_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dk = p.Dk, Dv = p.Dv;
  const int ldk = Dk + F32_PAD, ldv = VK ? ldk : Dv + F32_PAD;
  constexpr int ldp = BK + F32_PAD, lds = BK + F32_PAD;
  const int ldo = Dv + F32_PAD;
  const int stage_elems = BK * (ldk + (VK ? 0 : ldv));
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + (VK ? 0 : ROWS * ldk);
  float* sP = sKV + STAGES * stage_elems;
  float* sS = sP + ROWS * ldp;
  float* sO = sS + ROWS * lds;

  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_valid = min(ROWS, p.T - q0);
  // The causal bound: no key past the tile's last query position is read,
  // and with a window none before its first query's window.
  const int kv_end = min(p.S, p.offset + q0 + q_valid);
  const int kv_begin = p.window > 0 ? max(0, p.offset + q0 - p.window + 1) : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  const long long kvb = p.kv_batch ? p.kv_batch[b] : b;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + q0 * p.q_st + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + kvb * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + kvb * p.v_sb + kvh * p.v_sh;
  auto copy_kv = [&](int tile, int stage) {
    const int k0 = kv_begin + tile * BK;
    const int k_valid = min(BK, kv_end - k0);
    float* sK = sKV + stage * stage_elems;
    copy_tile_async(sK, ldk, k + k0 * p.k_ss, p.k_ss, BK, k_valid, Dk);
    if (!VK) copy_tile_async(sK + BK * ldk, ldv, v + k0 * p.v_ss, p.v_ss, BK, k_valid, Dv);
  };

  if (!VK) copy_tile_async(sQ, ldk, q, p.q_st, ROWS, q_valid, Dk);
  copy_kv(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < ROWS * ldo; i += THREADS) sO[i] = 0.0f;

  // this warp's rows; every lane holds every row's running max and
  // normaliser (the butterfly reductions leave the same value in all lanes)
  float* sSw = sS + warp * WARP_ROWS * lds;
  float* sPw = sP + warp * WARP_ROWS * ldp;
  float* sOw = sO + warp * WARP_ROWS * ldo;
  const int q_pos0 = p.offset + q0 + warp * WARP_ROWS;  // position of the warp's row 0
  float m[WARP_ROWS], l[WARP_ROWS];
#pragma unroll
  for (int r = 0; r < WARP_ROWS; ++r) {
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
    const float* sK = sKV + stage * stage_elems;
    const float* sV = VK ? sK : sK + BK * ldk;
    const int k0 = kv_begin + it * BK;
    const int k_valid = min(BK, kv_end - k0);

    if (VK) scores_f32(q, p.q_st, q_valid, sK, sS, Dk, ldk, lds, warp, lane);
    else scores_f32(sQ, ldk, ROWS, sK, sS, Dk, ldk, lds, warp, lane);
    __syncwarp();

    // online softmax over the warp's 16 rows at once; lane owns column lane
    float x[WARP_ROWS], mx[WARP_ROWS];
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) {
      float s = sSw[r * lds + lane] * p.scale;
      if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
      const int key = k0 + lane, qp = q_pos0 + r;
      x[r] = (lane < k_valid && key <= qp && (p.window <= 0 || key > qp - p.window)) ? s : NEG_INF;
      mx[r] = x[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < WARP_ROWS; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], o));
    }
    float corr[WARP_ROWS], sum[WARP_ROWS];
    bool rescale = false;  // the same in every lane
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no key yet (a tile before its window) keeps p = 0
      const float mu = m_new == NEG_INF ? 0.0f : m_new;
      corr[r] = expf(m[r] - mu);
      rescale |= m_new != m[r];
      m[r] = m_new;
      const float pr = expf(x[r] - mu);
      sPw[r * ldp + lane] = pr;
      sum[r] = pr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < WARP_ROWS; ++r) sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], o);
    }
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) l[r] = l[r] * corr[r] + sum[r];
    if (rescale) {
#pragma unroll
      for (int r = 0; r < WARP_ROWS; ++r) {
        for (int c = lane; c < Dv; c += 32) sOw[r * ldo + c] *= corr[r];
      }
    }
    __syncwarp();
    accumulate_f32(sP, ldp, sV, ldv, sO, ldo, Dv, warp, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (STAGES == 1 && it + 1 < n_tiles) {
      copy_kv(it + 1, 0);
      cp_async_commit();
    }
  }

  float* o = static_cast<float*>(p.o) + b * p.o_sb + q0 * p.o_st + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < WARP_ROWS; ++r) {
    const int row = warp * WARP_ROWS + r;
    if (row < q_valid) {
      for (int c = lane; c < Dv; c += 32) {
        o[row * p.o_st + c] = sOw[r * ldo + c] / fmaxf(l[r], 1e-30f);
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

// Two K/V stages where they fit, else one.
int f32_stages(int Dk, int Dv) {
  return f32_shared_bytes<2>(Dk, Dv) <= (size_t)max_shared_per_block() ? 2 : 1;
}

template <int STAGES, bool VK = false>
cudaError_t launch_f32_stages(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = f32_shared_bytes<STAGES, VK>(p.Dk, p.Dv);
  if (smem > (size_t)max_shared_per_block()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<STAGES, VK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + ROWS - 1) / ROWS, p.Hq, B);
  flash_f32_kernel<STAGES, VK><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

#if !(defined(MST_PART_PLAIN) || defined(MST_PART_OPT))
cudaError_t launch_f32(const Params& p, int B, bool vk, cudaStream_t stream) {
  if (vk) return launch_f32_stages<1, true>(p, B, stream);
  return f32_stages(p.Dk, p.Dv) == 2 ? launch_f32_stages<2>(p, B, stream)
                                     : launch_f32_stages<1>(p, B, stream);
}
#endif

// Blocks along the longest row tile's walk for `split` keys per block (0:
// one block); ops/flash_attention.py::num_splits sizes the partials the
// same way.
int num_splits(const Params& p, int split) {
  if (split <= 0) return 1;
  const int G = p.Hq / p.Hkv;
  const int tiles = (p.T * G + ROWS - 1) / ROWS;
  int n = 1;
  for (int tile = 0; tile < tiles; ++tile) {
    const int len = tile_kv_end(p, G, tile) - tile_kv_begin(p, G, tile);
    const int chunks = (len + split - 1) / split;
    if (chunks > n) n = chunks;
  }
  return n;
}

}  // namespace

// The library is built as three translation units, compiled in parallel and
// linked into one (ops/flash_attention.py names the parts): MST_PART_PLAIN
// holds the bf16 build without the options, MST_PART_OPT the one with them,
// and MST_PART_MAIN the MLA build, the fp32 kernel and the entry points,
// which pass a bf16 call to its part (p a Params). Without any of the macros
// this file holds everything.
#if defined(MST_PART_PLAIN) || defined(MST_PART_OPT) || defined(MST_PART_MAIN)
#define MST_SPLIT 1
#endif

// One bf16 build's launch and its attributes, in its part
#define MST_BF16_BUILD(NAME, OPT)                                                      \
  int mst_flash_bf16_##NAME(const void* p, int B, void* stream) {                      \
    const Params& params = *static_cast<const Params*>(p);                             \
    return (int)for_dims(params.Dk, params.Dv,                                         \
                         LaunchBf16<OPT>{params, B, static_cast<cudaStream_t>(stream)}); \
  }                                                                                    \
  int mst_flash_bf16_info_##NAME(int Dk, int Dv, long long* out) {                     \
    return (int)for_dims(Dk, Dv, InfoBf16<OPT>{out});                                  \
  }

extern "C" {

#if !defined(MST_SPLIT) || defined(MST_PART_PLAIN)
MST_BF16_BUILD(plain, false)
#endif
#if !defined(MST_SPLIT) || defined(MST_PART_OPT)
MST_BF16_BUILD(opt, true)
#endif

#if !defined(MST_SPLIT) || defined(MST_PART_MAIN)
#ifdef MST_SPLIT
int mst_flash_bf16_plain(const void*, int, void*);
int mst_flash_bf16_info_plain(int, int, long long*);
int mst_flash_bf16_opt(const void*, int, void*);
int mst_flash_bf16_info_opt(int, int, long long*);
#endif

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in the
// order q (b, t, h), k (b, s, h), v (b, s, h), o (b, t, h). softcap: the
// logit cap (0: none); window: the sliding window (0: none). split (bf16
// only; the fp32 kernel walks whole): keys per block of the walk, a multiple
// of 64, or 0 for the whole walk in one block. With more than one split,
// part_o and part_ml hold B * Hkv * row tiles * splits * 64 rows of Dv and
// 2 floats (row tiles of 64 packed (query position, group head) rows).
// values_from_k: v is k's first Dv columns (a view with k's strides): the
// MLA builds, which take no softcap or window; in bf16 only at Dk 576 / Dv
// 512. kv_batch: null, or B int64 on the device, the batch row of k and v
// that query batch row b reads (k and v then hold any number of rows).
// Returns the cudaError_t of the launches (0 on success); the caller checks
// it.
int mst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* part_o,
                            void* part_ml, int dtype, int B, int T, int S, int Hq, int Hkv,
                            int Dk, int Dv, const long long* strides, int offset, float scale,
                            float softcap, int window, int split, int values_from_k,
                            const void* kv_batch, void* stream) {
  const bool vk = values_from_k != 0;
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || offset < 0 || split < 0 ||
      split % 64 || softcap < 0.0f || window < 0 ||
      (vk && (v != k || Dv > Dk || softcap > 0.0f || window > 0)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
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
  p.kv_batch = static_cast<const long long*>(kv_batch);
  p.offset = offset;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.split = S;
    p.splits = 1;
    return (int)launch_f32(p, B, vk, s);
  }
  if (dtype != 1 || (vk && (Dk != MLA_DK || Dv != MLA_DV))) return (int)cudaErrorInvalidValue;
  p.splits = num_splits(p, split);
  p.split = p.splits > 1 ? split : S;
  if (p.splits > 1 && (part_o == nullptr || part_ml == nullptr)) return (int)cudaErrorInvalidValue;
  if (vk) return (int)launch_mla(p, B, s);
  return p.softcap > 0.0f || p.window > 0 ? mst_flash_bf16_opt(&p, B, stream)
                                          : mst_flash_bf16_plain(&p, B, stream);
}

const char* mst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The bf16 variant for (Dk, Dv), with the softcap and window (options = 1)
// or without: out[0..3] = shared bytes per block, registers per thread,
// resident blocks per SM, local (spill) bytes per thread. Returns the
// cudaError_t of the queries.
int mst_flash_attention_kernel_info(int Dk, int Dv, int options, long long* out) {
  return options ? mst_flash_bf16_info_opt(Dk, Dv, out) : mst_flash_bf16_info_plain(Dk, Dv, out);
}

// The same of the MLA build (Dk 576, Dv 512 read from K).
int mst_flash_attention_mla_info(long long* out) {
  constexpr int DV = MLA_DV / MLA_VS;
  const auto kernel = flash_bf16_kernel<MLA_DK, DV, false, MLA_VS>;
  constexpr int bytes = Bf16Layout<MLA_DK, DV, true>::BYTES;
  cudaError_t err = prepare_bf16<MLA_DK, DV, false, MLA_VS>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, bytes);
  out[0] = bytes;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (long long)attr.localSizeBytes;
  return (int)err;
}
#endif  // MST_PART_MAIN

}  // extern "C"
