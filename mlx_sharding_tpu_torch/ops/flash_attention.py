"""Flash prefill attention: the CUDA kernel's wrapper, its plain version, the
plan of its split key walk and its launch counter.

Port of ``mlx_sharding_tpu/ops/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The kernel is ``csrc/flash_attention.cu``, written by
hand for Hopper (``sm_90a``); its header says what bounds it on the card
and what the design does about that. It is compiled with ``nvcc`` on first
use into ``_build/`` and loaded with ``ctypes`` (``cuda_library.py``): no
PyTorch headers, so the build takes seconds.

In bf16 a block owns one (batch, KV head) and ``BLOCK_ROWS`` rows of the
packed (query position, head of the group) set; when those blocks do not
fill the card, the walk over each row tile's causal prefix is split into
chunks of keys (:func:`plan_split`), whose partial results a second kernel
merges. Both launches are one call and one count.

Gemma-2's logit softcap and sliding window are options of the kernel and of
its T=1 route, computed as the JAX package's plain path computes them:
scaled scores, then ``cap * tanh(s / cap)``, then the mask ``q_pos - window
< k_pos <= q_pos``. With a window a row tile's walk starts at its first
row's window (:func:`tile_kv_range`): key tiles before it are skipped, and
the split plan cuts the walk from there.

DeepSeek-V2's compressed MLA layout passes ``v`` as a view of ``k``'s first
columns (``k[..., :rank]``): the kernel's MLA build (Dk 576, Dv 512, any
GQA group) reads the values from the K rows it has already copied, and the
T=1 route sends such a call to the paged kernel's ``values_from_k``.

``kv_index`` (a (B,) int64 device tensor) makes query batch row b read the
batch row ``kv_index[b]`` of k and v, which may hold any number of rows: the
dense continuous-batching engine prefills one slot of its (M+1, S, Hkv, D)
slot caches, and the slot is a device value, so one captured chunk serves
every slot. Without it the kernel reads row b, as before.

On a CUDA tensor :func:`flash_attention` launches the kernel or raises; on a
CPU tensor it computes :func:`flash_attention_reference`, the plain version
of the same function. There is no other route and no fallback.

The TPU kernel's T=1 route (JAX ``MST_FLASH_DECODE=1``: one decode query at
the cache's offset, read on the device, over the full-capacity cache) is
:func:`flash_decode`. On the card it is the ragged paged kernel
(``csrc/paged_attention.cu``) over the dense cache seen as pages: a layer's
contiguous (B, S, Hkv, D) buffer is viewed, without a copy, as B·S/page
pages of ``DECODE_PAGE`` positions, row b's page table is the identity run
of its own pages (made once per shape), and the lengths ``position + 1``
are a device tensor (:func:`decode_lengths`, once per step for every
layer). One call is one launch that reads only the prefix and needs no
host read, so a captured decode step serves every position. On a CPU
tensor it computes :func:`flash_decode_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.ops import paged_attention as paged
from mlx_sharding_tpu_torch.graphs import count_launch
from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

NEG_INF = -1e30
HEAD_DIM_ALIGN = 64
#: the bf16 kernel's builds: Dk and Dv each one of these, or MLA's (Dk, Dv)
#: with V read from K, whose value columns run in ``MLA_VALUE_SLICES`` blocks
BF16_HEAD_DIMS = (64, 128, 192, 256)
MLA_HEAD_DIMS = (576, 512)
MLA_VALUE_SLICES = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: packed (query position, group head) rows of one bf16 block
BLOCK_ROWS = 64
#: keys of the causal walk one bf16 block takes on the card: None lets
#: :func:`plan_split` choose from the shapes and the card's SM count; 0 walks
#: each row tile's whole prefix in one block, with no merge pass; a multiple
#: of ``SPLIT_ALIGN`` forces chunks of that many keys. The checks set it.
SPLIT_KEYS: Optional[int] = None
SPLIT_ALIGN = 64
#: the planner's shortest chunk, and the blocks an SM holds at once (the
#: occupancy of the D = 128 variant, which chip_smoke.py prints)
MIN_SPLIT = 1024
RESIDENT_BLOCKS = 2
#: positions of one page of the dense cache's paged view (the T=1 route):
#: the dispatch sends it capacities that are multiples of 128
DECODE_PAGE = 128


def _bind(lib: ctypes.CDLL) -> None:
    lib.mst_flash_attention_fwd.restype = ctypes.c_int
    lib.mst_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,  # split partials: accumulators, max and normaliser
        ctypes.c_int,  # dtype code
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, T, S
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Hq, Hkv, Dk, Dv
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides
        ctypes.c_int, ctypes.c_float,  # offset, scale
        ctypes.c_float, ctypes.c_int,  # logit softcap (0: none), sliding window (0: none)
        ctypes.c_int,  # split
        ctypes.c_int,  # values_from_k: v is k's first Dv columns
        ctypes.c_void_p,  # kv_batch: the K/V batch row of each query row (null: the same)
        ctypes.c_void_p,  # stream
    ]
    lib.mst_flash_attention_kernel_info.restype = ctypes.c_int
    lib.mst_flash_attention_kernel_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.mst_flash_attention_mla_info.restype = ctypes.c_int
    lib.mst_flash_attention_mla_info.argtypes = [ctypes.POINTER(ctypes.c_longlong)]


_LIBRARY = CudaLibrary("flash_attention.cu", _bind,
                       parts=("MST_PART_PLAIN", "MST_PART_OPT", "MST_PART_MAIN"))
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def kernel_info(dk: int, dv: int, options: bool = False) -> dict:
    """The bf16 variant's shared bytes per block, registers per thread,
    resident blocks per SM and local (spill) bytes per thread, as the CUDA
    runtime reports them on the current card; ``options``: the build that
    takes a softcap and a window; (576, 512): the MLA build."""
    out = (ctypes.c_longlong * 4)()
    lib = _LIBRARY.get()
    err = (lib.mst_flash_attention_mla_info(out) if (dk, dv) == MLA_HEAD_DIMS else
           lib.mst_flash_attention_kernel_info(dk, dv, int(options), out))
    _LIBRARY.check(err, "kernel_info")
    return dict(shared_bytes=out[0], registers=out[1], blocks_per_sm=out[2], local_bytes=out[3])


def row_tiles(t: int, groups: int) -> int:
    """Row tiles of one (batch, KV head): T x G packed rows, ``BLOCK_ROWS`` each."""
    return -(-t * groups // BLOCK_ROWS)


def tile_kv_end(t: int, groups: int, s: int, offset: int, tile: int) -> int:
    """The causal end (exclusive) of row tile ``tile``: one past the last
    position of its rows, packed row r being position r // G."""
    last_row = min((tile + 1) * BLOCK_ROWS, t * groups) - 1
    return min(s, offset + last_row // groups + 1)


def tile_kv_range(t: int, groups: int, s: int, offset: int, tile: int,
                  window: Optional[int] = None) -> tuple:
    """The keys ``[first, end)`` row tile ``tile`` reads: from 0, or with a
    sliding window from its first row's window (later rows' windows start
    later), to its causal end."""
    first = max(0, offset + tile * BLOCK_ROWS // groups - window + 1) if window else 0
    return first, tile_kv_end(t, groups, s, offset, tile)


def longest_walk(t: int, groups: int, s: int, offset: int, window: Optional[int] = None) -> int:
    """Keys of the longest row tile's walk."""
    return max(e - f for f, e in (tile_kv_range(t, groups, s, offset, i, window)
                                  for i in range(row_tiles(t, groups))))


def num_splits(t: int, s: int, offset: int, split: int, groups: int = 1,
               window: Optional[int] = None) -> int:
    """Blocks along the longest row tile's walk for ``split`` keys per block
    (0: one); ``groups`` (Hq / Hkv) matters only with a window."""
    return -(-longest_walk(t, groups, s, offset, window) // split) if split else 1


def plan_split(b: int, t: int, s: int, hq: int, hkv: int, offset: int, sms: int,
               window: Optional[int] = None, value_slices: int = 1) -> int:
    """Keys per block of the bf16 walk, 0 for the whole walk. The walk is
    split only when the (row tile, KV head, batch) blocks leave room for
    two or more times as many in one wave of ``RESIDENT_BLOCKS`` per SM:
    then into as many chunks as that wave holds, if each keeps at least
    ``MIN_SPLIT`` keys (a shorter walk pays more for its partials and the
    merge than the extra blocks give back). The walk is the longest row
    tile's, which a sliding window shortens; ``value_slices``: the blocks
    that share a row tile's walk along its value columns (the MLA build)."""
    kv_len = longest_walk(t, hq // hkv, s, offset, window)
    chunks = RESIDENT_BLOCKS * sms // (b * hkv * row_tiles(t, hq // hkv) * value_slices)
    if chunks < 2:
        return 0
    split = -(-kv_len // chunks)
    split = -(-split // SPLIT_ALIGN) * SPLIT_ALIGN
    return split if MIN_SPLIT <= split < kv_len else 0


def split_chunks(t: int, groups: int, s: int, offset: int, split: int,
                 window: Optional[int] = None) -> list:
    """For each row tile, the (first, end) key ranges of the blocks that do
    work, as the kernel walks them: chunk c of ``split`` keys from the
    tile's first key is launched for every tile and returns at once where
    it starts at or past the tile's causal end."""
    plan = []
    n = num_splits(t, s, offset, split, groups, window)
    for tile in range(row_tiles(t, groups)):
        first, kv_end = tile_kv_range(t, groups, s, offset, tile, window)
        step = split or s
        plan.append([(kb, min(kb + step, kv_end))
                     for kb in (first + c * step for c in range(n)) if kb < kv_end])
    return plan


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_reference(
    q, k, v, offset: int, scale: float, *,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    probs_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version: softmax over the causal prefix in fp32, the same
    function the kernel computes (and the TPU kernel before it).

    It is also the plain grouped-GQA path of ``causal_attention`` for the
    chunks the kernel does not take (T not a multiple of 128), which rounds
    the probs to ``probs_dtype`` (v's dtype) before the product, as the JAX
    package's plain path does."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    # keys at or past offset + T are masked for every query: leave them out
    kv_len = min(s, offset + t)
    qg = q.reshape(b, t, hkv, hq // hkv, dk).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k[:, :kv_len].float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    q_pos = offset + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(kv_len, device=q.device)[None, :]
    allowed = k_pos <= q_pos
    if sliding_window is not None:
        allowed &= k_pos > q_pos - sliding_window
    probs = torch.softmax(scores.masked_fill(~allowed, NEG_INF), dim=-1)
    if probs_dtype is not None:
        probs = probs.to(probs_dtype).float()
    out = torch.einsum("bhgts,bshd->bthgd", probs, v[:, :kv_len].float())
    return out.reshape(b, t, hq, dv).to(q.dtype)


def flash_attention_split_reference(q, k, v, offset: int, scale: float, split: int, *,
                                    logit_softcap: Optional[float] = None,
                                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """The bf16 kernel's walk in plain PyTorch, in fp32, for the tests: the
    packed row tiles, each chunk of :func:`split_chunks` as one block that
    keeps its running max (log2 units), normaliser and accumulator, then the
    merge that rescales the chunks to their common max. A chunk that holds
    none of a row's keys keeps max -1e30 and sum 0, and weighs nothing."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    # (B, Hkv, T*G, D): packed row r is position r // G, head kvh*G + r % G
    qp = q.float().reshape(b, t, hkv, g, dk).permute(0, 2, 1, 3, 4).reshape(b, hkv, t * g, dk)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # (B, Hkv, S, D)
    pos = offset + torch.arange(t * g, device=q.device) // g
    out = torch.empty((b, hkv, t * g, dv), dtype=torch.float32, device=q.device)
    for tile, chunks in enumerate(split_chunks(t, g, s, offset, split, sliding_window)):
        r = slice(tile * BLOCK_ROWS, min((tile + 1) * BLOCK_ROWS, t * g))
        parts = []
        for kb, ke in chunks:
            sc = qp[:, :, r] @ kf[:, :, kb:ke].transpose(-1, -2) * scale
            if logit_softcap is not None:
                sc = logit_softcap * torch.tanh(sc / logit_softcap)
            sc = sc * math.log2(math.e)
            keys = torch.arange(kb, ke, device=q.device)
            out_of_reach = keys[None, :] > pos[r, None]
            if sliding_window is not None:
                out_of_reach |= keys[None, :] <= pos[r, None] - sliding_window
            sc = sc.masked_fill(out_of_reach, NEG_INF)
            m = sc.amax(-1)
            m_use = torch.where(m == NEG_INF, torch.zeros_like(m), m)
            p = torch.exp2(sc - m_use[..., None])
            parts.append((m, p.sum(-1), p @ vf[:, :, kb:ke]))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - mx) for m, _, _ in parts]
        l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[:, :, r] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hkv, t, g, dv).permute(0, 2, 1, 3, 4).reshape(b, t, hq, dv).to(q.dtype)


def values_from_k(k, v) -> bool:
    """True when ``v`` is a view of ``k``'s first columns (MLA's compressed
    layout: ``k[..., :rank]``)."""
    return (v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
            and v.shape[:-1] == k.shape[:-1] and v.shape[-1] < k.shape[-1])


def select_kv_rows(k, v, kv_index: torch.Tensor) -> tuple:
    """The rows ``kv_index`` of k and v, copied (the plain version's
    operands); v stays a view of the selected k's first columns when it was
    one of k's (MLA)."""
    ks = k.index_select(0, kv_index)
    return ks, (ks[..., : v.shape[-1]] if values_from_k(k, v) else v.index_select(0, kv_index))


def _check(q, k, v, offset: int, kv_index=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, T, Hq, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)")
    b, t, hq, dk = q.shape
    if kv_index is not None:
        if (kv_index.shape != (b,) or kv_index.dtype != torch.int64
                or kv_index.device != q.device):
            raise ValueError(f"kv_index must be a ({b},) int64 tensor on {q.device}")
        b = k.shape[0]  # any number of K/V rows
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2]:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape[-1] != dk:
        raise ValueError(f"q and k head dims differ: {dk} vs {k.shape[-1]}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads do not group over {k.shape[2]} KV heads")
    dv = v.shape[-1]
    for name, d in (("Dk", dk), ("Dv", dv)):
        if d % HEAD_DIM_ALIGN or d <= 0:
            raise ValueError(f"{name}={d}: the flash kernel takes head dims that are multiples "
                             f"of {HEAD_DIM_ALIGN}")
    if t < 1 or offset < 0:
        raise ValueError(f"need T >= 1 and offset >= 0, got T={t} offset={offset}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPE_CODES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, offset: int, scale: float, *,
                    logit_softcap: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    kv_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention of a prefill chunk over the full-capacity cache.

    q (B, T, Hq, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv); query row i sits
    at absolute position ``offset + i`` (a host int) and sees keys at or
    before it (and, with ``sliding_window``, after ``offset + i -
    sliding_window``); ``logit_softcap`` caps the scaled scores. Returns
    (B, T, Hq, Dv) in q's dtype. ``kv_index`` (B,) int64 on q's device:
    query row b reads row ``kv_index[b]`` of k and v, which then hold any
    number of rows. CUDA tensors launch the kernel, with its merge pass
    when the bf16 walk is split (counted once in
    ``flash_attention.launches``); CPU tensors take
    :func:`flash_attention_reference` (over the selected rows)."""
    _check(q, k, v, offset, kv_index)
    cap, window = paged.kernel_options(logit_softcap, sliding_window)
    if q.device.type == "cpu":
        if kv_index is not None:
            k, v = select_kv_rows(k, v, kv_index)
        return flash_attention_reference(q, k, v, offset, scale, logit_softcap=logit_softcap,
                                         sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    vk = values_from_k(k, v)
    dims = (q.shape[-1], v.shape[-1])
    if q.dtype == torch.bfloat16 and not (
            (vk and dims == MLA_HEAD_DIMS and cap == 0.0 and window == 0)
            or (not vk and set(dims) <= set(BF16_HEAD_DIMS))):
        raise ValueError(
            f"the bf16 flash kernel is built for head dims (Dk, Dv) in {BF16_HEAD_DIMS}, or "
            f"{MLA_HEAD_DIMS} with v a view of k's first columns and no softcap or window; "
            f"got {dims}{' (v from k)' if vk else ''}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a dense last dim, 16-byte aligned rows and "
                f"strides that are multiples of {vec} elements; got {x.stride()}"
            )
    if kv_index is not None and not kv_index.is_contiguous():
        raise ValueError("kv_index must be contiguous")
    b, t, hq, _ = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    offset = int(offset)
    out = torch.empty((b, t, hq, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    split, part_o, part_ml = 0, None, None
    if q.dtype == torch.bfloat16:  # the fp32 kernel always walks whole
        split = SPLIT_KEYS
        if split is None:
            split = plan_split(b, t, s, hq, hkv, offset, _sm_count(q.device.index or 0),
                               sliding_window, MLA_VALUE_SLICES if vk else 1)
        if split < 0 or split % SPLIT_ALIGN:
            raise ValueError(f"SPLIT_KEYS must be None, 0 or a multiple of {SPLIT_ALIGN}")
        splits = num_splits(t, s, offset, split, hq // hkv, sliding_window)
        if splits > 1:  # scratch of the split walk, merged by the second kernel
            n = b * hkv * row_tiles(t, hq // hkv) * splits * BLOCK_ROWS
            part_o = torch.empty((n, dv), dtype=torch.float32, device=q.device)
            part_ml = torch.empty((n, 2), dtype=torch.float32, device=q.device)
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.mst_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, s, hq, hkv, q.shape[-1], dv,
            strides, offset, float(scale), cap, window, split, int(vk),
            None if kv_index is None else kv_index.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _LIBRARY.check(err, "flash_attention")
    count_launch(flash_attention)
    return out


flash_attention.launches = 0


# ------------------------------------------------------------ the T=1 route
_DECODE_TABLES: dict = {}


def decode_tables(b: int, s: int, device) -> torch.Tensor:
    """The (B, S/page) int32 page table of the dense cache's paged view: row
    b is the identity run ``b·S/page ..`` of its own pages. Made once per
    (device, B, S) and kept, so that a captured step may hold its address."""
    key = (torch.device(device), b, s)
    table = _DECODE_TABLES.get(key)
    if table is None:
        spg = s // DECODE_PAGE
        table = upload(np.arange(b * spg, dtype=np.int32).reshape(b, spg), device)
        _DECODE_TABLES[key] = table
    return table


def decode_lengths(position: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B,) int32 valid positions of the T=1 route, ``position + 1`` capped
    at the capacity, from the (1,) device position: device work only."""
    return (position.reshape(1) + 1).clamp(max=s).to(torch.int32).expand(b).contiguous()


def slot_lengths(positions: torch.Tensor, active: torch.Tensor, s: int) -> torch.Tensor:
    """(M,) int32 valid positions of the T=1 route for M rows each at its
    own device position (the continuous batcher's slots): ``positions +
    1`` capped at the capacity, and 0 for a row that is not ``active`` (the
    kernel then returns zeros for it). Device work only."""
    return torch.where(active, (positions + 1).clamp(max=s), 0).to(torch.int32)


def _decode_operands(q, k, v):
    """q as (B, Hq, Dk), the cache as (B·S/page, page, Hkv, D) pools, views
    of the caller's tensors, and the paged kernel's ``values_from_k``: for v
    a view of k's first columns (MLA), the V pool is the K pool and the
    values its first Dv columns (else None)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query position, q (B, 1, Hq, Dk); got "
                         f"{tuple(q.shape)}")
    b, _, hq, dk = q.shape
    s = k.shape[1]
    if s % DECODE_PAGE:
        raise ValueError(f"flash_decode views the cache as pages of {DECODE_PAGE} positions; "
                         f"capacity {s} is not a multiple")
    vk = values_from_k(k, v)
    if not (k.is_contiguous() and (vk or v.is_contiguous())):
        raise ValueError("flash_decode views the cache as pages without a copy: k and v must "
                         "be contiguous (B, S, Hkv, D) buffers, or v a view of k's first "
                         "columns")

    def pool(x):
        return x.view(b * s // DECODE_PAGE, DECODE_PAGE, *x.shape[2:])

    kp = pool(k)
    return (q.reshape(b, hq, dk).contiguous(), kp, kp if vk else pool(v),
            v.shape[-1] if vk else None)


def flash_decode_reference(q, k, v, lengths: torch.Tensor, scale: float, *,
                           logit_softcap: Optional[float] = None,
                           sliding_window: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`flash_decode`: the paged decode's plain
    version (``paged_attention_reference``) over the same paged view, the
    same identity tables and the same lengths. Returns (B, 1, Hq, Dv)."""
    qm, kp, vp, vfk = _decode_operands(q, k, v)
    tables = decode_tables(q.shape[0], k.shape[1], q.device)
    out = paged.paged_attention_reference(qm, kp, vp, tables, lengths, scale,
                                          logit_softcap=logit_softcap,
                                          sliding_window=sliding_window, values_from_k=vfk)
    return out.reshape(q.shape[0], 1, q.shape[2], v.shape[-1])


def flash_decode(q, k, v, position: torch.Tensor, scale: float, *,
                 lengths: Optional[torch.Tensor] = None,
                 logit_softcap: Optional[float] = None,
                 sliding_window: Optional[int] = None) -> torch.Tensor:
    """The T=1 decode route of the flash kernel: q (B, 1, Hq, Dk) at the
    device position ``position`` (a (1,) tensor) attends to positions
    ``0 .. position`` of the full-capacity cache k (B, S, Hkv, Dk), v (B, S,
    Hkv, Dv) (with ``sliding_window``, those after ``position -
    sliding_window``; ``logit_softcap`` caps the scaled scores).
    ``lengths`` is :func:`decode_lengths` of that position, which a forward
    computes once for all its layers (made here if None). Returns (B, 1,
    Hq, Dv) in q's dtype. CUDA tensors launch the paged kernel once
    (counted in ``flash_decode.launches``); CPU tensors take
    :func:`flash_decode_reference`."""
    _check(q, k, v, 0)
    paged.kernel_options(logit_softcap, sliding_window)
    if lengths is None:
        lengths = decode_lengths(position, q.shape[0], k.shape[1])
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lengths, scale, logit_softcap=logit_softcap,
                                      sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, not {q.device}")
    qm, kp, vp, vfk = _decode_operands(q, k, v)
    tables = decode_tables(q.shape[0], k.shape[1], q.device)
    paged._check(qm, kp, vp, tables, lengths, None, None, vfk)
    out = paged.launch(qm, kp, vp, tables, lengths, scale, logit_softcap=logit_softcap,
                       sliding_window=sliding_window, values_from_k=vfk)
    count_launch(flash_decode)
    return out.reshape(q.shape[0], 1, q.shape[2], v.shape[-1])


flash_decode.launches = 0
