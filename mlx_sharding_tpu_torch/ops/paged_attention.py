"""Ragged paged decode attention: the CUDA kernel's wrapper, its plain
version, the plan of its split page walk and its launch counter.

Port of ``mlx_sharding_tpu/ops/paged_attention.py``: the Pallas TPU kernel
``_paged_attention_kernel`` becomes ``csrc/paged_attention.cu``, written by
hand for Hopper (``sm_90a``); its header says what bounds it on the card and
what the design does about that. It is compiled with ``nvcc`` on first use
into ``_build/`` and loaded with ``ctypes`` (``cuda_library.py``).

Slot m's single query attends to positions ``0 .. lengths[m]-1`` of its own
page-table row, in place in the pool: no contiguous copy of the cache is
made. On the card the walk over a slot's pages is split into work items of
``SPLIT_POSITIONS`` positions (planned by :func:`plan_paged_split` from the
shapes alone), walked by persistent blocks; the block that finishes a row's
last item merges its partials, in the same launch. One call is one launch, with no host sync and no memset,
so a CUDA graph can hold it. On a CUDA tensor :func:`paged_attention`
launches the kernel or raises; on a CPU tensor it computes
:func:`paged_attention_reference`, the plain version (the JAX package's
``_paged_attention_xla``). The JAX op's ``MST_PAGED_KERNEL`` switch selects
a fallback and is not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

NEG_INF = -1e30
HEAD_DIM_ALIGN = 64
MAX_HEAD_DIM = 256
#: positions of one slot's page walk per block on the card: None lets
#: :func:`plan_paged_split` choose from the shapes and the card's SM count;
#: 0 walks each (slot, KV head, head chunk) in one block; a multiple of
#: ``SPLIT_ALIGN`` forces blocks of that many positions. The checks set it.
SPLIT_POSITIONS: Optional[int] = None
SPLIT_ALIGN = 64
#: the longest planned walk: a longer walk streams through the kernel's ring
#: of copies without the per-item costs (the query's fragments, the merge of
#: the warps, the partial and its ticket) that shorter walks repeat
MAX_SPLIT = 512
#: query heads of one block (the mma's 16 rows); a wider group runs in chunks
HEADS_PER_BLOCK = 16
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.mst_paged_attention.restype = ctypes.c_int
    lib.mst_paged_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k pool, v pool
        ctypes.c_void_p, ctypes.c_void_p,  # k scales, v scales (int8 pools)
        ctypes.c_void_p, ctypes.c_void_p,  # tables, lengths
        ctypes.c_void_p,  # out
        ctypes.c_void_p, ctypes.c_void_p,  # split partials: accumulators, max and normaliser
        ctypes.c_void_p,  # the rows' ticket counters
        ctypes.c_int, ctypes.c_int,  # q code, pool code
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, Hq, Hkv, Dk, Dv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pool pages, page size, pages per slot
        ctypes.c_int,  # split
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.mst_paged_attention_kernel_info.restype = ctypes.c_int
    lib.mst_paged_attention_kernel_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]


_LIBRARY = CudaLibrary("paged_attention.cu", _bind)
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def kernel_info(pool_dtype: torch.dtype, dk: int, dv: int) -> dict:
    """The bf16-q kernel over a ``pool_dtype`` (bf16 or int8) pool, for 8
    slots (its shared bytes grow by 8 per slot): shared bytes per block,
    registers per thread, resident blocks per SM and local (spill) bytes per
    thread, as the CUDA runtime reports them."""
    out = (ctypes.c_longlong * 4)()
    _LIBRARY.check(_LIBRARY.get().mst_paged_attention_kernel_info(_KV_CODES[pool_dtype], dk, dv,
                                                                  8, out), "kernel_info")
    return dict(shared_bytes=out[0], registers=out[1], blocks_per_sm=out[2], local_bytes=out[3])


def head_chunks(hq: int, hkv: int) -> int:
    """Blocks of ``HEADS_PER_BLOCK`` query heads per KV head."""
    return -(-(hq // hkv) // HEADS_PER_BLOCK)


def plan_paged_split(m: int, hkv_chunks: int, page: int, spg: int, sms: int) -> int:
    """Positions per work item of the page walk, 0 for the whole walk. From
    the shapes alone (never ``lengths``: no host sync, so a CUDA graph can
    hold the call): the longest multiple of ``SPLIT_ALIGN`` up to
    ``MAX_SPLIT`` for which a full-length walk of the ``m * hkv_chunks``
    (slot, KV head, head chunk) rows gives each of the card's ``sms`` SMs an
    item."""
    reach = page * spg
    per_row = -(-sms // (m * hkv_chunks))  # splits a row needs
    # the longest split that still cuts the reach into per_row pieces
    longest = (reach - 1) // (per_row - 1) if per_row > 1 else MAX_SPLIT
    split = min(max(longest // SPLIT_ALIGN * SPLIT_ALIGN, SPLIT_ALIGN), MAX_SPLIT)
    return 0 if split >= reach else split


def num_splits(page: int, spg: int, split: int) -> int:
    """Items along a full walk for ``split`` positions per item (0: one)."""
    return -(-page * spg // split) if split else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_eligible(dk: int, dv: int, logit_softcap=None, sliding_window=None,
                    values_from_k=None) -> bool:
    """The kernel's domain (``kernel_eligible``, JAX op :46): standard GQA
    with no softcap, window or latent-as-values, head dims that are
    multiples of 64 up to 256."""
    if logit_softcap is not None or sliding_window is not None or values_from_k is not None:
        return False
    return all(d % HEAD_DIM_ALIGN == 0 and 0 < d <= MAX_HEAD_DIM for d in (dk, dv))


def _gathered(pool, scale, tables):
    """A slot-contiguous (M, SPG*page, Hkv, D) view of each slot's own
    table row; an int8 pool is dequantized after the gather."""
    m, spg = tables.shape
    x = pool[tables.long()]  # (M, SPG, page, Hkv, D)
    x = x.reshape(m, spg * x.shape[2], *x.shape[3:])
    if scale is not None:
        s = scale[tables.long()].reshape(m, x.shape[1], x.shape[2], 1)
        x = x.float() * s
    return x


def paged_attention_reference(
    q, k_pool, v_pool, tables, lengths, scale: float, *,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    values_from_k: Optional[int] = None,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """The plain version, with ``_paged_attention_xla``'s semantics: gather
    only the slot's own row, scores in fp32, mask ``k_pos < lengths`` (and
    the window), zero an all-masked row, round the probs to v's dtype (f32
    for an int8 pool), accumulate in fp32."""
    if values_from_k is not None:
        raise NotImplementedError(
            "paged_attention(values_from_k=...) (MLA latent-as-values) is not yet ported: "
            "it comes with the DeepSeek slice"
        )
    m, hq, dk = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    k = _gathered(k_pool, k_scale, tables)
    v = _gathered(v_pool, v_scale, tables)
    qg = q.reshape(m, hkv, g, dk).float()
    scores = torch.einsum("mhgd,mshd->mhgs", qg, k.float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    lens = lengths.to(device=q.device, dtype=torch.long)[:, None]
    allowed = k_pos < lens
    if sliding_window is not None:
        # the single query sits at position lengths - 1
        allowed &= k_pos > (lens - 1) - sliding_window
    mask = allowed[:, None, None, :]
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    # an all-masked row (length 0, an inactive slot) is zeros, not uniform
    probs = probs * mask
    out = torch.einsum("mhgs,mshd->mhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(m, hq, -1).to(q.dtype)


def paged_attention_split_reference(q, k_pool, v_pool, tables, lengths, scale: float,
                                    split: int, *, k_scale=None, v_scale=None) -> torch.Tensor:
    """The card's walk in plain PyTorch, in fp32, for the tests: each slot's
    positions ``[0, min(lengths[m], reach))`` cut into blocks of ``split``
    (0: one block), each keeping its running max (log2 units, scale *
    log2(e) folded in), normaliser and accumulator, then the merge the last
    block does: the partials rescaled to their common max and added in split
    order. Probs are rounded to a bf16 pool's dtype before P V, as the
    kernel and the plain version round them."""
    m, hq, dk = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    k = _gathered(k_pool, k_scale, tables).float()  # (M, S, Hkv, D)
    v = _gathered(v_pool, v_scale, tables).float()
    p_dtype = v_pool.dtype if v_pool.dtype == torch.bfloat16 else torch.float32
    reach = k.shape[1]
    step = split or reach
    out = torch.zeros((m, hq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for i, n in enumerate(lengths.tolist()):
        n = min(max(n, 0), reach)
        qi = q[i].float().reshape(hkv, g, dk)
        parts = []
        for b in range(0, n, step):
            e = min(n, b + step)
            sc = torch.einsum("hgd,shd->hgs", qi, k[i, b:e]) * (scale * math.log2(math.e))
            mx = sc.amax(-1)
            pr = torch.exp2(sc - mx[..., None])
            acc = torch.einsum("hgs,shd->hgd", pr.to(p_dtype).float(), v[i, b:e])
            parts.append((mx, pr.sum(-1), acc))
        if not parts:
            continue  # length 0: zeros
        mx = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp2(p[0] - mx) for p in parts]
        acc, norm = 0.0, 0.0
        for wi, (_, li, ai) in zip(w, parts):  # in split order
            acc = acc + wi[..., None] * ai
            norm = norm + wi * li
        out[i] = (acc / norm.clamp_min(1e-30)[..., None]).reshape(hq, -1)
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, tables, lengths, k_scale, v_scale) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (M, Hq, Dk) and the pools (P+1, page, Hkv, D)")
    m, hq, dk = q.shape
    if k_pool.shape[:3] != v_pool.shape[:3] or k_pool.shape[-1] != dk:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)} k_pool {tuple(k_pool.shape)} "
                         f"v_pool {tuple(v_pool.shape)}")
    if hq % k_pool.shape[2]:
        raise ValueError(f"{hq} query heads do not group over {k_pool.shape[2]} KV heads")
    if tables.dim() != 2 or tables.shape[0] != m or tuple(lengths.shape) != (m,):
        raise ValueError(f"tables must be (M, SPG) and lengths (M,) for M={m}; got "
                         f"{tuple(tables.shape)}, {tuple(lengths.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError("k_scale/v_scale go with int8 pools")
        for name, s, pool in (("k_scale", k_scale, k_pool), ("v_scale", v_scale, v_pool)):
            if tuple(s.shape) != (*pool.shape[:3], 1):
                raise ValueError(f"{name} must be {(*pool.shape[:3], 1)}, got {tuple(s.shape)}")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q and the pools must share one dtype (or the pools be int8 with "
                         f"scales); got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    devices = {t.device for t in (q, k_pool, v_pool, tables, lengths)}
    if k_scale is not None:
        devices |= {k_scale.device, v_scale.device}
    if len(devices) != 1:
        raise ValueError("q, the pools, scales, tables and lengths must be on one device")


def paged_attention(
    q: torch.Tensor,  # (M, Hq, Dk): one query token per slot
    k_pool: torch.Tensor,  # (P+1, page, Hkv, Dk): one layer's pool, scratch last
    v_pool: torch.Tensor,  # (P+1, page, Hkv, Dv)
    tables: torch.Tensor,  # (M, SPG) int32 pool page ids (scratch past the length)
    lengths: torch.Tensor,  # (M,) int32 valid positions, the new token's included
    scale: float,
    *,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    values_from_k: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (P+1, page, Hkv, 1) f32, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged decode attention over one layer's page pool. Returns (M, Hq,
    Dv) in q's dtype. Row m attends to positions ``0 .. lengths[m]-1`` of
    its own pages (lengths past the table's reach are clipped to it);
    ``lengths[m] == 0`` (an inactive slot) gives zeros. The new token's K/V
    must already be in the pool. With ``k_scale``/``v_scale`` the pools are
    int8 codes, multiplied by their per-row-per-head scale as they are read.
    CUDA tensors launch the kernel once, its split walk merged inside the
    launch (counted in ``paged_attention.launches``); CPU tensors take
    :func:`paged_attention_reference`."""
    _check(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
    kw = dict(logit_softcap=logit_softcap, sliding_window=sliding_window,
              values_from_k=values_from_k, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths, scale, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, not {q.device}")
    m, hq, dk = q.shape
    page, hkv, dv = k_pool.shape[1], k_pool.shape[2], v_pool.shape[-1]
    if not kernel_eligible(dk, dv, logit_softcap, sliding_window, values_from_k):
        raise ValueError(
            f"the paged kernel takes head dims that are multiples of {HEAD_DIM_ALIGN} up to "
            f"{MAX_HEAD_DIM} and no softcap, window or values_from_k (got Dk={dk}, Dv={dv}, "
            f"softcap={logit_softcap}, window={sliding_window}, values_from_k={values_from_k}); "
            "those options are not yet ported to the card"
        )
    if q.dtype not in _Q_CODES:
        raise ValueError(f"q must be one of {list(_Q_CODES)}, not {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    operands = [q, k_pool, v_pool, tables, lengths]
    if k_scale is not None:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError("k_scale and v_scale must be float32")
        operands += [k_scale, v_scale]
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("paged_attention: q, pools, scales, tables and lengths must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: q and the pools must start on 16-byte boundaries")
    out = torch.empty((m, hq, dv), dtype=q.dtype, device=q.device)
    lib = _LIBRARY.get()
    spg = tables.shape[1]
    chunks = hkv * head_chunks(hq, hkv)
    split = SPLIT_POSITIONS
    if split is None:
        split = plan_paged_split(m, chunks, page, spg, _sm_count(q.device.index or 0))
    splits = num_splits(page, spg, split)
    stream = torch.cuda.current_stream(q.device)
    part_acc = part_ml = counters = None
    if splits > 1:  # the split walk's partials, merged by the last block of each row
        part_acc = torch.empty((m, hq, splits, dv), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((m, hq, splits, 2), dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, m * chunks)
    with torch.cuda.device(q.device):
        err = lib.mst_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype],
            m, hq, hkv, dk, dv, k_pool.shape[0], page, spg, split, float(scale),
            stream.cuda_stream,
        )
    _LIBRARY.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


_COUNTERS: dict = {}
_RETIRED: list = []
_COUNTERS_LOCK = threading.Lock()


def _counters(device: torch.device, stream, n: int) -> torch.Tensor:
    """The ticket counters of ``stream``'s launches: one int32 per (slot, KV
    head, head chunk) row, zero between launches (each launch leaves them
    zero), so calls on one stream share them and calls that can run at once
    never do. Made once per (device, stream); a larger one replaces it and
    the old one is kept, since a CUDA graph may hold its address. To keep
    the zeroing out of a graph, make one call on the capture stream before
    capturing."""
    key = (device.index, stream.cuda_stream)
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < n:
            if buf is not None:
                _RETIRED.append(buf)
            buf = torch.zeros(max(n, 1 << 12), dtype=torch.int32, device=device)
            _COUNTERS[key] = buf
        return buf


paged_attention.launches = 0
