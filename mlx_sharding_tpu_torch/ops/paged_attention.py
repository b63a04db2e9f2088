"""Ragged paged decode attention: the CUDA kernel's wrapper, its plain
version and its launch counter.

Port of ``mlx_sharding_tpu/ops/paged_attention.py``: the Pallas TPU kernel
``_paged_attention_kernel`` becomes ``csrc/paged_attention.cu``, written by
hand for Hopper (``sm_90a``); its header says what bounds it on the card and
what the design does about that. It is compiled with ``nvcc`` on first use
into ``_build/`` and loaded with ``ctypes`` (``cuda_library.py``).

Slot m's single query attends to positions ``0 .. lengths[m]-1`` of its own
page-table row, in place in the pool: no contiguous copy of the cache is
made. On the card the walk over a slot's pages is split across blocks of
``SPLIT_POSITIONS`` positions, whose partial results a second kernel merges
(both launched by one call). On a CUDA tensor :func:`paged_attention` launches the kernel or
raises; on a CPU tensor it computes :func:`paged_attention_reference`, the
plain version (the JAX package's ``_paged_attention_xla``). The JAX op's
``MST_PAGED_KERNEL`` switch selects a fallback and is not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

NEG_INF = -1e30
HEAD_DIM_ALIGN = 64
MAX_HEAD_DIM = 256
#: positions of one slot's page walk per block on the card (a multiple of
#: 64); 0 walks each (slot, KV head) in one block, with no merge pass
SPLIT_POSITIONS = 256
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
        ctypes.c_int, ctypes.c_int,  # q code, pool code
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, Hq, Hkv, Dk, Dv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # page size, pages per slot, split
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.mst_paged_attention_splits.restype = ctypes.c_int
    lib.mst_paged_attention_splits.argtypes = [ctypes.c_int] * 3
    lib.mst_paged_attention_shared_bytes.restype = ctypes.c_longlong
    lib.mst_paged_attention_shared_bytes.argtypes = [ctypes.c_int] * 4


_LIBRARY = CudaLibrary("paged_attention.cu", _bind)
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def shared_memory_bytes(pool_dtype: torch.dtype, group: int, dk: int, dv: int) -> int:
    """Dynamic shared memory one launch of the kernel asks for."""
    return int(_LIBRARY.get().mst_paged_attention_shared_bytes(_KV_CODES[pool_dtype], group,
                                                               dk, dv))


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
    CUDA tensors launch the kernel, with its merge pass when the walk is
    split (counted once in ``paged_attention.launches``); CPU tensors take
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
    split, spg = SPLIT_POSITIONS, tables.shape[1]
    splits = lib.mst_paged_attention_splits(page, spg, split)
    part_acc = part_ml = None
    if splits > 1:  # scratch of the split walk, merged by the second kernel
        part_acc = torch.empty((m, hq, splits, dv), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((m, hq, splits, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mst_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype],
            m, hq, hkv, dk, dv, page, spg, split, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _LIBRARY.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
