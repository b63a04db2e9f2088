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

On a CUDA tensor :func:`flash_attention` launches the kernel or raises; on a
CPU tensor it computes :func:`flash_attention_reference`, the plain version
of the same function. There is no other route and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

NEG_INF = -1e30
HEAD_DIM_ALIGN = 64
MAX_HEAD_DIM = 256
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
        ctypes.c_int,  # split
        ctypes.c_void_p,  # stream
    ]
    lib.mst_flash_attention_kernel_info.restype = ctypes.c_int
    lib.mst_flash_attention_kernel_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]


_LIBRARY = CudaLibrary("flash_attention.cu", _bind)
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def kernel_info(dk: int, dv: int) -> dict:
    """The bf16 variant's shared bytes per block, registers per thread,
    resident blocks per SM and local (spill) bytes per thread, as the CUDA
    runtime reports them on the current card."""
    out = (ctypes.c_longlong * 4)()
    _LIBRARY.check(_LIBRARY.get().mst_flash_attention_kernel_info(dk, dv, out), "kernel_info")
    return dict(shared_bytes=out[0], registers=out[1], blocks_per_sm=out[2], local_bytes=out[3])


def row_tiles(t: int, groups: int) -> int:
    """Row tiles of one (batch, KV head): T x G packed rows, ``BLOCK_ROWS`` each."""
    return -(-t * groups // BLOCK_ROWS)


def tile_kv_end(t: int, groups: int, s: int, offset: int, tile: int) -> int:
    """The causal end (exclusive) of row tile ``tile``: one past the last
    position of its rows, packed row r being position r // G."""
    last_row = min((tile + 1) * BLOCK_ROWS, t * groups) - 1
    return min(s, offset + last_row // groups + 1)


def num_splits(t: int, s: int, offset: int, split: int) -> int:
    """Blocks along the walk for ``split`` keys per block (0: one)."""
    return -(-min(s, offset + t) // split) if split else 1


def plan_split(b: int, t: int, s: int, hq: int, hkv: int, offset: int, sms: int) -> int:
    """Keys per block of the bf16 walk, 0 for the whole walk. The walk is
    split only when the (row tile, KV head, batch) blocks leave room for
    two or more times as many in one wave of ``RESIDENT_BLOCKS`` per SM:
    then into as many chunks as that wave holds, if each keeps at least
    ``MIN_SPLIT`` keys (a shorter walk pays more for its partials and the
    merge than the extra blocks give back)."""
    kv_len = min(s, offset + t)
    chunks = RESIDENT_BLOCKS * sms // (b * hkv * row_tiles(t, hq // hkv))
    if chunks < 2:
        return 0
    split = -(-kv_len // chunks)
    split = -(-split // SPLIT_ALIGN) * SPLIT_ALIGN
    return split if MIN_SPLIT <= split < kv_len else 0


def split_chunks(t: int, groups: int, s: int, offset: int, split: int) -> list:
    """For each row tile, the (first, end) key ranges of the blocks that do
    work, as the kernel walks them: chunk c of ``split`` keys is launched for
    every tile and returns at once where it starts at or past the tile's
    causal end."""
    plan = []
    for tile in range(row_tiles(t, groups)):
        kv_end = tile_kv_end(t, groups, s, offset, tile)
        step = split or s
        plan.append([(kb, min(kb + step, kv_end))
                     for kb in (c * step for c in range(num_splits(t, s, offset, split)))
                     if kb < kv_end])
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

    It is also the plain grouped-GQA path of ``causal_attention``, which
    adds what the kernel does not take (a logit softcap, a sliding window)
    and rounds the probs to ``probs_dtype`` (v's dtype) before the product,
    as the JAX package's plain path does."""
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


def flash_attention_split_reference(q, k, v, offset: int, scale: float, split: int) -> torch.Tensor:
    """The bf16 kernel's walk in plain PyTorch, in fp32, for the tests: the
    packed row tiles, each chunk of :func:`split_chunks` as one block that
    keeps its running max (log2 units), normaliser and accumulator, then the
    merge that rescales the chunks to their common max."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    # (B, Hkv, T*G, D): packed row r is position r // G, head kvh*G + r % G
    qp = q.float().reshape(b, t, hkv, g, dk).permute(0, 2, 1, 3, 4).reshape(b, hkv, t * g, dk)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # (B, Hkv, S, D)
    pos = offset + torch.arange(t * g, device=q.device) // g
    out = torch.empty((b, hkv, t * g, dv), dtype=torch.float32, device=q.device)
    for tile, chunks in enumerate(split_chunks(t, g, s, offset, split)):
        r = slice(tile * BLOCK_ROWS, min((tile + 1) * BLOCK_ROWS, t * g))
        parts = []
        for kb, ke in chunks:
            sc = qp[:, :, r] @ kf[:, :, kb:ke].transpose(-1, -2) * (scale * math.log2(math.e))
            keys = torch.arange(kb, ke, device=q.device)
            sc = sc.masked_fill(keys[None, :] > pos[r, None], NEG_INF)
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


def _check(q, k, v, offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, T, Hq, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)")
    b, t, hq, dk = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2]:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape[-1] != dk:
        raise ValueError(f"q and k head dims differ: {dk} vs {k.shape[-1]}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads do not group over {k.shape[2]} KV heads")
    dv = v.shape[-1]
    for name, d in (("Dk", dk), ("Dv", dv)):
        if d % HEAD_DIM_ALIGN or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(
                f"{name}={d}: the flash kernel takes head dims that are multiples of "
                f"{HEAD_DIM_ALIGN} up to {MAX_HEAD_DIM}; the MLA compressed layout "
                "(Dk=576) waits for the DeepSeek slice"
            )
    if t < 1 or offset < 0:
        raise ValueError(f"need T >= 1 and offset >= 0, got T={t} offset={offset}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPE_CODES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, offset: int, scale: float) -> torch.Tensor:
    """Causal GQA attention of a prefill chunk over the full-capacity cache.

    q (B, T, Hq, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv); query row i sits
    at absolute position ``offset + i`` (a host int) and sees keys at or
    before it. Returns (B, T, Hq, Dv) in q's dtype. CUDA tensors launch the
    kernel, with its merge pass when the bf16 walk is split (counted once in
    ``flash_attention.launches``); CPU tensors take
    :func:`flash_attention_reference`."""
    _check(q, k, v, offset)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, offset, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a dense last dim, 16-byte aligned rows and "
                f"strides that are multiples of {vec} elements; got {x.stride()}"
            )
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
            split = plan_split(b, t, s, hq, hkv, offset, _sm_count(q.device.index or 0))
        if split < 0 or split % SPLIT_ALIGN:
            raise ValueError(f"SPLIT_KEYS must be None, 0 or a multiple of {SPLIT_ALIGN}")
        splits = num_splits(t, s, offset, split)
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
            strides, offset, float(scale), split,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _LIBRARY.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
