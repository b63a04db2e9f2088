"""Flash prefill attention: the CUDA kernel's wrapper, its plain version and
its launch counter.

Port of ``mlx_sharding_tpu/ops/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The kernel is ``csrc/flash_attention.cu``, written by
hand for Hopper (``sm_90a``); its header says what bounds it on the card
and what the design does about that. It is compiled with ``nvcc`` on first
use into ``_build/`` and loaded with ``ctypes`` (``cuda_library.py``): no
PyTorch headers, so the build takes seconds.

On a CUDA tensor :func:`flash_attention` launches the kernel or raises; on a
CPU tensor it computes :func:`flash_attention_reference`, the plain version
of the same function. There is no other route and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

NEG_INF = -1e30
HEAD_DIM_ALIGN = 64
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.mst_flash_attention_fwd.restype = ctypes.c_int
    lib.mst_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,  # dtype code
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, T, S
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Hq, Hkv, Dk, Dv
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides
        ctypes.c_int, ctypes.c_float,  # offset, scale
        ctypes.c_void_p,  # stream
    ]
    lib.mst_flash_attention_shared_bytes.restype = ctypes.c_longlong
    lib.mst_flash_attention_shared_bytes.argtypes = [ctypes.c_int] * 3


_LIBRARY = CudaLibrary("flash_attention.cu", _bind)
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers and shared memory."""
    return _LIBRARY.build()


def shared_memory_bytes(dtype: torch.dtype, dk: int, dv: int) -> int:
    """Dynamic shared memory one launch of the kernel asks for."""
    return int(_LIBRARY.get().mst_flash_attention_shared_bytes(_DTYPE_CODES[dtype], dk, dv))


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
    kernel (and count the launch in ``flash_attention.launches``); CPU
    tensors take :func:`flash_attention_reference`."""
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
    out = torch.empty((b, t, hq, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = _LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.mst_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, s, hq, hkv, q.shape[-1], dv,
            strides, int(offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _LIBRARY.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
