"""Causal attention over a fixed-capacity KV cache (port of
``mlx_sharding_tpu/ops/attention.py``).

Prefill chunks that the flash kernel takes go to
:func:`~mlx_sharding_tpu_torch.ops.flash_attention.flash_attention`; every
other call, T=1 decode included, takes the plain grouped-GQA attention,
which is the JAX package's own non-kernel path. Given the position as a
device tensor, that path is :func:`masked_attention`: it attends over the
whole capacity and masks from the position, as JAX's plain path does, so a
captured decode step has one shape at every position. With a host offset
it is ``flash_attention_reference`` with the probs rounded to v's dtype,
which reads only the causal prefix.

Dense single-stream T=1 attention is no kernel in either package.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.flash_attention import (
    HEAD_DIM_ALIGN,
    MAX_HEAD_DIM,
    flash_attention,
    flash_attention_reference,
)


def flash_eligible(q, k, v, logit_softcap=None, sliding_window=None) -> bool:
    """The dispatch rule of ``_flash_eligible`` (JAX ``ops/attention.py``):
    standard causal GQA (no softcap or window; the JAX package's reserved
    ``sinks`` argument has no caller and is not carried over), T and S
    multiples of 128, head dims multiples of 64 that the kernel holds."""
    if logit_softcap is not None or sliding_window is not None:
        return False
    t, dk = q.shape[1], q.shape[-1]
    s, dv = k.shape[1], v.shape[-1]
    return (
        t >= 128 and t % 128 == 0
        and s % 128 == 0
        and dk % HEAD_DIM_ALIGN == 0 and dk <= MAX_HEAD_DIM
        and dv % HEAD_DIM_ALIGN == 0 and dv <= MAX_HEAD_DIM
    )


def causal_attention(
    q: torch.Tensor,  # (B, T, Hq, Dk)
    k: torch.Tensor,  # (B, S, Hkv, Dk), the full cache buffer
    v: torch.Tensor,  # (B, S, Hkv, Dv)
    offset: int,  # first new position: query i sits at offset + i
    scale: float,
    *,
    position: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns (B, T, Hq, Dv). Keys past a query's position (or outside the
    sliding window) contribute nothing. Scores and softmax in fp32, probs
    cast to v's dtype, products accumulated in fp32, as in the JAX path.
    ``offset`` is a host int (the flash kernel bakes it into its launch);
    ``position``, the same position as a (1,) device tensor, sends every
    call the kernel does not take to :func:`masked_attention`."""
    if flash_eligible(q, k, v, logit_softcap, sliding_window):
        return flash_attention(q, k, v, offset, scale)
    if position is not None:
        return masked_attention(q, k, v, position, scale, logit_softcap=logit_softcap,
                                sliding_window=sliding_window)
    return flash_attention_reference(
        q, k, v, offset, scale, logit_softcap=logit_softcap,
        sliding_window=sliding_window, probs_dtype=v.dtype,
    )


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over (N, m, k) x (N, k, n) with fp32 output. On the card a
    bf16 or fp16 pair is multiplied as it is (cuBLAS accumulates in fp32 and
    writes fp32, JAX's ``preferred_element_type``), reading the cache through
    its strides: no fp32 copy of it is made. Elsewhere, and for fp32, the
    operands are fp32."""
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def masked_attention(q, k, v, position: torch.Tensor, scale: float, *,
                     logit_softcap: Optional[float] = None,
                     sliding_window: Optional[int] = None) -> torch.Tensor:
    """JAX's plain path (``mlx_sharding_tpu/ops/attention.py``) over the
    whole capacity: query i sits at ``position + i`` (``position`` a (1,)
    device tensor) and sees the keys at or before it; every key is read and
    the rest are masked, so the shapes do not depend on the position. Scores
    and softmax in fp32, probs rounded to v's dtype, the product accumulated
    in fp32. Returns (B, T, Hq, Dv) in q's dtype."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    # (B, Hkv, G*T, Dk): row r of a KV head is group head r // T at query r % T
    qg = q.reshape(b, t, hkv, g, dk).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * t, dk)
    outs = []
    for i in range(b):  # per batch row, so that each operand is a strided view
        scores = _product_f32(qg[i], k[i].permute(1, 2, 0)) * scale  # (Hkv, G*T, S)
        if logit_softcap is not None:
            scores = logit_softcap * torch.tanh(scores / logit_softcap)
        q_pos = position + torch.arange(t, device=q.device)  # (T,)
        k_pos = torch.arange(s, device=q.device)
        allowed = k_pos[None, :] <= q_pos[:, None]  # (T, S)
        if sliding_window is not None:
            allowed &= k_pos[None, :] > q_pos[:, None] - sliding_window
        scores = scores.view(hkv, g, t, s).masked_fill(~allowed, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype).view(hkv, g * t, s)
        outs.append(_product_f32(probs, v[i].permute(1, 0, 2)))  # (Hkv, G*T, Dv)
    out = torch.stack(outs).view(b, hkv, g, t, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, dv).to(q.dtype)
