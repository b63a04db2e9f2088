"""Causal attention over a fixed-capacity KV cache (port of
``mlx_sharding_tpu/ops/attention.py``).

Prefill chunks that the flash kernel takes go to
:func:`~mlx_sharding_tpu_torch.ops.flash_attention.flash_attention`; every
other call, T=1 decode included, takes the plain grouped-GQA attention
(``flash_attention_reference`` with the probs rounded to v's dtype), which
is the JAX package's own non-kernel path.
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
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns (B, T, Hq, Dv). Keys past a query's position (or outside the
    sliding window) contribute nothing. Scores and softmax in fp32, probs
    cast to v's dtype, products accumulated in fp32, as in the JAX path."""
    if flash_eligible(q, k, v, logit_softcap, sliding_window):
        return flash_attention(q, k, v, offset, scale)
    return flash_attention_reference(
        q, k, v, offset, scale, logit_softcap=logit_softcap,
        sliding_window=sliding_window, probs_dtype=v.dtype,
    )
