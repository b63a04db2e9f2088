"""Causal attention over a fixed-capacity KV cache (port of
``mlx_sharding_tpu/ops/attention.py``).

Calls that the flash kernel takes (:func:`flash_eligible`, JAX's
``_flash_eligible``) go to it: prefill chunks to
:func:`~mlx_sharding_tpu_torch.ops.flash_attention.flash_attention`, and
T=1 decode steps, under ``MST_FLASH_DECODE``, to its T=1 route
:func:`~mlx_sharding_tpu_torch.ops.flash_attention.flash_decode`.
``MST_FLASH=0`` turns both off. Every other call takes the plain
grouped-GQA attention, which is the JAX package's own non-kernel path.
Given the position as a device tensor, that path is
:func:`masked_attention`: it attends over the whole capacity and masks from
the position, as JAX's plain path does, so a captured decode step has one
shape at every position. With a host offset it is
``flash_attention_reference`` with the probs rounded to v's dtype, which
reads only the causal prefix.

The T=1 route's default differs from JAX's, whose ``MST_FLASH_DECODE``
defaults to off from TPU numbers: here it defaults to
``FLASH_DECODE_DEFAULT``, chosen from the card's numbers (``PERF.md``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from mlx_sharding_tpu_torch.ops.flash_attention import (
    HEAD_DIM_ALIGN,
    flash_attention,
    flash_attention_reference,
    flash_decode,
    select_kv_rows,
)

#: ``MST_FLASH_DECODE`` when it is unset
FLASH_DECODE_DEFAULT = "1"


def flash_decode_on() -> bool:
    """The T=1 route's switches: ``MST_FLASH`` (default on) and
    ``MST_FLASH_DECODE`` (default ``FLASH_DECODE_DEFAULT``), read per call
    as JAX reads them per trace."""
    return (os.environ.get("MST_FLASH", "1") != "0"
            and os.environ.get("MST_FLASH_DECODE", FLASH_DECODE_DEFAULT) == "1")


def flash_eligible(q, k, v, logit_softcap=None, sliding_window=None) -> bool:
    """The dispatch rule of ``_flash_eligible`` (JAX ``ops/attention.py``):
    ``MST_FLASH=0`` turns the kernel off; causal GQA, T a multiple of 128,
    or T = 1 with ``MST_FLASH_DECODE=1`` (:func:`flash_decode_on`), S a
    multiple of 128, head dims multiples of 64 (DeepSeek-V2's MLA shapes
    included: 192 / 128 in full mode, 576 / 512 compressed, with v a view
    of k's first columns).

    Unlike JAX's rule it takes a logit softcap and a sliding window (the
    options are not part of the rule): JAX refuses them only because its
    Pallas kernels lack them and sends such calls to its plain XLA path;
    both kernels here compute them, and the function is the same. The JAX
    package's reserved ``sinks`` argument has no caller and is not carried
    over."""
    if os.environ.get("MST_FLASH", "1") == "0":
        return False
    t, dk = q.shape[1], q.shape[-1]
    s, dv = k.shape[1], v.shape[-1]
    t_ok = (t >= 128 and t % 128 == 0) or (t == 1 and flash_decode_on())
    return (
        t_ok
        and s % 128 == 0
        and dk % HEAD_DIM_ALIGN == 0
        and dv % HEAD_DIM_ALIGN == 0
    )


def causal_attention(
    q: torch.Tensor,  # (B, T, Hq, Dk)
    k: torch.Tensor,  # (B, S, Hkv, Dk), the full cache buffer
    v: torch.Tensor,  # (B, S, Hkv, Dv)
    offset: int,  # first new position: query i sits at offset + i
    scale: float,
    *,
    position: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    kv_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (B, T, Hq, Dv). Keys past a query's position (or outside the
    sliding window) contribute nothing. Scores and softmax in fp32, probs
    cast to v's dtype, products accumulated in fp32, as in the JAX path.
    ``offset`` is a host int (the flash kernel bakes it into its launch);
    ``position``, the same position as a (1,) device tensor, sends a T=1
    call to the T=1 route with ``lengths`` (:func:`decode_lengths` of it,
    shared by a forward's layers), and every call the kernels do not take
    to :func:`masked_attention`. ``kv_index`` ((B,) int64 on the device):
    query row b attends row ``kv_index[b]`` of k and v (the dense batcher's
    slot caches), read in place by the flash kernel and copied out for the
    other paths."""
    # the options the call has (none for standard causal attention)
    options = {name: value for name, value in (("logit_softcap", logit_softcap),
                                               ("sliding_window", sliding_window))
               if value is not None}
    if kv_index is not None:
        if q.shape[1] > 1 and flash_eligible(q, k, v, logit_softcap, sliding_window):
            return flash_attention(q, k, v, offset, scale, kv_index=kv_index, **options)
        k, v = select_kv_rows(k, v, kv_index)
    if flash_eligible(q, k, v, logit_softcap, sliding_window):
        if q.shape[1] > 1:
            return flash_attention(q, k, v, offset, scale, **options)
        if position is None:
            position = torch.full((1,), int(offset), dtype=torch.int64, device=q.device)
        return flash_decode(q, k, v, position, scale, lengths=lengths, **options)
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
    whole capacity: query i of row b sits at ``position[b] + i``
    (``position`` a (1,) device tensor shared by the rows, or (B,), one per
    row: the batcher's T=K verify) and sees the keys at or before it; every
    key is read and the rest are masked, so the shapes do not depend on the
    position. Scores and softmax in fp32, probs rounded to v's dtype, the
    product accumulated in fp32. Returns (B, T, Hq, Dv) in q's dtype."""
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
        row_pos = position[i : i + 1] if position.numel() > 1 else position
        q_pos = row_pos + torch.arange(t, device=q.device)  # (T,)
        k_pos = torch.arange(s, device=q.device)
        allowed = k_pos[None, :] <= q_pos[:, None]  # (T, S)
        if sliding_window is not None:
            allowed &= k_pos[None, :] > q_pos[:, None] - sliding_window
        scores = scores.view(hkv, g, t, s).masked_fill(~allowed, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype).view(hkv, g * t, s)
        outs.append(_product_f32(probs, v[i].permute(1, 0, 2)))  # (Hkv, G*T, Dv)
    out = torch.stack(outs).view(b, hkv, g, t, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, dv).to(q.dtype)
