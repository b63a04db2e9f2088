"""Rotary position embeddings (port of ``mlx_sharding_tpu/ops/rope.py``).

Frequencies are computed once on the host in numpy; application follows
the HF split-half (``rotate_half``) convention with fp32 trig. YaRN and the
interleaved form come with the DeepSeek slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: dict | None = None,
) -> np.ndarray:
    """Per-pair inverse frequencies (head_dim // 2,), float32. Supports HF
    ``rope_scaling`` variants ``linear`` and ``llama3``."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type == "linear":
            inv_freq = inv_freq / float(rope_scaling["factor"])
        elif rope_type == "llama3":
            factor = float(rope_scaling["factor"])
            low = float(rope_scaling.get("low_freq_factor", 1.0))
            high = float(rope_scaling.get("high_freq_factor", 4.0))
            orig_max = float(rope_scaling.get("original_max_position_embeddings", 8192))
            wavelen = 2 * math.pi / inv_freq
            # long wavelengths are fully rescaled, short ones untouched,
            # with a smooth ramp between
            smooth = np.clip((orig_max / wavelen - low) / (high - low), 0.0, 1.0)
            scaled = inv_freq / factor
            inv_freq = np.where(
                wavelen > orig_max / low,
                scaled,
                np.where(
                    wavelen < orig_max / high,
                    inv_freq,
                    (1 - smooth) * scaled + smooth * inv_freq,
                ),
            )
        elif rope_type in ("default", None):
            pass
        else:
            raise ValueError(f"Unsupported rope_scaling type: {rope_type!r}")
    return inv_freq.astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, inv_freq: torch.Tensor, offset) -> torch.Tensor:
    """Rotate ``x`` (B, T, H, D) for absolute positions ``offset + arange(T)``.
    fp32 trig, result in ``x``'s dtype. ``inv_freq`` is a float32 tensor on
    ``x``'s device. ``offset`` is an int, or a (B,) tensor of per-row
    positions (the ragged paged decode, where every slot sits at its own
    length)."""
    steps = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        positions = offset.to(torch.float32)[:, None] + steps  # (B, T)
    else:
        positions = offset + steps  # (T,)
    angles = positions[..., None] * inv_freq  # (…, T, D/2)
    angles = torch.cat([angles, angles], dim=-1)[..., None, :]  # (…, T, 1, D)
    x32 = x.float()
    out = x32 * torch.cos(angles) + _rotate_half(x32) * torch.sin(angles)
    return out.to(x.dtype)
