"""Rotary position embeddings (port of ``mlx_sharding_tpu/ops/rope.py``).

Frequencies are computed once on the host in numpy; application follows
the HF split-half (``rotate_half``) convention with fp32 trig, or
DeepSeek-V2's interleaved pairs (:func:`apply_rope_interleaved`) with YaRN
frequencies and attention factor (:func:`yarn_frequencies`).
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


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """DeepSeek's YaRN magnitude scale: with ``rope_scaling.mscale_all_dim``
    set, DeepSeek-V2 multiplies the softmax scale by
    ``yarn_get_mscale(factor, mscale_all_dim) ** 2`` on top of the cos/sin
    attention factor."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_frequencies(head_dim: int, theta: float, rope_scaling: dict,
                     max_position_embeddings: int) -> tuple:
    """YaRN (NTK-by-parts) inverse frequencies (head_dim // 2,) float32 and
    the attention factor that multiplies cos and sin, with DeepSeek's
    ``mscale``/``mscale_all_dim`` convention when ``attention_factor`` is
    not given."""
    dim = head_dim
    factor = float(rope_scaling["factor"])
    attention_factor = rope_scaling.get("attention_factor")
    mscale = rope_scaling.get("mscale")
    mscale_all_dim = rope_scaling.get("mscale_all_dim")
    orig_max = float(rope_scaling.get("original_max_position_embeddings")
                     or max_position_embeddings)
    beta_fast = float(rope_scaling.get("beta_fast") or 32)
    beta_slow = float(rope_scaling.get("beta_slow") or 1)
    if attention_factor is None:
        attention_factor = (yarn_get_mscale(factor, 1.0 if mscale is None else float(mscale))
                            / yarn_get_mscale(factor, 0.0 if mscale_all_dim is None
                                              else float(mscale_all_dim)))

    def correction_dim(num_rotations):
        return (dim * math.log(orig_max / (num_rotations * 2 * math.pi))) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
    keep = 1.0 - ramp  # the share of each pair's extrapolated frequency
    inv_freq = interpolation * (1 - keep) + extrapolation * keep
    return inv_freq.astype(np.float32), float(attention_factor)


def apply_rope_interleaved(x: torch.Tensor, inv_freq: torch.Tensor, offset,
                           scaling: float = 1.0) -> torch.Tensor:
    """Rotate adjacent pairs (2i, 2i+1) of ``x`` (B, T, H, D) together
    (DeepSeek-V2's complex-pair convention), cos and sin multiplied by the
    YaRN attention factor ``scaling``. fp32 trig, result in ``x``'s dtype;
    ``offset`` as in :func:`apply_rope`."""
    steps = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        positions = offset.to(torch.float32)[:, None] + steps  # (B, T)
    else:
        positions = offset + steps  # (T,)
    angles = positions[..., None] * inv_freq  # (..., T, D/2)
    cos = (torch.cos(angles) * scaling)[..., None, :]
    sin = (torch.sin(angles) * scaling)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
