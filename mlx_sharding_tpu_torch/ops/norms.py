"""Normalization ops (port of ``mlx_sharding_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to ``x``'s dtype.
    ``offset=1.0`` gives Gemma-style ``(1 + w) * x_hat``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x_hat = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (x_hat * (weight.float() + offset)).to(x.dtype)
