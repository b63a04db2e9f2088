"""Expert parallelism (port of ``mlx_sharding_tpu/parallel/expert_parallel.py``):
the expert stacks split over the ``ep`` axis, every shard computing its
resident experts' contribution for all tokens (masked accumulation) and one
psum over ep combining them. Routing is every shard's, so there is no
all-to-all, no capacity factor and no dropped token. Inside a model the same
thing is ``ops.moe.apply_experts(..., ep_axis=...)``; this is the
top-level entry over dense stacks.

JAX computes it in XLA, so plain PyTorch it is here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mlx_sharding_tpu_torch.parallel.mesh import device_grid, psum


def expert_parallel_apply(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
                          w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                          ep: int, device=None) -> torch.Tensor:
    """SwiGLU experts with the stacks split over ``ep`` shards (the first
    ep CUDA devices, or every shard on ``device``): x (N, H), routing
    ``weights`` / global ``idx`` (N, K), dense stacks in the port's (E,
    OUT, IN) orientation, ``w_gate`` / ``w_up`` (E, I, H) and ``w_down``
    (E, H, I). Equals ``ops.moe.apply_experts`` on one device. Returns
    (N, H) on shard 0's device."""
    num_experts = w_gate.shape[0]
    if num_experts % ep:
        raise ValueError(f"{num_experts} experts not divisible over ep={ep}")
    e_local = num_experts // ep
    accs = []
    for rank, dev in enumerate(device_grid(ep=ep, device=device)[0, 0, :, 0]):
        base = rank * e_local
        xs, wts, ids = x.to(dev), weights.to(dev), idx.to(dev)
        acc = torch.zeros_like(xs)
        for e in range(e_local):
            wg, wu, wd = (w[base + e].to(dev) for w in (w_gate, w_up, w_down))
            coef = ((ids == base + e) * wts).sum(dim=-1)  # (N,)
            y = F.linear(F.silu(F.linear(xs, wg)) * F.linear(xs, wu), wd)
            acc = acc + coef[:, None].to(y.dtype) * y
        accs.append(acc)
    return psum(accs)[0]
