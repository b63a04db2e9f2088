"""Mixture-of-experts dispatch (port of ``mlx_sharding_tpu/ops/moe.py``).

Routing: Mixtral's softmax over every expert's logit, the top k, the kept
mass renormalised (the router's product in the activations' dtype, cast to
fp32 after, as in JAX); or DeepSeek-V2's gate (:func:`deepseek_routing`:
the product in fp32, greedy or group-limited top k, scaled). Ties between
experts (and groups) go to the lower index, as ``jax.lax.top_k`` breaks
them (a stable descending sort: ``torch.topk`` promises no order among
ties).

Experts apply by JAX's switch on the token count:

- at most ``GATHER_PATH_MAX_TOKENS`` tokens (decode) take the gather path:
  each token's k experts alone. Packed stacks go to the GEMV kernel's
  routed entry (``quant_gemv_experts``), which reads the expert ids on the
  device and walks only the chosen experts' packed rows; dense stacks
  multiply the gathered slices with ``torch.matmul``, as JAX's plain einsum;
- more tokens (prefill) take the scan over every expert through
  ``ops.quant.linear`` (the packed matmul kernel), weighted by each token's
  routing mass on that expert.

The two paths round differently in bf16, so the threshold is JAX's.
Expert stacks are dense (E, OUT, IN) tensors (PyTorch's orientation) or
packed ``{q, scales, biases}`` triples with leaves (E, OUT, ...), MLX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mlx_sharding_tpu_torch.ops.quant import is_quantized, linear
from mlx_sharding_tpu_torch.ops.quant_matmul import quant_gemv_experts

GATHER_PATH_MAX_TOKENS = 16


def top_k_lower_first(x: torch.Tensor, k: int) -> tuple:
    """The k largest entries of each row and their indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def mixtral_routing(x: torch.Tensor, router: torch.Tensor, k: int) -> tuple:
    """x (N, H), router (E, H) -> (weights (N, K) f32, expert ids (N, K)
    int32): softmax over all experts, top k, the kept mass renormalised."""
    probs = torch.softmax(F.linear(x, router).float(), dim=-1)
    topv, topi = top_k_lower_first(probs, k)
    return topv / topv.sum(dim=-1, keepdim=True), topi.to(torch.int32)


def deepseek_routing(x: torch.Tensor, router: torch.Tensor, k: int, *, norm_topk_prob: bool,
                     routed_scaling_factor: float, topk_method: str = "greedy",
                     n_group: int = 1, topk_group: int = 1) -> tuple:
    """DeepSeek-V2's gate: x (N, H), router (E, H) -> (weights (N, K) f32,
    expert ids (N, K) int32). Softmax scores in fp32, then ``greedy`` top k
    (V2-Lite) or ``group_limited_greedy`` (V2: only the ``topk_group``
    groups of ``E / n_group`` experts with the highest per-group max score
    stay, then the top k among them), the kept mass renormalised when
    ``norm_topk_prob``, times ``routed_scaling_factor``."""
    scores = torch.softmax(F.linear(x.float(), router.float()), dim=-1)
    if topk_method == "group_limited_greedy":
        n, e = scores.shape
        group_scores = scores.reshape(n, n_group, e // n_group).amax(dim=-1)
        _, group_idx = top_k_lower_first(group_scores, topk_group)
        group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1.0)
        scores = scores * group_mask.repeat_interleave(e // n_group, dim=-1)
    elif topk_method != "greedy":
        raise ValueError(f"unknown topk_method {topk_method!r}")
    topv, topi = top_k_lower_first(scores, k)
    if norm_topk_prob:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
    return topv * routed_scaling_factor, topi.to(torch.int32)


def apply_experts(x, weights, idx, w_gate, w_up, w_down, group_size: int = 64,
                  bits: int = 4) -> torch.Tensor:
    """SwiGLU experts: x (N, H), routing ``weights`` and ``idx`` (N, K).
    Returns (N, H) in x's dtype."""
    if x.shape[0] <= GATHER_PATH_MAX_TOKENS:
        if is_quantized(w_gate):
            return _apply_gather_packed(x, weights, idx, w_gate, w_up, w_down, group_size, bits)
        return _apply_gather(x, weights, idx, w_gate, w_up, w_down)
    return _apply_scan(x, weights, idx, w_gate, w_up, w_down, group_size, bits)


def _combine(y: torch.Tensor, weights: torch.Tensor, dtype) -> torch.Tensor:
    """sum_k y[:, k] * weights[:, k], in y's dtype, as JAX sums."""
    return (y * weights[..., None].to(y.dtype)).sum(dim=1).to(dtype)


def _apply_gather(x, weights, idx, w_gate, w_up, w_down):
    ids = idx.long()
    xs = x[:, None, :, None]  # (N, 1, H, 1)
    g = torch.matmul(w_gate[ids], xs)[..., 0]  # (N, K, I)
    u = torch.matmul(w_up[ids], xs)[..., 0]
    y = torch.matmul(w_down[ids], (F.silu(g) * u)[..., None])[..., 0]  # (N, K, H)
    return _combine(y, weights, x.dtype)


def _apply_gather_packed(x, weights, idx, w_gate, w_up, w_down, gs, bits):
    """Only the routed experts' packed rows are read: the gate and up
    products per (token, k) pair from the token's row, the down product
    from the pair's own row."""

    def product(inp, w):
        return quant_gemv_experts(inp, idx, w["q"], w["scales"], w["biases"], gs, bits)

    h = F.silu(product(x, w_gate)) * product(x, w_up)  # (N, K, I)
    return _combine(product(h, w_down), weights, x.dtype)


def _apply_scan(x, weights, idx, w_gate, w_up, w_down, gs=64, bits=4):
    packed = is_quantized(w_gate)
    experts = (w_gate["q"] if packed else w_gate).shape[0]

    def expert(w, e):
        return {leaf: t[e] for leaf, t in w.items()} if packed else w[e]

    # (N, E): each token's routing mass on each expert, once for the scan
    mass = ((idx[..., None] == torch.arange(experts, device=idx.device)) * weights[..., None]
            ).sum(dim=1)
    acc = torch.zeros_like(x)
    for e in range(experts):
        g, u = linear(x, expert(w_gate, e), gs, bits), linear(x, expert(w_up, e), gs, bits)
        y = linear(F.silu(g) * u, expert(w_down, e), gs, bits)
        acc = acc + mass[:, e : e + 1].to(y.dtype) * y
    return acc
