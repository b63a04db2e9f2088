"""Mixtral decoder (port of ``mlx_sharding_tpu/models/mixtral.py``): Llama's
attention, and in place of the MLP a router over ``num_local_experts``
SwiGLU experts of which each token takes ``num_experts_per_tok``
(``ops/moe.py``).

The experts of a layer are stacks: ``w_gate`` and ``w_up`` (E, I, H),
``w_down`` (E, H, I), dense in PyTorch's (out, in) orientation or, in a
``keep_quantized`` load, packed in MLX's layout (``QuantizedLinear``
modules with a leading E). The loader stacks the checkpoint's per-expert
``block_sparse_moe.experts.{e}.w1/w3/w2`` weights. The router stays dense
(``packed_keep_dense_re``): its product feeds the fp32 routing.
"""

from __future__ import annotations

import torch
from torch import nn

from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from mlx_sharding_tpu_torch.models.llama import LlamaLayer, LlamaModel
from mlx_sharding_tpu_torch.ops import rms_norm
from mlx_sharding_tpu_torch.ops.moe import apply_experts, mixtral_routing
from mlx_sharding_tpu_torch.parallel.mesh import reduce


class ExpertStack(nn.Module):
    """One projection of every expert, dense: ``weight`` (E, OUT, IN)."""

    def __init__(self, experts: int, out_dim: int, in_dim: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, out_dim, in_dim, **kw))


class MixtralLayer(LlamaLayer):
    def init_mlp(self, cfg, kw) -> None:
        hd, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
        self.router = nn.Linear(hd, e, bias=False, **kw)
        self.w_gate = ExpertStack(e, inter, hd, **kw)
        self.w_up = ExpertStack(e, inter, hd, **kw)
        self.w_down = ExpertStack(e, hd, inter, **kw)


# the stacks and the checkpoint's per-expert names
_EXPERT_NAMES = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


class MixtralModel(LlamaModel):
    LAYER = MixtralLayer
    HF_LAYER_MAP = {
        **{k: v for k, v in LlamaModel.HF_LAYER_MAP.items() if not k.startswith("mlp.")},
        "block_sparse_moe.gate.weight": "router.weight",
    }

    def packed_keep_dense_re(self):
        return r"block_sparse_moe\.gate\.weight$"

    def fused_projection_groups(self) -> dict:
        return {"qkv_proj": ("q_proj", "k_proj", "v_proj")}

    def attn_options(self, p) -> dict:
        window = self.config.sliding_window
        return {"sliding_window": window} if window else {}

    def finish_steps(self, p, h, attn, tp_axis=None, ep_axis=None):
        """The O projection with its residual, then the routed experts.
        Under tp alone the experts' intermediate dim is split, so their
        down products are partial and summed over tp; under tp x ep the
        stacks are split over ep instead and the experts' own psum over ep
        makes them whole."""
        cfg = self.config
        b, t, hidden = h.shape
        h = h + (yield from reduce(self._linear(attn.reshape(b, t, -1), p.o_proj), tp_axis))
        flat = rms_norm(h, p.post_norm, cfg.rms_norm_eps).reshape(b * t, hidden)
        weights, idx = mixtral_routing(flat, p.router.weight, cfg.num_experts_per_tok)

        def stack(m):
            return m.packed if isinstance(m, QuantizedLinear) else m.weight

        q = getattr(cfg, "quantization", None) or {}
        moe = apply_experts(flat, weights, idx, stack(p.w_gate), stack(p.w_up), stack(p.w_down),
                            int(q.get("group_size", 64)), int(q.get("bits", 4)), ep_axis=ep_axis)
        if ep_axis is not None:
            moe = yield from moe
        elif tp_axis is not None:
            moe = yield from reduce(moe, tp_axis)
        return h + moe.reshape(b, t, hidden)

    def ep_layer_axes(self) -> dict:
        """The expert stacks split their leading (E) dim over ep."""
        return {"w_gate": 0, "w_up": 0, "w_down": 0}

    def tp_layer_axes(self) -> dict:
        """Megatron's split of the attention (whole heads a shard); the
        expert stacks split their intermediate dim, the router replicates."""
        return {
            "input_norm": None, "post_norm": None,
            "q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 0,
            "router": None,
            "w_gate": 2, "w_up": 2, "w_down": 1,
        }

    def map_weights(self, weights: dict) -> dict:
        """Llama's names, and each layer's per-expert tensors stacked on a
        leading E: dense (E, OUT, IN), or packed triples stacked per leaf."""
        sd = super().map_weights(weights)
        cfg = self.config
        for i in range(cfg.start_layer, cfg.end_layer):
            for ours, hf in _EXPERT_NAMES.items():
                parts = []
                for e in range(cfg.num_local_experts):
                    key = f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight"
                    parts.append(weights[key if key in weights else key.removeprefix("model.")])
                if isinstance(parts[0], dict):
                    stacked = {leaf: torch.stack([w[leaf] for w in parts]) for leaf in parts[0]}
                else:
                    stacked = torch.stack(parts)
                sd[f"layers.{i - cfg.start_layer}.{ours}.weight"] = stacked
        return sd
