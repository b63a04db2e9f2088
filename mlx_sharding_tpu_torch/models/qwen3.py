"""Qwen3 decoder (port of ``mlx_sharding_tpu/models/qwen3.py``): Llama's
structure with an RMSNorm over each head's query and key vectors (weights
(head_dim,)), applied after the projections' reshape and before RoPE;
``head_dim`` comes from the config, and QKV biases are optional. Everything
else, the fused QKV and gate+up of a packed load included, is
:class:`~mlx_sharding_tpu_torch.models.llama.LlamaModel`'s.
"""

from __future__ import annotations

import torch
from torch import nn

from mlx_sharding_tpu_torch.models.llama import LlamaLayer, LlamaModel
from mlx_sharding_tpu_torch.ops import rms_norm


class Qwen3Layer(LlamaLayer):
    def init_norms(self, cfg, kw) -> None:
        super().init_norms(cfg, kw)
        self.q_norm = nn.Parameter(torch.empty(cfg.head_dim, **kw))
        self.k_norm = nn.Parameter(torch.empty(cfg.head_dim, **kw))


class Qwen3Model(LlamaModel):
    LAYER = Qwen3Layer
    HF_LAYER_MAP = {
        **LlamaModel.HF_LAYER_MAP,
        "self_attn.q_norm.weight": "q_norm",
        "self_attn.k_norm.weight": "k_norm",
    }

    def head_norms(self, p, q, k):
        eps = self.config.rms_norm_eps
        return rms_norm(q, p.q_norm, eps), rms_norm(k, p.k_norm, eps)
