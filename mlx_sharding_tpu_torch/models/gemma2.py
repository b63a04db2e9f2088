"""Gemma-2 decoder (port of ``mlx_sharding_tpu/models/gemma2.py``).

Against Llama: the zero-centred ``(1 + w)`` RMSNorm, four norms a layer
(before and after the attention, before and after the feed-forward), a
GeGLU feed-forward (tanh-approximated GELU), the attention scale
``query_pre_attn_scalar ** -0.5``, the attention logits softcapped, a
sliding window on even layers (global layers between), the embedding
scaled by ``sqrt(hidden)`` (the factor rounded to the activations' dtype, as
JAX rounds it), a final logit softcap, and the head tied to the embedding.

Each layer knows its global index (``layer_idx``, JAX's stacked
``layer_idx``), and passes its window as a host int: a layer's kernel launch
is fixed, so a CUDA graph holds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlx_sharding_tpu_torch.models.llama import LlamaLayer, LlamaModel
from mlx_sharding_tpu_torch.ops import rms_norm
from mlx_sharding_tpu_torch.parallel.mesh import reduce


class Gemma2Layer(LlamaLayer):
    def init_norms(self, cfg, kw) -> None:
        for name in ("post_attn_norm", "pre_ffw_norm", "post_ffw_norm"):
            setattr(self, name, nn.Parameter(torch.empty(cfg.hidden_size, **kw)))


class Gemma2Model(LlamaModel):
    LAYER = Gemma2Layer
    NORM_OFFSET = 1.0
    HF_LAYER_MAP = {
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_attn_norm",
        "pre_feedforward_layernorm.weight": "pre_ffw_norm",
        "post_feedforward_layernorm.weight": "post_ffw_norm",
        "self_attn.q_proj.weight": "q_proj.weight",
        "self_attn.k_proj.weight": "k_proj.weight",
        "self_attn.v_proj.weight": "v_proj.weight",
        "self_attn.o_proj.weight": "o_proj.weight",
        "mlp.gate_proj.weight": "gate_proj.weight",
        "mlp.up_proj.weight": "up_proj.weight",
        "mlp.down_proj.weight": "down_proj.weight",
    }

    def __init__(self, config, dtype=torch.bfloat16):
        config.tie_word_embeddings = True  # the head is always the embedding
        super().__init__(config, dtype)
        for i, layer in enumerate(self.layers):
            layer.layer_idx = config.start_layer + i
        self.scale = config.query_pre_attn_scalar ** -0.5

    def attn_options(self, p) -> dict:
        cfg = self.config
        return {"logit_softcap": cfg.attn_logit_softcapping or None,
                "sliding_window": cfg.sliding_window if p.layer_idx % 2 == 0 else None}

    def finish_steps(self, p, h, attn, tp_axis=None, ep_axis=None):
        """The O projection into the post-attention norm (sandwich norms),
        then GeGLU into the post-feed-forward norm, each with its residual.
        The norms are nonlinear: under tp the partial products are summed
        before them."""
        b, t, _ = h.shape
        eps = self.config.rms_norm_eps
        attn_out = yield from reduce(self._linear(attn.reshape(b, t, -1), p.o_proj), tp_axis)
        h = h + rms_norm(attn_out, p.post_attn_norm, eps, offset=1.0)
        r = rms_norm(h, p.pre_ffw_norm, eps, offset=1.0)
        if hasattr(p, "gate_up_proj"):  # fused packed gate+up (tp = 1 only)
            gate, up = torch.split(self._linear(r, p.gate_up_proj),
                                   self.config.intermediate_size, dim=-1)
        else:
            gate, up = self._linear(r, p.gate_proj), self._linear(r, p.up_proj)
        ff = yield from reduce(self._linear(F.gelu(gate, approximate="tanh") * up, p.down_proj),
                               tp_axis)
        return h + rms_norm(ff, p.post_ffw_norm, eps, offset=1.0)

    def tp_layer_axes(self) -> dict:
        return {
            "input_norm": None, "post_attn_norm": None, "pre_ffw_norm": None,
            "post_ffw_norm": None, "layer_idx": None,
            "q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 0,
            "gate_proj": 1, "up_proj": 1, "down_proj": 0,
        }

    def embed_transform(self, h: torch.Tensor) -> torch.Tensor:
        # sqrt(hidden) rounded to the activations' dtype first, as JAX's
        # jnp.asarray(hidden ** 0.5, h.dtype)
        factor = float(torch.tensor(self.config.hidden_size ** 0.5, dtype=h.dtype))
        return h * factor

    def head_input(self, h):
        return rms_norm(h, self.final_norm, self.config.rms_norm_eps, offset=1.0)

    def head_transform(self, logits: torch.Tensor) -> torch.Tensor:
        cap = self.config.final_logit_softcapping
        return cap * torch.tanh(logits / cap) if cap else logits
