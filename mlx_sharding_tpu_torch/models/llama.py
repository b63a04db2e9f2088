"""Llama-family decoder (port of ``mlx_sharding_tpu/models/llama.py``); it
also serves Mistral and Qwen2 (QKV biases) through ``MODEL_REMAPPING``.

Pipeline-stage aware like the JAX model: the embedding only on the first
stage, the final norm and head only on the last; ``[start_layer,
end_layer)`` selects the local layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mlx_sharding_tpu_torch.cache import KVCache, advance, write_layer_kv
from mlx_sharding_tpu_torch.config import LlamaConfig
from mlx_sharding_tpu_torch.graphs import note_eager_forward
from mlx_sharding_tpu_torch.models.base import BaseModel
from mlx_sharding_tpu_torch.ops import apply_rope, causal_attention, rms_norm, rope_frequencies


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        hd, d = cfg.hidden_size, cfg.head_dim
        hq, hkv, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
        kw = dict(device="meta", dtype=dtype)
        self.input_norm = nn.Parameter(torch.empty(hd, **kw))
        self.post_norm = nn.Parameter(torch.empty(hd, **kw))
        self.q_proj = nn.Linear(hd, hq * d, bias=cfg.attention_bias, **kw)
        self.k_proj = nn.Linear(hd, hkv * d, bias=cfg.attention_bias, **kw)
        self.v_proj = nn.Linear(hd, hkv * d, bias=cfg.attention_bias, **kw)
        self.o_proj = nn.Linear(hq * d, hd, bias=False, **kw)
        self.gate_proj = nn.Linear(hd, inter, bias=False, **kw)
        self.up_proj = nn.Linear(hd, inter, bias=False, **kw)
        self.down_proj = nn.Linear(inter, hd, bias=False, **kw)


class LlamaModel(BaseModel):
    # projections may stay packed (loading.load_model(keep_quantized=True))
    supports_packed = True
    # HF per-layer weight names -> this module's names
    HF_LAYER_MAP = {
        "input_layernorm.weight": "input_norm",
        "post_attention_layernorm.weight": "post_norm",
        "self_attn.q_proj.weight": "q_proj.weight",
        "self_attn.k_proj.weight": "k_proj.weight",
        "self_attn.v_proj.weight": "v_proj.weight",
        "self_attn.o_proj.weight": "o_proj.weight",
        "mlp.gate_proj.weight": "gate_proj.weight",
        "mlp.up_proj.weight": "up_proj.weight",
        "mlp.down_proj.weight": "down_proj.weight",
    }
    HF_BIAS_MAP = {
        "self_attn.q_proj.bias": "q_proj.bias",
        "self_attn.k_proj.bias": "k_proj.bias",
        "self_attn.v_proj.bias": "v_proj.bias",
    }

    def __init__(self, config: LlamaConfig, dtype=torch.bfloat16):
        super().__init__(config, dtype)
        cfg = config
        self.layers = nn.ModuleList(LlamaLayer(cfg, dtype) for _ in range(cfg.num_local_layers))
        kw = dict(device="meta", dtype=dtype)
        if cfg.needs_embed:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        if cfg.needs_head:
            self.final_norm = nn.Parameter(torch.empty(cfg.hidden_size, **kw))
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        self.requires_grad_(False)
        # a plain attribute, not a buffer: to_empty would leave a buffer
        # uninitialised; moved to the activations' device once, on first use
        self.inv_freq = torch.from_numpy(
            rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        )
        self.scale = cfg.head_dim ** -0.5

    def place_constants(self, device) -> None:
        """Move the RoPE frequencies to ``device``: a copy from the host,
        which a captured step must not make, so the generators call this
        before their first step."""
        self.inv_freq = self.inv_freq.to(device)

    # ------------------------------------------------------------------
    def layer_attn_inputs(self, p: LlamaLayer, h, offset):
        """Norm, QKV projections (with Qwen2-style biases when configured)
        and RoPE at positions ``offset .. offset+T`` (``offset`` an int, or
        a (B,) tensor of per-row positions)."""
        b, t, _ = h.shape
        d = self.config.head_dim
        cfg = self.config
        r = rms_norm(h, p.input_norm, cfg.rms_norm_eps)
        if hasattr(p, "qkv_proj"):
            # fused packed projection (Generator applies the fusion): one
            # launch; the split sizes come from the config
            nq, nkv = cfg.num_attention_heads * d, cfg.num_key_value_heads * d
            q, k, v = torch.split(self._linear(r, p.qkv_proj), [nq, nkv, nkv], dim=-1)
        else:
            q, k, v = (self._linear(r, proj) for proj in (p.q_proj, p.k_proj, p.v_proj))
        q, k, v = (y.reshape(b, t, -1, d) for y in (q, k, v))
        if self.inv_freq.device != h.device:
            self.place_constants(h.device)
        return apply_rope(q, self.inv_freq, offset), apply_rope(k, self.inv_freq, offset), v

    def layer_finish(self, p: LlamaLayer, h, attn):
        """Output projection and the SwiGLU MLP, each with its residual."""
        b, t, _ = h.shape
        h = h + self._linear(attn.reshape(b, t, -1), p.o_proj)
        r = rms_norm(h, p.post_norm, self.config.rms_norm_eps)
        if hasattr(p, "gate_up_proj"):  # fused packed gate+up
            gate, up = torch.split(self._linear(r, p.gate_up_proj),
                                   self.config.intermediate_size, dim=-1)
        else:
            gate, up = self._linear(r, p.gate_proj), self._linear(r, p.up_proj)
        return h + self._linear(F.silu(gate) * up, p.down_proj)

    def _layer(self, p: LlamaLayer, h, k_buf, v_buf, offset: int, pos):
        """``offset`` is the host position (the flash kernel's); ``pos`` the
        cache's device position, or None to read ``offset`` everywhere."""
        where = offset if pos is None else pos
        q, k, v = self.layer_attn_inputs(p, h, where)
        k_buf, v_buf = write_layer_kv(k_buf, v_buf, k, v, where)
        attn = causal_attention(q, k_buf, v_buf, offset, self.scale, position=pos)
        return self.layer_finish(p, h, attn)

    def fused_projection_groups(self) -> dict:
        """QKV and gate+up share their input activations: once packed, each
        group is concatenated along OUT and served by one launch."""
        return {
            "qkv_proj": ("q_proj", "k_proj", "v_proj"),
            "gate_up_proj": ("gate_proj", "up_proj"),
        }

    def head_input(self, h):
        return rms_norm(h, self.final_norm, self.config.rms_norm_eps)

    def forward(self, x, cache: KVCache, n_valid: int | None = None,
                logits_at: int | torch.Tensor | None = None):
        """Run the stage over ``x`` and write its K/V into ``cache`` in
        place. ``n_valid`` advances the offset by fewer positions than T for
        a right-padded prefill chunk: pad rows are overwritten by later
        contiguous writes before any valid query attends them.
        ``logits_at`` computes the head for that one position only (B, 1, V)
        instead of all T: an int, or a (1,) device tensor (a captured
        chunk's last valid row). A cache with a device ``pos`` is written,
        rotated and masked at that position, which the forward reads and
        never moves. Returns ``(logits or hidden, advanced cache)``."""
        cfg = self.config
        note_eager_forward(self, x)
        h = self.embed(x) if cfg.is_first_stage else x
        for i, layer in enumerate(self.layers):
            h = self._layer(layer, h, cache.k[i], cache.v[i], cache.offset, cache.pos)
        cache = advance(cache, x.shape[1] if n_valid is None else n_valid)
        if not cfg.is_last_stage:
            return h, cache
        if isinstance(logits_at, torch.Tensor):
            h = h.index_select(1, logits_at.reshape(1))
        elif logits_at is not None:
            h = h[:, logits_at : logits_at + 1]
        return self.apply_head(h), cache

    # ------------------------------------------------------------------
    def map_weights(self, weights: dict) -> dict:
        """HF-named, stage-filtered tensors -> this module's state dict
        (global layer i lands in local slot i - start_layer). Packed
        ``{q, scales, biases}`` triples pass through as they are, in MLX's
        (out, in) orientation; ``load_weights`` places them."""
        cfg = self.config
        names = dict(self.HF_LAYER_MAP)
        if cfg.attention_bias:
            names.update(self.HF_BIAS_MAP)
        sd = {}
        for i in range(cfg.start_layer, cfg.end_layer):
            for hf, ours in names.items():
                key = f"model.layers.{i}.{hf}"
                sd[f"layers.{i - cfg.start_layer}.{ours}"] = weights[
                    key if key in weights else f"layers.{i}.{hf}"
                ]
        if cfg.needs_embed:
            sd["embed_tokens.weight"] = _first_key(
                weights, "model.embed_tokens.weight", "embed_tokens.weight"
            )
        if cfg.needs_head:
            sd["final_norm"] = _first_key(weights, "model.norm.weight", "norm.weight")
            if not cfg.tie_word_embeddings:
                sd["lm_head.weight"] = _first_key(weights, "lm_head.weight")
        return sd

    def init_params(self, generator: torch.Generator, device) -> "LlamaModel":
        """Random weights drawn on ``device`` from ``generator`` (tests and
        benchmarks only), with the JAX model's recipe: unit norms, normal
        projections scaled by 1/sqrt(in), a 0.02-scaled embedding."""
        self.to_empty(device=device)
        for name, w in self.named_parameters():
            if "norm" in name:
                w.fill_(1.0)
            elif name.endswith(".bias"):
                w.zero_()
            elif name == "embed_tokens.weight":
                w.normal_(0.0, 0.02, generator=generator)
            else:  # (out, in) projections, the LM head included
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)
        return self


def _first_key(weights: dict, *candidates: str):
    for c in candidates:
        if c in weights:
            return weights[c]
    raise KeyError(f"none of {candidates} present in checkpoint")
