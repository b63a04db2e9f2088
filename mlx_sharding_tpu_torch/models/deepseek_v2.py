"""DeepSeek-V2 decoder (port of ``mlx_sharding_tpu/models/deepseek_v2.py``):
MLA attention and fine-grained experts with shared experts.

- **MLA.** Queries come from ``q_proj``, or through a low-rank
  ``q_a_proj`` -> RMSNorm -> ``q_b_proj`` (q-LoRA). Keys and values come
  from one shared latent: ``kv_a_proj`` gives ``kv_lora_rank`` latent
  columns and one rope head of ``qk_rope_head_dim``; ``kv_b_proj`` expands
  the normed latent into per-head nope keys and values. RoPE rotates
  interleaved pairs, with YaRN frequencies and attention factor; with
  ``mscale_all_dim`` the softmax scale (from ``head_dim = nope + rope``) is
  multiplied by ``yarn_get_mscale(factor, mscale_all_dim) ** 2``.
- **Two cache layouts** (``mla_cache_mode``). ``"compressed"`` (the
  default) caches the latent and the rope head, one "head" of ``rank +
  rope`` a token, and a dummy V of width 1: ``kv_b`` is absorbed into the
  query side (``bthn,hnr->bthr``) and the output side (``bthr,hrv->bthv``),
  and the attention reads its values from the keys' first ``rank`` columns
  (``causal_attention(q, k, k[..., :rank])``; ``values_from_k=rank`` for an
  injected ``attn_fn``). ``"full"`` caches per-head keys of ``nope + rope``
  and values of ``v_head_dim``.
- **Experts.** Layers below ``first_k_dense_replace`` are dense SwiGLU; the
  rest route over ``n_routed_experts`` experts (``ops.moe.deepseek_routing``:
  greedy or group-limited) beside always-on shared experts, a dense SwiGLU
  of ``moe_intermediate_size * n_shared_experts``.

The JAX model runs its dense and MoE layers as two scans over two stacked
parameter trees; here every layer is its own module, so there are no
stacks to split. The router always stays dense under a packed load, and in
compressed mode ``kv_b_proj`` too (``packed_keep_dense_re``): the absorbed
products read it as a tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlx_sharding_tpu_torch.cache import write_layer_kv
from mlx_sharding_tpu_torch.config import DeepseekV2Config
from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from mlx_sharding_tpu_torch.models.llama import LlamaModel, _first_key
from mlx_sharding_tpu_torch.models.mixtral import ExpertStack
from mlx_sharding_tpu_torch.ops import causal_attention, rms_norm
from mlx_sharding_tpu_torch.ops.attention import _product_f32
from mlx_sharding_tpu_torch.ops.moe import apply_experts, deepseek_routing
from mlx_sharding_tpu_torch.parallel.mesh import reduce
from mlx_sharding_tpu_torch.ops.rope import (apply_rope_interleaved, rope_frequencies,
                                             yarn_frequencies, yarn_get_mscale)


class DeepseekV2Layer(nn.Module):
    """One decoder layer's weights on the ``meta`` device: MLA, then a dense
    SwiGLU (``moe=False``) or the router, the expert stacks and the shared
    experts."""

    def __init__(self, cfg: DeepseekV2Config, dtype, moe: bool):
        super().__init__()
        hd, heads = cfg.hidden_size, cfg.num_attention_heads
        nope, rope_d, v_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        rank = cfg.kv_lora_rank
        kw = dict(device="meta", dtype=dtype)
        self.input_norm = nn.Parameter(torch.empty(hd, **kw))
        self.post_norm = nn.Parameter(torch.empty(hd, **kw))
        if cfg.q_lora_rank is None:
            self.q_proj = nn.Linear(hd, heads * (nope + rope_d), bias=False, **kw)
        else:
            self.q_a_proj = nn.Linear(hd, cfg.q_lora_rank, bias=False, **kw)
            self.q_a_norm = nn.Parameter(torch.empty(cfg.q_lora_rank, **kw))
            self.q_b_proj = nn.Linear(cfg.q_lora_rank, heads * (nope + rope_d), bias=False, **kw)
        self.kv_a_proj = nn.Linear(hd, rank + rope_d, bias=False, **kw)
        self.kv_a_norm = nn.Parameter(torch.empty(rank, **kw))
        self.kv_b_proj = nn.Linear(rank, heads * (nope + v_d), bias=False, **kw)
        self.o_proj = nn.Linear(heads * v_d, hd, bias=False, **kw)
        self.moe = moe
        if moe:
            e, mi = cfg.n_routed_experts, cfg.moe_intermediate_size
            si = mi * (cfg.n_shared_experts or 1)
            self.router = nn.Linear(hd, e, bias=False, **kw)
            self.w_gate = ExpertStack(e, mi, hd, **kw)
            self.w_up = ExpertStack(e, mi, hd, **kw)
            self.w_down = ExpertStack(e, hd, mi, **kw)
            self.shared_gate = nn.Linear(hd, si, bias=False, **kw)
            self.shared_up = nn.Linear(hd, si, bias=False, **kw)
            self.shared_down = nn.Linear(si, hd, bias=False, **kw)
        else:
            inter = cfg.intermediate_size
            self.gate_proj = nn.Linear(hd, inter, bias=False, **kw)
            self.up_proj = nn.Linear(hd, inter, bias=False, **kw)
            self.down_proj = nn.Linear(inter, hd, bias=False, **kw)


# HF per-layer names -> this module's, shared by dense and MoE layers
_ATTN_NAMES = {
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_norm",
    "self_attn.kv_a_proj_with_mqa.weight": "kv_a_proj.weight",
    "self_attn.kv_a_layernorm.weight": "kv_a_norm",
    "self_attn.kv_b_proj.weight": "kv_b_proj.weight",
    "self_attn.o_proj.weight": "o_proj.weight",
}
_Q_NAMES = {"self_attn.q_proj.weight": "q_proj.weight"}
_Q_LORA_NAMES = {
    "self_attn.q_a_proj.weight": "q_a_proj.weight",
    "self_attn.q_a_layernorm.weight": "q_a_norm",
    "self_attn.q_b_proj.weight": "q_b_proj.weight",
}
_DENSE_NAMES = {
    "mlp.gate_proj.weight": "gate_proj.weight",
    "mlp.up_proj.weight": "up_proj.weight",
    "mlp.down_proj.weight": "down_proj.weight",
}
_MOE_NAMES = {
    "mlp.gate.weight": "router.weight",
    "mlp.shared_experts.gate_proj.weight": "shared_gate.weight",
    "mlp.shared_experts.up_proj.weight": "shared_up.weight",
    "mlp.shared_experts.down_proj.weight": "shared_down.weight",
}
_EXPERT_NAMES = {"w_gate": "gate_proj", "w_up": "up_proj", "w_down": "down_proj"}


class DeepseekV2Model(LlamaModel):
    """The Llama module's forward, generation hooks, head and random init;
    its own layers, attention and weight names."""

    def __init__(self, config: DeepseekV2Config, dtype=torch.bfloat16):
        super(LlamaModel, self).__init__(config, dtype)  # BaseModel's, not Llama's layers
        cfg = config
        if cfg.mla_cache_mode not in ("compressed", "full"):
            raise ValueError(f"mla_cache_mode={cfg.mla_cache_mode!r}: want compressed or full")
        self.layers = nn.ModuleList(
            DeepseekV2Layer(cfg, dtype, moe=cfg.start_layer + i >= cfg.first_k_dense_replace)
            for i in range(cfg.num_local_layers))
        kw = dict(device="meta", dtype=dtype)
        if cfg.needs_embed:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        if cfg.needs_head:
            self.final_norm = nn.Parameter(torch.empty(cfg.hidden_size, **kw))
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        self.requires_grad_(False)
        scaling = cfg.rope_scaling or {}
        yarn = scaling.get("type", scaling.get("rope_type")) == "yarn"
        if yarn:
            inv_freq, self.rope_scale = yarn_frequencies(
                cfg.qk_rope_head_dim, cfg.rope_theta, scaling, cfg.max_position_embeddings)
        else:
            inv_freq, self.rope_scale = rope_frequencies(cfg.qk_rope_head_dim,
                                                         cfg.rope_theta, None), 1.0
        self.inv_freq = torch.from_numpy(inv_freq)
        # from head_dim = nope + rope, whatever the cache's width
        self.scale = cfg.head_dim ** -0.5
        if yarn and scaling.get("mscale_all_dim"):
            self.scale *= yarn_get_mscale(float(scaling["factor"]),
                                          float(scaling["mscale_all_dim"])) ** 2

    @property
    def compressed(self) -> bool:
        return self.config.mla_cache_mode == "compressed"

    def cache_head_dim(self):
        cfg = self.config
        if self.compressed:  # the latent and the rope head; V a dummy
            return (cfg.kv_lora_rank + cfg.qk_rope_head_dim, 1)
        return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)

    def cache_num_heads(self) -> int:
        return 1 if self.compressed else self.config.num_attention_heads

    def packed_keep_dense_re(self):
        if self.compressed:
            return r"mlp\.gate\.weight$|self_attn\.kv_b_proj\.weight$"
        return r"mlp\.gate\.weight$"

    def fused_projection_groups(self) -> dict:
        return {}

    def attn_options(self, p) -> dict:
        """Compressed mode: an injected ``attn_fn`` reads the values from the
        keys' first ``kv_lora_rank`` columns."""
        return {"values_from_k": self.config.kv_lora_rank} if self.compressed else {}

    # ------------------------------------------------------------------
    def _kv_b(self, p):
        """kv_b's dense weight as (H, nope + v, rank); a tp shard's H is
        its own heads."""
        cfg = self.config
        return p.kv_b_proj.weight.view(-1, cfg.qk_nope_head_dim + cfg.v_head_dim,
                                        cfg.kv_lora_rank)

    def layer_attn_inputs(self, p: DeepseekV2Layer, h, offset):
        """``(q, k_new, v_new)`` at positions ``offset .. offset+T``. Compressed:
        q (B, T, H, rank + rope) with kv_b's key half absorbed, k_new (B, T,
        1, rank + rope) the normed latent and the rotated rope head, v_new
        zeros (B, T, 1, 1). Full: per-head q and k of nope + rope, v of
        ``v_head_dim``."""
        cfg = self.config
        b, t, _ = h.shape
        nope, rope_d, rank = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        if self.inv_freq.device != h.device:
            self.place_constants(h.device)
        r = rms_norm(h, p.input_norm, cfg.rms_norm_eps)
        if cfg.q_lora_rank is None:
            q = self._linear(r, p.q_proj)
        else:
            q = self._linear(rms_norm(self._linear(r, p.q_a_proj), p.q_a_norm, cfg.rms_norm_eps),
                             p.q_b_proj)
        q = q.view(b, t, -1, nope + rope_d)
        q_nope = q[..., :nope]
        q_pe = apply_rope_interleaved(q[..., nope:], self.inv_freq, offset, self.rope_scale)
        ckv = self._linear(r, p.kv_a_proj)  # (B, T, rank + rope)
        latent = rms_norm(ckv[..., :rank], p.kv_a_norm, cfg.rms_norm_eps)
        k_pe = apply_rope_interleaved(ckv[:, :, None, rank:], self.inv_freq, offset,
                                      self.rope_scale)  # one shared rope head
        if self.compressed:
            heads = q.shape[2]
            w_bk = self._kv_b(p)[:, :nope]  # (H, nope, rank)
            q_lat = _product_f32(q_nope.permute(2, 0, 1, 3).reshape(heads, b * t, nope), w_bk)
            q_lat = q_lat.to(h.dtype).view(heads, b, t, rank).permute(1, 2, 0, 3)
            q_cat = torch.cat([q_lat, q_pe], dim=-1)
            k_new = torch.cat([latent[:, :, None, :], k_pe], dim=-1)
            return q_cat, k_new, torch.zeros((b, t, 1, 1), dtype=h.dtype, device=h.device)
        kv = self._linear(latent, p.kv_b_proj).view(b, t, -1, nope + cfg.v_head_dim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:-1], rope_d)], dim=-1)
        return torch.cat([q_nope, q_pe], dim=-1), k, v

    def finish_steps(self, p: DeepseekV2Layer, h, attn, tp_axis=None, ep_axis=None):
        """Compressed mode's latent output through kv_b's value half, the O
        projection with its residual (summed over tp: its heads are
        split), then the dense or routed MLP. Under tp alone the routed and
        shared experts are both partial and take one sum over tp; under tp
        x ep the routed sum is made whole over ep inside the experts and
        only the shared experts' is summed over tp."""
        cfg = self.config
        b, t, hidden = h.shape
        if self.compressed:
            heads, rank = attn.shape[2], cfg.kv_lora_rank
            w_bv = self._kv_b(p)[:, cfg.qk_nope_head_dim :]  # (H, v, rank)
            out = _product_f32(attn.permute(2, 0, 1, 3).reshape(heads, b * t, rank),
                               w_bv.transpose(1, 2))
            attn = out.to(h.dtype).view(heads, b, t, -1).permute(1, 2, 0, 3)
        h = h + (yield from reduce(self._linear(attn.reshape(b, t, -1), p.o_proj), tp_axis))
        r = rms_norm(h, p.post_norm, cfg.rms_norm_eps)
        if not p.moe:
            return h + (yield from reduce(self._swiglu(r, p.gate_proj, p.up_proj, p.down_proj),
                                          tp_axis))
        flat = r.reshape(b * t, hidden)
        weights, idx = deepseek_routing(
            flat, p.router.weight, cfg.num_experts_per_tok, norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor, topk_method=cfg.topk_method,
            n_group=cfg.n_group, topk_group=cfg.topk_group)

        def stack(m):
            return m.packed if isinstance(m, QuantizedLinear) else m.weight

        q = getattr(cfg, "quantization", None) or {}
        routed = apply_experts(flat, weights, idx, stack(p.w_gate), stack(p.w_up),
                               stack(p.w_down), int(q.get("group_size", 64)),
                               int(q.get("bits", 4)), ep_axis=ep_axis)
        if ep_axis is not None:
            routed = yield from routed
        shared = self._swiglu(flat, p.shared_gate, p.shared_up, p.shared_down)
        if tp_axis is None:
            combined = routed + shared
        elif ep_axis is None:
            combined = yield from reduce(routed + shared, tp_axis)
        else:
            combined = routed + (yield from reduce(shared, tp_axis))
        return h + combined.reshape(b, t, hidden)

    def cache_tp_replicated(self) -> bool:
        # the compressed cache holds one latent "head" computed from
        # replicated projections: every tp shard keeps a whole copy
        return self.compressed

    def layer_group(self, p) -> str:
        """The JAX layer group of layer ``p``: ``"moe"`` or ``"dense"``."""
        return "moe" if p.moe else "dense"

    def ep_layer_axes(self) -> dict:
        """Only the moe group's routed stacks split over ep."""
        return {"moe": {"w_gate": 0, "w_up": 0, "w_down": 0}}

    def tp_layer_axes(self) -> dict:
        """Per group: the per-head projections (q or q_b, kv_b) column-
        parallel, o_proj row-parallel, the latent path and the router
        replicated; the routed stacks split their intermediate dim (over ep
        instead under tp x ep), the shared experts as a dense MLP."""
        cfg = self.config
        attn = {
            "input_norm": None, "post_norm": None,
            "kv_a_proj": None, "kv_a_norm": None,
            "kv_b_proj": 1, "o_proj": 0,
        }
        if cfg.q_lora_rank is None:
            attn["q_proj"] = 1
        else:
            attn.update({"q_a_proj": None, "q_a_norm": None, "q_b_proj": 1})
        fk = min(max(cfg.first_k_dense_replace, 0), cfg.num_hidden_layers)
        out = {}
        if fk > 0:
            out["dense"] = {**attn, "gate_proj": 1, "up_proj": 1, "down_proj": 0}
        if fk < cfg.num_hidden_layers:
            out["moe"] = {**attn, "router": None, "shared_gate": 1, "shared_up": 1,
                          "shared_down": 0, "w_gate": 2, "w_up": 2, "w_down": 1}
        return out

    def _swiglu(self, r, gate, up, down):
        return self._linear(F.silu(self._linear(r, gate)) * self._linear(r, up), down)

    def _layer(self, p, h, k_buf, v_buf, offset: int, pos, lengths=None):
        """One layer over the dense cache (``LlamaModel._layer``'s contract);
        compressed mode attends with the keys' latent columns as values."""
        where = offset if pos is None else pos
        q, k, v = self.layer_attn_inputs(p, h, where)
        k_buf, v_buf = write_layer_kv(k_buf, v_buf, k, v, where)
        values = k_buf[..., : self.config.kv_lora_rank] if self.compressed else v_buf
        attn = causal_attention(q, k_buf, values, offset, self.scale, position=pos,
                                lengths=lengths)
        return self.layer_finish(p, h, attn)

    # ------------------------------------------------------------------
    def map_weights(self, weights: dict) -> dict:
        """HF-named, stage-filtered tensors -> this module's state dict; each
        MoE layer's per-expert ``mlp.experts.{e}.{gate,up,down}_proj``
        stacked on a leading E (packed triples stacked per leaf)."""
        cfg = self.config

        def get(key):
            return weights[key if key in weights else key.removeprefix("model.")]

        sd = {}
        q_names = _Q_NAMES if cfg.q_lora_rank is None else _Q_LORA_NAMES
        for i in range(cfg.start_layer, cfg.end_layer):
            local = f"layers.{i - cfg.start_layer}."
            moe = self.layers[i - cfg.start_layer].moe
            for hf, ours in {**_ATTN_NAMES, **q_names,
                             **(_MOE_NAMES if moe else _DENSE_NAMES)}.items():
                sd[local + ours] = get(f"model.layers.{i}.{hf}")
            if not moe:
                continue
            for ours, hf in _EXPERT_NAMES.items():
                parts = [get(f"model.layers.{i}.mlp.experts.{e}.{hf}.weight")
                         for e in range(cfg.n_routed_experts)]
                if isinstance(parts[0], dict):
                    stacked = {leaf: torch.stack([w[leaf] for w in parts]) for leaf in parts[0]}
                else:
                    stacked = torch.stack(parts)
                sd[local + f"{ours}.weight"] = stacked
        if cfg.needs_embed:
            sd["embed_tokens.weight"] = _first_key(weights, "model.embed_tokens.weight",
                                                   "embed_tokens.weight")
        if cfg.needs_head:
            sd["final_norm"] = _first_key(weights, "model.norm.weight", "norm.weight")
            if not cfg.tie_word_embeddings:
                sd["lm_head.weight"] = _first_key(weights, "lm_head.weight")
        return sd
