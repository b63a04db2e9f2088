"""Shared model infrastructure (port of ``mlx_sharding_tpu/models/base.py``).

A model is an ``nn.Module`` holding its weights. It is built on the
``meta`` device (no memory) and then either filled with random weights by
``init_params`` or given real tensors with ``load_state_dict(...,
assign=True)`` by the loaders. Dense weights keep PyTorch's ``(out, in)``
layout for ``F.linear``; the JAX package keeps ``(in, out)`` for ``x @ W``
(``convert.py`` transposes). The JAX ``lax.scan`` over stacked layers is a
Python loop over an ``nn.ModuleList``.

Packed 4- or 8-bit weights (``--keep-quantized``) live in
:class:`QuantizedLinear` modules, which keep MLX's ``(out, in)`` packed
layout; ``_linear``, the embedding and the LM head dispatch on them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlx_sharding_tpu_torch.cache import KVCache, init_cache
from mlx_sharding_tpu_torch.ops.quant import dequantize, fuse_packed, is_quantized
from mlx_sharding_tpu_torch.ops.quant import linear as quant_linear


class QuantizedLinear(nn.Module):
    """A projection kept packed: buffers ``q`` (OUT, IN*bits/32) int32 (the
    checkpoint's 32-bit words), ``scales`` and ``biases`` (OUT,
    IN/group_size) in the checkpoint's dtype, and an optional dense
    ``bias`` (OUT,) (Qwen2's QKV biases stay dense in MLX checkpoints). A
    stack of experts' projections carries leading dims, (E, OUT, ...), and
    is read by ``ops.moe``, not called."""

    def __init__(self, q, scales, biases, group_size: int = 64, bits: int = 4, bias=None):
        super().__init__()
        self.group_size = group_size
        self.bits = bits
        self.register_buffer("q", q)
        self.register_buffer("scales", scales)
        self.register_buffer("biases", biases)
        self.register_buffer("bias", bias)

    @classmethod
    def empty(cls, out_dim: int, in_dim: int, group_size: int, bits: int, *,
              bias_dtype, param_dtype, lead: tuple = ()) -> "QuantizedLinear":
        """A module of the right shapes on the ``meta`` device, to be given
        its tensors by ``load_state_dict(..., assign=True)``; ``lead``: the
        leading dims of a stack (experts)."""
        kw = dict(device="meta")
        groups = in_dim // group_size
        return cls(
            torch.empty(*lead, out_dim, in_dim * bits // 32, dtype=torch.int32, **kw),
            torch.empty(*lead, out_dim, groups, dtype=param_dtype, **kw),
            torch.empty(*lead, out_dim, groups, dtype=param_dtype, **kw),
            group_size, bits,
            None if bias_dtype is None else torch.empty(out_dim, dtype=bias_dtype, **kw),
        )

    @property
    def packed(self) -> dict:
        return {"q": self.q, "scales": self.scales, "biases": self.biases}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = quant_linear(x, self.packed, self.group_size, self.bits)
        return out if self.bias is None else out + self.bias

    def dequantized(self, dtype) -> torch.Tensor:
        """The dense (OUT, IN) weight these words stand for."""
        return dequantize(self.q, self.scales, self.biases, self.group_size, self.bits, dtype)


def apply_projection_fusion(model) -> list[str]:
    """Fuse each group that the model declares in ``fused_projection_groups``
    IN PLACE: in every layer whose group members are all packed, one
    :class:`QuantizedLinear` holding their triples concatenated along OUT
    (``fuse_packed``) replaces them, so a decode step serves the group with
    one launch over one read of the activations. Dense biases are
    concatenated likewise. Groups with a dense member stay as they are.
    Returns the fused names added."""
    fused = []
    for layer in getattr(model, "layers", []):
        for fname, parts in model.fused_projection_groups().items():
            mods = [getattr(layer, p, None) for p in parts]
            if not all(isinstance(m, QuantizedLinear) for m in mods):
                continue
            triple = fuse_packed([m.packed for m in mods])
            biases = [m.bias for m in mods]
            bias = None if any(b is None for b in biases) else torch.cat(biases)
            setattr(layer, fname, QuantizedLinear(triple["q"], triple["scales"],
                                                  triple["biases"], mods[0].group_size,
                                                  mods[0].bits, bias))
            for p in parts:
                delattr(layer, p)
            if fname not in fused:
                fused.append(fname)
    return fused


class BaseModel(nn.Module):
    """Common surface: ``forward(x, cache) -> (logits or hidden, cache)``
    where ``x`` is token ids (B, T) on the first stage or hidden states
    (B, T, H) downstream. The families override the hooks of the JAX
    ``BaseModel``: ``embed_transform``, ``head_input``, ``head_transform``,
    ``head_is_tied``, ``packed_keep_dense_re`` and, for the attention's
    options, ``attn_options``."""

    #: projections may stay packed (``loading.load_model(keep_quantized=True)``)
    supports_packed = False

    def __init__(self, config, dtype=torch.bfloat16):
        super().__init__()
        self.config = config
        # the dtype that paths materialising dense values from packed weights
        # (the embedding's row dequantization) produce; the loader sets it
        # to the load dtype so that packed and dense loads agree
        self.compute_dtype = dtype
        # forwards run eagerly on the card (a captured step's replays run none)
        self.eager_forwards = 0

    @staticmethod
    def _linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
        """``x @ W.T (+ b)`` for a dense ``nn.Linear`` or a packed
        :class:`QuantizedLinear` (the quant kernels' dispatch)."""
        if isinstance(layer, QuantizedLinear):
            return layer(x)
        return F.linear(x, layer.weight, layer.bias)

    def sp_layer(self, p, h, offset, attn_fn):
        """One decoder layer with the attention op injected (JAX
        ``BaseModel.sp_layer``): ``attn_fn(q, k_new, v_new, **opts) ->
        attn``, ``opts`` the layer's :meth:`attn_options` (a logit softcap,
        a sliding window). The ragged paged decode passes one that writes
        the new rows into the page pool and attends over the pool in place;
        ``offset`` is then a (B,) tensor of per-row positions. Returns
        ``(h, k_new, v_new)``."""
        q, k, v = self.layer_attn_inputs(p, h, offset)
        return self.layer_finish(p, h, attn_fn(q, k, v, **self.attn_options(p))), k, v

    def attn_options(self, p) -> dict:
        """The attention options of layer ``p``: ``logit_softcap`` and
        ``sliding_window`` as host numbers (a layer's launch is fixed, so a
        CUDA graph holds it). None: standard causal attention."""
        return {}

    def packed_keep_dense_re(self):
        """Regex over HF weight names that stay dense under
        ``keep_quantized`` (a MoE router, consumed by the routing's own
        product)."""
        return None

    def place_constants(self, device) -> None:
        """Move constants made on the host (RoPE tables) to ``device``."""

    def fused_projection_groups(self) -> dict:
        """{fused name: (source names, ...)}: per-layer projections that share
        their input and may be concatenated along OUT once packed. The
        forward pass dispatches on the fused name's presence."""
        return {}

    def load_weights(self, sd: dict, device, dtype) -> None:
        """Assign a state dict whose ``<module>.weight`` entries may be
        packed triples. Each packed entry's module becomes a
        :class:`QuantizedLinear` (words as int32, scales and biases in their
        own dtype, a dense ``.bias`` beside it in ``dtype``); dense tensors
        are cast to ``dtype``. Sources of a fused group that the state dict
        serves fused are removed. Everything lands on ``device``."""
        q = getattr(self.config, "quantization", None) or {}
        group_size, bits = int(q.get("group_size", 64)), int(q.get("bits", 4))
        flat = {}
        for key, value in sd.items():
            if not is_quantized(value):
                continue
            path = key.removesuffix(".weight")
            parent, _, name = path.rpartition(".")
            words, bias = value["q"], sd.get(f"{path}.bias")
            setattr(self.get_submodule(parent) if parent else self, name, QuantizedLinear.empty(
                words.shape[-2], words.shape[-1] * 32 // bits, group_size, bits,
                bias_dtype=None if bias is None else dtype, param_dtype=value["scales"].dtype,
                lead=tuple(words.shape[:-2]),
            ))
            flat[f"{path}.q"] = words.to(device)
            flat[f"{path}.scales"] = value["scales"].to(device)
            flat[f"{path}.biases"] = value["biases"].to(device)
        for key, value in sd.items():
            if not is_quantized(value):
                flat[key] = value.to(device=device, dtype=dtype)
        for layer in getattr(self, "layers", []):
            for fname, parts in self.fused_projection_groups().items():
                if hasattr(layer, fname):
                    for p in parts:
                        if hasattr(layer, p):
                            delattr(layer, p)
        self.load_state_dict(flat, assign=True)
        self.compute_dtype = dtype

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def cache_head_dim(self):
        """The cache's head dim: an int, or a ``(k_dim, v_dim)`` pair
        (DeepSeek-V2's MLA layouts)."""
        return self.config.head_dim

    def cache_num_heads(self) -> int:
        """KV heads the cache stores (one latent head for MLA's compressed
        layout)."""
        return self.config.num_key_value_heads

    def make_cache(self, batch: int, max_seq: int) -> KVCache:
        """An empty cache for the stage's layers, in the model's dtype and on
        its device, sized by :meth:`cache_head_dim` and
        :meth:`cache_num_heads`."""
        return init_cache(self.config.num_local_layers, batch, max_seq, self.cache_num_heads(),
                          self.cache_head_dim(), self.dtype, self.device)

    def embed_tokens_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.embed_tokens
        if isinstance(table, QuantizedLinear):
            # gather the looked-up rows' words, scales and biases and
            # dequantize only those; the (V, H) dense table never exists
            return dequantize(table.q[tokens], table.scales[tokens], table.biases[tokens],
                              table.group_size, table.bits, self.compute_dtype)
        return F.embedding(tokens, table.weight)

    def embed_transform(self, h: torch.Tensor) -> torch.Tensor:
        """Post-lookup transform (Gemma-2 scales by sqrt(hidden))."""
        return h

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_transform(self.embed_tokens_rows(tokens))

    def head_input(self, h):
        """Transform before the vocab projection (the final norm)."""
        raise NotImplementedError

    def head_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Elementwise transform after the vocab projection (Gemma-2's final
        softcap)."""
        return logits

    def head_is_tied(self) -> bool:
        """True when logits project through the embedding table."""
        return bool(self.config.tie_word_embeddings)

    def apply_head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits through the LM head, or the embedding when it is tied. A
        packed table is already (V, H), the head's packed orientation."""
        head = self.embed_tokens if self.head_is_tied() else self.lm_head
        h = self.head_input(h)
        if isinstance(head, QuantizedLinear):
            return self.head_transform(head(h))
        return self.head_transform(F.linear(h, head.weight))
