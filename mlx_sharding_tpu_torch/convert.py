"""Carry the JAX package's parameters into the port's modules.

The tests run both packages on the same numbers with this: take the JAX
parameter tree to numpy with ``jax.tree.map(np.asarray, params)`` and hand
it to :func:`params_from_numpy`. JAX stores dense weights as ``(in, out)``
for ``x @ W``, the embedding as ``(V, H)`` and the untied LM head as
``(H, V)``; the port keeps PyTorch's ``(out, in)``. Packed ``{q, scales,
biases}`` leaves (a ``keep_quantized`` load, fused or not) keep MLX's
``(out, in)`` layout in both packages and are not transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import resolve_device
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops.quant import PACKED_LEAVES, is_quantized, words_to_torch

# JAX per-layer names -> (port name, transpose)
_LAYER_NAMES = {
    "input_norm": ("input_norm", False),
    "post_norm": ("post_norm", False),
    "q_proj": ("q_proj.weight", True),
    "k_proj": ("k_proj.weight", True),
    "v_proj": ("v_proj.weight", True),
    "o_proj": ("o_proj.weight", True),
    "gate_proj": ("gate_proj.weight", True),
    "up_proj": ("up_proj.weight", True),
    "down_proj": ("down_proj.weight", True),
    "q_bias": ("q_proj.bias", False),
    "k_bias": ("k_proj.bias", False),
    "v_bias": ("v_proj.bias", False),
}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) included, as a contiguous copy."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _packed(tree: dict, i=None) -> dict:
    """A packed numpy triple (layer ``i`` of a stacked one) as torch tensors."""
    leaf = lambda name: np.asarray(tree[name] if i is None else tree[name][i])  # noqa: E731
    return {name: words_to_torch(leaf(name)) if name == "q" else to_torch(leaf(name))
            for name in PACKED_LEAVES}


def params_from_numpy(config, tree: dict, device=None):
    """``config`` (a config dataclass of either package, or a config.json
    dict) and a numpy parameter tree of the JAX Llama model -> the port's
    ``LlamaModel`` holding the same numbers, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg_dict = config if isinstance(config, dict) else config.to_dict()
    layers = tree["layers"]
    dtype = to_torch(np.asarray(layers["input_norm"][:1])).dtype
    model, cfg = build_model(cfg_dict, dtype=dtype)
    fused_qkv = "qkv_proj" in layers
    sd = {}
    for name, stack in layers.items():
        for i in range(cfg.num_local_layers):
            if is_quantized(stack):  # packed (out, in) words: the name is the module
                sd[f"layers.{i}.{name}.weight"] = _packed(stack, i)
                continue
            if fused_qkv and name.endswith("_bias"):
                continue  # concatenated onto the fused module below
            ours, transpose = _LAYER_NAMES[name]
            w = np.asarray(stack[i])
            sd[f"layers.{i}.{ours}"] = to_torch(w.T if transpose else w)
        if fused_qkv and name == "q_bias":
            for i in range(cfg.num_local_layers):
                sd[f"layers.{i}.qkv_proj.bias"] = to_torch(np.concatenate(
                    [np.asarray(layers[b][i]) for b in ("q_bias", "k_bias", "v_bias")]))
    if cfg.needs_embed:
        embed = tree["embed"]["weight"]
        sd["embed_tokens.weight"] = _packed(embed) if is_quantized(embed) else to_torch(embed)
    if cfg.needs_head:
        sd["final_norm"] = to_torch(tree["final_norm"]["weight"])
        if not cfg.tie_word_embeddings:
            head = tree["lm_head"]["weight"]
            sd["lm_head.weight"] = (_packed(head) if is_quantized(head)
                                    else to_torch(np.asarray(head).T))
    model.load_weights(sd, dev, dtype)
    return model
