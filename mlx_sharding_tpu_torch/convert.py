"""Carry the JAX package's parameters into the port's modules.

The tests run both packages on the same numbers with this: take the JAX
parameter tree to numpy with ``jax.tree.map(np.asarray, params)`` and hand
it to :func:`params_from_numpy`. JAX stores dense weights as ``(in, out)``
for ``x @ W``, the embedding as ``(V, H)`` and the untied LM head as
``(H, V)``; the port keeps PyTorch's ``(out, in)``.
"""

from __future__ import annotations

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import resolve_device
from mlx_sharding_tpu_torch.models import build_model

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


def params_from_numpy(config, tree: dict, device=None):
    """``config`` (a config dataclass of either package, or a config.json
    dict) and a numpy parameter tree of the JAX Llama model -> the port's
    ``LlamaModel`` holding the same numbers, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg_dict = config if isinstance(config, dict) else config.to_dict()
    layers = tree["layers"]
    dtype = to_torch(np.asarray(layers["q_proj"][:1])).dtype
    model, cfg = build_model(cfg_dict, dtype=dtype)
    sd = {}
    for name, stack in layers.items():
        ours, transpose = _LAYER_NAMES[name]
        for i in range(cfg.num_local_layers):
            w = np.asarray(stack[i])
            sd[f"layers.{i}.{ours}"] = to_torch(w.T if transpose else w)
    if cfg.needs_embed:
        sd["embed_tokens.weight"] = to_torch(tree["embed"]["weight"])
    if cfg.needs_head:
        sd["final_norm"] = to_torch(tree["final_norm"]["weight"])
        if not cfg.tie_word_embeddings:
            sd["lm_head.weight"] = to_torch(np.asarray(tree["lm_head"]["weight"]).T)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, assign=True)
    return model
