"""Carry the JAX package's parameters into the port's modules.

The tests run both packages on the same numbers with this: take the JAX
parameter tree to numpy with ``jax.tree.map(np.asarray, params)`` and hand
it to :func:`params_from_numpy`. JAX stores dense weights as ``(in, out)``
for ``x @ W`` (expert stacks as ``(E, in, out)``), the embedding as
``(V, H)`` and the untied LM head as ``(H, V)``; the port keeps PyTorch's
``(out, in)``. Packed ``{q, scales, biases}`` leaves (a ``keep_quantized``
load, fused or not, expert stacks included) keep MLX's ``(out, in)`` layout
in both packages and are not transposed. Gemma-2's stacked ``layer_idx``
becomes each layer's ``layer_idx``. DeepSeek-V2's layer groups (``{"dense":
..., "moe": ...}``, each stacked over its own layers) land on the layers in
order, the dense group first.
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
    # Qwen3
    "q_norm": ("q_norm", False),
    "k_norm": ("k_norm", False),
    # Gemma-2
    "post_attn_norm": ("post_attn_norm", False),
    "pre_ffw_norm": ("pre_ffw_norm", False),
    "post_ffw_norm": ("post_ffw_norm", False),
    # Mixtral: (in, out) router, (E, in, out) expert stacks
    "router": ("router.weight", True),
    "w_gate": ("w_gate.weight", True),
    "w_up": ("w_up.weight", True),
    "w_down": ("w_down.weight", True),
    # DeepSeek-V2: MLA, (in, out) router, shared experts
    "q_a_proj": ("q_a_proj.weight", True),
    "q_a_norm": ("q_a_norm", False),
    "q_b_proj": ("q_b_proj.weight", True),
    "kv_a_proj": ("kv_a_proj.weight", True),
    "kv_a_norm": ("kv_a_norm", False),
    "kv_b_proj": ("kv_b_proj.weight", True),
    "shared_gate": ("shared_gate.weight", True),
    "shared_up": ("shared_up.weight", True),
    "shared_down": ("shared_down.weight", True),
}
# DeepSeek-V2's layer groups, in layer order
_GROUPS = ("dense", "moe")


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
    dict) and a numpy parameter tree of the JAX model (Llama, Qwen3,
    Gemma-2, Mixtral or DeepSeek-V2) -> the port's model holding the same numbers, on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg_dict = config if isinstance(config, dict) else config.to_dict()
    layers = tree["layers"]
    groups = [layers[g] for g in _GROUPS if g in layers] if "input_norm" not in layers else [layers]
    dtype = to_torch(np.asarray(groups[0]["input_norm"][:1])).dtype
    model, cfg = build_model(cfg_dict, dtype=dtype)
    sd = {}
    first = 0  # the group's first layer
    for group in groups:
        count = len(group["input_norm"])
        fused_qkv = "qkv_proj" in group
        for name, stack in group.items():
            if name == "layer_idx":
                for i in range(count):
                    model.layers[first + i].layer_idx = int(np.asarray(stack)[i])
                continue
            for i in range(count):
                at = f"layers.{first + i}"
                if is_quantized(stack):  # packed (out, in) words: the name is the module
                    sd[f"{at}.{name}.weight"] = _packed(stack, i)
                    continue
                if fused_qkv and name.endswith("_bias"):
                    continue  # concatenated onto the fused module below
                ours, transpose = _LAYER_NAMES[name]
                w = np.asarray(stack[i])
                sd[f"{at}.{ours}"] = to_torch(np.swapaxes(w, -1, -2) if transpose else w)
            if fused_qkv and name == "q_bias":
                for i in range(count):
                    sd[f"layers.{first + i}.qkv_proj.bias"] = to_torch(np.concatenate(
                        [np.asarray(group[b][i]) for b in ("q_bias", "k_bias", "v_bias")]))
        first += count
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
