"""Tensor- and expert-parallel sharding (port of
``mlx_sharding_tpu/parallel/tp.py``, and of the per-name shard rules of
JAX's ``place_weights``, ``mlx_sharding_tpu/parallel/pipeline.py:240-300``).

JAX annotates the stacked parameter tree with ``PartitionSpec``s and lets
GSPMD place each device's slice. Here each shard of the mesh gets a layer
module of its own (:func:`shard_layer`): a shallow copy of the model's layer
holding its slice of every split tensor. Column-parallel Q/K/V/gate/up are
split on their output dim (their biases with them), row-parallel O/down on
their contracting dim; the expert stacks split their E dim over ep (or their
intermediate dim over tp without ep). The models declare the split dims
(``tp_layer_axes`` / ``ep_layer_axes``) in JAX's orientation, dense weights
``(in, out)`` after the stacked-L axis; the port keeps PyTorch's ``(out,
in)``, which is also MLX's packed layout, so for a dense or a packed weight
alike a dense ``out`` split cuts dim -2 and a dense ``in`` split cuts dim -1
(JAX's ``quant_spec`` flip), and a leading stack dim (E) keeps its place.
JAX's divisibility checks, with its messages, double as guards that a split
of packed words and group scales lands on a word and a group boundary.

On one device a slice is a view of the model's tensor when it can be (a
split of the leading dims, or any split of a dense weight, which
``F.linear`` reads strided), so the shards hold the weights once. A packed
slice that is not contiguous (a row-parallel split, and the expert stacks'
splits) is copied into a contiguous tensor, which the kernels want, and the
model's whole tensor is then dropped, layer by layer, so the peak never
holds the weights twice: the model serves only through its shards after.
On distinct devices every slice is copied to its shard's device.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from mlx_sharding_tpu_torch.parallel.mesh import AXIS_EP, AXIS_TP


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one mesh axis name (or None) per dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def llama_param_specs(tp: Optional[str] = "tp", layers: Optional[str] = None) -> dict:
    """PartitionSpec tree matching the JAX Llama's stacked params (copied
    from ``mlx_sharding_tpu/parallel/tp.py``); ``layers`` optionally shards
    the stacked-layer axis."""
    col = P(layers, None, tp)  # (L, in, out): split output dim
    row = P(layers, tp, None)  # (L, in, out): split contracting dim
    norm = P(layers, None)
    bias = P(layers, tp)  # (L, out): follows its column-split projection
    return {
        "layers": {
            "input_norm": norm,
            "post_norm": norm,
            "q_proj": col,
            "k_proj": col,
            "v_proj": col,
            "o_proj": row,
            "gate_proj": col,
            "up_proj": col,
            "down_proj": row,
            "qkv_proj": col,
            "gate_up_proj": col,
            "q_bias": bias,
            "k_bias": bias,
            "v_bias": bias,
            "q_norm": norm,
            "k_norm": norm,
        },
        "embed": {"weight": P(None, None)},
        "final_norm": {"weight": P(None)},
        "lm_head": {"weight": P(None, tp)},
    }


def prune_specs(specs: dict, params: dict) -> dict:
    """Drop spec entries for params the stage doesn't have (copied)."""
    return {
        k: (prune_specs(specs[k], v) if isinstance(v, dict) else specs[k])
        for k, v in params.items()
    }


def merge_axes(model, tp: int, ep: int) -> dict:
    """JAX's per-name shard axes: ``{name: (per-layer dim, axis name)}``
    (nested ``{group: {...}}`` for DeepSeek's groups), tp first, then ep,
    which overrides tp for the expert stacks under tp x ep."""
    def merge(out, axes_map, axis_name):
        for n, ax in axes_map.items():
            if isinstance(ax, dict):
                out.setdefault(n, {})
                merge(out[n], ax, axis_name)
            elif ax is not None:
                out[n] = (ax, axis_name)

    axes: dict = {}
    if tp > 1:
        merge(axes, model.tp_layer_axes(), AXIS_TP)
    if ep > 1:
        merge(axes, model.ep_layer_axes(), AXIS_EP)
    return axes


def layer_axes(axes: dict, model, layer) -> dict:
    """The flat map of ``layer`` (its group's, for a grouped model)."""
    if any(isinstance(v, dict) for v in axes.values()):
        return axes.get(model.layer_group(layer), {})
    return axes


def port_dim(ax: int, ndim: int) -> int:
    """The port's dim of JAX's per-layer dim ``ax`` of a tensor of ``ndim``
    per-layer dims: a leading stack dim keeps its place; within the matrix
    pair, JAX's ``out`` (last) is the port's -2 and ``in`` its -1."""
    if ndim < 2 or ax < ndim - 2:
        return ax
    return ndim - 2 if ax == ndim - 1 else ndim - 1


def _check_div(name: str, size: int, axis_name: str, n: int) -> None:
    if size % n:
        raise ValueError(f"{name} dim {size} not divisible over {axis_name}={n}")


def _slice(t: torch.Tensor, dim: int, n: int, rank: int, device, packed: bool) -> torch.Tensor:
    """Shard ``rank`` of ``n`` of ``t`` along ``dim`` on ``device``: a view
    where it can be (the same device; contiguous for packed words), else a
    contiguous copy."""
    k = t.shape[dim] // n
    part = t.narrow(dim, rank * k, k)
    if part.device != device or (packed and not part.is_contiguous()):
        part = part.to(device, memory_format=torch.contiguous_format, copy=True)
    return part


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def shard_layer(layer: nn.Module, axes: dict, ranks: dict, device) -> tuple:
    """Shard ``ranks`` (``{axis name: (rank, size)}``) of ``layer`` on
    ``device``: a shallow copy of the module whose split tensors are its
    slices (the others the model's own, moved to ``device`` if it is
    another). ``axes``: the layer's flat ``{name: (JAX dim, axis)}``.
    Returns ``(module, names of the packed tensors it copied)``."""
    from mlx_sharding_tpu_torch.models.base import QuantizedLinear
    from mlx_sharding_tpu_torch.models.mixtral import ExpertStack

    device = torch.device(device)
    out = _copy_module(layer)
    copied = []
    for name, (ax, axis_name) in axes.items():
        rank, n = ranks[axis_name]
        if name in layer._parameters:
            w = layer._parameters[name]
            d = port_dim(ax, w.dim())
            _check_div(name, w.shape[d], axis_name, n)
            out._parameters[name] = _param(_slice(w, d, n, rank, device, False))
            continue
        mod = layer._modules.get(name)
        if mod is None:  # a name only JAX's tree has (q_bias, layer_idx)
            continue
        part = _copy_module(mod)
        if isinstance(mod, QuantizedLinear):
            nd = mod.q.dim()
            d = port_dim(ax, nd)
            for leaf in ("biases", "q", "scales"):  # JAX's (sorted) leaf order
                _check_div(f"{name}.{leaf}", getattr(mod, leaf).shape[d], axis_name, n)
            for leaf in ("q", "scales", "biases"):
                t = _slice(getattr(mod, leaf), d, n, rank, device, True)
                part._buffers[leaf] = t
            if (part._buffers["q"].untyped_storage().data_ptr()
                    != mod.q.untyped_storage().data_ptr()):
                copied.append(name)
            if mod.bias is not None:
                part._buffers["bias"] = _follow_bias(name, mod.bias, d, nd, n, rank, device)
        elif isinstance(mod, (nn.Linear, ExpertStack)):
            w = mod.weight
            d = port_dim(ax, w.dim())
            _check_div(name, w.shape[d], axis_name, n)
            part._parameters["weight"] = _param(_slice(w, d, n, rank, device, False))
            if getattr(mod, "bias", None) is not None:
                part._parameters["bias"] = _param(
                    _follow_bias(name, mod.bias, d, w.dim(), n, rank, device))
        else:
            raise TypeError(f"no shard rule for {name} ({type(mod).__name__})")
        out._modules[name] = part
    if device != _device_of(layer):
        _move_rest(out, axes, device)
    return out, copied


def _follow_bias(name, bias, d, nd, n, rank, device):
    """A projection's bias follows its column split; a row-split one would
    be summed over the shards, which no model has."""
    if d != nd - 2 or nd != 2:
        raise ValueError(f"{name}: a bias cannot follow a split of its contracting dim")
    return _slice(bias, 0, n, rank, device, False)


def _copy_module(mod: nn.Module) -> nn.Module:
    out = copy.copy(mod)
    out._parameters = dict(mod._parameters)
    out._buffers = dict(mod._buffers)
    out._modules = dict(mod._modules)
    return out


def _device_of(mod: nn.Module) -> torch.device:
    return next(t for t in list(mod.parameters()) + list(mod.buffers())).device


def _move_rest(out: nn.Module, split, device) -> None:
    """Every tensor of ``out`` not on ``device`` copied there (the
    replicated ones of a shard on another device than the model's)."""
    for key, sub in list(out._modules.items()):
        if key not in split and sub is not None:
            out._modules[key] = _copy_module(sub)
    for mod in out.modules():
        for key, t in list(mod._parameters.items()):
            if t is not None and t.device != device:
                mod._parameters[key] = _param(t.to(device))
        for key, t in list(mod._buffers.items()):
            if t is not None and t.device != device:
                mod._buffers[key] = t.to(device)


def drop_whole(layer: nn.Module, names: list) -> None:
    """Free the model's whole packed tensors of ``names`` once every shard
    holds a copy of its slice: the layer keeps empty tensors in their place
    and serves no longer."""
    for name in names:
        mod = layer._modules[name]
        for leaf in ("q", "scales", "biases"):
            t = mod._buffers[leaf]
            mod._buffers[leaf] = torch.empty(t.shape, dtype=t.dtype, device="meta")
