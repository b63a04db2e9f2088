"""MLX grouped-affine quantization (port of ``mlx_sharding_tpu/ops/quant.py``).

Published ``*-4bit`` MLX checkpoints store each linear as a triple
``{weight, scales, biases}``:

- ``weight``: 32-bit words, shape (out, in * bits / 32); each word packs
  ``32 / bits`` consecutive input-dim codes, least-significant bits first;
- ``scales`` / ``biases``: (out, in / group_size); a weight is
  ``code * scale + bias`` for its group.

The port holds the words as an ``int32`` view of the same bits (PyTorch has
no right shift for ``uint32`` on the CPU). Shifting an int32 right copies
the sign bit in from the top, but every code is masked to its ``bits`` low
bits after the shift, so the codes come out exactly as from unsigned words.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from mlx_sharding_tpu_torch.ops.quant_matmul import GEMV_MAX_M, quant_gemv, quant_matmul

PACKED_LEAVES = ("q", "scales", "biases")


def dequantize(w_q, scales, biases, group_size: int = 64, bits: int = 4,
               dtype=torch.bfloat16) -> torch.Tensor:
    """(..., out, in*bits/32) packed words -> (..., out, in) dense in
    ``dtype``; leading dims carry stacked layers. ``code * scale + bias`` is
    computed in f32, as in the JAX package."""
    if w_q.dtype != torch.int32:
        raise ValueError(f"packed words must be an int32 view, got {w_q.dtype}")
    lead = w_q.shape[:-1]
    per_word = 32 // bits
    shifts = torch.arange(per_word, dtype=torch.int32, device=w_q.device) * bits
    vals = (w_q[..., None] >> shifts) & ((1 << bits) - 1)
    vals = vals.reshape(*lead, -1).float()
    in_dim = vals.shape[-1]
    s = scales.float().reshape(*lead, in_dim // group_size, 1)
    b = biases.float().reshape(*lead, in_dim // group_size, 1)
    grouped = vals.reshape(*lead, in_dim // group_size, group_size)
    return (grouped * s + b).reshape(*lead, in_dim).to(dtype)


def is_quantized(w) -> bool:
    """True for a packed ``{q, scales, biases}`` triple, False for a dense
    tensor."""
    return isinstance(w, Mapping) and "q" in w


def fuse_packed(parts) -> dict:
    """Concatenate packed triples that share IN along OUT (dim -2 of every
    leaf), so one launch serves the group (QKV, gate+up). Each output row
    is computed as it was in its own projection, so the fused product is
    bit-identical to the separate ones."""
    if not all(is_quantized(p) for p in parts):
        raise ValueError("fuse_packed expects packed {q, scales, biases} triples")
    return {leaf: torch.cat([p[leaf] for p in parts], dim=-2) for leaf in PACKED_LEAVES}


def linear(x: torch.Tensor, w, group_size: int = 64, bits: int = 4) -> torch.Tensor:
    """``x @ W.T`` for a dense (out, in) ``w`` or a packed triple.

    Packed: M = the product of x's leading dims; M <= ``GEMV_MAX_M`` goes
    to the decode GEMV kernel, larger M to the tiled dequant-matmul kernel.
    On CPU tensors both wrappers compute the plain version; on CUDA tensors
    they launch their kernel or raise (for example IN not a multiple of
    ``group_size``). The dense weight never exists in device memory."""
    if not is_quantized(w):
        return torch.nn.functional.linear(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    kernel = quant_gemv if x2.shape[0] <= GEMV_MAX_M else quant_matmul
    out = kernel(x2, w["q"], w["scales"], w["biases"], group_size, bits)
    return out.reshape(*lead, -1)


def quantize_torch(w: torch.Tensor, group_size: int = 64, bits: int = 4):
    """Device-side MLX-layout packer (the counterpart of ``quantize_jax``):
    (..., out, in) -> (q (..., out, in*bits/32) int32 view of the words,
    scales, biases (..., out, in/group_size) f32). Same arithmetic as
    :func:`quantize`, on whatever device ``w`` lies."""
    w = w.float()
    *lead, out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} not divisible by group_size {group_size}")
    grouped = w.reshape(*lead, out_dim, in_dim // group_size, group_size)
    w_max = grouped.amax(dim=-1, keepdim=True)
    w_min = grouped.amin(dim=-1, keepdim=True)
    n_levels = (1 << bits) - 1
    scale = torch.clamp((w_max - w_min) / n_levels, min=1e-8)
    q = torch.clamp(torch.round((grouped - w_min) / scale), 0, n_levels).to(torch.int64)
    per_word = 32 // bits
    q = q.reshape(*lead, out_dim, in_dim // per_word, per_word)
    shifts = torch.arange(per_word, dtype=torch.int64, device=w.device) * bits
    words = (q << shifts).sum(dim=-1)
    # the unsigned word's bits as an int32: subtract 2^32 from words >= 2^31
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return words, scale[..., 0], w_min[..., 0]


def quantize(w: np.ndarray, group_size: int = 64, bits: int = 4):
    """Inverse of :func:`dequantize`, the MLX-compatible packer (numpy, on
    the host): uint32 words and fp16 scales and biases, as in the JAX
    package."""
    w = np.asarray(w, np.float32)
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} not divisible by group_size {group_size}")
    grouped = w.reshape(out_dim, in_dim // group_size, group_size)
    w_max = grouped.max(axis=-1, keepdims=True)
    w_min = grouped.min(axis=-1, keepdims=True)
    n_levels = (1 << bits) - 1
    scale = np.maximum((w_max - w_min) / n_levels, 1e-8)
    q = np.clip(np.round((grouped - w_min) / scale), 0, n_levels).astype(np.uint32)
    q = q.reshape(out_dim, in_dim)
    per_word = 32 // bits
    packed = np.zeros((out_dim, in_dim // per_word), np.uint32)
    for j in range(per_word):
        packed |= q[:, j::per_word] << np.uint32(j * bits)
    return packed, scale[..., 0].astype(np.float16), w_min[..., 0].astype(np.float16)


def words_to_torch(q: np.ndarray) -> torch.Tensor:
    """numpy uint32 words -> the port's int32 view of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(q, np.uint32).view(np.int32).copy())
