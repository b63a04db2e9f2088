"""Preallocated dense KV cache (port of the dense subset of
``mlx_sharding_tpu/cache.py``).

Layout: keys and values stacked over the stage's local layers,
``k, v : (L, B, S, H_kv, D)``, plus ``offset``, the number of valid
positions. Unlike the JAX cache, whose buffers are immutable and donated,
:func:`write_layer_kv` updates K/V IN PLACE, and ``offset`` is a host
``int``: the generator always knows it, and a device scalar would force a
sync to read it. The paged-pool helpers come with the paged slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor  # (L, B, S, H_kv, D)
    v: torch.Tensor  # (L, B, S, H_kv, D)
    offset: int = 0  # number of valid positions

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(
    num_layers: int,
    batch: int,
    max_seq: int,
    n_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    device: torch.device | str,
) -> KVCache:
    """Allocate an empty cache. (The MLA layouts' separate K and V head
    dims come with the DeepSeek slice.)"""
    shape = (num_layers, batch, max_seq, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def write_layer_kv(k_buf, v_buf, k_new, v_new, offset: int):
    """Write ``k_new``/``v_new`` (B, T, H_kv, D) into one layer's buffers
    (B, S, H_kv, D) at ``offset``, in place. Returns the buffers."""
    t = k_new.shape[1]
    if offset + t > k_buf.shape[1]:
        raise ValueError(f"KV write of {t} rows at {offset} overflows capacity {k_buf.shape[1]}")
    k_buf[:, offset : offset + t] = k_new
    v_buf[:, offset : offset + t] = v_new
    return k_buf, v_buf


def advance(cache: KVCache, n_tokens: int) -> KVCache:
    return dataclasses.replace(cache, offset=cache.offset + int(n_tokens))


def check_capacity(cache: KVCache, n_new: int) -> None:
    """Raise before writing ``n_new`` tokens past the cache's capacity."""
    if cache.offset + n_new > cache.max_seq:
        raise ValueError(
            f"KV cache overflow: offset {cache.offset} + {n_new} new tokens exceeds "
            f"capacity {cache.max_seq}. Allocate a larger max_seq."
        )


def reset(cache: KVCache) -> KVCache:
    """Invalidate without reallocating."""
    return dataclasses.replace(cache, offset=0)
