"""Preallocated KV caches (port of ``mlx_sharding_tpu/cache.py``): the
dense per-request cache and the paged pool that continuous batching shares
across slots.

Dense layout: keys and values stacked over the stage's local layers,
``k, v : (L, B, S, H_kv, D)``, plus ``offset``, the number of valid
positions. Unlike the JAX cache, whose buffers are immutable and donated,
:func:`write_layer_kv` updates K/V IN PLACE, and ``offset`` is a host
``int``: the generator always knows it, and reading a device scalar would
force a sync. A cache that captured steps run over also carries ``pos``, the
same position as a (1,) int64 device tensor (JAX's ``offset`` array): the
forward reads it for the K/V write, RoPE and the T=1 attention mask, and the
step that owns the cache moves it, so a replayed step reads a position that
no host int baked into the graph.

Paged layout (:class:`PagedKV`): one pool per K and V of shape
``(L, P+1, page, H_kv, D)``, the JAX leaf ``(S, L, P+1, B, page, H, D)``
with S = B = 1 dropped; page P is scratch. An int8 pool is a ``{"d": int8,
"s": float32 (…, 1)}`` pair (:func:`quantize_kv_rows`). Slot offsets are
host ints here too (:func:`rewind_slot_offset` rolls one back). Exporting
and importing pool pages (spill, migration) come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor  # (L, B, S, H_kv, D)
    v: torch.Tensor  # (L, B, S, H_kv, D)
    offset: int = 0  # number of valid positions
    # the position as a (1,) int64 tensor on the cache's device, or None
    pos: Optional[torch.Tensor] = None

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


def write_layer_kv(k_buf, v_buf, k_new, v_new, offset):
    """Write ``k_new``/``v_new`` (B, T, H_kv, D) into one layer's buffers
    (B, S, H_kv, D) at ``offset``, in place. Returns the buffers.

    ``offset`` is a host int, checked against the capacity, or a (1,) device
    tensor. A device position is clamped to ``S - T`` as JAX's
    ``dynamic_update_slice`` clamps its start: a write past the capacity
    lands on the last rows instead of raising or leaving the buffer. The
    single-stream generator runs whole decode blocks, so the steps past a
    request's last token may write there; their tokens are dropped, and no
    valid row sits that far (the last token a request keeps is never
    written)."""
    t = k_new.shape[1]
    if isinstance(offset, torch.Tensor):
        start = offset.clamp(0, k_buf.shape[1] - t)
        rows = start + torch.arange(t, device=k_buf.device)
        k_buf.index_copy_(1, rows, k_new.to(k_buf.dtype))
        v_buf.index_copy_(1, rows, v_new.to(v_buf.dtype))
        return k_buf, v_buf
    if offset + t > k_buf.shape[1]:
        raise ValueError(f"KV write of {t} rows at {offset} overflows capacity {k_buf.shape[1]}")
    k_buf[:, offset : offset + t] = k_new
    v_buf[:, offset : offset + t] = v_new
    return k_buf, v_buf


def advance(cache: KVCache, n_tokens: int) -> KVCache:
    """The host offset moved by ``n_tokens``; ``pos`` is left to the step
    that owns it."""
    return dataclasses.replace(cache, offset=cache.offset + int(n_tokens))


def check_capacity(cache: KVCache, n_new: int) -> None:
    """Raise before writing ``n_new`` tokens past the cache's capacity."""
    if cache.offset + n_new > cache.max_seq:
        raise ValueError(
            f"KV cache overflow: offset {cache.offset} + {n_new} new tokens exceeds "
            f"capacity {cache.max_seq}. Allocate a larger max_seq."
        )


def reset(cache: KVCache) -> KVCache:
    """Invalidate without reallocating (``pos`` is zeroed on the device)."""
    if cache.pos is not None:
        cache.pos.zero_()
    return dataclasses.replace(cache, offset=0)


# ------------------------------------------------------------- paged pool
def is_quantized_kv(buf) -> bool:
    """True for an int8 KV buffer: ``{"d": int8 data, "s": float32
    scales}`` with the scale's trailing dim 1 broadcasting over head_dim."""
    return isinstance(buf, dict) and "d" in buf


def kv_data(buf) -> torch.Tensor:
    """The data leaf of a KV buffer: the int8 payload of a quantized pool,
    the tensor itself otherwise."""
    return buf["d"] if is_quantized_kv(buf) else buf


def quantize_kv_rows(rows: torch.Tensor) -> dict:
    """(…, H, D) float rows -> ``{"d": int8, "s": float32 (…, H, 1)}`` with
    a per-row-per-head symmetric scale ``max|x| / 127`` (floor 1e-12),
    rounded half to even and clipped to ±127. Per-row scales keep every
    write a pure write: a decode tick writes one row into a page without
    touching the page's other rows."""
    x = rows.float()
    s = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    d = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"d": d, "s": s}


def dequantize_kv(buf, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`; a dense buffer passes through
    cast to ``dtype``."""
    if not is_quantized_kv(buf):
        return buf.to(dtype)
    return (buf["d"].float() * buf["s"]).to(dtype)


@dataclasses.dataclass
class PagedKV:
    """The page pool of a continuous-batching engine. ``k``/``v`` are
    (L, P+1, page, H_kv, D) tensors or int8 ``{"d", "s"}`` pairs, written
    in place; ``offsets[m]`` is slot m's number of valid positions, a host
    int. Position p of slot m lives at pool page ``table[m, p // page]``,
    row ``p % page`` (:func:`init_page_table`)."""

    k: object
    v: object
    offsets: list

    @property
    def nbytes(self) -> int:
        leaves = [b for buf in (self.k, self.v)
                  for b in (buf.values() if is_quantized_kv(buf) else (buf,))]
        return sum(t.numel() * t.element_size() for t in leaves)


def init_cache_paged(num_layers: int, pool_pages: int, page_size: int, n_kv_heads: int,
                     head_dim: int, slots: int, dtype: torch.dtype, device,
                     quantized: bool = False) -> PagedKV:
    """A zeroed pool of ``pool_pages`` pages plus the scratch page, in
    ``dtype`` or, ``quantized``, as int8 codes with float32 scales (D + 4
    bytes per row and head instead of 2D in bf16)."""
    shape = (num_layers, pool_pages + 1, page_size, n_kv_heads, head_dim)

    def pool():
        if not quantized:
            return torch.zeros(shape, dtype=dtype, device=device)
        return {"d": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device)}

    return PagedKV(k=pool(), v=pool(), offsets=[0] * slots)


def init_page_table(slots: int, slot_pages: int, pool_pages: int) -> np.ndarray:
    """The (M+1, slot_pages) int32 page table, host side: every entry
    starts at the scratch page (id ``pool_pages``), and row M stays all
    scratch for the ticks of inactive slots."""
    return np.full((slots + 1, slot_pages), pool_pages, np.int32)


def write_pool_rows(pool, page_ids: torch.Tensor, row_pos: torch.Tensor, rows: torch.Tensor):
    """Write ``rows`` (N, H_kv, D) into one layer's pool (P+1, page, H_kv,
    D), row n at ``[page_ids[n], row_pos[n]]``, in place; an int8 pool gets
    the quantized rows. Duplicate targets (inactive slots all write the
    scratch page's row 0) keep one of the rows."""
    if is_quantized_kv(pool):
        q = quantize_kv_rows(rows)
        pool["d"][page_ids, row_pos] = q["d"]
        pool["s"][page_ids, row_pos] = q["s"]
    else:
        pool[page_ids, row_pos] = rows.to(pool.dtype)


def write_pool_span(pool, page_id: torch.Tensor, start: int, rows: torch.Tensor):
    """Write ``rows`` (T, H_kv, D) into rows ``start .. start+T`` of the
    pool page ``page_id``, a (1,) int64 tensor on the pool's device (a
    captured chunk reads its write page on the device), in place (quantized
    for an int8 pool): a prefill chunk, which never straddles a page."""
    t = rows.shape[0]
    if is_quantized_kv(pool):
        q = quantize_kv_rows(rows)
        pool["d"][:, start : start + t].index_copy_(0, page_id, q["d"][None])
        pool["s"][:, start : start + t].index_copy_(0, page_id, q["s"][None])
    else:
        pool[:, start : start + t].index_copy_(0, page_id, rows[None].to(pool.dtype))


def rewind_slot_offset(cache: "PagedKV", slot: int, steps: int) -> None:
    """Roll slot ``slot``'s host offset back by ``steps`` positions
    (floored at 0), in place: an async batcher reclaiming a slot that
    finished while a lookahead decode block was in flight (the block's
    dispatch advanced the offset one block past the slot's end) keeps the
    offset inside the pages it returns."""
    cache.offsets[slot] = max(cache.offsets[slot] - steps, 0)


def layer_pool(buf, layer: int):
    """One layer's (P+1, page, H_kv, D) pool out of the stacked one (an
    int8 pair stays a pair), as views."""
    if is_quantized_kv(buf):
        return {"d": buf["d"][layer], "s": buf["s"][layer]}
    return buf[layer]
