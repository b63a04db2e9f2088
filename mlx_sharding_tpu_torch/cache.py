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
host ints here too (:func:`rewind_slot_offset` rolls one back).
:func:`export_pool_pages` gathers pages out of a pool (a new tensor per
leaf, scales with codes) and :func:`import_pool_pages` scatters them back
in place, so the addresses captured step graphs hold stay valid.

Dense slot caches (:func:`init_cache_slots`, JAX ``PipelineEngine.init_cache``):
M+1 caches of the full capacity, slot M the scratch that every inactive
slot writes into, with per-slot host offsets. They are the pool layout with
one page of ``max_seq`` rows per slot, ``(L, M+1, max_seq, H_kv, D)``, and
:func:`slot_table` is their page table: slot m's one page is page m.

A pipeline engine of S > 1 stages keeps one such pool (or set of slot
caches) per stage, over that stage's layers and on its device
(:class:`StagedKV`); the stages share the slot offsets and the page table,
so a request holds the same page ids on every stage. Its page blocks carry
one payload per stage (:func:`export_pool_pages`). At tp or ep > 1 a
stage's KV is one such pool a shard (:class:`ShardedKV`), the same page ids
again. Its page payload carries whole heads, as JAX's block out of its one
global array does: the export gathers the tp shards' pages (of ep index 0)
and joins them on the heads axis on the first shard's device, the import
splits them back and writes every ep copy in place, and a head-count
independent cache (MLA's latent) moves shard 0's pages alone. So a block
has the tp = 1 pool's leaf shapes and bytes whatever tp and ep, and
imports into a pool of another tp. On distinct cards the export costs one
device-to-device copy of the other shards' pages, and the import one back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.parallel.mesh import hop


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
    head_dim,
    dtype: torch.dtype,
    device: torch.device | str,
) -> KVCache:
    """Allocate an empty cache. ``head_dim`` is one int, or a ``(k_dim,
    v_dim)`` pair for per-tensor head dims (DeepSeek-V2's MLA: 192 / 128 per
    head in full mode, one latent head of 576 and a dummy V of width 1 in
    compressed mode)."""
    k_dim, v_dim = kv_dims(head_dim)
    shape = (num_layers, batch, max_seq, n_kv_heads)
    return KVCache(k=torch.zeros((*shape, k_dim), dtype=dtype, device=device),
                   v=torch.zeros((*shape, v_dim), dtype=dtype, device=device))


def kv_dims(head_dim) -> tuple:
    """``(k_dim, v_dim)`` of a model's ``cache_head_dim()``: an int serves
    both."""
    return tuple(head_dim) if isinstance(head_dim, (tuple, list)) else (head_dim, head_dim)


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


@dataclasses.dataclass
class StagedKV:
    """The KV of an S-stage pipeline engine: one :class:`PagedKV` per stage
    (a pool, or dense slot caches, over the stage's own layers, on its own
    device), all holding the same ``offsets`` list."""

    stages: list

    @property
    def offsets(self) -> list:
        return self.stages[0].offsets

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.stages)


@dataclasses.dataclass
class ShardedKV:
    """The KV of one stage at tp or ep > 1: one :class:`PagedKV` per shard
    of the stage, shard r = e * tp + t (JAX's ``_kv_spec``: a tp shard's
    pool or slot caches hold its own KV heads, or a whole copy of a
    head-count independent cache, ``replicated``; an ep shard keeps the
    copy its replicated attention writes), each on its shard's device, all
    holding the same ``offsets`` list."""

    shards: list
    tp: int = 1
    replicated: bool = False

    @property
    def whole(self) -> list:
        """The shards whose heads, in tp order, make the whole-head cache:
        the tp shards of ep index 0, or shard 0 alone for a replicated
        cache."""
        return self.shards[:1] if self.replicated else self.shards[: self.tp]

    @property
    def offsets(self) -> list:
        return self.shards[0].offsets

    @offsets.setter
    def offsets(self, value: list) -> None:
        for c in self.shards:
            c.offsets = value

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.shards)


def sharded(caches: list, tp: int = 1, replicated: bool = False):
    """Per-shard caches of one stage made to share the first one's slot
    offsets (the cache itself for one shard). ``tp``: the tp width (shard r
    = e * tp + t); ``replicated``: every shard holds a whole copy."""
    if len(caches) == 1:
        return caches[0]
    for c in caches[1:]:
        c.offsets = caches[0].offsets
    return ShardedKV(list(caches), tp=tp, replicated=replicated)


def shard_caches(cache) -> list:
    """The per-shard caches of one stage's cache, or ``[cache]``."""
    return cache.shards if isinstance(cache, ShardedKV) else [cache]


def staged(caches: list) -> StagedKV:
    """Per-stage caches made to share the first one's slot offsets."""
    for c in caches[1:]:
        c.offsets = caches[0].offsets
    return StagedKV(list(caches))


def stage_caches(cache) -> list:
    """The per-stage caches of a :class:`StagedKV`, or ``[cache]``."""
    return cache.stages if isinstance(cache, StagedKV) else [cache]


def stage_layers(cache) -> Optional[tuple]:
    """The per-stage layer counts of a :class:`StagedKV` (its stage layout,
    which a staged page block records), or None for one pool."""
    if not isinstance(cache, StagedKV):
        return None
    return tuple(kv_data(shard_caches(c)[0].k).shape[0] for c in cache.stages)


def pool_device(cache) -> torch.device:
    """The device of a single pool's leaves (a :class:`ShardedKV`'s first
    shard's, where its whole-head page payloads lie)."""
    return kv_data(shard_caches(cache)[0].k).device


def whole_pool(cache):
    """The pool geometry a page block of one stage's cache carries: the
    pool itself, or for a :class:`ShardedKV` a :class:`PagedKV` of meta
    tensors with its whole heads (its :attr:`ShardedKV.whole` shards'
    heads summed; JAX's global leaf), which nothing reads or writes."""
    if not isinstance(cache, ShardedKV):
        return cache
    parts = cache.whole

    def meta(*leaves):
        shape = list(leaves[0].shape)
        shape[3] = sum(t.shape[3] for t in leaves)
        return torch.empty(shape, dtype=leaves[0].dtype, device="meta")

    return PagedKV(k=_map_pool(meta, parts[0].k, *(c.k for c in parts[1:])),
                   v=_map_pool(meta, parts[0].v, *(c.v for c in parts[1:])),
                   offsets=cache.offsets)


def kv_row_bytes(cache) -> int:
    """K + V bytes of one position over every layer of a pool (every stage
    of a :class:`StagedKV`; a :class:`ShardedKV`'s whole heads once, as
    JAX's global leaves count them), scales included."""
    pools = [whole_pool(st) for st in stage_caches(cache)]
    return sum(t.shape[0] * t.shape[-2] * t.shape[-1] * t.element_size()
               for pool in pools for buf in (pool.k, pool.v)
               for t in (buf.values() if is_quantized_kv(buf) else (buf,)))


def init_cache_paged(num_layers: int, pool_pages: int, page_size: int, n_kv_heads: int,
                     head_dim, slots: int, dtype: torch.dtype, device,
                     quantized: bool = False) -> PagedKV:
    """A zeroed pool of ``pool_pages`` pages plus the scratch page, in
    ``dtype`` or, ``quantized``, as int8 codes with float32 scales (D + 4
    bytes per row and head instead of 2D in bf16). ``head_dim``: an int or
    a ``(k_dim, v_dim)`` pair, as :func:`init_cache` takes it."""
    lead = (num_layers, pool_pages + 1, page_size, n_kv_heads)

    def pool(dim):
        if not quantized:
            return torch.zeros((*lead, dim), dtype=dtype, device=device)
        return {"d": torch.zeros((*lead, dim), dtype=torch.int8, device=device),
                "s": torch.zeros((*lead, 1), dtype=torch.float32, device=device)}

    k_dim, v_dim = kv_dims(head_dim)
    return PagedKV(k=pool(k_dim), v=pool(v_dim), offsets=[0] * slots)


def init_page_table(slots: int, slot_pages: int, pool_pages: int) -> np.ndarray:
    """The (M+1, slot_pages) int32 page table, host side: every entry
    starts at the scratch page (id ``pool_pages``), and row M stays all
    scratch for the ticks of inactive slots."""
    return np.full((slots + 1, slot_pages), pool_pages, np.int32)


def init_cache_slots(num_layers: int, slots: int, max_seq: int, n_kv_heads: int, head_dim,
                     dtype: torch.dtype, device) -> PagedKV:
    """``slots`` dense caches of ``max_seq`` positions plus the scratch slot
    (JAX ``init_cache``: the leaf ``(S, L, M+1, B, seq, H, D)`` with S = B =
    1 dropped), zeroed, each slot's offset 0. ``head_dim``: an int or a
    ``(k_dim, v_dim)`` pair, as :func:`init_cache` takes it."""
    return init_cache_paged(num_layers, slots, max_seq, n_kv_heads, head_dim, slots, dtype,
                            device)


def slot_table(slots: int) -> np.ndarray:
    """The (M+1, 1) int32 page table of the dense slot caches: row m maps
    slot m's one page, m, and row M the scratch slot."""
    return np.arange(slots + 1, dtype=np.int32)[:, None]


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


def read_pool_rows(pool, page_ids: torch.Tensor, row_pos: torch.Tensor):
    """Copies of the rows at ``[page_ids[n], row_pos[n]]`` of one layer's
    pool, as stored (an int8 pool's codes and scales): what
    :func:`restore_pool_rows` puts back."""
    return _map_pool(lambda leaf: leaf[page_ids, row_pos], pool)


def restore_pool_rows(pool, page_ids: torch.Tensor, row_pos: torch.Tensor, saved) -> None:
    """Write rows that :func:`read_pool_rows` took back in place, as they
    were (no requantization). Duplicate targets carry equal rows, read
    before any write."""

    def put(leaf, old):
        leaf[page_ids, row_pos] = old

    _map_pool(put, pool, saved)


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


def _map_pool(fn, buf, *others):
    """``fn`` over a pool's leaves: the tensor, or each of an int8 pool's
    ``{"d", "s"}`` leaves with the matching leaves of ``others``."""
    if is_quantized_kv(buf):
        return {key: fn(buf[key], *(o[key] for o in others)) for key in buf}
    return fn(buf, *others)


def export_pool_pages(cache, page_ids: torch.Tensor):
    """Gather pool pages ``page_ids`` (an int64 vector) out of a paged
    cache's K and V (JAX ``export_pool_pages``): one ``index_select``
    along the pool axis (1 here, 2 in JAX's ``(S, L, P+1, B, page, H, D)``)
    per leaf, an int8 pool's scales with its codes. Returns ``(k_pages,
    v_pages)`` shaped like the pool leaves with the pool axis narrowed to
    ``len(page_ids)``, in new tensors that later writes to the pool leave
    alone. Enqueued on the current stream of the pool's device, nothing
    read back.

    A :class:`StagedKV` gives one payload per stage, in stage order (lists
    of the per-stage trees), each gathered on its stage's device: JAX's
    one leaf with every stage on axis 0. JAX pads an uneven split to its
    largest stage; the port gathers each stage's own layers, so a staged
    payload is smaller than JAX's at an uneven split and equal at an even
    one.

    A :class:`ShardedKV` gives one whole-head payload (JAX's global leaf):
    each of its :attr:`ShardedKV.whole` shards' pages gathered on its
    device, then joined on the heads axis (3) in tp order on the first
    shard's device."""
    if isinstance(cache, StagedKV):
        parts = [export_pool_pages(c, page_ids.to(pool_device(c))) for c in cache.stages]
        return [k for k, _ in parts], [v for _, v in parts]
    if isinstance(cache, ShardedKV):
        dev = pool_device(cache)
        parts = [export_pool_pages(c, page_ids.to(pool_device(c))) for c in cache.whole]
        if len(parts) == 1:
            return parts[0]
        join = lambda *leaves: torch.cat([hop(t, dev) for t in leaves], dim=3)  # noqa: E731
        return (_map_pool(join, *(k for k, _ in parts)),
                _map_pool(join, *(v for _, v in parts)))
    take = lambda leaf: leaf.index_select(1, page_ids)  # noqa: E731
    return _map_pool(take, cache.k), _map_pool(take, cache.v)


def import_pool_pages(cache, k_pages, v_pages, page_ids: torch.Tensor):
    """Scatter exported page payloads into pool pages ``page_ids`` of
    ``cache``, the inverse of :func:`export_pool_pages` (JAX
    ``import_pool_pages``). The pool is written IN PLACE (``index_copy_``):
    its tensors are never rebound, since the captured prefill and decode
    graphs hold their addresses. Payload leaves must already sit on the
    pool's device (each stage's on its stage's); they are cast to the
    pool's dtype. A :class:`StagedKV` takes the per-stage lists its export
    gave. A :class:`ShardedKV` takes a whole-head payload on its first
    shard's device: shard r = e * tp + t gets heads ``[t·H, (t+1)·H)`` of it
    (all of them for a replicated cache), so every ep copy is written.
    Returns ``cache``."""
    if isinstance(cache, StagedKV):
        for c, k, v in zip(cache.stages, k_pages, v_pages, strict=True):
            import_pool_pages(c, k, v, page_ids.to(pool_device(c)))
        return cache
    if isinstance(cache, ShardedKV):
        for r, c in enumerate(cache.shards):
            dev, t = pool_device(c), r % cache.tp

            def part(blk, pool, dev=dev, t=t):
                if not cache.replicated:
                    h = pool.shape[3]
                    blk = blk.narrow(3, t * h, h)
                return hop(blk, dev)

            import_pool_pages(c, _map_pool(part, k_pages, c.k), _map_pool(part, v_pages, c.v),
                              page_ids.to(dev))
        return cache

    def put(pool, blk):
        pool.index_copy_(1, page_ids, blk.to(pool.dtype))

    _map_pool(put, cache.k, k_pages)
    _map_pool(put, cache.v, v_pages)
    return cache


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
