"""The pipeline engine (port of
``mlx_sharding_tpu/parallel/pipeline.py::PipelineEngine``):
M slots of one model split into S pipeline stages, each slot with its own KV
offset, over a shared pool of KV pages (``pool_pages``) or over M+1 dense
slot caches (no pool, JAX ``init_cache``; slot M is the scratch every
inactive slot writes into).
The dense caches are laid out as a pool whose pages are whole slots
(``cache.init_cache_slots``, table ``cache.slot_table``), so both engines
plan their steps alike.

- :meth:`PipelineEngine.prefill_slot` runs one prefill chunk of one slot
  (JAX ``_build_prefill_slot``). Paged: it gathers the slot's pages below
  ``offset + chunk`` into a contiguous view (dequantized for an int8 pool),
  writes the chunk's K/V rows into the view unquantized, attends over it
  through ``causal_attention`` (the flash kernel on the card), and writes
  the chunk's rows into their page, quantized for an int8 pool. A chunk
  never straddles a page (``page_size % prefill_chunk == 0``). Dense: the
  rows go into the slot's cache and the flash kernel attends it in place,
  the slot a device index into the (M+1, S, Hkv, D) caches
  (``kv_index``). The host fills the engine's persistent prefill inputs
  (the slot's page row, the tokens, the last valid row) in one upload, and
  :meth:`prefill_step` reads them on the device: at a fixed offset the step
  is one program whatever the slot, its pages and ``n_valid``, so the
  batcher captures one CUDA graph per chunk offset (the flash kernel bakes
  the offset and its split plan into its launch).
- :meth:`PipelineEngine.decode_cb` is one T=1 step of all M slots (JAX
  ``_build_decode_cb``), then per-slot sampling. Its attention takes one
  of three paths (:attr:`decode_path`): ``ragged`` (a paged engine's
  default) writes the M new K/V rows into their pool pages (quantized
  first for an int8 pool) and ``paged_attention`` reads the pool in place;
  ``gather`` (JAX ``_paged_read`` / ``_paged_writeback``) gathers each
  slot's pages into a contiguous view (dequantized after the gather for an
  int8 pool), writes the new row into it, attends the view through the
  T=1 route and writes the touched page back (quantized for an int8 pool);
  ``dense`` writes the rows into the slot caches and attends them through
  the T=1 route in place. The T=1 route is ``flash_decode``: kernel 2's
  CUDA kernel over the contiguous caches seen as 128-position pages, with
  per-slot lengths made on the device (``slot_lengths``). An inactive slot
  writes to the scratch and attends at length 0. A step touches no host
  state, so the batcher captures a block of them as one CUDA graph;
  :meth:`PipelineEngine.advance_offsets` moves the host offsets after it.
- :meth:`PipelineEngine.spec_verify` (``spec_verify_cb`` /
  ``spec_verify_ngram_cb``) is one T=K forward of all M slots over ``[t0,
  d1..d_{K-1}]`` with per-slot acceptance (JAX ``_spec_verify_fn``, every
  position's logits kept). Its attention is ``masked_attention``, as JAX's
  verify is always its plain path. Paged: each slot's pages are gathered
  into a contiguous view over its whole table row (dequantized for an int8
  pool), the K new rows are written into the view and, through
  ``write_pool_rows``, into the pool (they may straddle a page; quantized
  for an int8 pool). Dense: the rows go into the slot caches, which are
  attended in place. The view spans the capacity, so one step serves every
  position.
- A dense engine is also the draft engine of speculation in the batcher
  (JAX ``spec_propose_cb`` / ``spec_replay_cb``): :meth:`spec_propose` runs
  K T=1 steps of every slot and returns the proposals (argmax for a greedy
  slot; for a sampled one a draw from its transformed distribution, with
  that distribution's log-probs), and :meth:`spec_replay` feeds the tokens
  of a plain decode block through the draft's caches.
- Every step is planned on the device: :meth:`PipelineEngine.
  device_inputs` uploads, in one copy into a persistent buffer that a
  captured step reads, each slot's table row, the active mask, the host's
  offsets and whether to take them, and a verify's drafts and window caps
  (:class:`DeviceInputs`); :meth:`device_plan` builds the step's pages,
  rows and lengths (:class:`DecodePlan`) from the slot offsets on the
  device. The host's offsets are taken whenever they are exact; a
  speculative round in flight moves the device's by counts the host has
  not read yet, so nothing is read back from the card inside a step.

- Layer-wise KV sharing (``kv_share_map``, a paged engine; JAX's
  ``_scan_layers_shared``): the pool holds one buffer per share group, layer
  i reads and writes group ``group_of[i]``'s (:attr:`PipelineEngine.
  pool_layer`), and only a group's owner, its lowest layer, keeps its rows
  there (:attr:`PipelineEngine.owner_layer`, fixed per engine, so a
  captured step has no branch on the card). A non-owner's prefill chunk
  and verify rows go into its gathered view only; on the gather path it
  writes no page back; on the ragged path it writes its rows into the pool
  for the paged kernel, which must read them in place, and then puts the
  owner's rows back (read before its write). The identity map keeps the
  unshared layout and code path.
- Shared weights (``weights``, a ``weights.ResidentWeights``): replicas run
  against one model module; everything an engine changes per step lives on
  the engine, and :meth:`PipelineEngine.close` runs its ``on_close`` hooks
  (a store lease's release) once.

Pipeline stages (``stages`` / ``stage_bounds``, JAX's ``pp`` axis): stage s
owns the layers ``[start, end)`` of its bounds (by default
:func:`balanced_stage_bounds`, the larger stages first) on its device
(``parallel.mesh.stage_devices``), with its own pool or slot caches over
those layers only (``cache.StagedKV``; the stages share the offsets and the
page table). Stage 0 embeds, the last stage applies the final norm and the
head, and the hidden state hops between stages (``hop``: an event, then
``.to(device, non_blocking=True)``; nothing on one device). On one device
the stages are slices of the model's layer list, so the weights are held
once whatever S. JAX runs one microbatch a tick through a GPipe loop of
S + M - 1 ticks; here all M slots run each stage as one batched forward, as
the pp = 1 step does, which gives the same tokens and on one card streams
each stage's weights once a step. Sampling runs after the last stage, on
stage 0's device. What JAX allows only at pp = 1 raises JAX's error here:
the ragged decode path (a paged engine at S > 1 takes ``gather``), a KV
share map, a compression map and the speculative steps. On one device a
step over every stage is one CUDA graph (the batcher's, or the single
stream's); on distinct devices (or with ``stage_graphs=True``) each
stage's share of a step is a graph of its own on its device
(``graphs.StageGraphs``, one set for each cache the engine steps) and the
rest of the step runs eagerly. At S > 1 each stage runs its layers through
a view of the model whose RoPE table lies on the stage's device
(:func:`stage_model`), so no stage moves a table another stage's program
reads. Stages on distinct devices have not been run on more than one
card.

:meth:`PipelineEngine.generate_step` is the single stream of JAX's engine,
a ``Generator`` over the engine's stages (:class:`StagedGenerator` over
:class:`_Stream`): every one of the M microbatches runs the same tokens
over dense slot caches of the stream's own (M = 1 serves one request), and
the stream is slot 0's; chunked prefill and decode blocks are captured as
at pp = 1 (:meth:`PipelineEngine.warm_up`).

Tensor and expert parallelism (``tp`` / ``ep``, JAX's mesh axes): every
stage runs as tp x ep shards, shard r = e * tp + t on the device grid's cell
(s, 0, e, t) (``parallel.mesh.device_grid``), each with its own layer
modules (:func:`place_weights`, ``parallel.tp.shard_layer``: column- and
row-parallel slices, expert stacks split over ep) and its own pool or slot
caches (``cache.ShardedKV``: its KV heads, or a whole copy of a head-count
independent cache). The loop over the shards runs inside each layer
(:meth:`PipelineEngine._layer_step`): every shard's attention and its part
of the layer up to a reduction, then the reduction in process
(``parallel.mesh.run_shards``), twice a layer under tp; the hidden state
after it is shard 0's. On one device a whole step is still one CUDA graph.
Fusion stays off, and the decode path is ``gather`` or ``dense`` (ragged
needs tp = ep = 1, as in JAX). Share maps group every shard's pool alike;
a page block carries whole heads (``cache.export_pool_pages``), so the
codecs act on the tp = 1 payload; the speculative verify runs its T = K
rows through the same shard loop, its reductions over every position
(JAX's keep-all body). Shards of a stage on distinct devices run eagerly:
one graph cannot hold a program over two cards.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
import weakref
from typing import Optional

import numpy as np
import torch
from torch import nn

from mlx_sharding_tpu_torch.cache import (
    KVCache,
    PagedKV,
    shard_caches,
    sharded,
    stage_caches,
    staged,
    dequantize_kv,
    init_cache_paged,
    init_cache_slots,
    init_page_table,
    quantize_kv_rows,
    is_quantized_kv,
    whole_pool,
    slot_table,
    kv_data,
    layer_pool,
    read_pool_rows,
    restore_pool_rows,
    write_pool_rows,
    write_pool_span,
)
from mlx_sharding_tpu_torch.device import upload_into
from mlx_sharding_tpu_torch.generate import BLOCK_KINDS, DEFAULT_DECODE_BLOCK, Generator
from mlx_sharding_tpu_torch.graphs import StageGraphs, note_eager_forward
from mlx_sharding_tpu_torch.models.base import apply_projection_fusion, undo_projection_fusion
from mlx_sharding_tpu_torch.ops.attention import causal_attention, masked_attention
from mlx_sharding_tpu_torch.ops.flash_attention import slot_lengths
from mlx_sharding_tpu_torch.ops.paged_attention import paged_attention
from mlx_sharding_tpu_torch.parallel.mesh import (
    ShardAxis,
    device_grid,
    hop,
    run_shards,
    same_mesh_devices,
)
from mlx_sharding_tpu_torch.parallel.tp import drop_whole, layer_axes, merge_axes, shard_layer
from mlx_sharding_tpu_torch.sample import draw, sample_token_batched, update_recent_tokens
from mlx_sharding_tpu_torch.speculative import dist_logits, verify_round
from mlx_sharding_tpu_torch.weights import ResidentWeights, model_weight_bytes, tree_weight_bytes


def balanced_stage_bounds(num_layers: int, num_stages: int) -> list[tuple[int, int]]:
    """Contiguous near-equal ``[start, end)`` bounds, the larger stages
    first (JAX's): the split when the caller gives no bounds."""
    base, extra = divmod(num_layers, num_stages)
    bounds, start = [], 0
    for s in range(num_stages):
        size = base + (1 if s < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def check_stage_bounds(stage_bounds, num_layers: int) -> list[tuple[int, int]]:
    """The bounds as a list of ``(start, end)`` pairs, with JAX's checks
    (``split_stage_stacks``): they cover every layer, contiguously, and no
    stage is empty."""
    bounds = [tuple(int(x) for x in b) for b in stage_bounds]
    if not bounds or bounds[0][0] != 0 or bounds[-1][1] != num_layers:
        raise ValueError(f"stage bounds {bounds} must cover all layers")
    for (_, a1), (b0, _) in zip(bounds, bounds[1:]):
        if a1 != b0:
            raise ValueError(f"stage bounds {bounds} must be contiguous")
    if any(e <= s for s, e in bounds):
        raise ValueError(f"stage bounds {bounds} contain an empty stage")
    return bounds


def resolve_stage_bounds(num_layers: int, stages: Optional[int] = None,
                         stage_bounds=None) -> list[tuple[int, int]]:
    """The split of ``num_layers`` layers: ``stage_bounds`` checked, or
    ``stages`` balanced stages (one without either)."""
    if stage_bounds is None:
        return balanced_stage_bounds(num_layers, stages or 1)
    if stages is not None and stages != len(stage_bounds):
        raise ValueError(f"{len(stage_bounds)} stage bounds for a {stages}-stage pp mesh")
    return check_stage_bounds(stage_bounds, num_layers)


def stage_model(model, start: int, end: int):
    """The stage ``[start, end)`` of a loaded full model, holding the
    model's own tensors: its layers ``start .. end`` (the same modules), the
    embedding where the stage embeds (the first stage, and the last for a
    tied head), the final norm and the head on the last stage. Its
    constants (the RoPE table) are its own once it places them
    (``place_constants``), so stages on distinct devices never move one
    another's."""
    stage = copy.copy(model)
    stage._modules = dict(model._modules)
    stage._parameters = dict(model._parameters)
    stage._buffers = dict(model._buffers)
    stage.__dict__.pop("_graph_pool", None)
    stage.config = cfg = dataclasses.replace(model.config, start_layer=start, end_layer=end)
    stage._modules["layers"] = nn.ModuleList(list(model.layers)[start:end])
    if not cfg.needs_embed:
        stage._modules.pop("embed_tokens", None)
    if not cfg.needs_head:
        stage._parameters.pop("final_norm", None)
        stage._modules.pop("lm_head", None)
    return stage


def _head_module(model):
    return model.embed_tokens if model.head_is_tied() else model.lm_head


def check_mesh_model(model, tp: int, ep: int) -> None:
    """JAX's checks of a model for tp / ep > 1: the wiring, and tp
    dividing the KV heads unless the cache is head-count independent."""
    if tp > 1:
        if not model.tp_layer_axes():
            raise ValueError(f"tensor parallelism is not wired for {type(model).__name__}")
        if not model.cache_tp_replicated() and model.cache_num_heads() % tp:
            raise ValueError(f"tp={tp} must divide the {model.cache_num_heads()} KV heads")
    if ep > 1 and not model.ep_layer_axes():
        raise ValueError(f"expert parallelism is not wired for {type(model).__name__}")


def place_weights(model, *, stages: Optional[int] = None, stage_bounds=None, tp: int = 1,
                  ep: int = 1, device=None) -> ResidentWeights:
    """Place a loaded full model for an S-stage engine at ``tp`` x ``ep``
    (JAX ``place_weights``) and return its :class:`ResidentWeights`, which
    carries the split, the device grid and each shard's layers. On one
    device nothing moves: the stages are slices of the model's layer list.
    On distinct devices each stage's layers move to its first shard's
    device, and the final norm and the head to the head table's (the last
    stage's; stage 0's for a tied embedding, whose one table serves both
    ends); the embedding and the head replicate over tp and ep, used on
    the first shard only. At tp or ep > 1 every shard of every stage gets
    its own layer modules (``parallel.tp.shard_layer``: views of the
    model's tensors, or contiguous copies of packed slices, whose whole
    tensor is then dropped layer by layer). Such a placement is the
    model's: a second call for the same split and grid returns it (JAX
    places a tree from the parameters anew each time; here the wholes it
    would slice are gone, and a second copy would double the packed
    bytes)."""
    cfg = model.config
    bounds = resolve_stage_bounds(cfg.num_hidden_layers, stages, stage_bounds)
    grid = device_grid(pp=len(bounds), tp=tp, ep=ep, device=device)
    key = (tuple(bounds), tp, ep, tuple(str(d) for d in grid.flat))
    placed = model.__dict__.setdefault("_mesh_placements", {})
    if tp * ep > 1 and key in placed:
        return placed[key]
    devices = list(grid[:, 0, 0, 0])
    if len(set(devices)) > 1:
        for (a, b), dev in zip(bounds, devices):
            model.layers[a:b].to(dev)
        head_dev = devices[0] if model.head_is_tied() else devices[-1]
        _head_module(model).to(head_dev)
        model.final_norm.data = model.final_norm.data.to(head_dev)
    shards = None
    if tp * ep > 1:
        check_mesh_model(model, tp, ep)
        # a fused group's OUT axis interleaves its members' rows, which a
        # column split would cut wrongly: split into its members first
        undo_projection_fusion(model)
        axes = merge_axes(model, tp, ep)
        shards = []
        for s, (a, b) in enumerate(bounds):
            per = [[] for _ in range(tp * ep)]
            for i in range(a, b):
                layer = model.layers[i]
                each = []
                for e, t in itertools.product(range(ep), range(tp)):
                    part, copied = shard_layer(layer, layer_axes(axes, model, layer),
                                               {"tp": (t, tp), "ep": (e, ep)}, grid[s, 0, e, t])
                    per[e * tp + t].append(part)
                    each.append(set(copied))
                drop_whole(layer, sorted(set.intersection(*each)))
            shards.append(tuple(per))
        shards = tuple(shards)
        rest = [getattr(model, n) for n in ("embed_tokens", "lm_head") if hasattr(model, n)]
        weight_bytes = tree_weight_bytes(
            [m for stage in shards for per in stage for m in per] + rest + [model.final_norm])
    else:
        weight_bytes = model_weight_bytes(model)
    out = ResidentWeights(model=model, device=devices[0], weight_bytes=weight_bytes,
                          stage_bounds=tuple(bounds), devices=tuple(devices), tp=tp, ep=ep,
                          grid=grid, shard_layers=shards)
    if tp * ep > 1:
        placed[key] = out
    return out


def shard_view(view, layers: list, device):
    """A stage's view (:func:`stage_model`) over one shard's layer modules,
    its constants on the shard's ``device``."""
    shard = copy.copy(view)
    shard._modules = dict(view._modules)
    shard._parameters = dict(view._parameters)
    shard._buffers = dict(view._buffers)
    shard.__dict__.pop("_graph_pool", None)
    shard._modules["layers"] = nn.ModuleList(layers)
    shard.place_constants(device)
    return shard


@dataclasses.dataclass
class DecodePlan:
    """The device-side inputs of a decode block's K steps, uploaded once
    into one persistent buffer per K: row j of each (K, M) tensor is step
    j."""

    # (K, M) int32: pool page of each slot's write position (a dense
    # engine's: the slot, or the scratch slot M)
    page_ids: torch.Tensor
    row_pos: torch.Tensor  # (K, M) int32: row of that position in its page
    lengths: torch.Tensor  # (K, M) int32: valid positions with the new one; 0 if inactive
    positions: torch.Tensor  # (K, M) int32: RoPE position of the new token
    tables: torch.Tensor  # (M, SPG) int32: slot table rows, all scratch if inactive


@dataclasses.dataclass
class DeviceInputs:
    """What a step planned on the device reads, uploaded in one copy into a
    persistent int32 buffer (:meth:`PipelineEngine.device_inputs`)."""

    rows: torch.Tensor  # (M, SPG): each slot's table row, scratch if inactive
    active: torch.Tensor  # (M,): 1 for a decoding slot
    reset: torch.Tensor  # (1,): 1 = the host's offsets are exact, take them
    offsets: torch.Tensor  # (M,): the host's slot offsets
    drafts: Optional[torch.Tensor]  # (K, M): a verify's proposals
    wcap: Optional[torch.Tensor]  # (M,): a verify's window caps


class PipelineEngine:
    """M continuous-batching slots of one model (the JAX engine, batch 1 per
    slot) in ``stages`` pipeline stages (or the stages of ``stage_bounds``)
    of ``tp`` x ``ep`` shards each, over a shared KV page pool
    (``pool_pages`` set) or M+1 dense slot caches (``pool_pages`` None).
    ``device``: every shard's device; None puts shard (s, e, t) on its own
    CUDA device, in the grid's order.

    At construction the model's packed projection groups are fused in
    place, as ``Generator`` does (``models.base.apply_projection_fusion``);
    at M <= 8 a packed decode step then runs the GEMV kernel. At tp or ep
    > 1 they are split back instead, and the shards are placed
    (:func:`place_weights`).
    ``decode_block`` and ``cuda_graphs`` are the single stream's
    (:meth:`generate_step`). ``stage_graphs``: capture each stage's share
    of a step on its own (``graphs.StageGraphs``, one set a cache: a
    program holds its cache's addresses) rather than whole steps; by
    default iff the stages are on distinct devices (``cuda_graphs`` off
    turns both off). At S > 1 stage s runs its layers through a view of the
    model (:func:`stage_model`) whose constants lie on its device: a
    captured program reads a RoPE table that no other stage moves."""

    def __init__(
        self,
        model,
        *,
        stages: Optional[int] = None,
        stage_bounds=None,
        tp: int = 1,
        ep: int = 1,
        microbatches: int = 1,
        max_seq: int = 4096,
        prefill_chunk: int = 256,
        pool_pages: Optional[int] = None,
        page_size: Optional[int] = None,
        paged_attention: str = "auto",
        kv_dtype: Optional[str] = None,
        kv_share_map=None,
        kv_compress_map=None,
        weights=None,
        device=None,
        decode_block: int = DEFAULT_DECODE_BLOCK,
        cuda_graphs: bool = True,
        stage_graphs: Optional[bool] = None,
    ):
        cfg = model.config
        if not (cfg.is_first_stage and cfg.is_last_stage):
            raise ValueError("PipelineEngine wants the full model config")
        #: the tensor- and expert-parallel widths: every stage runs as tp x
        #: ep shards, shard r = e * tp + t on the device grid's cell (s, e, t)
        self.tp, self.ep = tp, ep
        self.shards = tp * ep
        if self.shards > 1:
            check_mesh_model(model, tp, ep)
        placed = None
        # Weight residency (JAX ``weights=``): a ``weights.WeightStore``
        # lease's resident model, which other engines (replicas) run
        # against too, placed for its stage split and its grid. The caller
        # owns the lease and hangs its release on ``on_close()``.
        # Everything an engine changes lives on the engine.
        if weights is not None:
            if weights.model is not model:
                raise ValueError("resident weights hold another model than this engine's")
            bounds = [tuple(b) for b in (weights.stage_bounds
                                         or [(0, cfg.num_hidden_layers)])]
            if stage_bounds is not None and [tuple(b) for b in stage_bounds] != bounds:
                raise ValueError(f"stage_bounds {list(stage_bounds)} disagree with the resident "
                                 f"tree's split {bounds}")
            if stages is not None and stages != len(bounds):
                raise ValueError(f"{len(bounds)} stage bounds for a {stages}-stage pp mesh")
            grid = weights.grid
            if grid is None:
                grid = np.empty(len(bounds), dtype=object)
                grid[:] = list(weights.devices or [torch.device(weights.device)])
                grid = grid.reshape(-1, 1, 1, 1)
            if (weights.tp, weights.ep) != (tp, ep) or not same_mesh_devices(
                    grid, device_grid(pp=len(bounds), tp=tp, ep=ep, device=device)):
                raise ValueError(
                    "resident weights were placed on a different device grid than this "
                    "engine's mesh — aliased construction needs identical placement (same "
                    "devices, same axis layout)")
            placed = weights
        else:
            bounds = resolve_stage_bounds(cfg.num_hidden_layers, stages, stage_bounds)
            grid = device_grid(pp=len(bounds), tp=tp, ep=ep, device=device)
            if len(set(grid.flat)) > 1 or self.shards > 1:
                placed = place_weights(model, stage_bounds=bounds, tp=tp, ep=ep, device=device)
            elif model.device != grid.flat[0]:
                raise ValueError(f"the model is on {model.device}, the engine on {grid.flat[0]}")
        self.stage_bounds, self.grid = bounds, grid
        self.stage_devices = list(grid[:, 0, 0, 0])
        #: each stage's shards' devices, shard r = e * tp + t
        self.shard_devices = [list(grid[s, 0].flat) for s in range(len(bounds))]
        self.num_stages = len(self.stage_bounds)
        self.device = self.stage_devices[0]  # stage 0's: the inputs, the sampling
        self._one_device = len(set(grid.flat)) == 1
        head = _head_module(model)
        self._head_device = next(itertools.chain(head.parameters(), head.buffers())).device
        self.decode_block = decode_block
        self.cuda_graphs = cuda_graphs
        #: each stage's share of a step is captured on its own: the steps
        #: themselves are not (a batcher over this engine captures none)
        self.per_stage_graphs = (not self._one_device) if stage_graphs is None else stage_graphs
        # a stage's program spans its shards' devices, which one graph
        # cannot hold: shards of a stage on distinct devices run eagerly
        self._stage_capture = all(len(set(devs)) == 1 for devs in self.shard_devices)
        # id(cache) -> (a weak reference to it, its stages' programs)
        self._stage_graphs: dict = {}
        self._stream: Optional[StagedGenerator] = None  # made on first use
        self.weights_shared = weights is not None
        self.resident = weights
        self.model = model
        if self.shards == 1:
            # idempotent: a fused group is left as it is; at tp > 1 the
            # fused OUT axis would interleave the group's rows (JAX's rule)
            apply_projection_fusion(model)
        # the weight bytes a decode step streams (JAX ``weight_bytes``, the
        # batcher's bytes-a-token gauge): every tensor of the placement once
        self.weight_stream_bytes = (placed.weight_bytes if placed is not None
                                    else model_weight_bytes(model))
        self.microbatches = microbatches
        # chunk-multiple capacity: padded prefill writes stay in bounds
        self.max_seq = -(-max_seq // prefill_chunk) * prefill_chunk
        self.prefill_chunk = prefill_chunk
        self.cache_dtype = model.dtype

        # Paged KV: slots address up to max_seq/page_size pages out of a
        # shared pool of ``pool_pages`` physical pages; the batcher reserves
        # pages at admission. Dense: each slot owns a max_seq cache
        self.paged = pool_pages is not None
        self.page_size = page_size or prefill_chunk
        self.pool_pages = pool_pages
        if self.paged:
            if self.page_size % prefill_chunk:
                raise ValueError(
                    f"page_size {self.page_size} must be a multiple of the prefill chunk "
                    f"{prefill_chunk} (chunk writes must stay inside one page)"
                )
            if self.max_seq % self.page_size:
                raise ValueError(f"page_size {self.page_size} must divide max_seq "
                                 f"{self.max_seq}")
        self.slot_pages = self.max_seq // self.page_size  # table width
        # the geometry the device plans a step in: pool pages, or for the
        # dense caches one page of max_seq rows per slot, slot M the scratch
        self._plan_page = self.page_size if self.paged else self.max_seq
        self._plan_pages = self.slot_pages if self.paged else 1
        self._scratch = pool_pages if self.paged else microbatches

        if kv_dtype is None and self.paged:
            # a checkpoint may pin it (config.kv_cache_dtype); a dense engine
            # ignores the pin, as JAX's does
            kv_dtype = getattr(cfg, "kv_cache_dtype", None)
        if kv_dtype not in (None, "bf16", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}: want int8 or bf16")
        self.kv_quant = kv_dtype == "int8"
        if self.kv_quant and not self.paged:
            raise ValueError("kv_dtype='int8' requires a paged engine (pool_pages)")

        if paged_attention not in ("auto", "ragged", "gather"):
            raise ValueError(f"paged_attention={paged_attention!r}: want auto|ragged|gather")
        # the ragged body runs at pp = 1, tp = ep = 1 only (JAX's ``ragged_ok``)
        ragged_ok = self.paged and self.num_stages == 1 and self.shards == 1
        if paged_attention == "ragged" and not ragged_ok:
            raise ValueError(
                "paged_attention='ragged' needs a paged (pool_pages) pp=1 engine with tp=ep=1, "
                "batch=1, and a model with supports_sp"
            )
        # JAX's attribute: "ragged" or "gather" (a dense engine's is "gather")
        self.paged_attention = ("ragged" if paged_attention in ("auto", "ragged") and ragged_ok
                                else "gather")
        #: the T=1 step's attention: "ragged", "gather" or "dense"
        self.decode_path = self.paged_attention if self.paged else "dense"
        # Layer-wise KV sharing (kv_share.KVShareMap, JAX's checks): the
        # pool holds one buffer per share group, layer i reads and writes
        # group ``group_of[i]``'s, and only a group's owner (its lowest
        # layer) keeps its rows there. The identity map keeps the unshared
        # layout and code path (and hashes to None).
        if kv_share_map is not None:
            if not self.paged:
                raise ValueError("kv_share_map requires a paged engine (pool_pages)")
            if self.num_stages != 1:
                raise ValueError("kv_share_map requires a pp=1 engine: share groups span the "
                                 "full layer stack, which a stage split cuts")
            kv_share_map.validate_for(cfg.num_local_layers)
        self.kv_share = kv_share_map
        self.kv_share_hash = kv_share_map.share_hash if kv_share_map is not None else None
        self._share_active = kv_share_map is not None and not kv_share_map.is_identity
        n_layers = cfg.num_local_layers
        #: per layer: its buffer in the pool, and whether its rows persist
        self.pool_layer = (kv_share_map.group_of if self._share_active
                           else tuple(range(n_layers)))
        self.owner_layer = (kv_share_map.owner_mask if self._share_active
                            else (True,) * n_layers)
        self.kv_share_bytes_saved = 0  # filled by init_cache_paged
        # compressed-latent KV transport (kv_compress.py, JAX's wiring): an
        # MLA-native pool gets the exact latent codec, a calibrated map
        # (``kv_compress_map``) opts a bf16 GQA pool into lowrank; every
        # exported page block carries the codec and the share hash.
        from mlx_sharding_tpu_torch.kv_compress import build_codec

        pool_layers = kv_share_map.num_groups if self._share_active else n_layers
        # a block carries whole heads at any tp or ep, so the codec is the
        # tp = 1 pool's
        self.kv_codec = build_codec(
            model, paged=self.paged, kv_quant=self.kv_quant, num_stages=self.num_stages,
            pool_layers=pool_layers, share_hash=self.kv_share_hash,
            compress_map=kv_compress_map)
        self.kv_compress_hash = (self.kv_codec.compress_hash if self.kv_codec is not None
                                 else None)
        model.place_constants(self.device)
        self.stage_models = ([model] if self.num_stages == 1 else
                             [stage_model(model, a, b) for a, b in self.stage_bounds])
        for view, dev in zip(self.stage_models, self.stage_devices):
            view.place_constants(dev)
        #: each stage's shards' views of the model (the stage's view at tp =
        #: ep = 1), each over its shard's layers with its constants on its
        #: device, and each shard's mesh axes
        self.shard_views = [[view] for view in self.stage_models]
        if self.shards > 1:
            self.shard_views = [
                [shard_view(view, layers, dev) for layers, dev in zip(per, devs)]
                for view, per, devs in zip(self.stage_models, placed.shard_layers,
                                           self.shard_devices)]
        self._axes = [dict(tp_axis=ShardAxis("tp", t, tp) if tp > 1 else None,
                           ep_axis=ShardAxis("ep", e, ep) if ep > 1 else None)
                      for e, t in itertools.product(range(ep), range(tp))]
        # the ranks that reduce together over each axis
        self._groups = {"tp": [[e * tp + t for t in range(tp)] for e in range(ep)],
                        "ep": [[e * tp + t for e in range(ep)] for t in range(tp)]}
        # persistent step inputs: a step's key -> (buffer, DeviceInputs over it)
        self._plans: dict = {}
        # (buffer, tokens (1, chunk), page row (SPG,), last valid row (1,))
        self._prefill_buf: Optional[tuple] = None
        # forwards (prefill chunks, decode steps) run eagerly on the card:
        # warm-ups of captured steps, or ``cuda_graphs=False``
        self.eager_forwards = 0
        # what the engine holds beyond its own tensors (a shared-weight
        # lease's release): close() runs each hook once
        self._close_hooks: list = []

    def on_close(self, cb) -> None:
        """Register a teardown callback, run once from :meth:`close`. The
        shared-weights spawn hangs the store lease's release here, so a
        drain, a retirement or a hot-swap (each ends in ``close()``) drops
        the ref, and the last engine's drop frees the store's tree."""
        self._close_hooks.append(cb)

    def close(self) -> None:
        """Release what the engine holds beyond its own tensors, and its
        persistent step inputs. Idempotent: each hook runs once."""
        hooks, self._close_hooks = self._close_hooks, []
        self._plans.clear()
        self._prefill_buf = None
        self._stream = None
        self._stage_graphs.clear()
        for cb in hooks:
            cb()

    def kv_share_stats(self) -> dict:
        """The ``mst_kv_share_*`` read-out (JAX's): whether a non-identity
        map is on, the groups and layers, the pool bytes it saves and its
        hash."""
        m = self.kv_share
        layers = self.model.config.num_local_layers
        return {
            "enabled": bool(self._share_active),
            "groups": m.num_groups if m is not None else layers,
            "layers": layers,
            "bytes_saved": int(self.kv_share_bytes_saved),
            "share_hash": self.kv_share_hash,
        }

    def kv_compress_stats(self) -> Optional[dict]:
        """The ``mst_kv_compress_*`` read-out: the codec's counters, None
        when no codec is active."""
        return self.kv_codec.stats() if self.kv_codec is not None else None

    # ------------------------------------------------------------------
    def init_cache(self) -> PagedKV:
        """The dense slot caches (JAX ``init_cache``): M+1 of ``max_seq``
        positions, slot M the scratch, K and V as wide as the model's cache
        heads (``cache_head_dim``: DeepSeek-V2's compressed MLA cache
        included), offsets 0. Their page table is ``cache.slot_table``."""
        if self.paged:
            raise ValueError("a paged engine's cache is its pool: init_cache_paged")
        model = self.model
        caches = [sharded([init_cache_slots(b - a, self.microbatches, self.max_seq,
                                            self.cache_heads(), model.cache_head_dim(),
                                            self.cache_dtype, dev) for dev in devs],
                          self.tp, model.cache_tp_replicated())
                  for (a, b), devs in zip(self.stage_bounds, self.shard_devices)]
        return caches[0] if self.num_stages == 1 else staged(caches)

    def cache_heads(self) -> int:
        """The KV heads one shard's cache holds (JAX ``_kv_spec``): the
        model's cache heads over tp, or all of them when the cache is
        head-count independent (every tp shard keeps a whole copy)."""
        heads = self.model.cache_num_heads()
        return heads if self.model.cache_tp_replicated() else heads // self.tp

    def init_cache_paged(self) -> tuple[PagedKV, np.ndarray]:
        """The shared page pool (last page scratch) and the host page table
        (M+1, slot_pages), row M all scratch. Under a share map the pool's
        layer axis is the group count G. At S > 1 each stage has a pool of
        its own layers on its device, with the same pages (``StagedKV``)."""
        if not self.paged:
            raise ValueError("engine built without pool_pages")
        model = self.model
        n_layers = model.config.num_local_layers
        n_pool = self.kv_share.num_groups if self._share_active else n_layers
        caches = [sharded([init_cache_paged(
            n_pool if self.num_stages == 1 else b - a, self.pool_pages, self.page_size,
            self.cache_heads(), model.cache_head_dim(), self.microbatches,
            self.cache_dtype, dev, quantized=self.kv_quant,
        ) for dev in devs], self.tp, model.cache_tp_replicated())
            for (a, b), devs in zip(self.stage_bounds, self.shard_devices)]
        cache = caches[0] if self.num_stages == 1 else staged(caches)
        if self._share_active:
            # the allocation that did not happen: an unshared pool would be
            # L/G times these leaves (whole heads once, JAX's global bytes)
            whole = whole_pool(cache).nbytes
            self.kv_share_bytes_saved = int(whole * (n_layers - n_pool) / n_pool)
        return cache, init_page_table(self.microbatches, self.slot_pages, self.pool_pages)

    # ------------------------------------------------------------ stages
    def _stage_layers(self, cache, s: int, r: int = 0):
        """Stage s's layers in shard r: ``(global index, layer, K pool, V
        pool)``, each pool the layer's (its share group's) in the shard's
        cache."""
        c = shard_caches(stage_caches(cache)[s])[r]
        lo, hi = self.stage_bounds[s]
        layers = self.shard_views[s][r].layers
        for i in range(lo, hi):
            g = self.pool_layer[i] - lo  # share groups exist at pp = 1 only
            yield i, layers[i - lo], layer_pool(c.k, g), layer_pool(c.v, g)

    def _shard_pools(self, cache, s: int):
        """Stage s's layers: ``(global index, [(K pool, V pool) a shard])``."""
        per = [list(self._stage_layers(cache, s, r)) for r in range(self.shards)]
        for rows in zip(*per):
            yield rows[0][0], [(kp, vp) for _, _, kp, vp in rows]

    def _layer_step(self, s: int, i: int, h: torch.Tensor, offset, attn_fns: list):
        """Layer i of stage s over ``h`` with shard r's attention
        ``attn_fns[r]`` (JAX ``sp_layer``). At tp or ep > 1 every shard runs
        its part of the layer, and the loop over the shards runs inside the
        layer: each shard's attention, then its program to its partial sums,
        each reduced over its axis in process (``parallel.mesh.run_shards``),
        twice a layer under tp. Returns the hidden state on shard 0's
        device."""
        views, lo = self.shard_views[s], self.stage_bounds[s][0]
        if len(views) == 1:
            return views[0].sp_layer(views[0].layers[i - lo], h, offset, attn_fns[0])[0]
        programs = []
        for view, fn, dev, axes in zip(views, attn_fns, self.shard_devices[s], self._axes):
            p, hr = view.layers[i - lo], hop(h, dev)
            off = hop(offset, dev) if isinstance(offset, torch.Tensor) else offset
            q, k, v = view.layer_attn_inputs(p, hr, off)
            programs.append(view.finish_steps(p, hr, fn(q, k, v, **view.attn_options(p)), **axes))
        return run_shards(programs, self._groups)[0]

    def _graphs_for(self, cache) -> StageGraphs:
        """The stages' programs of the steps over ``cache`` (made on first
        use, dropped with the cache): a captured program writes the rows
        of the cache it was captured over."""
        key = id(cache)
        entry = self._stage_graphs.get(key)
        if entry is None or entry[0]() is not cache:
            graphs = StageGraphs(self.stage_devices, self.per_stage_graphs and self.cuda_graphs
                                 and self._stage_capture and self.device.type == "cuda")
            entry = self._stage_graphs[key] = (weakref.ref(cache), graphs)
            weakref.finalize(cache, self._stage_graphs.pop, key, None)
        return entry[1]

    def _on(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """``x`` on stage s's device (a step's plan and inputs)."""
        return hop(x, self.stage_devices[s])

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The final norm and the head after the last stage, the logits
        handed to stage 0's device, where sampling runs."""
        return hop(self.model.apply_head(hop(h, self._head_device)), self.device)

    def _slot_view(self, pool, page_ids: torch.Tensor) -> torch.Tensor:
        """The slot's pages ``page_ids`` (n,) gathered into a contiguous (1,
        n·page, H_kv, D) copy in the model's dtype (an int8 pool is
        dequantized after the gather); (M, n) table rows give (M, n·page,
        H_kv, D), one row per slot."""
        if is_quantized_kv(pool):
            x = dequantize_kv({"d": pool["d"][page_ids], "s": pool["s"][page_ids]},
                              self.cache_dtype)
        else:
            x = pool[page_ids]
        lead = page_ids.shape[:-1] if page_ids.dim() > 1 else (1,)
        return x.reshape(*lead, -1, *x.shape[-2:])

    def _write_back(self, pool, view: torch.Tensor, page_ids: torch.Tensor,
                    rows: torch.Tensor) -> None:
        """JAX ``_paged_writeback`` of one T=1 step: the page of each slot's
        (M,) view that holds row ``rows[m]`` goes back to pool page
        ``page_ids[m]``, whole (quantized row by row for an int8 pool: a
        row read back from the pool requantizes to its own codes)."""
        m = view.shape[0]
        pages = view.view(m, self.slot_pages, self.page_size, *view.shape[2:])
        dirty = pages[torch.arange(m, device=view.device), rows // self.page_size]
        if is_quantized_kv(pool):
            q = quantize_kv_rows(dirty)
            pool["d"][page_ids] = q["d"]
            pool["s"][page_ids] = q["s"]
        else:
            pool[page_ids] = dirty.to(pool.dtype)

    def prefill_inputs(self, tokens, slot: int, n_valid: int, table: np.ndarray) -> None:
        """Copy one chunk's inputs into the engine's persistent prefill
        buffer, in one upload: the chunk ``tokens`` (chunk,), the slot's
        page row and ``n_valid - 1``, the row whose logits the step
        returns. A captured :meth:`prefill_step` reads them at its replay
        (the copy is ordered before it on the stream)."""
        c = self.prefill_chunk
        if len(tokens) != c or not 0 < n_valid <= c:
            raise ValueError(f"a prefill chunk is {c} tokens; got {len(tokens)} tokens, "
                             f"{n_valid} valid")
        host = np.concatenate([np.asarray(tokens, np.int64), table[slot].astype(np.int64),
                               np.asarray([n_valid - 1], np.int64)])
        if self._prefill_buf is None:
            buf = torch.empty(host.shape, dtype=torch.int64, device=self.device)
            self._prefill_buf = (buf, buf[:c].view(1, c), buf[c:-1], buf[-1:])
        upload_into(self._prefill_buf[0], host)

    def prefill_step(self, cache: PagedKV, off: int, inputs=None) -> torch.Tensor:
        """One prefill chunk at offset ``off`` from the persistent inputs
        (:meth:`prefill_inputs`, or ``inputs``: tokens (1, chunk), the
        slot's page row and the last valid row (1,), on the device): the
        page view, the write page (indexed on the device from the slot's
        row; a dense engine's is the slot) and the last valid row are read
        on the device, so the step has one program at each offset. Writes
        the chunk's K/V rows into the pool and returns the logits (1, V) at
        the last valid row. Device work only: the slot's offset is the
        caller's."""
        tokens, row, last = inputs if inputs is not None else self._prefill_buf[1:]
        note_eager_forward(self, tokens)
        h = self.model.embed(tokens)
        graphs = self._graphs_for(cache)
        for s in range(self.num_stages):
            h = graphs.run(s, ("prefill", off),
                                 functools.partial(self._prefill_layers, cache, s, off),
                                 self._on(s, h), self._on(s, row))
        return self._head(h.index_select(1, self._on(self.num_stages - 1, last)))[:, 0]

    def _prefill_layers(self, cache, s: int, off: int, h, row):
        """Stage s's layers over one prefill chunk's hidden states ``h``
        at offset ``off``, the slot's page row ``row`` on its device."""
        rows = [hop(row, dev) for dev in self.shard_devices[s]]
        for i, pools in self._shard_pools(cache, s):
            fns = [functools.partial(self._prefill_attn, kp, vp, self.owner_layer[i], off, rr)
                   for (kp, vp), rr in zip(pools, rows)]
            h = self._layer_step(s, i, h, off, fns)
        return h

    def _prefill_attn(self, kp, vp, owner: bool, off: int, row, q, k_new, v_new,
                      values_from_k=None, **opts):
        """One layer's attention over a prefill chunk at ``off`` into the
        pools ``kp``/``vp`` of the slot whose page row is ``row``. The
        chunk's own rows are attended as computed (unquantized); the pool
        keeps them quantized for an int8 pool. ``opts``: the layer's softcap
        and window (the model's attn_options); ``values_from_k`` (MLA): the
        values are the keys' first columns, so only K rows are written. A
        share group's non-owner writes its chunk into its view only: it
        attends over the owner's rows and its own chunk, which the pool
        never keeps (JAX's ``_paged_writeback`` keeps owner rows)."""
        model, c, page = self.model, self.prefill_chunk, self._plan_page
        start = off % page
        page_ids = row[: -(-(off + c) // page)]
        write_page = row[off // page : off // page + 1]
        if not self.paged:
            # the slot's cache is one page: written, then attended in place
            # by the flash kernel, the slot a device index
            write_pool_span(kp, write_page, start, k_new[0])
            if values_from_k is not None:
                v_all = kp[..., :values_from_k]
            else:
                write_pool_span(vp, write_page, start, v_new[0])
                v_all = vp
            return causal_attention(q, kp, v_all, off, model.scale, kv_index=write_page, **opts)
        k_view = self._slot_view(kp, page_ids)
        k_view[:, off : off + c] = k_new
        if owner:
            write_pool_span(kp, write_page, start, k_new[0])
        if values_from_k is not None:
            v_view = k_view[..., :values_from_k]
        else:
            v_view = self._slot_view(vp, page_ids)
            v_view[:, off : off + c] = v_new
            if owner:
                write_pool_span(vp, write_page, start, v_new[0])
        return causal_attention(q, k_view, v_view, off, model.scale, **opts)

    def prefill_slot(self, tokens, slot: int, cache: PagedKV, n_valid: int,
                     table: np.ndarray, graphs=None) -> torch.Tensor:
        """Prefill one right-padded chunk ``tokens`` (chunk,) of ``slot`` at
        its offset, leaving every other slot untouched; advances the slot's
        offset by ``n_valid``. ``graphs`` (a ``StepGraphs``) replays the
        step's graph for that offset, capturing it on first use; without
        it the step runs eagerly. Returns the logits (1, V) at the last
        valid row."""
        off = cache.offsets[slot]
        if off % self.prefill_chunk:
            raise ValueError(f"slot {slot}: a prefill chunk starts at a chunk-aligned offset, "
                             f"not {off}")
        if off + self.prefill_chunk > self.max_seq:
            raise ValueError(f"slot {slot}: prefill at {off} overflows capacity {self.max_seq}")
        self.prefill_inputs(tokens, slot, n_valid, table)
        step = functools.partial(self.prefill_step, cache, off)
        logits = step() if graphs is None else graphs.run(("prefill", off), step).clone()
        cache.offsets[slot] = off + n_valid
        return logits

    def device_inputs(self, key, table: np.ndarray, active: list, offsets: list, reset: bool,
                      drafts: Optional[np.ndarray] = None,
                      wcaps: Optional[np.ndarray] = None) -> DeviceInputs:
        """Upload a device-planned step's inputs in one copy into the
        persistent buffer of ``key`` (the same tensors at every call, so a
        captured step reads each upload): each slot's table row (row M, all
        scratch, for an inactive slot), the active mask, ``reset`` and the
        host's ``offsets``, and a verify's (K, M) ``drafts`` (a draft
        replay's tokens) and (M,) ``wcaps``."""
        m, spg = self.microbatches, self._plan_pages
        act = np.asarray(active, bool)
        parts = [np.where(act[:, None], table[:m], table[m][None, :]).ravel(), act,
                 [int(reset)], offsets]
        if drafts is not None:
            parts += [np.asarray(drafts).ravel(), wcaps]
        host = np.concatenate([np.asarray(p, np.int64).ravel() for p in parts]).astype(np.int32)
        if key not in self._plans:
            buf = torch.empty(host.size, dtype=torch.int32, device=self.device)
            k = 0 if drafts is None else len(drafts)
            views, at = [], 0
            for n in (m * spg, m, 1, m, k * m, m if k else 0):
                views.append(buf[at : at + n])
                at += n
            rows, act_v, reset_v, off_v, d_v, w_v = views
            self._plans[key] = (buf, DeviceInputs(rows.view(m, spg), act_v, reset_v, off_v,
                                                  d_v.view(k, m) if k else None,
                                                  w_v if k else None))
        buf, inputs = self._plans[key]
        upload_into(buf, host)
        return inputs

    def device_plan(self, offsets: torch.Tensor, inputs: DeviceInputs, steps: int) -> DecodePlan:
        """Every slot's write page, row and attention length for ``steps``
        positions from its (M,) ``offsets`` on the device: device work only.
        An inactive slot routes to the table's scratch row M at length 0. A
        position past the slot's mapped pages (a finished slot decoding to
        the end of its block) writes to the scratch page."""
        page, spg = self._plan_page, self._plan_pages
        active = inputs.active.bool()
        j = torch.arange(steps, device=offsets.device)[:, None]
        pos = torch.where(active[None, :], offsets[None, :] + j, 0)  # (K, M)
        pidx = pos // page
        page_ids = inputs.rows.t().gather(0, pidx.clamp(max=spg - 1))
        page_ids = torch.where(pidx < spg, page_ids, self._scratch)
        lengths = torch.where(active[None, :], pos + 1, 0)
        return DecodePlan(page_ids.to(torch.int32), (pos % page).to(torch.int32),
                          lengths.to(torch.int32), pos.to(torch.int32), inputs.rows)

    # ------------------------------------------------------------ T=1 steps
    def _attend_ragged(self, kp, vp, plan, j, lengths, owner, q, k_new, v_new,
                       values_from_k=None, **opts):
        """The ragged path: the new rows into their pool pages, then the
        paged kernel over the pool in place. A share group's non-owner
        attends with its own rows in place of the owner's at the new
        positions, then puts the owner's rows back (JAX keeps the owner's
        buffer: ``_scan_layers_shared``), so the pool ends the step as its
        owner left it."""
        pages, rows = plan.page_ids[j], plan.row_pos[j]
        pools = (kp,) if values_from_k is not None else (kp, vp)  # MLA: values from K rows
        saved = None if owner else [read_pool_rows(p, pages, rows) for p in pools]
        for pool, new in zip(pools, (k_new, v_new)):
            write_pool_rows(pool, pages, rows, new[:, 0])
        quant = is_quantized_kv(kp)
        out = paged_attention(
            q[:, 0], kv_data(kp), kv_data(vp), plan.tables, lengths, self.model.scale,
            k_scale=kp["s"] if quant else None, v_scale=vp["s"] if quant else None,
            values_from_k=values_from_k, **opts,
        )
        if saved is not None:
            for pool, old in zip(pools, saved):
                restore_pool_rows(pool, pages, rows, old)
        return out[:, None]  # (M, T=1, Hq, Dv)

    def _attend_gather(self, kp, vp, plan, j, lengths, owner, q, k_new, v_new,
                       values_from_k=None, **opts):
        """The gather path (JAX ``_paged_read`` / ``_paged_writeback``):
        each slot's pages gathered into a contiguous view (dequantized after
        the gather for an int8 pool), the new row written into it, the T=1
        route over the view, and the touched page written back (a position
        past the mapped pages goes to the scratch page); a share group's
        non-owner writes nothing back."""
        m, cap = q.shape[0], self.max_seq
        slots = torch.arange(m, device=q.device)
        positions = plan.positions[j]
        rows = positions.long().clamp(max=cap - 1)
        k_view = self._slot_view(kp, plan.tables)  # (M, cap, H_kv, Dk)
        k_view[slots, rows] = k_new[:, 0].to(k_view.dtype)
        if owner:
            self._write_back(kp, k_view, plan.page_ids[j], rows)
        if values_from_k is not None:
            v_view = k_view[..., :values_from_k]
        else:
            v_view = self._slot_view(vp, plan.tables)
            v_view[slots, rows] = v_new[:, 0].to(v_view.dtype)
            if owner:
                self._write_back(vp, v_view, plan.page_ids[j], rows)
        return causal_attention(q, k_view, v_view, 0, self.model.scale, position=positions,
                                lengths=lengths, **opts)

    def _attend_dense(self, kp, vp, plan, j, lengths, owner, q, k_new, v_new,
                      values_from_k=None, **opts):
        """The dense path: the new rows into the slot caches (an inactive
        slot's into the scratch slot), then the T=1 route over the first M
        caches in place."""
        m = q.shape[0]
        write_pool_rows(kp, plan.page_ids[j], plan.row_pos[j], k_new[:, 0])
        k = kp[:m]
        if values_from_k is not None:
            v = k[..., :values_from_k]
        else:
            write_pool_rows(vp, plan.page_ids[j], plan.row_pos[j], v_new[:, 0])
            v = vp[:m]
        return causal_attention(q, k, v, 0, self.model.scale, position=plan.positions[j],
                                lengths=lengths, **opts)

    def decode_hidden(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan,
                      j: int) -> torch.Tensor:
        """The T=1 forward of step j of the plan for all M slots through the
        last layer, on :attr:`decode_path`: the new K/V rows land in the
        cache, ``tokens`` (M, 1) give hidden states (M, 1, hidden), an
        inactive slot's zeros. Offsets are not advanced."""
        model = self.model
        note_eager_forward(self, tokens)
        lengths = plan.lengths[j]
        if self.decode_path != "ragged":
            # the T=1 route's per-slot lengths, capped at the capacity
            lengths = slot_lengths(plan.positions[j], lengths > 0, self.max_seq)
        attend = {"ragged": self._attend_ragged, "gather": self._attend_gather,
                  "dense": self._attend_dense}[self.decode_path]
        h = model.embed(tokens)  # (M, 1, hidden): the slot axis is the batch axis
        graphs = self._graphs_for(cache)
        for s in range(self.num_stages):
            on = functools.partial(self._on, s)
            h = graphs.run(s, ("decode",),
                                 functools.partial(self._decode_layers, cache, s, attend),
                                 on(h), on(plan.positions[j]), on(lengths), on(plan.page_ids[j]),
                                 on(plan.row_pos[j]), on(plan.tables))
        live = self._on(self.num_stages - 1, lengths) > 0
        return torch.where(live[:, None, None], h, torch.zeros((), dtype=h.dtype, device=h.device))

    def _decode_layers(self, cache, s: int, attend, h, positions, lengths, page_ids, row_pos,
                       tables):
        """Stage s's layers over one T=1 step of all M slots: ``h`` (M, 1,
        hidden), the step's (M,) positions, attention lengths, write pages
        and rows, and the (M, SPG) table rows, on the stage's device."""
        plans = []
        for dev in self.shard_devices[s]:
            on = functools.partial(hop, device=dev)
            plans.append((DecodePlan(on(page_ids)[None], on(row_pos)[None], on(lengths)[None],
                                     on(positions)[None], on(tables)), on(lengths)))
        for i, pools in self._shard_pools(cache, s):
            fns = [functools.partial(attend, kp, vp, plan, 0, lens, self.owner_layer[i])
                   for (kp, vp), (plan, lens) in zip(pools, plans)]
            h = self._layer_step(s, i, h, positions, fns)
        return h

    def decode_logits(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan,
                      j: int) -> torch.Tensor:
        """:meth:`decode_hidden` through the head: logits (M, V) on stage
        0's device."""
        return self._head(self.decode_hidden(tokens, cache, plan, j))[:, 0]

    def decode_cb(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan, step: int, *,
                  recent: torch.Tensor, generators: list, sp, rep_mask: torch.Tensor,
                  sampled: bool):
        """One continuous-batching decode step (step ``step`` of ``plan``):
        the T=1 forward of all M slots, then per-slot sampling with each
        slot's settings, generator and repetition window (``rep_mask``
        keeps the last ``rep_context`` entries of slot m's window), and the
        window updated in place. ``sampled``: some slot may sample (every
        row then draws from its generator). Device work only: offsets are
        the caller's (:meth:`advance_offsets`). Returns ``(tokens (M, 1),
        logprobs (M, V))``."""
        logits = self.decode_logits(tokens, cache, plan, step)
        masked = torch.where(rep_mask, recent, torch.full_like(recent, -1))
        tok, logprobs = sample_token_batched(generators, logits, sp, masked, sampled=sampled)
        recent.copy_(update_recent_tokens(recent, tok))
        return tok[:, None], logprobs

    # ----------------------------------------------------------- speculation
    def verify_logits(self, x: torch.Tensor, cache: PagedKV, plan: DecodePlan) -> torch.Tensor:
        """The T=K forward of all M slots: ``x`` (M, K) at the plan's K
        positions. Per layer the K new K/V rows go into their pages (pool
        pages, quantized for an int8 pool, or slot caches) and
        ``masked_attention`` attends at each slot's position: a paged
        engine over each slot's pages gathered into a view over its whole
        table row (the new rows written into it unquantized), a dense one
        over the slot caches in place. At tp or ep > 1 every shard runs its
        heads' part of each layer (:meth:`_layer_step`), its reductions
        over all K rows (JAX's keep-all body). Returns the logits (M, K,
        V); an inactive slot's are zeros' logits. Offsets are not
        advanced."""
        self._check_pp1()
        note_eager_forward(self, x)
        start = plan.positions[0]  # (M,)
        plans = []
        for dev in self.shard_devices[0]:
            on = functools.partial(hop, device=dev)
            plans.append((on(plan.positions), on(plan.page_ids), on(plan.row_pos),
                          on(plan.tables)))
        h = self.model.embed(x)  # (M, K, hidden)
        for i, pools in self._shard_pools(cache, 0):
            fns = [functools.partial(self._verify_attn, kp, vp, self.owner_layer[i], *p)
                   for (kp, vp), p in zip(pools, plans)]
            h = self._layer_step(0, i, h, start, fns)
        active = plan.lengths[0] > 0
        h = torch.where(active[:, None, None], h, torch.zeros((), dtype=h.dtype, device=h.device))
        return self.model.apply_head(h)

    def _verify_attn(self, kp, vp, owner: bool, positions, page_ids, row_pos, tables, q, k_new,
                     v_new, values_from_k=None, **opts):
        """One layer's attention over a verify's K rows of every slot, into
        the pools ``kp``/``vp`` of one shard; the plan's (K, M) positions,
        pages and rows and its (M, SPG) tables on the shard's device. A
        share group's non-owner writes its rows into its view only (JAX's
        gather body keeps owner rows)."""
        m, k = q.shape[:2]
        start = positions[0]
        pages, rows_in = page_ids.t().reshape(-1), row_pos.t().reshape(-1)
        if owner:
            write_pool_rows(kp, pages, rows_in, k_new.reshape(m * k, *k_new.shape[2:]))
        if owner and values_from_k is None:
            write_pool_rows(vp, pages, rows_in, v_new.reshape(m * k, *v_new.shape[2:]))
        if not self.paged:
            k_view = kp[:m]
            v_view = k_view[..., :values_from_k] if values_from_k is not None else vp[:m]
            return masked_attention(q, k_view, v_view, start, self.model.scale, **opts)
        rows = positions.t().long().clamp(max=self.max_seq - 1)  # (M, K) rows of the view
        slots = torch.arange(m, device=q.device)[:, None]
        k_view = self._slot_view(kp, tables)
        k_view[slots, rows] = k_new.to(k_view.dtype)
        if values_from_k is not None:
            v_view = k_view[..., :values_from_k]
        else:
            v_view = self._slot_view(vp, tables)
            v_view[slots, rows] = v_new.to(v_view.dtype)
        return masked_attention(q, k_view, v_view, start, self.model.scale, **opts)

    def spec_verify(self, k: int, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan,
                    drafts: torch.Tensor, wcap: torch.Tensor, *, qlps=None,
                    recent: torch.Tensor, generators: list, sp, rep_mask: torch.Tensor,
                    sampled: bool):
        """One speculative verify of all M slots (JAX ``_spec_verify_fn``):
        the T=K forward over ``[t0, d1..d_{K-1}]`` (:meth:`verify_logits`),
        then greedy acceptance per slot, or rejection sampling with each
        slot's generator for sampled slots (``sampled``: some slot may
        sample), the cap ``m = min(m, wcap - 1)`` before anything commits,
        and the replay of only the emitted tokens into the window (in
        place). ``qlps`` (K, M, V): the draft's distributions, one-hot on
        the drafts when None. An inactive slot emits nothing. Device work
        only: offsets are the caller's. Returns ``(gs (K, M), count (M,),
        next tokens (M, 1))``."""
        if drafts.shape[0] != k:
            raise ValueError(f"a verify of {k} positions takes {k} drafts a slot, got "
                             f"{drafts.shape[0]}")
        active = plan.lengths[0] > 0
        d = drafts.long()
        logits = self.verify_logits(torch.cat([tokens, d[:-1].t()], dim=1), cache, plan)
        gs, count, nxt, rec = verify_round(logits, d, recent, sp, generators, sampled=sampled,
                                           q_logprobs=qlps, wcap=wcap, active=active,
                                           rep_mask=rep_mask)
        recent.copy_(rec)
        return gs, count, torch.where(active, nxt, tokens[:, 0])[:, None]

    def spec_verify_cb(self, k: int):
        """The verify of K positions for a draft engine's proposals, whose
        distributions ``qlps`` (K, M, V) the caller passes."""
        self._check_pp1()
        return functools.partial(self.spec_verify, k)

    def spec_verify_ngram_cb(self, k: int):
        """The verify of K positions for deterministic (n-gram) proposals:
        q is one-hot on the drafts, built on the device."""
        self._check_pp1()
        return functools.partial(self.spec_verify, k, qlps=None)

    def _check_pp1(self) -> None:
        """JAX's check: the speculative steps need the pp = 1 body."""
        if self.num_stages != 1:
            raise ValueError("speculative continuous batching needs pp=1 engines")

    def _check_draft(self) -> None:
        """JAX's check when a draft program is built."""
        self._check_pp1()
        if self.paged:
            raise ValueError("the draft engine must be dense (no pool_pages)")

    def spec_propose(self, k: int, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan, *,
                     recent: torch.Tensor, generators: list, sp, rep_mask: torch.Tensor,
                     sampled: bool):
        """K draft proposals for every slot (JAX ``spec_propose_cb``), on
        this dense draft engine: K T=1 steps from ``tokens`` (M, 1), the
        target's next inputs, over the plan's K positions. A greedy slot
        proposes the argmax of the raw logits; with ``sampled`` (some slot
        samples) every slot also draws from its transformed distribution
        (``dist_logits`` under the target's settings ``sp`` and a local copy
        of the window ``recent``, evolved with its own proposals) with its
        generator, a sampled slot takes the draw, and the distributions'
        log-probs are kept. Device work only: offsets are the caller's.
        Returns ``(drafts (K, M) int64, qlps (K, M, V) float32 or None)``."""
        rec, tok, drafts, qlps = recent, tokens, [], []
        for j in range(k):
            logits = self.decode_logits(tok, cache, plan, j)
            nxt = torch.argmax(logits, dim=-1)
            if sampled:
                f = dist_logits(logits, torch.where(rep_mask, rec, torch.full_like(rec, -1)), sp)
                qlps.append(torch.log_softmax(f, dim=-1))
                nxt = torch.where(sp.temperature > 0, draw(torch.softmax(f, dim=-1), generators),
                                  nxt)
            rec = update_recent_tokens(rec, nxt)
            drafts.append(nxt)
            tok = nxt[:, None]
        return torch.stack(drafts), torch.stack(qlps) if sampled else None

    def spec_propose_cb(self, k: int):
        """:meth:`spec_propose` of K steps."""
        self._check_draft()
        return functools.partial(self.spec_propose, k)

    def spec_replay(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan) -> None:
        """Feed ``tokens`` (K, M), the chain a plain decode block of the
        target consumed, through this dense draft engine's caches at the
        plan's K positions without sampling (JAX ``spec_replay_cb``): the
        draft's caches then hold what the target's do. Device work only."""
        for j in range(tokens.shape[0]):
            self.decode_hidden(tokens[j].long()[:, None], cache, plan, j)

    def spec_replay_cb(self, k: int):
        """:meth:`spec_replay` of K tokens a slot."""
        self._check_draft()
        return self.spec_replay

    @staticmethod
    def advance_offsets(cache: PagedKV, active: list, steps: int) -> None:
        """The host side of ``steps`` decode steps: every active slot's
        offset moves by ``steps``."""
        for m, a in enumerate(active):
            if a:
                cache.offsets[m] += steps

    # --------------------------------------------------------- single stream
    def stream(self) -> StagedGenerator:
        """The single stream of JAX's engine, made on first use: a
        ``Generator`` over the engine's stages and dense slot caches of its
        own (:class:`_Stream`), its steps captured as at pp = 1 (each
        stage's on its own with :attr:`per_stage_graphs`)."""
        if self._stream is None:
            if self.paged:
                raise ValueError("generate_step runs over the dense slot caches: build the "
                                 "engine without pool_pages")
            self._stream = StagedGenerator(_Stream(self), max_seq=self.max_seq,
                                           prefill_chunk=self.prefill_chunk,
                                           decode_block=self.decode_block,
                                           cuda_graphs=self.cuda_graphs)
        return self._stream

    def warm_up(self, decode_blocks: bool = True, prefill_upto: Optional[int] = None,
                blocks=BLOCK_KINDS) -> dict:
        """The single stream's ``Generator.warm_up``."""
        return self.stream().warm_up(decode_blocks, prefill_upto, blocks)

    def generate_step(self, prompt_tokens, **kwargs):
        """The contract of ``Generator.generate_step`` (JAX's engine's):
        every microbatch runs the prompt, and the stream is slot 0's."""
        return self.stream().generate_step(prompt_tokens, **kwargs)


class StageStack:
    """A stack of pipeline stages as the one model a ``Generator`` steps:
    the stages keep their rows in caches of their own, so the Generator's
    cache holds its offset and device position only. ``graphs``: the
    stages' programs (``StageGraphs``, off when the Generator captures
    whole steps)."""

    device: torch.device
    layers: list
    graphs: StageGraphs

    def make_cache(self, batch: int, max_seq: int) -> KVCache:
        empty = torch.empty((0, batch, max_seq, 1, 1), device=self.device)
        return KVCache(k=empty, v=empty)


class _Stream(StageStack):
    """The engine's single stream over dense slot caches of its own: every
    one of the M microbatches runs the same tokens (JAX runs the prompt in
    every microbatch), a prefill chunk slot by slot and a decode step as
    one batched forward at the Generator's device position, and a call
    returns slot 0's logits."""

    def __init__(self, engine: PipelineEngine):
        m = engine.microbatches
        self.engine, self.device, self.layers = engine, engine.device, engine.model.layers
        self.cache = engine.init_cache()
        self.graphs = engine._graphs_for(self.cache)
        # every slot decodes: the table rows and the active mask, uploaded once
        self.inputs = engine.device_inputs(("stream",), slot_table(m), [True] * m, [0] * m, True)
        self.rows = self.inputs.rows.long()

    def fused_projection_groups(self) -> dict:
        # at tp or ep > 1 the shards' layers stay unfused (JAX's rule)
        eng = self.engine
        return eng.model.fused_projection_groups() if eng.shards == 1 else {}

    def place_constants(self, device) -> None:
        """Each stage's view holds its own, placed by the engine."""

    def __call__(self, x, cache: KVCache, n_valid=None, logits_at=None):
        eng, m = self.engine, self.engine.microbatches
        if x.shape[1] > 1:
            for slot in reversed(range(m)):
                logits = eng.prefill_step(self.cache, cache.offset,
                                          (x, self.rows[slot], logits_at))
            return logits[:, None], cache
        plan = eng.device_plan(cache.pos.expand(m), self.inputs, 1)
        return eng.decode_logits(x.expand(m, 1), self.cache, plan, 0)[:1, None], cache


class StagedGenerator(Generator):
    """A ``Generator`` over a :class:`StageStack`. With each stage's
    programs captured on their own it captures no whole step, and its
    warm-up runs the steps once, every stage's programs captured at their
    first run."""

    def __init__(self, model: StageStack, *, cuda_graphs: bool = True, **kwargs):
        super().__init__(model, cuda_graphs=cuda_graphs and model.graphs.graphs is None, **kwargs)

    def warm_up(self, decode_blocks: bool = True, prefill_upto: Optional[int] = None,
                blocks=BLOCK_KINDS) -> dict:
        stages = self.model.graphs
        if stages.graphs is None:
            return super().warm_up(decode_blocks, prefill_upto, blocks)
        self._warm_steps(decode_blocks, prefill_upto, blocks)
        return stages.stats()
