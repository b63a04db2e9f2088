"""OpenAI-compatible HTTP server (port of the single-host path of
``mlx_sharding_tpu/server/openai_api.py``).

``POST /v1/completions`` and ``POST /v1/chat/completions`` (non-streamed,
or SSE that holds back text that could still grow into a stop sequence),
logprobs, ``logit_bias``, the JAX server's parameter validation, the plain
chat prompt for tokenizers without a template (``--chat-template``
overrides the checkpoint's), ``--api-key`` on the POST routes. ``GET
/health`` (the generator's ``health()``: 503 when it is not serving),
``GET /metrics`` (Prometheus text, ``utils/observability.py``), ``GET
/admin/trace`` and ``/admin/trace/{dump|<request id>}`` (``--trace``,
``tracing.py``), and the static web UI (``/`` is ``index.html``).

One :class:`ModelProvider` holds one generator and its tokenizer; a request
that names another checkpoint (a path inside the working directory) swaps
the model: the new generator is built as the first was, and once it has
loaded the old one is closed and its graphs, pools and caches released (a
failed load leaves the old one serving). A single-stream ``Generator``
(with ``--prompt-cache``, reusing the previous request's prompt prefix) is
serialized by a lock; with ``--concurrent N`` the generator is a
:class:`~mlx_sharding_tpu_torch.scheduler.ContinuousBatcher` over dense
slot caches, or with ``--paged-pool P`` over a shared page pool
(``--paged-attention ragged|gather``), which interleaves requests itself
and is served without the lock, with ``--prompt-cache`` shares
prompt-prefix pages, with ``--max-queue`` bounds its queue (429 with
``Retry-After``) and enforces the deadlines (``--request-timeout`` and
``--ttft-timeout``, or the body's fields; 504). A single-stream generator
gets the total deadline as a check between tokens. ``--draft ngram``
speculates by prompt lookup and ``--draft-model`` with a draft model, on
the single stream or in the batcher's slots with ``--concurrent``.
``--profile-dir`` records a ``torch.profiler`` trace of each request.
``--kv-share-map`` serves a paged pool under a layer-wise KV share map.
``--replicas N`` serves N engines behind one
:class:`~mlx_sharding_tpu_torch.replicas.ReplicaSet` (least-loaded routing,
session stickiness, prefix affinity, circuit breakers); on one card they
alias one resident copy of the weights (``--shared-weights``, the
``weights.WeightStore``), and ``POST /admin/drain`` retires one, its streams
migrating to the others. ``--disagg`` splits them into a prefill pool and a
decode pool (``--prefill-replicas``, ``--decode-replicas``) behind a
:class:`~mlx_sharding_tpu_torch.disagg.DisaggCoordinator`: each request
prefills and emits its first token on a prefill replica, then its KV page
block moves (through the host) to a decode replica. ``--autoscale``
(``--autoscale-min``, ``--autoscale-max``, ``--autoscale-interval``,
``--autoscale-cooldown``) runs a ``fleet.FleetAutoscaler`` over the replica
set (one per pool under ``--disagg``), spawning aliased replicas under
sustained pressure and draining idle ones; its brownout ladder
(``--brownout on|off``) caps ``max_tokens`` (the ``X-MST-Brownout-Level`` and
``X-MST-Max-Tokens-Capped`` headers), sheds speculation and tightens
admission. ``POST /admin/autoscaler`` starts, stops and reads the
controllers. ``--num-stages S`` or ``--stage-bounds`` serves the model as a
pipeline of stages (the engine's single stream, or its batcher with
``--concurrent``; a pool decodes on the ``gather`` path); ``--engine
chained`` with bounds serves one model per stage (the single stream only);
``--start-layer`` / ``--end-layer`` load a layer range. ``--coordinator
H:P --num-processes P --process-id R`` serves a pipeline over P processes
(``parallel/multihost.py``): each holds and runs its own stages, rank 0
serves HTTP and drives the others over the control plane (a
``MultiHostPipeline``, or with ``--concurrent`` a ``MultiHostBatcher``),
and ranks above 0 serve no HTTP and mirror its steps; ``/health`` then has
a ``multihost`` block and answers 503 ``degraded`` once a worker stops
answering. With ``--pod`` each process serves its own fleet instead, one
host of a ``pod.PodFleet`` over a ``pod.CollectiveTransport``.

    python -m mlx_sharding_tpu_torch.server.openai_api --model DIR [--device cpu]
        [--num-stages S | --stage-bounds 0-14,14-27 [--engine fused|chained]]
        [--start-layer A] [--end-layer B]
        [--prompt-cache] [--decode-block 16] [--api-key KEY] [--chat-template @FILE]
        [--concurrent 8 [--paged-pool 64 [--paged-attention gather] [--kv-dtype int8]
         [--prompt-cache]] [--max-queue 32]] [--request-timeout S] [--ttft-timeout S]
        [--draft ngram [--spec-window-max W] | --draft-model DIR [--spec-k K]]
        [--trace off|sample|on [--trace-buffer N] [--trace-sample N] [--trace-profile]]
        [--kv-share-map MAP.json] [--replicas N [--shared-weights on|off|auto]]
        [--disagg [--prefill-replicas N] [--decode-replicas N]]
        [--autoscale [--autoscale-min N] [--autoscale-max N] [--autoscale-interval S]
         [--autoscale-cooldown S]] [--brownout on|off]
        [--coordinator H:P --num-processes P --process-id R [--pod]]
        [--profile-dir DIR] [--log-level INFO]
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hmac
import json
import logging
import os
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.resilience import (
    QueueFullError,
    ReplicasUnavailableError,
    RequestTimeoutError,
)
from mlx_sharding_tpu_torch.tokenizer_utils import (
    StreamingDetokenizer,
    sequence_overlap,
    stopping_criteria,
)
from mlx_sharding_tpu_torch.utils.locks import make_lock
from mlx_sharding_tpu_torch.utils.observability import ServingMetrics, profile_trace

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent / "static"
CONTENT_TYPES = {
    ".html": "text/html",
    ".js": "application/javascript",
    ".css": "text/css",
    ".json": "application/json",
}


def _encode_plain(tokenizer, text: str) -> list[int]:
    """Encode without special tokens (stop sequences must match raw ids)."""
    try:
        return list(tokenizer.encode(text, add_special_tokens=False))
    except TypeError:
        return list(tokenizer.encode(text))


def convert_chat(messages: list, role_mapping: Optional[dict] = None) -> str:
    """Plain-text prompt for a tokenizer without a chat template."""
    default = {
        "system_prompt": "A chat between a curious user and an artificial "
        "intelligence assistant. The assistant follows the given rules no "
        "matter what.",
        "system": "ASSISTANT's RULE: ",
        "user": "USER: ",
        "assistant": "ASSISTANT: ",
        "stop": "\n",
    }
    role_mapping = role_mapping or default
    prompt = role_mapping.get("system_prompt", "")
    for m in messages:
        prefix = role_mapping.get(m["role"], "")
        stop = role_mapping.get("stop", "")
        prompt += f"{prefix}{m['content']}{stop}"
    prompt += role_mapping.get("assistant", "")
    return prompt.rstrip()


def shared_weights_on(mode: str, want: int, per: int = 1, n_devices: int = 1) -> bool:
    """Resolve ``--shared-weights`` (JAX ``_shared_weights_on``): ``on``
    forces, ``off`` refuses; ``auto`` shares whenever there are replicas to
    share between, and is forced on when ``want`` private slices of ``per``
    devices do not fit the grid. The port's engines run on one device, so
    the grid is one device and ``auto`` always shares."""
    mode = (mode or "auto").lower()
    if mode == "off":
        return False
    if mode == "on":
        return True
    if want <= 1:
        return False
    if want * per > n_devices:
        logger.info("shared-weights auto: forced ON — %d private slices of %d devices exceed "
                    "the %d-device grid", want, per, n_devices)
    return True


def build_generator(path: str, *, device=None, max_seq: int = 4096, prefill_chunk: int = 256,
                    keep_quantized: bool = False, decode_block: int = 16,
                    concurrent: int = 1, paged_pool: Optional[int] = None,
                    page_size: Optional[int] = None, paged_attention: str = "auto",
                    kv_dtype: Optional[str] = None, admission_policy: str = "fifo",
                    overcommit: bool = False, async_sched: str = "auto",
                    prompt_cache: bool = False, max_queue: Optional[int] = None,
                    draft: str = "auto", draft_model: Optional[str] = None,
                    spec_k: int = 4, spec_window_max: Optional[int] = None,
                    spill_bytes: Optional[int] = None, spill_cold_after: Optional[int] = None,
                    kv_prefetch: str = "auto", prefix_store: bool = False,
                    prefix_store_bytes: Optional[int] = None, prefix_insert_min_hits: int = 1,
                    kv_compress_map: Optional[str] = None,
                    kv_compress_rank: Optional[int] = None,
                    kv_share_map: Optional[str] = None, replicas: int = 1,
                    shared_weights: str = "auto", disagg: bool = False,
                    prefill_replicas: int = 1, decode_replicas: int = 1,
                    autoscale: bool = False, autoscale_min: Optional[int] = None,
                    autoscale_max: Optional[int] = None, autoscale_interval: float = 2.0,
                    autoscale_cooldown: float = 15.0, brownout: bool = True,
                    start_layer: Optional[int] = None, end_layer: Optional[int] = None,
                    num_stages: Optional[int] = None, stage_bounds=None, engine: str = "fused",
                    tp: int = 1, ep: int = 1, model=None, multihost: bool = False,
                    dtype=None):
    """The generator the server runs for the checkpoint at ``path``: a
    single-stream ``Generator`` (with ``prompt_cache``, JAX's prompt-prefix
    reuse), or with ``concurrent > 1`` a ``ContinuousBatcher`` of that many
    slots over dense slot caches, or over a pool of ``paged_pool`` KV pages
    (the JAX server's pp=1 engines), with ``overcommit`` admission,
    ``async_sched`` ticks, prefix sharing (``prompt_cache``) and a queue
    bound (``max_queue``); its decode blocks are ``min(8, decode_block)``
    steps, as JAX's. ``draft="ngram"`` speculates by prompt lookup
    (``NgramSpeculativeGenerator``, or the batcher's n-gram mode),
    ``draft_model`` (a checkpoint directory) with a draft model
    (``SpeculativeGenerator``, or a dense draft engine beside the
    batcher's, with the same slots, capacity and chunk). KV movement:
    ``spill_bytes``, ``spill_cold_after`` and ``kv_prefetch`` (the spill
    tier), ``prefix_store`` (one ``PrefixStore`` for this load, of
    ``prefix_store_bytes`` host bytes, shared by every replica's batcher)
    and ``kv_compress_map`` (a calibrated low-rank map's path, truncated to
    ``kv_compress_rank``); ``kv_share_map`` (a share-map artifact's path)
    lays a paged pool out by share group. ``replicas > 1``: a
    ``ReplicaSet`` of that many such generators; with ``shared_weights``
    resolved on (``auto`` on one device) they alias one resident model
    through the process's ``WeightStore``, each with its own pool, graphs
    and graph memory pool, and a drained replica's card memory is given back
    at its retirement. ``disagg``: a ``DisaggCoordinator`` over a prefill
    pool of ``prefill_replicas`` (which never speculate) and a decode pool
    of ``decode_replicas``, all aliasing the one resident model.
    ``autoscale``: a started ``FleetAutoscaler`` over the replica set (one
    per pool under ``disagg``) with JAX's bounds, its brownout ladder on
    unless ``brownout`` is False. ``num_stages`` or ``stage_bounds``: a
    pipeline of that many stages (JAX's engine choice): the engine's own
    single stream, or with ``concurrent > 1`` its batcher; ``engine="chained"``
    with bounds: a ``ChainedPipeline``, one model per stage. Without
    ``device`` stage s goes on the s-th card. ``start_layer`` /
    ``end_layer``: the layer range to load. Replicas, disagg and the
    autoscaler run over stages too: each replica is an engine of that many
    stages, JAX's ``stages x tp x ep`` devices a replica, and the resident
    tree's key carries the split; with ``device`` every replica's stages
    sit on that one device. ``tp`` / ``ep``: every stage as tp x ep shards
    (JAX's mesh axes; the engine's single stream without ``concurrent``,
    else its batcher on the gather path), each on its own card, or all on
    ``device``; the spill tier, the prefix store, share and compression
    maps, replicas, disagg and the autoscaler run over them as over one
    shard (a page block carries whole heads), every replica's resident
    tree the one placed tp x ep tree. ``multihost``: the stages span the
    deployment's processes (:func:`multihost_generator`). ``dtype``: the
    load's (JAX's provider ``cache_dtype``; bf16 by default). ``model``: an
    already loaded model to serve, which ``path`` then only names. On a
    card each generator's step graphs are captured here, before the first
    request."""
    import torch

    dtype = dtype or torch.bfloat16
    from mlx_sharding_tpu_torch.kv_compress import load_compress_map
    from mlx_sharding_tpu_torch.kv_share import load_share_map
    from mlx_sharding_tpu_torch.loading import load_model
    from mlx_sharding_tpu_torch.parallel.mesh import device_grid

    stages = len(stage_bounds) if stage_bounds else (num_stages or 1)
    if multihost:
        return multihost_generator(
            path, device=device, max_seq=max_seq, prefill_chunk=prefill_chunk,
            keep_quantized=keep_quantized, decode_block=decode_block, concurrent=concurrent,
            paged_pool=paged_pool, page_size=page_size, paged_attention=paged_attention,
            kv_dtype=kv_dtype, admission_policy=admission_policy, async_sched=async_sched,
            prompt_cache=prompt_cache, max_queue=max_queue, spill_bytes=spill_bytes,
            spill_cold_after=spill_cold_after, kv_prefetch=kv_prefetch, stages=stages,
            stage_bounds=stage_bounds, tp=tp, ep=ep, dtype=dtype)
    if stage_bounds and engine == "chained":
        from mlx_sharding_tpu_torch.parallel.chained import (
            chained_from_model,
            load_chained_pipeline,
        )

        kw = dict(max_seq=max_seq, prefill_chunk=prefill_chunk, decode_block=decode_block)
        generator = (chained_from_model(model, stage_bounds, **kw) if model is not None else
                     load_chained_pipeline(path, stage_bounds, device=device, dtype=dtype,
                                           keep_quantized=keep_quantized, **kw))
        _warm_up(generator)
        return generator

    def load():
        if model is not None:
            return model
        return load_model(path, start_layer, end_layer, dtype=dtype,
                          device=device_grid(pp=stages, tp=tp, ep=ep, device=device).flat[0],
                          keep_quantized=keep_quantized)[0]

    store = None
    if prefix_store and paged_pool and concurrent > 1:
        from mlx_sharding_tpu_torch.prefix_store import PrefixStore

        # one store for the load (every replica's batcher binds to it): a
        # swap closes it with its generator
        store = PrefixStore(host_bytes=prefix_store_bytes or (256 << 20),
                            insert_min_hits=prefix_insert_min_hits)
    pooled = bool(paged_pool) and concurrent > 1
    share_map = load_share_map(kv_share_map) if pooled else None
    compress_map = load_compress_map(kv_compress_map, kv_compress_rank) if pooled else None

    def make(model, weights=None, draft_engine=None, graph_pool=None, speculate=True):
        from mlx_sharding_tpu_torch.generate import Generator
        from mlx_sharding_tpu_torch.parallel import PipelineEngine

        if concurrent <= 1 and (stages > 1 or tp > 1 or ep > 1):
            # the engine's single stream (JAX's engine at pp, tp or ep > 1)
            return PipelineEngine(model, stages=stages, stage_bounds=stage_bounds, tp=tp, ep=ep,
                                  max_seq=max_seq, prefill_chunk=prefill_chunk,
                                  decode_block=decode_block, device=device)
        if concurrent <= 1 and draft == "ngram":
            from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator

            return NgramSpeculativeGenerator(model, spec_window_max=spec_window_max or 8,
                                             max_seq=max_seq, prefill_chunk=prefill_chunk,
                                             decode_block=decode_block)
        if concurrent <= 1 and draft_model:
            from mlx_sharding_tpu_torch.speculative import SpeculativeGenerator

            dmodel, _ = load_model(draft_model, device=device)
            return SpeculativeGenerator(model, dmodel, spec_k=spec_k, max_seq=max_seq,
                                        prefill_chunk=prefill_chunk, decode_block=decode_block)
        if concurrent <= 1:
            return Generator(model, max_seq=max_seq, prefill_chunk=prefill_chunk,
                             decode_block=decode_block, prompt_cache=prompt_cache,
                             graph_pool=graph_pool, weights=weights)
        from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

        engine = PipelineEngine(
            model, stages=stages, stage_bounds=stage_bounds, tp=tp, ep=ep,
            microbatches=concurrent, max_seq=max_seq, prefill_chunk=prefill_chunk,
            pool_pages=paged_pool, page_size=page_size, paged_attention=paged_attention,
            kv_dtype=kv_dtype, kv_share_map=share_map, kv_compress_map=compress_map,
            weights=weights, device=device,
        )
        return ContinuousBatcher(engine, decode_block=min(8, decode_block),
                                 policy=admission_policy, overcommit=overcommit,
                                 async_sched=async_sched, prefix_cache=prompt_cache,
                                 max_queue=max_queue, draft_engine=draft_engine,
                                 spec_k=spec_k, draft=draft if speculate else "off",
                                 spec_window_max=spec_window_max if speculate else None,
                                 spill_bytes=spill_bytes,
                                 spill_cold_after=spill_cold_after,
                                 kv_prefetch=kv_prefetch, prefix_store=store)

    def dense_draft_engine(dmodel, weights=None):
        from mlx_sharding_tpu_torch.parallel import PipelineEngine

        return PipelineEngine(dmodel, microbatches=concurrent, max_seq=max_seq,
                              prefill_chunk=prefill_chunk, weights=weights, device=device)

    if replicas <= 1 and not disagg:
        draft_engine = None
        if draft_model and concurrent > 1:
            draft_engine = dense_draft_engine(load_model(draft_model, device=device)[0])
        generator = make(load(), draft_engine=draft_engine)
        _warm_up(generator)
        return generator
    from mlx_sharding_tpu_torch.loading import checkpoint_signature

    signature = (checkpoint_signature(path, keep_quantized=keep_quantized) if model is None
                 else f"{path}::loaded")
    fleet = dict(disagg=disagg, prefill_replicas=prefill_replicas,
                 decode_replicas=decode_replicas, autoscale=autoscale,
                 autoscale_min=autoscale_min, autoscale_max=autoscale_max,
                 autoscale_interval=autoscale_interval,
                 autoscale_cooldown=autoscale_cooldown, brownout=brownout)
    # the split is part of a resident tree's identity (JAX's WeightKey)
    split = (tuple(tuple(b) for b in stage_bounds) if stage_bounds else ("auto", stages))
    return _replica_set(signature, device=device, keep_quantized=keep_quantized, load=load,
                        make=make, dense_draft_engine=dense_draft_engine, split=split,
                        stages=stages, stage_bounds=stage_bounds, tp=tp, ep=ep,
                        draft_model=draft_model if concurrent > 1 else None,
                        replicas=replicas, shared_weights=shared_weights, prefix_store=store,
                        **fleet)


def multihost_generator(path: str, *, device, max_seq: int, prefill_chunk: int,
                        keep_quantized: bool, decode_block: int, concurrent: int,
                        paged_pool: Optional[int], page_size: Optional[int],
                        paged_attention: str, kv_dtype: Optional[str], admission_policy: str,
                        async_sched: str, prompt_cache: bool, max_queue: Optional[int],
                        spill_bytes: Optional[int], spill_cold_after: Optional[int],
                        kv_prefetch: str, stages: int, stage_bounds, tp: int, ep: int,
                        dtype):
    """This rank's generator of a pipeline over the deployment's processes
    (JAX's provider under ``multihost``): the rank loads only its stages
    (``loading.load_rank_model``) into a ``PipelineEngine`` over the
    process layout (stage s on rank ``s // (S / P)``). Rank 0 gets a
    ``MultiHostPipeline`` over the engine's single stream, or with
    ``concurrent > 1`` a ``MultiHostBatcher`` (decode blocks of ``min(8,
    decode_block)``, JAX's, its spill flags passed on for the batcher to
    refuse what the mirrors cannot replay); a worker rank gets the engine,
    which ``serve_worker`` drives, or the mirror batcher that
    ``serve_worker_batched`` drives. Every rank warms up here, running the
    same steps in the same order over the hops; the kernels' launch
    counters, the hop's and the stage timings start from zero after it."""
    from mlx_sharding_tpu_torch.graphs import counted_wrappers
    from mlx_sharding_tpu_torch.loading import get_model_path, load_config, load_rank_model
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel.mesh import device_grid, process_layout
    from mlx_sharding_tpu_torch.parallel.multihost import (
        MultiHostPipeline,
        make_multihost_batcher,
        process_index,
    )
    from mlx_sharding_tpu_torch.parallel.pipeline import resolve_stage_bounds
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    procs = process_layout(stages, tp=tp, ep=ep)
    layers = load_config(get_model_path(path))["num_hidden_layers"]
    bounds = resolve_stage_bounds(layers, stages, stage_bounds)
    first = device_grid(pp=stages, tp=tp, ep=ep, device=device, procs=procs)[
        procs.local_stages[0], 0, 0, 0]
    model, _ = load_rank_model(path, bounds, procs, dtype=dtype, device=first,
                               keep_quantized=keep_quantized)
    paged = concurrent > 1 and paged_pool
    engine = PipelineEngine(
        model, stage_bounds=bounds, tp=tp, ep=ep,
        microbatches=concurrent if concurrent > 1 else 1, max_seq=max_seq,
        prefill_chunk=prefill_chunk, pool_pages=paged_pool if paged else None,
        page_size=page_size if paged else None,
        paged_attention=paged_attention, kv_dtype=kv_dtype if paged else None,
        decode_block=decode_block, device=device, processes=procs)
    rank0 = process_index() == 0
    if concurrent > 1:
        mirror = dict(decode_block=min(8, decode_block), prefix_cache=prompt_cache)
        generator = (make_multihost_batcher(
            engine, policy=admission_policy, max_queue=max_queue, async_sched=async_sched,
            spill_bytes=spill_bytes, spill_cold_after=spill_cold_after,
            kv_prefetch=kv_prefetch, **mirror) if rank0
            # the worker's mirror, as serve_worker_batched builds it
            else ContinuousBatcher(engine, **mirror))
    else:
        generator = MultiHostPipeline(engine) if rank0 else engine
    _warm_up(generator)
    # the read-outs count what serving runs
    engine.reset_read_outs()
    for wrapper in counted_wrappers():
        wrapper.launches = 0
    return generator


def rank_report(generator) -> dict:
    """This rank's read-outs of a deployment over several processes: the
    kernels' launches, the hop's counters, each of its stages' mean device
    ms, and the card's memory (allocated now and at its peak)."""
    import torch

    from mlx_sharding_tpu_torch.graphs import counted_wrappers
    from mlx_sharding_tpu_torch.parallel.multihost import process_index

    engine = getattr(generator, "engine", generator)
    out = {"rank": process_index(),
           "launches": {w.__name__: int(w.launches) for w in counted_wrappers()},
           "hop": dict(engine.hop_stats), "stage_ms": engine.stage_ms()}
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        out["memory_allocated"] = torch.cuda.memory_allocated(dev)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def _write_rank_report(generator) -> None:
    """Write :func:`rank_report` to the path ``MST_RANK_REPORT`` names
    (``{rank}`` filled in), when it is set: a worker at each request
    boundary and when it leaves, rank 0 when it shuts down."""
    template = os.environ.get("MST_RANK_REPORT")
    if not template:
        return
    report = rank_report(generator)
    path = template.format(rank=report["rank"])
    # whole or not at all: a reader never sees a report half written
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def _warm_up(generator) -> None:
    captured = generator.warm_up()  # on a card: the step graphs, before any request
    if captured:
        logger.info("captured %d CUDA graphs in %.2f s, graph pool %.1f MB",
                    captured["graphs"], captured["seconds"], captured["pool_bytes"] / 1e6)


def _replica_set(signature, *, device, keep_quantized, load, make, dense_draft_engine,
                 draft_model, replicas, shared_weights, prefix_store, split=("auto", 1),
                 stages=1, stage_bounds=None, tp=1, ep=1, disagg=False,
                 prefill_replicas=1, decode_replicas=1, autoscale=False, autoscale_min=None,
                 autoscale_max=None, autoscale_interval=2.0, autoscale_cooldown=15.0,
                 brownout=True):
    """``replicas`` generators behind one ``ReplicaSet`` (JAX's ``--replicas``
    spawn), or under ``disagg`` a prefill and a decode pool behind a
    ``DisaggCoordinator``: with shared weights each aliases the store's
    resident model (a lease released when its engine closes, so the last
    retirement frees the tree); otherwise the grid must hold a private copy
    per replica, which one device does not. Each replica takes JAX's ``per
    = stages x tp x ep`` devices: its shards' cards, or with ``device`` one
    device that carries every shard. The resident tree is placed once, at
    tp x ep (``parallel.pipeline.place_weights``), and every replica
    aliases it: its key names tp and ep, so a tp = 2 tree is never served
    to a tp = 1 engine. ``autoscale``: the fleet controllers
    (JAX's bounds on the port's device slices), started."""
    import functools

    import torch

    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.loading import checkpoint_signature, load_model
    from mlx_sharding_tpu_torch.parallel.mesh import device_grid, mesh_fingerprint
    from mlx_sharding_tpu_torch.parallel.pipeline import place_weights
    from mlx_sharding_tpu_torch.replicas import ReplicaSet
    from mlx_sharding_tpu_torch.weights import WeightKey, aliased_spawn, weight_store

    # JAX's per = stages x tp x ep devices a replica: the shards' own cards,
    # or one device when ``device`` carries them all
    placed = device_grid(pp=stages, tp=tp, ep=ep, device=device)
    per = len(set(placed.flat))
    n_devices = per if device is not None else torch.cuda.device_count()
    want = prefill_replicas + decode_replicas if disagg else replicas
    shared = shared_weights_on(shared_weights, want, per, n_devices)
    if not shared and want * per > n_devices:
        raise ValueError(f"{want} replicas x {per} devices each needs {want * per} "
                         f"devices, have {n_devices}")
    slices = n_devices // per  # JAX's device-slice allocator's total
    dev = resolve_device(device) if device is not None else placed.flat[0]
    store = weight_store()

    def resident(build_model, staged=True):
        def build():
            # the tree carries its split, its grid and each shard's layers,
            # which every aliasing engine checks against its own
            return place_weights(build_model(), stages=stages if staged else 1,
                                 stage_bounds=stage_bounds if staged else None,
                                 tp=tp if staged else 1, ep=ep if staged else 1, device=device)
        return build

    def key_of(checkpoint, quant, stages, devices):
        return WeightKey(checkpoint=checkpoint, stage_bounds=stages,
                         dtype="bfloat16",  # load_model's
                         quant=quant, placement=mesh_fingerprint(devices))

    key = key_of(signature, f"tp{tp}:ep{ep}", split, placed)
    draft_key = (key_of(checkpoint_signature(draft_model, keep_quantized=keep_quantized), "draft",
                        ("auto", 1), [dev])
                 if draft_model else None)

    def spawn(speculate=True):
        """One replica aliasing the resident model; ``speculate=False``
        builds one that never drafts (a disagg prefill replica emits one
        token a request)."""
        def make_one(lease):
            draft_engine = None
            if draft_key is not None and speculate:
                def make_draft(dlease):
                    deng = dense_draft_engine(dlease.weights.model, weights=dlease.weights)
                    deng.on_close(dlease.release)
                    return deng

                draft_engine = aliased_spawn(
                    store, draft_key,
                    resident(lambda: load_model(draft_model, device=device)[0], staged=False),
                    make_draft)
            pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
            try:
                gen = make(lease.weights.model, weights=lease.weights,
                           draft_engine=draft_engine, graph_pool=pool, speculate=speculate)
            except BaseException:
                if draft_engine is not None:
                    draft_engine.close()
                raise
            owner = getattr(gen, "engine", gen)
            owner.on_close(lease.release)
            _warm_up(gen)
            return gen

        return aliased_spawn(store, key, resident(load), make_one)

    def release_retired(rep):
        # a drained replica stays in the set's list: give its pool, graphs
        # and graph memory pool back to the card
        release = getattr(rep, "release_memory", None)
        if release is not None:
            release()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def controller(pool, factory, lo, hi):
        from mlx_sharding_tpu_torch.fleet import FleetAutoscaler

        ctrl = FleetAutoscaler(pool, factory, min_replicas=lo, max_replicas=hi,
                               interval_s=autoscale_interval, cooldown_s=autoscale_cooldown,
                               enable_brownout=brownout)
        ctrl.start()
        return ctrl

    if disagg:
        from mlx_sharding_tpu_torch.disagg import DisaggCoordinator

        spawn_prefill = functools.partial(spawn, speculate=False)
        prefill = ReplicaSet([spawn_prefill() for _ in range(prefill_replicas)],
                             role="prefill", prefix_store=prefix_store)
        decode = ReplicaSet([spawn() for _ in range(decode_replicas)], role="decode",
                            prefix_store=prefix_store)
        for pool in (prefill, decode):
            pool.on_retire = release_retired
            pool.shared_weights_active = shared
        generator = DisaggCoordinator(prefill, decode, prefix_store=prefix_store)
        generator.shared_weights_active = shared
        if autoscale:
            # one controller per pool, each reading its own pool's pressure;
            # an aliased spawn takes no device slice, so each pool keeps one
            # elastic spawn on a fully used grid (JAX's arithmetic)
            spare = slices - (prefill_replicas + decode_replicas)
            for pool, factory, base in ((prefill, spawn_prefill, prefill_replicas),
                                        (decode, spawn, decode_replicas)):
                controller(pool, factory, base,
                           base + (max(1, spare) if shared else max(0, spare)))
        return generator
    reps = ReplicaSet([spawn() for _ in range(replicas)], prefix_store=prefix_store)
    reps.on_retire = release_retired
    reps.shared_weights_active = shared
    if autoscale:
        # shared replicas take no device slice: KV memory, not the grid,
        # bounds them; private ones stay clamped to the slices
        hi = autoscale_max or slices
        controller(reps, spawn, autoscale_min or 1, hi if shared else min(hi, slices))
    return reps


def fleet_controllers(generator):
    """The fleet controllers driving ``generator`` (JAX's ``provider.fleet``):
    a ``FleetAutoscaler`` over a replica set, a (prefill, decode) tuple of
    them under a disagg coordinator, or None without ``--autoscale``."""
    pools = (getattr(generator, "prefill", None), getattr(generator, "decode", None))
    if None not in pools:
        ctrls = tuple(getattr(p, "_controller", None) for p in pools)
        return None if None in ctrls else ctrls
    return getattr(generator, "_controller", None)


class ModelProvider:
    """One generator and its tokenizer, served under ``model_name``.

    Built by :meth:`from_checkpoint`, it keeps its load arguments and swaps
    the model when a request names another checkpoint (JAX's hot-swap):
    paths must stay inside the working directory unless
    ``trust_remote_paths``; loads are serialized by ``_load_lock``; the new
    generator is built by :func:`build_generator` with the same arguments,
    and only once it has loaded is the old one closed (a batcher's thread
    stopped) and dropped, after any single-stream request in flight on it
    (``gen_lock``), so that its graphs, pools and caches are freed. Built
    around a generator (``ModelProvider(generator, tokenizer)``), it serves
    that one only. ``tokenizer_loader`` (a path -> tokenizer callable)
    defaults to the checkpoint's tokenizer through ``transformers``;
    ``chat_template`` overrides the tokenizer's."""

    def __init__(self, generator=None, tokenizer=None, *, model_name: str = "default_model",
                 load_args: Optional[dict] = None, trust_remote_paths: bool = False,
                 chat_template: Optional[str] = None, tokenizer_loader=None,
                 pod: bool = False):
        self.model_name = model_name
        self.load_args = load_args
        #: JAX's ``multihost``: the stages span the deployment's processes
        #: (no hot-swap then: the workers mirror steps, not loads)
        self.multihost = bool((load_args or {}).get("multihost"))
        #: ``--pod``: this host's fleet joins the pod over a
        #: ``pod.CollectiveTransport`` at load
        self.pod = pod
        self.trust_remote_paths = trust_remote_paths
        self.chat_template = chat_template
        self.tokenizer_loader = tokenizer_loader
        # a single-stream generator serves one request at a time under this
        # lock; a swap closes it under the lock too
        self.gen_lock = make_lock("APIHandler.gen_lock")
        # swaps are serialized: two requests naming different models would
        # otherwise race the generator and double-load onto the card
        self._load_lock = make_lock("ModelProvider._load_lock")
        # the pod.PodFleet this host serves in (--pod, or set by a caller):
        # /health's pod block and /metrics' pod families read it
        self.pod_fleet = None
        self._key: Optional[str] = None
        self.generator = None
        self.tokenizer = None
        # the live generator's fleet controllers (fleet_controllers): what
        # /admin/autoscaler drives and whose brownout ladder caps requests
        self.fleet = None
        self.load_seconds = 0.0  # the last load's: checkpoint, generator, graphs, tokenizer
        # the share-map artifact every engine binds (the ``mst_kv_share_*``
        # families and the ``kv_share`` block of /health render only with it)
        share_path = (load_args or {}).get("kv_share_map")
        if share_path and (load_args or {}).get("paged_pool"):
            from mlx_sharding_tpu_torch.kv_share import load_share_map

            self.kv_share_map = load_share_map(share_path)
        else:
            self.kv_share_map = None
        if generator is not None:
            self._set(model_name, generator, tokenizer)

    @classmethod
    def from_checkpoint(cls, path: str, *, trust_remote_paths: bool = False,
                        chat_template: Optional[str] = None, tokenizer_loader=None,
                        pod: bool = False, **load_args) -> "ModelProvider":
        """A provider serving the checkpoint at ``path``, its generator
        built by :func:`build_generator` with ``load_args`` (kept for
        swaps); with ``pod``, wrapped in this host's ``PodFleet``."""
        provider = cls(model_name=path, load_args=load_args,
                       trust_remote_paths=trust_remote_paths, chat_template=chat_template,
                       tokenizer_loader=tokenizer_loader, pod=pod)
        provider.load("default_model")
        return provider

    def _validate(self, name: str) -> str:
        if name == "default_model":
            return self.model_name
        if self.load_args is None:
            # a provider around a built generator cannot load another
            if name == self.model_name:
                return name
            raise ValueError(f"model {name!r} is not served here; this server serves "
                             f"{self.model_name!r}")
        # a containment check: a plain prefix test would let a sibling like
        # /srv/repo-evil pass for the working directory /srv/repo
        if not self.trust_remote_paths and not Path(name).resolve().is_relative_to(
                Path.cwd().resolve()):
            raise ValueError(f"model path {name!r} escapes the working directory")
        return name

    def load(self, name: str):
        """The generator and tokenizer for a request naming ``name``,
        loading that checkpoint first if another one is served."""
        target = self._validate(name)
        with self._load_lock:
            if self._key == target:
                return self.generator, self.tokenizer
            if self.multihost and self._key is not None:
                # workers mirror only the step sequence, not model swaps
                raise ValueError("model hot-swap is not supported in multi-host serving")
            logger.info("loading model %s", target)
            t0 = time.perf_counter()
            generator = build_generator(target, **self.load_args)
            if self.pod:
                generator = self._join_pod(generator)
            loader = self.tokenizer_loader
            if loader is None:
                from mlx_sharding_tpu_torch.loading import load_tokenizer as loader
            tokenizer = loader(target)
            self.load_seconds = time.perf_counter() - t0
            self._set(target, generator, tokenizer)
            logger.info("loaded model %s in %.2f s", target, self.load_seconds)
            return self.generator, self.tokenizer

    def _join_pod(self, generator):
        """Stitch this host's fleet into the pod (JAX's ``--pod``): the
        gossip transport over the pod's control plane, and the weight
        registry, the cross-host handoff, the pod autoscaler and the prefix
        federation around the local generator. Returns the ``PodFleet``,
        which serves in its place."""
        from mlx_sharding_tpu_torch.pod import CollectiveTransport, PodFleet

        fleet = fleet_controllers(generator)
        ctrls = fleet if isinstance(fleet, tuple) else (fleet,) if fleet is not None else ()
        transport = CollectiveTransport()
        pf = PodFleet(transport.host_id, transport, generator, controllers=list(ctrls),
                      prefix_store=getattr(generator, "prefix_store", None))
        pf.start()
        self.pod_fleet = pf
        return pf

    def _set(self, key, generator, tokenizer):
        if self.chat_template:
            # the operator's template wins over the checkpoint's
            tokenizer.chat_template = self.chat_template
        old = self.generator
        self._key = key
        self.generator = generator
        self.tokenizer = tokenizer
        # the old generator's controllers stop with its close below
        self.fleet = fleet_controllers(generator)
        if old is None:
            return
        if getattr(old, "concurrent", False):
            old.close()  # stop the replaced batcher's scheduler thread
            store = getattr(old, "prefix_store", None)
            if store is not None:
                store.close()  # its host tier goes with its load
        else:
            with self.gen_lock:  # after a request in flight on it
                if hasattr(old, "close"):
                    old.close()
        del old
        # the old generator's graphs, pools and caches are garbage now
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()


    def _load_arg(self, name: str, default=None):
        return (self.load_args or {}).get(name, default)

    # JAX's pipeline fields, from the load arguments
    start_layer = property(lambda self: self._load_arg("start_layer"))
    end_layer = property(lambda self: self._load_arg("end_layer"))
    num_stages = property(lambda self: self._load_arg("num_stages"))
    stage_bounds = property(lambda self: self._load_arg("stage_bounds"))
    engine = property(lambda self: self._load_arg("engine", "fused"))

    @property
    def shared_weights_active(self) -> bool:
        """Whether the live generator's replicas alias one resident model."""
        return bool(getattr(self.generator, "shared_weights_active", False))

    def kv_share_stats(self) -> Optional[dict]:
        """The layer-wise KV sharing summary (JAX's): the configured map's
        geometry and the live engine's measured pool-bytes saving; None
        without a share map."""
        m = self.kv_share_map
        if m is None:
            return None
        out = {"enabled": not m.is_identity, "groups": m.num_groups, "layers": m.num_layers,
               "share_hash": m.share_hash, "bytes_saved": 0}
        try:
            fn = getattr(getattr(self.generator, "engine", None), "kv_share_stats", None)
            if fn is not None:
                out["bytes_saved"] = int(fn().get("bytes_saved", 0))
        except Exception:  # noqa: BLE001 — the geometry still renders
            pass
        return out

    @property
    def prefix_store_obj(self):
        """The live batcher's prefix store (JAX's attribute), or None."""
        return getattr(self.generator, "prefix_store", None)

    def kv_compress_stats(self) -> Optional[dict]:
        """The live engine codec's counters (``mst_kv_compress_*``, the
        ``kv_compress`` block of ``/health``), None without a codec."""
        fn = getattr(getattr(self.generator, "engine", None), "kv_compress_stats", None)
        return fn() if fn is not None else None


class APIHandler(BaseHTTPRequestHandler):
    """Bound to its provider by :func:`make_server` (class attributes, as
    the standard library requires)."""

    provider: ModelProvider = None
    gen_lock: threading.Lock = None
    metrics: ServingMetrics = None
    profile_dir: Optional[str] = None
    api_key: Optional[str] = None
    # server-wide deadline defaults (--request-timeout / --ttft-timeout);
    # the body's fields override them
    request_timeout: Optional[float] = None
    ttft_timeout: Optional[float] = None
    protocol_version = "HTTP/1.1"
    # request bodies above this are rejected before being read
    MAX_BODY = 8 << 20
    # operator routes: key-gated, no sampler parameters, no model swap
    ADMIN_ROUTES = ("/admin/drain", "/admin/autoscaler")

    # ------------------------------------------------------------- helpers
    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _cors(self):
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type, Authorization")

    def _json(self, code: int, payload: dict, extra_headers: Optional[dict] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # the headers gathered while handling (the request id) ride along
        headers = dict(getattr(self, "_resp_headers", None) or {})
        headers.update(extra_headers or {})
        for k, v in headers.items():
            self.send_header(k, str(v))
        self._cors()
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, extra_headers: Optional[dict] = None):
        kind = (
            "invalid_request_error" if code == 400
            else "not_found_error" if code == 404
            else "overloaded_error" if code == 429
            else "service_unavailable_error" if code == 503
            else "timeout_error" if code == 504
            else "server_error"
        )
        self._json(code, {"error": {"message": message, "type": kind, "code": code}},
                   extra_headers=extra_headers)

    def _bytes(self, content_type: str, body: bytes):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self._cors()
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------------- routing
    def do_OPTIONS(self):
        self.send_response(204)
        self._cors()
        self.end_headers()

    def do_GET(self):
        path = self.path.split("?")[0]
        if path in ("/", "/index.html"):
            path = "/index.html"
        elif path == "/health":
            # the generator's own view (a batcher: ok, draining, degraded);
            # ``serving`` decides 200 against 503
            gen = self.provider.generator
            payload, serving = {"status": "ok"}, True
            if hasattr(gen, "health"):
                payload = dict(gen.health())
                serving = bool(payload.pop("serving", True))
            # resident weight trees (weights.WeightStore): trees, the engine
            # refs aliasing them and their bytes — the N×W → ~W number
            try:
                from mlx_sharding_tpu_torch.weights import weight_store

                st = weight_store().stats()
                payload["weight_store"] = {
                    "shared_weights": self.provider.shared_weights_active,
                    "trees": st["trees"], "refs": st["refs"], "bytes": st["bytes"]}
            except Exception:  # noqa: BLE001 — health renders without the block
                pass
            # the prefix store's residency, hits and insertion counters, the
            # pod's per-host view and counters (absent off a pod), the KV
            # share map's, and the KV codec's: the blocks operators size the
            # pool and the host tiers by
            store = self.provider.prefix_store_obj
            pod = getattr(self.provider, "pod_fleet", None)
            share = (self.provider.kv_share_stats
                     if getattr(self.provider, "kv_share_map", None) is not None else None)
            for key, read in (("prefix_store", store.stats if store is not None else None),
                              ("pod", pod.pod_stats if pod is not None else None),
                              ("kv_share", share),
                              ("kv_compress", self.provider.kv_compress_stats)):
                try:
                    block = read() if read is not None else None
                except Exception:  # noqa: BLE001 — health renders without the block
                    block = None
                if block is not None:
                    payload[key] = block
            ctrl = getattr(gen, "ctrl", None)
            if ctrl is not None:
                # a timed-out or failed collective marks the plane dead
                # (parallel/multihost.py); a completed one proves every rank
                # alive at that moment
                last = getattr(ctrl, "last_ok", None)
                payload["multihost"] = {
                    "workers_responsive": not ctrl.dead,
                    "last_exchange_s_ago": (None if last is None
                                            else round(time.monotonic() - last, 1)),
                }
                if ctrl.dead:
                    payload["status"] = "degraded"
                    serving = False
            return self._json(200 if serving else 503, payload)
        elif path == "/admin/trace" or path.startswith("/admin/trace/"):
            # the flight recorder: /admin/trace/dump is the whole ring (and
            # the incident snapshots) as one chrome://tracing document,
            # /admin/trace/<request id> one request's timeline
            tracer = tracing.get_tracer()
            if tracer is None or not tracer.enabled:
                return self._error(404, "tracing is off — start the server with "
                                        "--trace sample|on")
            rest = path[len("/admin/trace"):].strip("/")
            if rest in ("", "dump"):
                return self._json(200, tracer.export_dump())
            payload = tracer.export_request(rest)
            if payload is None:
                return self._error(404, f"no trace recorded for {rest!r}")
            return self._json(200, payload)
        elif path == "/metrics":
            return self._bytes("text/plain; version=0.0.4", self.metrics.render().encode())
        target = (STATIC_DIR / path.lstrip("/")).resolve()
        if not target.is_relative_to(STATIC_DIR.resolve()) or not target.is_file():
            return self._error(404, f"not found: {self.path}")
        self._bytes(CONTENT_TYPES.get(target.suffix, "application/octet-stream"),
                    target.read_bytes())

    def do_POST(self):
        route = self.path.split("?")[0]
        self._resp_headers: dict = {}  # per request (a handler serves many)
        handlers = {
            "/v1/completions": self._handle_text_completion,
            "/v1/chat/completions": self._handle_chat_completion,
        }
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if not 0 <= length <= self.MAX_BODY:
            self.close_connection = True  # can't safely drain; don't reuse
            return self._error(413, "invalid or oversized request body")
        try:
            # always drain before any reply (401 and 404 included), or
            # keep-alive desyncs
            raw = self.rfile.read(length)
        except OSError:
            return self._error(400, "unreadable request body")
        if route not in handlers and route not in self.ADMIN_ROUTES:
            return self._error(404, f"unknown route {route}")
        if self.api_key:
            # the web UI sends Authorization: Bearer <key>; only the POST
            # routes are gated (static files, /health and /metrics stay
            # open). Bytes compare: compare_digest refuses non-ASCII str,
            # and the header is the client's
            auth = self.headers.get("Authorization", "").encode("utf-8", "surrogateescape")
            if not hmac.compare_digest(auth, f"Bearer {self.api_key}".encode()):
                return self._json(401, {"error": {"message": "invalid or missing API key",
                                                  "type": "authentication_error",
                                                  "code": 401}})
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return self._error(400, "invalid JSON body")
        if route == "/admin/drain":
            return self._handle_drain(body)
        if route == "/admin/autoscaler":
            return self._handle_autoscaler(body)
        try:
            params = self._validate_params(body)
        except ValueError as e:
            return self._error(400, str(e))
        try:
            # a swap that fails to load answers here and leaves the old
            # model serving
            generator, tokenizer = self.provider.load(body.get("model", "default_model"))
            handlers[route](body, params, generator, tokenizer)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away
        except QueueFullError as e:
            # shed at submission, before any work: say when to come back
            self._error(429, str(e),
                        extra_headers={"Retry-After": str(max(1, round(e.retry_after_s)))})
        except RequestTimeoutError as e:
            self._error(504, str(e))
        except ReplicasUnavailableError as e:
            # every replica circuit-broken: the earliest half-open probe's
            # ETA says when a retry could be admitted
            ra = getattr(e, "retry_after_s", None)
            hdrs = ({"Retry-After": str(max(1, round(ra)))}
                    if isinstance(ra, (int, float)) and not isinstance(ra, bool) else None)
            self._error(503, str(e), extra_headers=hdrs)
        except ValueError as e:  # bad request discovered late (e.g. KV capacity)
            self._error(400, str(e))
        except Exception as e:  # a structured error, not a dropped connection
            logger.exception("request failed")
            self._error(500, f"{type(e).__name__}: {e}")

    def _handle_drain(self, body: dict):
        """POST /admin/drain ``{"replica": i, "deadline": s}`` (JAX's):
        retire one replica gracefully. Its requests migrate to the others
        (their streams go on) and /health reports ``draining`` meanwhile.
        400 without a replica set; a failure mid-migration leaves the
        replica quarantined (500, retryable) with nothing dropped."""
        drain = getattr(self.provider.generator, "drain", None)
        if drain is None:
            return self._error(400, "drain requires --replicas serving (a ReplicaSet generator)")
        if "replica" not in body:
            return self._error(400, "missing 'replica' index")
        try:
            replica = int(body["replica"])
            deadline = float(body.get("deadline", 30.0))
            if deadline <= 0:
                raise ValueError
        except (TypeError, ValueError):
            return self._error(400, "'replica' must be an integer and 'deadline' a positive "
                                    "number of seconds")
        try:
            result = drain(replica, deadline=deadline)
        except ValueError as e:
            return self._error(400, str(e))
        except Exception as e:  # noqa: BLE001 — quarantined, retryable
            logger.exception("replica drain failed")
            return self._error(500, f"{type(e).__name__}: {e}")
        return self._json(200, result)

    def _handle_autoscaler(self, body: dict):
        """POST /admin/autoscaler ``{"enabled": bool}`` (JAX's): start or
        stop the fleet controllers' loops (omit ``enabled`` to read them);
        answers each controller's state and its brownout ladder's, a list
        per pool under ``--disagg``. 400 without ``--autoscale``."""
        fleet = self.provider.fleet
        if fleet is None:
            return self._error(400, "autoscaler requires --autoscale (and --replicas > 1 or "
                                    "--disagg) serving")
        ctrls = fleet if isinstance(fleet, tuple) else (fleet,)
        enabled = body.get("enabled")
        if enabled is not None and not isinstance(enabled, bool):
            return self._error(400, "'enabled' must be a boolean")
        try:
            for ctrl in ctrls:
                if enabled is True:
                    ctrl.start()
                elif enabled is False:
                    ctrl.stop()
        except Exception as e:  # noqa: BLE001 — a structured 500
            logger.exception("autoscaler control failed")
            return self._error(500, f"{type(e).__name__}: {e}")

        def state(ctrl):
            out = dict(ctrl.state())
            bro = getattr(ctrl, "brownout", None)
            if bro is not None:
                out["brownout"] = bro.state()
            return out

        if len(ctrls) == 1:
            return self._json(200, state(ctrls[0]))
        return self._json(200, {"pools": [state(c) for c in ctrls]})

    # ---------------------------------------------------------- validation
    def _validate_params(self, body: dict) -> dict:
        """Parameter extraction and validation, the JAX server's bounds."""
        p = {}
        p["stream"] = bool(body.get("stream", False))
        p["max_tokens"] = body.get("max_tokens", 100)
        if not isinstance(p["max_tokens"], int) or p["max_tokens"] < 0:
            raise ValueError("max_tokens must be a non-negative integer")
        p["temperature"] = body.get("temperature", 0.0)
        if not isinstance(p["temperature"], (int, float)) or p["temperature"] < 0:
            raise ValueError("temperature must be a non-negative float")
        p["top_p"] = body.get("top_p", 1.0)
        if not isinstance(p["top_p"], (int, float)) or not 0 < p["top_p"] <= 1:
            raise ValueError("top_p must be in (0, 1]")
        rp = body.get("repetition_penalty")
        if rp is not None and (not isinstance(rp, (int, float)) or rp <= 0):
            raise ValueError("repetition_penalty must be a positive float")
        p["repetition_penalty"] = rp
        rcs = body.get("repetition_context_size", 20)
        if not isinstance(rcs, int) or rcs < 1:
            raise ValueError("repetition_context_size must be a positive integer")
        p["repetition_context_size"] = rcs
        logprobs = body.get("logprobs", -1)
        if logprobs != -1 and not (0 < logprobs <= 10):
            raise ValueError("logprobs must be between 1 and 10")
        p["logprobs"] = logprobs
        bias = body.get("logit_bias")
        if bias is not None:
            if not isinstance(bias, dict):
                raise ValueError("logit_bias must be a token_id -> bias map")
            try:
                bias = {int(k): float(v) for k, v in bias.items()}
            except (ValueError, TypeError):
                raise ValueError("logit_bias keys must be token ids")
            if len(bias) > 512:
                raise ValueError("logit_bias supports at most 512 entries")
        p["logit_bias"] = bias
        stop = body.get("stop", [])
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
            raise ValueError("stop must be a string or list of strings")
        p["stop_words"] = stop
        p["seed"] = body.get("seed")
        for key in ("request_timeout", "ttft_timeout"):
            v = body.get(key)
            if v is not None and (
                isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0
            ):
                raise ValueError(f"{key} must be a positive number of seconds")
            p[key] = v
        return p

    # ------------------------------------------------------------- prompts
    def _chat_prompt(self, body: dict, tokenizer) -> list[int]:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        if getattr(tokenizer, "chat_template", None):
            return tokenizer.apply_chat_template(messages, tokenize=True,
                                                 add_generation_prompt=True)
        return tokenizer.encode(convert_chat(messages, body.get("role_mapping")))

    # ----------------------------------------------------------- responses
    @staticmethod
    def _response_id() -> str:
        return f"cmpl-{uuid.uuid4().hex[:24]}"

    def _make_response(self, *, rid, object_type, model, text=None, delta=None,
                       finish_reason=None, usage=None, logprobs=None) -> dict:
        choice = {"index": 0, "finish_reason": finish_reason, "logprobs": logprobs}
        if object_type.startswith("chat"):
            if delta is not None:
                choice["delta"] = delta
            else:
                choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text if text is not None else ""
        resp = {
            "id": rid,
            "object": object_type,
            "created": int(time.time()),
            "model": model,
            "system_fingerprint": f"fp_{uuid.uuid4().hex[:10]}",
            "choices": [choice],
        }
        if usage:
            resp["usage"] = usage
        return resp

    # ----------------------------------------------------------- execution
    def _run(self, body, params, generator, tokenizer, prompt_ids, chat: bool):
        rid = self._response_id()
        # the key of /admin/trace/<id>, on every response, traced or not
        self._resp_headers["X-MST-Request-Id"] = rid
        model_name = body.get("model", "default_model")
        stop_id_sequences = [_encode_plain(tokenizer, s) for s in params["stop_words"]]
        eos = getattr(tokenizer, "eos_token_id", None)
        obj = "chat.completion" if chat else "text_completion"
        gen_kwargs = dict(
            temperature=params["temperature"],
            top_p=params["top_p"],
            repetition_penalty=params["repetition_penalty"],
            repetition_context_size=params["repetition_context_size"],
            logit_bias=params["logit_bias"],
            seed=params["seed"],
            max_tokens=params["max_tokens"],
        )
        if not params["stream"] and params["logprobs"] > 0:
            # streaming discards logprobs, so only this path computes them
            gen_kwargs["want_logprobs"] = True
        # brownout: under sustained overload the ladder caps max_tokens
        # before anything is shed, and says so in the response's headers;
        # under --disagg the decode pool's ladder governs (max_tokens is
        # decode-side cost)
        fleet = self.provider.fleet
        if isinstance(fleet, tuple):
            fleet = fleet[-1]
        bro = getattr(fleet, "brownout", None) if fleet is not None else None
        if bro is not None:
            bstate = bro.state()
            level = bstate.get("level", 0)
            if level > 0:
                self._resp_headers["X-MST-Brownout-Level"] = level
                cap = bstate.get("max_tokens_cap")
                if cap is not None and gen_kwargs["max_tokens"] > cap:
                    gen_kwargs["max_tokens"] = cap
                    self._resp_headers["X-MST-Max-Tokens-Capped"] = cap
        # session stickiness: a session_id (or OpenAI's ``user``) keeps a
        # conversation on the replica that holds its prefix
        sess = body.get("session_id") or body.get("user")
        if isinstance(sess, str) and sess and getattr(generator, "supports_sessions", False):
            gen_kwargs["_session"] = sess
        # the body's deadlines beat the server's; a generator that supports
        # deadlines enforces them itself, anything else gets the total
        # bound as a check between tokens
        req_to = params["request_timeout"]
        if req_to is None:
            req_to = self.request_timeout
        ttft_to = params["ttft_timeout"]
        if ttft_to is None:
            ttft_to = self.ttft_timeout
        timeout = None
        if getattr(generator, "supports_deadlines", False):
            if req_to is not None:
                gen_kwargs["request_timeout"] = req_to
            if ttft_to is not None:
                gen_kwargs["ttft_timeout"] = ttft_to
        else:
            timeout = req_to
        # a continuous batcher interleaves requests itself; a single-stream
        # generator is serialized by the lock
        lock = (contextlib.nullcontext() if getattr(generator, "concurrent", False)
                else self.gen_lock)
        # request tracing: a timeline under the client's request id, handed
        # down to the generator, which stamps its spans; the server retires
        # it into the flight recorder when the response has ended
        trace = tracing.begin(rid) if getattr(generator, "supports_trace", False) else None
        if trace is not None:
            gen_kwargs["_trace"] = trace
        try:
            with lock:
                if params["stream"]:
                    self._stream(rid, obj + ".chunk", model_name, generator, tokenizer,
                                 prompt_ids, stop_id_sequences, eos, chat, gen_kwargs, timeout,
                                 trace=trace)
                else:
                    self._complete(rid, obj, model_name, generator, tokenizer, prompt_ids,
                                   stop_id_sequences, eos, params["logprobs"], gen_kwargs,
                                   timeout)
        finally:
            tracing.finish(trace)

    def _complete(self, rid, obj, model_name, generator, tokenizer, prompt_ids,
                  stop_id_sequences, eos, want_logprobs, gen_kwargs, timeout):
        tokens: list[int] = []
        token_logprobs: list[float] = []
        top_logprobs: list[dict] = []
        finish_reason = "length"
        t_start = time.perf_counter()
        t_first = None
        it = self._generate(generator, prompt_ids, gen_kwargs, timeout)
        try:
            for token, logprobs in it:
                if t_first is None:
                    t_first = time.perf_counter()
                if eos is not None and token == eos:
                    finish_reason = "stop"
                    break
                tokens.append(token)
                if want_logprobs > 0:
                    token_logprobs.append(logprobs.chosen)
                    top_logprobs.append({
                        int(i): float(v)
                        for i, v in zip(logprobs.top_indices[:want_logprobs],
                                        logprobs.top_values[:want_logprobs])
                    })
                stop = stopping_criteria(tokens, stop_id_sequences, None)
                if stop.stop_met:
                    if stop.trim_length:
                        tokens = tokens[: -stop.trim_length]
                        if want_logprobs > 0:
                            token_logprobs = token_logprobs[: -stop.trim_length]
                            top_logprobs = top_logprobs[: -stop.trim_length]
                    finish_reason = "stop"
                    break
        finally:
            it.close()
        self._record(len(prompt_ids), len(tokens), t_start, t_first)
        logprobs_payload = None
        if want_logprobs > 0:
            logprobs_payload = {
                "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs,
                "tokens": tokens,
            }
        usage = {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(tokens),
            "total_tokens": len(prompt_ids) + len(tokens),
        }
        self._json(200, self._make_response(
            rid=rid, object_type=obj, model=model_name, text=tokenizer.decode(tokens),
            finish_reason=finish_reason, usage=usage, logprobs=logprobs_payload,
        ))

    def _stream(self, rid, obj, model_name, generator, tokenizer, prompt_ids,
                stop_id_sequences, eos, chat, gen_kwargs, timeout, trace=None):
        """SSE; text whose token tail could still grow into a stop sequence
        is held back. Each write is an ``sse_write`` span when traced."""
        t_start = time.perf_counter()
        it = self._generate(generator, prompt_ids, gen_kwargs, timeout)
        # prime the first token before committing to a 200, so a request
        # that fails at once gets a proper status code
        try:
            head = next(it)
        except StopIteration:
            head = None
        except BaseException:
            it.close()
            raise
        t_first = time.perf_counter() if head is not None else None

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # SSE has no Content-Length: the stream ends with the connection
        self.send_header("Connection", "close")
        for k, v in (getattr(self, "_resp_headers", None) or {}).items():
            self.send_header(k, str(v))
        self._cors()
        self.end_headers()

        def emit(payload: dict):
            buf = f"data: {json.dumps(payload)}\n\n".encode()
            if trace is not None:
                t0 = time.perf_counter()
                self.wfile.write(buf)
                self.wfile.flush()
                trace.add("sse_write", t0, time.perf_counter(), bytes=len(buf))
            else:
                self.wfile.write(buf)
                self.wfile.flush()

        def chunk(text):
            return self._make_response(
                rid=rid, object_type=obj, model=model_name,
                **({"delta": {"content": text}} if chat else {"text": text}),
            )

        if chat:
            emit(self._make_response(rid=rid, object_type=obj, model=model_name,
                                     delta={"role": "assistant", "content": ""}))

        def token_stream():
            if head is not None:
                yield head
            yield from it

        detok = StreamingDetokenizer(tokenizer)
        tokens: list[int] = []
        in_flight: list[int] = []  # tokens withheld for a possible stop sequence
        finish_reason = "length"
        timed_out: Optional[RequestTimeoutError] = None
        try:
            for token, _ in token_stream():
                if eos is not None and token == eos:
                    finish_reason = "stop"
                    break
                tokens.append(token)
                if stopping_criteria(tokens, stop_id_sequences, None).stop_met:
                    finish_reason = "stop"
                    in_flight.clear()
                    break
                if any(sequence_overlap(tokens, s) for s in stop_id_sequences):
                    in_flight.append(token)
                    continue
                for t in in_flight:
                    detok.add_token(t)
                in_flight.clear()
                detok.add_token(token)
                if detok.last_segment:
                    emit(chunk(detok.last_segment))
        except RequestTimeoutError as e:
            # headers are gone: close the stream with an error event
            timed_out = e
            in_flight.clear()
        finally:
            it.close()
        self._record(len(prompt_ids), len(tokens), t_start, t_first)
        if timed_out is not None:
            emit({"error": {"message": str(timed_out), "type": "timeout_error", "code": 504}})
        else:
            # a length-finished run that was still buffering emits the
            # buffered tokens: they never completed a stop sequence
            for t in in_flight:
                detok.add_token(t)
            detok.finalize()
            if detok.last_segment:
                emit(chunk(detok.last_segment))
            emit(self._make_response(
                rid=rid, object_type=obj, model=model_name,
                **({"delta": {}} if chat else {"text": ""}),
                finish_reason=finish_reason,
            ))
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()
        self.close_connection = True

    def _generate(self, generator, prompt_ids, gen_kwargs, timeout=None):
        """The generator's stream, inside a ``torch.profiler`` capture when
        ``--profile-dir`` is set; ``timeout`` bounds the total between
        tokens for a generator without deadlines of its own."""
        with profile_trace(self.profile_dir):
            it = generator.generate_step(prompt_ids, **gen_kwargs)
            if timeout is None:
                yield from it
                return
            t0 = time.monotonic()
            try:
                for item in it:
                    yield item
                    if time.monotonic() - t0 > timeout:
                        raise RequestTimeoutError("total", time.monotonic() - t0, timeout)
            finally:
                it.close()

    def _record(self, n_prompt, n_gen, t_start, t_first):
        end = time.perf_counter()
        ttft = (t_first - t_start) if t_first else 0.0
        decode_time = (end - t_first) if t_first else 0.0
        decode_tps = max(n_gen - 1, 0) / decode_time if decode_time > 0 else 0.0
        self.metrics.record_request(prompt_tokens=n_prompt, generation_tokens=n_gen,
                                    ttft_s=ttft, decode_tps=decode_tps)
        logger.info("request: %d prompt tokens, %d generated, TTFT %.1f ms, decode %.1f tok/s",
                    n_prompt, n_gen, ttft * 1e3, decode_tps)

    # ------------------------------------------------------------ handlers
    def _handle_chat_completion(self, body, params, generator, tokenizer):
        prompt_ids = self._chat_prompt(body, tokenizer)
        self._run(body, params, generator, tokenizer, list(prompt_ids), chat=True)

    def _handle_text_completion(self, body, params, generator, tokenizer):
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            return self._error(400, "prompt must be a non-empty string")
        self._run(body, params, generator, tokenizer, list(tokenizer.encode(prompt)), chat=False)


def make_server(provider: ModelProvider, host: str = "127.0.0.1", port: int = 8080,
                profile_dir: Optional[str] = None, api_key: Optional[str] = None,
                request_timeout: Optional[float] = None,
                ttft_timeout: Optional[float] = None) -> ThreadingHTTPServer:
    """A threading HTTP server over ``provider`` (JAX's signature); its
    ``/metrics`` read the provider's live generator at each scrape."""
    gen = lambda: provider.generator  # noqa: E731  (a swap must never leave a stale one)
    metrics = ServingMetrics(
        batcher_fn=lambda: gen() if getattr(gen(), "concurrent", False) else None,
        spec_fn=lambda: gen() if hasattr(gen(), "accepted_tokens") else None,
        prefix_store_fn=lambda: provider.prefix_store_obj,
        kv_compress_fn=provider.kv_compress_stats,
        kv_share_fn=lambda: (provider.kv_share_stats()
                             if getattr(provider, "kv_share_map", None) is not None else None),
        pod_stats_fn=lambda: (provider.pod_fleet.pod_stats()
                              if getattr(provider, "pod_fleet", None) is not None else None),
    )
    handler = type("BoundAPIHandler", (APIHandler,), {
        "provider": provider, "gen_lock": provider.gen_lock, "metrics": metrics,
        "profile_dir": profile_dir, "api_key": api_key,
        "request_timeout": request_timeout, "ttft_timeout": ttft_timeout})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None, *, tokenizer_loader=None, dtype=None):
    """The server's command line. ``tokenizer_loader`` (a path -> tokenizer
    callable) replaces the checkpoint's ``transformers`` tokenizer, and
    ``dtype`` the load's bf16 (JAX's provider ``cache_dtype``), for a
    caller that runs the entry point itself."""
    import argparse

    parser = argparse.ArgumentParser(description="OpenAI-compatible API server (PyTorch port)")
    parser.add_argument("--model", required=True, help="local checkpoint directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--start-layer", type=int, default=None)
    parser.add_argument("--end-layer", type=int, default=None)
    parser.add_argument("--num-stages", type=int, default=None,
                        help="pipeline stages (fused engine)")
    parser.add_argument("--stage-bounds", default=None,
                        help="pipeline stage bounds, e.g. '0-14,14-27' "
                        "(uneven splits and MoE/dense mixes allowed)")
    parser.add_argument("--engine", choices=("fused", "chained"), default="fused",
                        help="pipeline engine for --stage-bounds: fused "
                        "(one engine over every stage, default) or chained per-stage "
                        "models")
    parser.add_argument("--max-seq", type=int, default=4096)
    parser.add_argument("--prefill-chunk", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs without a card)")
    parser.add_argument("--keep-quantized", action="store_true",
                        help="keep 4-bit checkpoint weights packed in HBM "
                        "(fused dequant-matmul) instead of dequantizing on "
                        "load — 4x decode weight bandwidth")
    parser.add_argument("--concurrent", type=int, default=1,
                        help="continuous-batching slots: serve up to N "
                        "requests interleaved in one fused engine (N>1 "
                        "replaces the per-request generation lock)")
    parser.add_argument("--paged-pool", type=int, default=None,
                        help="with --concurrent: share a KV pool of N pages "
                             "across slots (reservation admission) instead "
                             "of dense per-slot max-seq allocations")
    parser.add_argument("--page-size", type=int, default=None,
                        help="KV page size in tokens (default: the prefill chunk); "
                        "must be a chunk multiple")
    parser.add_argument("--paged-attention",
                        choices=("auto", "ragged", "gather"), default="auto",
                        help="with --paged-pool: decode-attention path over "
                             "the page pool. 'ragged' attends in place via "
                             "the slot page tables (no per-tick gather/"
                             "scatter of the cache), 'gather' keeps the "
                             "contiguous per-slot view, 'auto' (default) "
                             "picks ragged where the engine supports it "
                             "(pp=1, tp=ep=1)")
    parser.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                        help="with --paged-pool: KV-pool storage. 'int8' stores codes "
                        "plus a per-row-per-head float32 scale; default keeps the "
                        "model dtype")
    parser.add_argument("--admission-policy", choices=("fifo", "first_fit"), default="fifo",
                        help="with --paged-pool: waiting-line policy when a request "
                        "does not fit the pool: strict order, or let smaller "
                        "requests pass a blocked head")
    parser.add_argument("--overcommit", action="store_true",
                        help="with --paged-pool: admit on current page need (prompt + "
                        "one decode block) and grow per block, preempting the "
                        "newest-admitted request on pool exhaustion (token-exact "
                        "resume) — higher slot occupancy than reserving every "
                        "request's full prompt+max_tokens need")
    parser.add_argument("--kv-share-map", default=None, metavar="PATH",
                        help="with --paged-pool: layer-wise KV sharing "
                             "(KVSharer) — path to a calibrated share-map "
                             "artifact from cli/kv_share_calibrate.py. "
                             "Pools allocate one physical (k,v) buffer per "
                             "share GROUP (~25-50%% fewer KV bytes at the "
                             "calibrated sharing ratio); exported blocks "
                             "carry the map's hash so mismatched layouts "
                             "fail closed at import. Composes with "
                             "--kv-dtype int8, --spill-bytes and "
                             "--prefix-store")
    parser.add_argument("--kv-compress-map", default=None, metavar="PATH",
                        help="with --paged-pool: compressed-latent KV transport "
                             "(kv_compress.py) — path to a calibrated low-rank artifact. "
                             "Exported KV page blocks (spill, prefix demotion) ship rank-r "
                             "latent coefficients instead of full per-head pages; "
                             "bounded-error, opt-in. MLA-native models (DeepSeek-V2's "
                             "compressed cache mode) compress exactly WITHOUT this flag. "
                             "Requires float/bf16 pools (not --kv-dtype int8)")
    parser.add_argument("--kv-compress-rank", type=int, default=None, metavar="R",
                        help="with --kv-compress-map: truncate the artifact's nested SVD "
                             "basis to rank R (a cheaper operating point than the "
                             "calibrated rank; more reconstruction error)")
    parser.add_argument("--spill-bytes", type=int, default=None,
                        help="with --overcommit or --spill-cold-after: host-memory budget "
                             "(bytes) for spilled KV page blocks. Preemption/cold-spill "
                             "exports the victim's pages to host memory and resume "
                             "re-imports them — one page scatter instead of a full "
                             "re-prefill; LRU-evicted past the budget, falling back to "
                             "re-prefill")
    parser.add_argument("--spill-cold-after", type=int, default=None,
                        help="with --spill-bytes: proactively spill a decode slot whose "
                             "consumer stopped pulling tokens for N scheduler ticks (idle "
                             "streaming session) — its pool pages free up for admission "
                             "and the session resumes token-exactly when the consumer "
                             "catches up")
    parser.add_argument("--kv-prefetch", choices=("on", "off", "auto"), default="auto",
                        help="stage spilled KV blocks host→device BEFORE the resume tick "
                             "(a side stream, overlapped with decode), demoting the demand "
                             "import to a counted fallback; auto = on whenever "
                             "--spill-bytes is set (default)")
    parser.add_argument("--prefix-store", action="store_true",
                        help="content-addressed prefix KV store (with --concurrent "
                             "--paged-pool): completed prefills register their "
                             "page-aligned prompt prefix under chained chunk digests; "
                             "later requests sharing the prefix lease the pages "
                             "copy-on-write or import them from the host tier (after "
                             "demotion) and prefill only the uncovered tail. Subsumes "
                             "--prompt-cache (the two are mutually exclusive)")
    parser.add_argument("--prefix-store-bytes", type=int, default=None,
                        help="with --prefix-store: host-memory budget (bytes) for the "
                             "demoted-prefix tier (default 256 MiB); LRU-evicted past the "
                             "budget, falling back to plain prefill")
    parser.add_argument("--prefix-insert-min-hits", type=int, default=1,
                        help="with --prefix-store: a prefix must MISS this many times "
                             "before a completed prefill inserts it (damps one-shot "
                             "prompts; default 1)")
    parser.add_argument("--prompt-cache", action="store_true",
                        help="reuse KV for shared prompt prefixes (chat turns "
                             "re-send their whole history: TTFT becomes "
                             "O(new tokens)). Single-chip generator path, or "
                             "with --concurrent --paged-pool: content-"
                             "addressed page sharing across interleaved "
                             "requests")
    parser.add_argument("--decode-block", type=int, default=16,
                        help="decode steps fused per program launch (token "
                             "pulls amortize over this many tokens; set 1 "
                             "for strict per-token streaming on a local chip)")
    parser.add_argument("--async-sched", choices=("on", "off", "auto"), default="auto",
                        help="with --concurrent: async tick pipelining — dispatch decode "
                        "block t+1 before harvesting block t, overlapping host-side "
                        "emit/stop/admission work with device compute (token streams "
                        "stay bit-identical to sync). 'auto' (default) enables it for "
                        "plain decode and --draft ngram (pure device-side chains) and "
                        "falls back to sync with --draft-model; 'off' forces the "
                        "sequential tick")
    parser.add_argument("--request-timeout", type=float, default=None,
                        help="total-generation deadline in seconds (submit to last token); "
                        "expiry cancels the request, frees its slot and KV pages and returns "
                        "HTTP 504 (or a final SSE error event). The body's "
                        "'request_timeout' overrides it")
    parser.add_argument("--ttft-timeout", type=float, default=None,
                        help="time-to-first-token deadline in seconds (queue wait + "
                        "prefill); also the default inter-token stall watchdog. Requests "
                        "still queued past it are shed before prefill. The body's "
                        "'ttft_timeout' overrides it")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="with --concurrent: admission bound on queued requests; a full "
                        "queue rejects with 429 + Retry-After instead of growing without "
                        "limit under overload")
    parser.add_argument("--api-key", default=None,
                        help="require 'Authorization: Bearer <key>' on the "
                             "/v1/* endpoints (the web UI's API key setting)")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace (Chrome trace JSON) per request "
                        "here")
    parser.add_argument("--trace", choices=("off", "sample", "on"), default="off",
                        help="request-lifecycle tracing: record per-request "
                             "span timelines (queue wait, prefill, decode "
                             "ticks, SSE writes) into a bounded flight-"
                             "recorder ring, exported as chrome://tracing "
                             "JSON via GET /admin/trace/{request_id} and "
                             "/admin/trace/dump. 'sample' traces every "
                             "--trace-sample-th request; 'on' traces all; "
                             "'off' (default) leaves None-check no-ops on "
                             "the hot paths")
    parser.add_argument("--trace-buffer", type=int, default=256,
                        help="flight-recorder capacity: completed request "
                             "timelines kept in the ring (oldest evicted); "
                             "incident snapshots (a wedged or failed "
                             "scheduler) preserve theirs separately")
    parser.add_argument("--trace-sample", type=int, default=8,
                        help="with --trace sample: trace every Nth request")
    parser.add_argument("--trace-profile", action="store_true",
                        help="with --trace: wrap each dispatched decode block "
                             "in a torch.profiler range (mst.decode_block) "
                             "so host spans line up with the card's kernels "
                             "under --profile-dir")
    parser.add_argument("--chat-template", default=None,
                        help="jinja chat template (inline, or @/path/to/file) "
                        "overriding the tokenizer's")
    parser.add_argument("--draft-model", default=None,
                        help="speculative decoding: a small draft model "
                             "proposes --spec-k tokens per round (greedy "
                             "token-exact, sampled distribution-exact): "
                             "on the single-stream generator, or with "
                             "--concurrent N as a dense draft engine beside "
                             "the batcher's slots")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="speculation window (with --draft-model)")
    parser.add_argument("--draft", choices=("auto", "off", "ngram", "engine"),
                        default="auto",
                        help="speculative proposal source. 'ngram' drafts "
                             "by prompt-lookup against the stream's own "
                             "prompt+history — no second checkpoint, no "
                             "draft KV, free to enable on every decode "
                             "host; 'engine' uses --draft-model; 'auto' "
                             "(default) keeps the legacy contract: engine "
                             "iff --draft-model, else off")
    parser.add_argument("--spec-window-max", type=int, default=None,
                        help="per-slot ADAPTIVE speculation windows, "
                             "resized each round on an acceptance EWMA "
                             "over the ladder {0,2,4,8} capped here "
                             "(losing slots disable and re-probe). Always "
                             "on for --draft ngram (default cap 8); opt-in "
                             "for --draft engine (without it the engine "
                             "path keeps fixed --spec-k rounds)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="data-parallel serving: N independent engine "
                             "replicas, each on its own devices (stages x tp "
                             "x ep each), least-loaded request routing — "
                             "aggregate throughput scales with N")
    parser.add_argument("--shared-weights", choices=("on", "off", "auto"),
                        default="auto",
                        help="cross-replica shared weights: place ONE "
                             "resident packed param tree per host and have "
                             "every replica (and both disagg pools) alias "
                             "it — fleet weight bytes ~W instead of N*W, "
                             "and an autoscaler spawn costs slot/cache "
                             "setup instead of a checkpoint re-upload. "
                             "Replicas co-locate on one model-parallel "
                             "slice (capacity is then bounded by KV "
                             "memory, not weight copies). auto: on when "
                             "--replicas > 1 or --disagg on a single-host "
                             "fused-engine config; off: always private "
                             "per-replica copies")
    parser.add_argument("--disagg", action="store_true",
                        help="disaggregated prefill/decode serving: split "
                             "the fleet into a prefill pool and a decode "
                             "pool. Each request prefills (and emits its "
                             "first token) on a prefill replica, then its "
                             "KV page block is handed to the least-loaded "
                             "decode replica, which owns the rest of the "
                             "stream — long prefills stop stalling decode "
                             "steady-state. Requires --concurrent; "
                             "--paged-pool makes the handoff a block "
                             "import instead of a re-prefill; handoff "
                             "failures degrade to serve-in-place (never a "
                             "dropped stream)")
    parser.add_argument("--prefill-replicas", type=int, default=1,
                        help="with --disagg: replicas in the prefill pool")
    parser.add_argument("--decode-replicas", type=int, default=1,
                        help="with --disagg: replicas in the decode pool")
    parser.add_argument("--autoscale", action="store_true",
                        help="with --replicas: run the elastic fleet "
                             "controller — spawn extra replicas onto unused "
                             "device slices under sustained queue pressure, "
                             "drain idle ones back down; spawn/drain "
                             "failures degrade to the static fleet (never a "
                             "dropped stream). Control at runtime via POST "
                             "/admin/autoscaler")
    parser.add_argument("--autoscale-min", type=int, default=None,
                        help="autoscaler floor: never drain below this many "
                             "replicas (default: 1)")
    parser.add_argument("--autoscale-max", type=int, default=None,
                        help="autoscaler ceiling (default: every replica the "
                             "device count can hold)")
    parser.add_argument("--autoscale-interval", type=float, default=2.0,
                        help="seconds between autoscaler control ticks")
    parser.add_argument("--autoscale-cooldown", type=float, default=15.0,
                        help="seconds after any scale event (or failed "
                             "attempt) before the next one")
    parser.add_argument("--brownout", choices=("on", "off"), default="on",
                        help="overload brownout ladder: under sustained "
                             "pressure cap max_tokens, shed speculation "
                             "(per-slot lowest-acceptance-first under "
                             "adaptive windows, globally in fixed-K engine "
                             "mode) and tighten admission BEFORE shedding "
                             "with 429; "
                             "level surfaced in /health and the "
                             "X-MST-Brownout-Level response header")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel width within each pipeline stage (shards on the "
                             "first cards, or all on --device)")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel width within each pipeline stage (MoE)")
    # multi-host bring-up: the torch.distributed control plane
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the torch.distributed rendezvous (rank 0 listens "
                             "there)")
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--pod", action="store_true",
                        help="pod-scale serving: each process runs its own "
                             "host-local fleet on its local devices, "
                             "stitched by the pod gossip plane (weight "
                             "registry, cross-host disagg handoff, pod "
                             "autoscaler) instead of the SPMD mirror — "
                             "requires --coordinator and --num-processes")
    args = parser.parse_args(argv)
    if args.engine == "chained" and not args.stage_bounds:
        parser.error("--engine chained requires --stage-bounds")
    if args.concurrent > 1 and args.engine == "chained":
        parser.error("--concurrent requires the fused engine")
    # JAX's mesh and multi-host rules and messages (its "requires --model"
    # rules have nothing to refuse: --model is required here)
    if (args.tp > 1 or args.ep > 1) and args.engine == "chained":
        parser.error("--tp/--ep require the fused engine")
    if args.pod and not (args.coordinator and (args.num_processes or 1) > 1):
        parser.error("--pod requires --coordinator and --num-processes > 1 (the pod gossip "
                     "plane rides jax.distributed)")
    # a pipeline over several processes, rank 0 driving the others
    multihost = bool(args.coordinator) and (args.num_processes or 1) > 1 and not args.pod
    if multihost and not args.stage_bounds and (args.num_stages or 1) <= 1:
        parser.error("multi-host serving requires a pipeline "
                     "(--num-stages > 1 or --stage-bounds)")
    # the stage flags, and (JAX's rules) the tp / ep mesh beside them
    staged = (bool(args.stage_bounds) or (args.num_stages or 1) > 1 or args.engine == "chained"
              or args.tp > 1 or args.ep > 1)
    layer_range = args.start_layer is not None or args.end_layer is not None
    if args.trace_buffer < 1:
        parser.error("--trace-buffer must be >= 1")
    if args.trace_sample < 1:
        parser.error("--trace-sample must be >= 1")
    if args.trace_profile and args.trace == "off":
        parser.error("--trace-profile requires --trace sample|on")
    if args.draft_model and (args.coordinator or staged or layer_range):
        parser.error("--draft-model applies to the single-chip full-model "
                     "generator or to --concurrent serving "
                     "(no --coordinator/--tp/--ep/stage or "
                     "layer-range flags)")
    if args.draft == "engine" and not args.draft_model:
        parser.error("--draft engine needs --draft-model")
    if args.draft_model and args.draft in ("off", "ngram"):
        parser.error(f"--draft {args.draft} conflicts with --draft-model: "
                     "drop one (--draft-model implies the engine proposer)")
    if args.draft == "ngram" and (multihost or staged or layer_range):
        parser.error("--draft ngram applies to the single-chip full-model "
                     "generator or to --concurrent serving (the verify "
                     "needs the pp=1 vectorized body; multi-host worker "
                     "mirrors replay plain decode ticks only — run it on "
                     "single-host replicas or --pod hosts instead)")
    if args.spec_window_max is not None:
        if args.spec_window_max < 2:
            parser.error("--spec-window-max must be >= 2")
        if args.draft == "off" or (
            args.draft == "auto" and not args.draft_model
        ):
            parser.error("--spec-window-max needs a speculating server: "
                         "--draft ngram or --draft-model")
    # the store subsumes --prompt-cache: both would put two owners over the
    # same pool pages (JAX's rules and messages)
    if args.prefix_store:
        if args.prompt_cache:
            parser.error(
                "--prompt-cache is subsumed by --prefix-store: the fleet-"
                "wide store covers the slot-local prefix cache's reuse and "
                "adds cross-replica sharing and a host tier — drop "
                "--prompt-cache (see README: migrating from --prompt-cache)")
        if args.concurrent <= 1 or not args.paged_pool:
            parser.error("--prefix-store requires --concurrent N (N > 1) "
                         "with --paged-pool (prefix reuse is page-granular)")
        if args.draft_model:
            parser.error("--prefix-store is incompatible with --draft-model "
                         "(the draft cache cannot alias shared prefix pages)")
        if args.coordinator and (args.num_processes or 1) > 1:
            parser.error("--prefix-store is single-host only: store "
                         "admissions rewrite page tables host-side, outside "
                         "the op stream worker ranks mirror")
    elif args.prefix_store_bytes is not None or args.prefix_insert_min_hits != 1:
        parser.error("--prefix-store-bytes/--prefix-insert-min-hits require --prefix-store")
    if args.prefix_store_bytes is not None and args.prefix_store_bytes < 1:
        parser.error("--prefix-store-bytes must be a positive byte count")
    if args.prefix_insert_min_hits < 1:
        parser.error("--prefix-insert-min-hits must be >= 1")
    if args.prompt_cache:
        # concurrent serving needs the paged pool; otherwise the flag means
        # the single-stream full-model generator (JAX's rule)
        if args.concurrent > 1:
            if not args.paged_pool:
                parser.error("--prompt-cache with --concurrent requires --paged-pool (prefix "
                             "sharing is page-granular)")
        elif (args.coordinator or staged or args.draft_model or args.replicas > 1
              or args.disagg or layer_range):
            parser.error("--prompt-cache applies to the single-chip "
                         "full-model generator path or to --concurrent "
                         "--paged-pool serving (no --coordinator/--tp/--ep/"
                         "stage, layer-range, --draft-model, or fleet "
                         "flags)")
    if args.replicas > 1 and (
        (args.coordinator and not args.pod) or args.engine == "chained"
        or (args.draft_model and args.concurrent <= 1)
        or (args.draft == "ngram" and args.concurrent <= 1)
        or layer_range
    ):
        parser.error("--replicas requires the fused full-model engine path "
                     "(no --coordinator/--engine chained/layer-range flags "
                     "unless --pod; --draft-model/--draft ngram only with "
                     "--concurrent)")
    if args.paged_pool and args.concurrent <= 1:
        parser.error("--paged-pool requires --concurrent N (N > 1)")
    if args.paged_pool and args.engine == "chained":
        parser.error("--paged-pool requires the fused engine")
    if args.page_size and not args.paged_pool:
        parser.error("--page-size requires --paged-pool")
    if args.paged_attention != "auto" and not args.paged_pool:
        parser.error("--paged-attention requires --paged-pool")
    if args.kv_dtype and not args.paged_pool:
        parser.error("--kv-dtype requires --paged-pool")
    if args.kv_share_map:
        if not args.paged_pool:
            parser.error("--kv-share-map requires --paged-pool (sharing "
                         "deduplicates the paged KV pool's layer axis)")
        if args.stage_bounds or (args.num_stages or 1) > 1:
            parser.error("--kv-share-map requires a single-stage engine: "
                         "share groups span the full layer stack, which a "
                         "pipeline stage split cuts")
    if args.kv_compress_map:
        if not args.paged_pool:
            parser.error("--kv-compress-map requires --paged-pool "
                         "(compression rides the paged KV transport path)")
        if args.kv_dtype == "int8":
            parser.error("--kv-compress-map is incompatible with "
                         "--kv-dtype int8: dequantize->project->requantize "
                         "compounds quantization error past the artifact's "
                         "calibrated bound")
        if args.stage_bounds or (args.num_stages or 1) > 1:
            parser.error("--kv-compress-map requires a single-stage "
                         "engine: the calibration spans the full layer "
                         "stack, which a pipeline stage split cuts")
    if args.kv_compress_rank is not None and not args.kv_compress_map:
        parser.error("--kv-compress-rank requires --kv-compress-map")
    if args.admission_policy != "fifo" and not args.paged_pool:
        parser.error("--admission-policy requires --paged-pool")
    if args.overcommit and not args.paged_pool:
        parser.error("--overcommit requires --paged-pool")
    if args.overcommit and multihost:
        # preemption and resume rewrite page tables and free lists host-side,
        # outside the op stream the worker ranks mirror
        parser.error(
            "--overcommit is not supported in multi-host serving: "
            "preemption/resume rewrites page tables and free lists "
            "host-side, outside the op stream worker ranks mirror; run "
            "overcommit on single-host replicas (e.g. behind --replicas) "
            "instead"
        )
    if args.spill_bytes is not None:
        if args.spill_bytes < 1:
            parser.error("--spill-bytes must be a positive byte count")
        if not args.overcommit and args.spill_cold_after is None:
            parser.error("--spill-bytes requires --overcommit or "
                         "--spill-cold-after: the spill tier holds "
                         "preempted or cold-spilled requests' KV page "
                         "blocks")
        if args.draft_model:
            parser.error("--spill-bytes is incompatible with --draft-model "
                         "(speculative slots re-prefill on preemption)")
    if args.spill_cold_after is not None:
        if args.spill_cold_after < 1:
            parser.error("--spill-cold-after must be >= 1 (scheduler ticks)")
        if args.spill_bytes is None:
            parser.error("--spill-cold-after needs a spill tier to spill "
                         "into: set --spill-bytes")
        if args.concurrent <= 1:
            parser.error("--spill-cold-after requires --concurrent N "
                         "(N > 1): cold-slot residency is a continuous-"
                         "batching policy")
    if args.kv_prefetch == "on" and args.spill_bytes is None:
        parser.error("--kv-prefetch on needs a spill tier to prefetch "
                     "from: set --spill-bytes")
    # JAX's fleet rules and messages
    if args.disagg:
        if args.concurrent <= 1:
            parser.error("--disagg requires --concurrent N (N > 1): only "
                         "the continuous batcher can park a prefill-only "
                         "request and resume it from a KV page block")
        if args.replicas > 1:
            parser.error("--disagg replaces --replicas: size the pools "
                         "with --prefill-replicas/--decode-replicas")
        if (args.coordinator and not args.pod) or args.engine == "chained":
            parser.error("--disagg requires the single-host fused engine "
                         "path (no --coordinator/--engine chained) — or "
                         "--pod, where each host runs its own disagg pools")
        if args.draft_model:
            parser.error("--disagg is incompatible with --draft-model: a "
                         "resumed stream's draft KV cannot be rebuilt from "
                         "the handed-off block (only the target's pages "
                         "travel). Use --draft ngram — prompt-lookup "
                         "drafts need no draft KV, so decode replicas "
                         "speculate on resumed streams too")
        if args.prefill_replicas < 1 or args.decode_replicas < 1:
            parser.error("--prefill-replicas/--decode-replicas must be "
                         "positive integers")
        if args.autoscale and (args.autoscale_min is not None
                               or args.autoscale_max is not None):
            parser.error("--autoscale-min/--autoscale-max do not apply to "
                         "--disagg: each pool's floor is its initial size "
                         "and its ceiling is the free device slices")
    elif args.prefill_replicas != 1 or args.decode_replicas != 1:
        parser.error("--prefill-replicas/--decode-replicas require "
                     "--disagg")
    if args.autoscale and args.replicas <= 1 and not args.disagg:
        parser.error("--autoscale requires --replicas N (N > 1) or "
                     "--disagg: only a ReplicaSet fleet can grow or shrink")
    if not args.autoscale and (
        args.autoscale_min is not None or args.autoscale_max is not None
    ):
        parser.error("--autoscale-min/--autoscale-max require --autoscale")
    if args.autoscale_min is not None and args.autoscale_min < 1:
        parser.error("--autoscale-min must be a positive integer")
    if (
        args.autoscale_min is not None and args.autoscale_max is not None
        and args.autoscale_max < args.autoscale_min
    ):
        parser.error("--autoscale-max must be >= --autoscale-min")
    if args.autoscale_interval <= 0 or args.autoscale_cooldown < 0:
        parser.error("--autoscale-interval must be > 0 and "
                     "--autoscale-cooldown >= 0")
    if args.async_sched != "auto" and args.concurrent <= 1:
        parser.error("--async-sched requires --concurrent N (N > 1): only the continuous "
                     "batcher has a tick loop to pipeline")
    if args.async_sched == "on" and args.draft_model:
        parser.error("--async-sched on is incompatible with --draft-model "
                     "(speculative rounds harvest per-round accept counts); "
                     "use 'auto'")
    if args.async_sched == "on" and multihost:
        parser.error("--async-sched on is not supported in multi-host "
                     "serving (worker mirrors replay the op stream per "
                     "broadcast tick); use 'auto'")
    if args.shared_weights == "on" and (
            args.coordinator or (args.num_processes or 1) > 1) and not args.pod:
        parser.error("--shared-weights on is single-host only: worker "
                     "ranks hold their own device grids, there is no "
                     "one resident tree for them to alias (--pod hosts "
                     "each alias their own local tree)")
    if args.shared_weights == "on" and args.engine == "chained":
        parser.error("--shared-weights on requires the fused engine "
                     "path (chained stage processes each own their "
                     "stage's weights)")
    if args.shared_weights == "on" and args.replicas <= 1 and not args.disagg:
        parser.error("--shared-weights on requires --replicas N "
                     "(N > 1) or --disagg: with one engine there is "
                     "nothing to alias")
    if args.max_queue is not None:
        if args.max_queue < 1:
            parser.error("--max-queue must be a positive integer")
        if args.concurrent <= 1:
            parser.error("--max-queue requires --concurrent N (N > 1): only the continuous "
                         "batcher has a submit queue to bound")
    for flag, val in (("--request-timeout", args.request_timeout),
                      ("--ttft-timeout", args.ttft_timeout)):
        if val is not None and val <= 0:
            parser.error(f"{flag} must be a positive number of seconds")

    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.parallel.mesh import device_grid, process_layout

    stage_bounds = None
    if args.stage_bounds:
        stage_bounds = [tuple(int(x) for x in part.split("-"))
                        for part in args.stage_bounds.split(",")]
    stages = len(stage_bounds) if stage_bounds else (args.num_stages or 1)
    logging.basicConfig(level=args.log_level.upper())
    if args.coordinator:
        # before anything is built: the rank decides what this process loads
        from mlx_sharding_tpu_torch.parallel.multihost import init_process

        try:
            init_process(args.coordinator, args.num_processes, args.process_id)
        except ValueError as e:
            parser.error(str(e))
    try:
        procs = process_layout(stages, tp=args.tp, ep=args.ep) if multihost else None
        if stages * args.tp * args.ep > 1:
            # without --device shard (s, e, t) goes on its own card (over
            # several processes: this rank's stages on its own cards)
            device_grid(pp=stages, tp=args.tp, ep=args.ep, device=args.device, procs=procs)
            device = args.device
        else:
            device = resolve_device(args.device)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        parser.error(str(e))
    # before the provider builds any batcher: a batcher resolves the
    # profile bridge once, at construction
    tracing.configure(args.trace, buffer=args.trace_buffer, sample_n=args.trace_sample,
                      profile=args.trace_profile)
    chat_template = args.chat_template
    if chat_template and chat_template.startswith("@"):
        chat_template = Path(chat_template[1:]).read_text()
    load_args = dict(
        device=device, max_seq=args.max_seq,
        prefill_chunk=args.prefill_chunk, keep_quantized=args.keep_quantized,
        decode_block=max(1, args.decode_block), concurrent=args.concurrent,
        paged_pool=args.paged_pool, page_size=args.page_size,
        paged_attention=args.paged_attention, kv_dtype=args.kv_dtype,
        admission_policy=args.admission_policy, overcommit=args.overcommit,
        async_sched=args.async_sched, prompt_cache=args.prompt_cache, max_queue=args.max_queue,
        draft=args.draft, draft_model=args.draft_model, spec_k=args.spec_k,
        spec_window_max=args.spec_window_max, spill_bytes=args.spill_bytes,
        spill_cold_after=args.spill_cold_after, kv_prefetch=args.kv_prefetch,
        prefix_store=args.prefix_store, prefix_store_bytes=args.prefix_store_bytes,
        prefix_insert_min_hits=args.prefix_insert_min_hits,
        kv_compress_map=args.kv_compress_map, kv_compress_rank=args.kv_compress_rank,
        kv_share_map=args.kv_share_map, replicas=args.replicas,
        shared_weights=args.shared_weights, disagg=args.disagg,
        prefill_replicas=args.prefill_replicas, decode_replicas=args.decode_replicas,
        autoscale=args.autoscale, autoscale_min=args.autoscale_min,
        autoscale_max=args.autoscale_max, autoscale_interval=args.autoscale_interval,
        autoscale_cooldown=args.autoscale_cooldown, brownout=args.brownout == "on",
        start_layer=args.start_layer, end_layer=args.end_layer, num_stages=args.num_stages,
        stage_bounds=stage_bounds, engine=args.engine, tp=args.tp, ep=args.ep,
        multihost=multihost, dtype=dtype,
    )
    if multihost and procs.rank > 0:
        # a worker rank: no HTTP and no tokenizer; it mirrors rank 0's step
        # sequence until rank 0 shuts the deployment down (the reference's
        # per-machine shard server without its RPC surface)
        import torch

        from mlx_sharding_tpu_torch.parallel.multihost import (
            serve_worker,
            serve_worker_batched,
            shutdown_process,
        )

        logger.info("worker rank %d serving", procs.rank)
        # the engine, or with --concurrent the mirror batcher over it
        mirror = build_generator(args.model, **load_args)
        # its read-outs at each request boundary (MST_RANK_REPORT)
        on_idle = functools.partial(_write_rank_report, mirror)
        with torch.no_grad():
            if args.concurrent > 1:
                serve_worker_batched(mirror, on_idle=on_idle)
            else:
                serve_worker(mirror, on_idle=on_idle)
        _write_rank_report(mirror)
        shutdown_process()
        return
    provider = ModelProvider.from_checkpoint(
        args.model, chat_template=chat_template, tokenizer_loader=tokenizer_loader,
        pod=args.pod, **load_args)
    server = make_server(provider, args.host, args.port, profile_dir=args.profile_dir,
                         api_key=args.api_key, request_timeout=args.request_timeout,
                         ttft_timeout=args.ttft_timeout)
    if multihost and threading.current_thread() is threading.main_thread():
        # SIGTERM ends rank 0 through the finally below, which shuts the
        # workers down first
        def _terminate(signum, frame):
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _terminate)
    logger.info("serving on http://%s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        if multihost:
            gen = provider.generator
            gen.close()  # the workers leave their loops on its SHUTDOWN
            _write_rank_report(gen)


if __name__ == "__main__":
    main()
