"""Continuous batching (port of the single-host subset of
``mlx_sharding_tpu/scheduler.py::ContinuousBatcher``), over a paged KV pool
or over dense slot caches (an engine without ``pool_pages``: admission by a
free slot alone, no page accounting, as JAX's dense batcher).

- Every slot of a :class:`~mlx_sharding_tpu_torch.parallel.PipelineEngine`
  holds an independent request with its own KV offset, sampler settings,
  ``torch.Generator`` and repetition window.
- One scheduler thread owns the engine and all the card's work; HTTP
  threads only enqueue requests and read their token queues. Each tick
  reaps cancelled slots, admits waiting requests into free slots (``fifo``
  holds the line behind a head that does not fit, ``first_fit`` lets later
  requests that fit pass it), runs prefill chunks, and runs one decode
  block of ``decode_block`` steps over every decoding slot.
- Admission reserves a request's whole prompt + max_tokens need in pages
  up front, or with ``overcommit`` only its current need (the prompt plus
  ``_grow_ahead`` tokens); an overcommitted slot grows before each decode
  block, oldest request first, and on pool exhaustion the newest-admitted
  request is preempted: its emitted tokens fold into its prompt, its
  sampler state (generator state, window row) is stashed, and it goes back
  to the head of the waiting line, to be re-prefilled and continue exactly
  where it stopped (the discard path), or, with a spill tier, to import its
  exported pages and continue from them.
- While anything decodes, one prefill chunk runs per tick, round-robin
  over the admitting requests; with nothing decoding they all advance.
- A decode block reads the card once: right after its dispatch its outputs
  are copied to pinned host memory and an event is recorded, and the
  harvest waits on that event alone. On a CUDA device the block's K steps
  are one captured CUDA graph per (K, logprobs, sampler branch), JAX's
  ``decode_block_prog``, and each prefill chunk one graph per chunk offset
  (``PipelineEngine.prefill_step``), JAX's ``prefill_slot``.

Over an engine whose stages span processes (``engine.procs``), rank 0's
batcher and the workers' mirrors replay one op stream
(``parallel.multihost.MultiHostBatcher``): a sync tick's decode block is
:meth:`ContinuousBatcher._decode_once`, which that batcher overrides to
broadcast the op first; "auto" ticks resolve to sync, and n-gram
speculation, overcommit, cold-slot spill and the prefix store are refused
with JAX's messages (each a host-side decision outside the op stream).

Async ticks (``async_sched``, "auto" resolves to on): decode block t+1 is
dispatched before block t is harvested, so the card runs block t+1 while
the host waits for block t's tokens and emits them. The streams
are bit-identical to sync ticks: the same graphs consume the same device
carries in the same order. The cost is a one-tick control lag: a slot that
finishes at block t's harvest is still in block t+1, whose tokens for it
are dropped at its harvest (its host offset, advanced at that dispatch, is
rolled back when the slot is reclaimed), and overcommit growth reaches two
blocks ahead. Admission prefill, growth that might preempt, idling and
shutdown quiesce first (harvest the block in flight).

Determinism: a slot's generator is seeded from the request's seed, and its
repetition window set, when its prefill completes (other slots' ticks run
between its chunks), and a sampled row draws from its own generator alone,
so a seeded request gives the same tokens alone, among others and across a
preemption.

Deadlines and the queue bound (``resilience.py``): ``generate_step`` takes
``ttft_timeout``, ``request_timeout`` and ``stall_timeout``, stamped on the
batcher's clock at submission; the consumer's waits are bounded by them
and an expiry cancels the request (the next tick reclaims its slot and
pages) and raises ``RequestTimeoutError``; a queued request whose TTFT
budget has gone is shed at admission. With ``max_queue``, a submission
that finds that many requests queued raises ``QueueFullError`` with a
``Retry-After`` estimated from the recent completion rate.

Prefix sharing (``prefix_cache``): every full page of a finished prefill
is registered under a rolling blake2b key of the whole prompt prefix it
closes; a later prompt that starts with a registered chain maps those pages
(refcounted) and prefills only past them. Pages that only the index holds
are evicted least recently used when admission or growth runs short. A
preempted request drops its pages and looks its folded prompt up again.

N-gram speculation (``draft="ngram"``): a tick whose decoding slots all
have window-max rows of headroom and want no logprobs runs one speculative
round instead of a decode block. Each slot's prompt + history proposes up
to its adaptive window (``AcceptanceTracker``) by prompt lookup
(``NgramDraftProposer``), and one T=K verify of all M slots
(``PipelineEngine.spec_verify_ngram_cb``, one CUDA graph per (K, sampler
branch)) emits each slot's accepted prefix and correction token; a slot
whose window is 0 rides along with a cap of 1 and emits its correction
token only. Every verify and decode block plans its positions on the
device from the slot offsets held there (``_dev_off``, moved by each
round's counts and each block's steps); the drafts, the caps, the table
rows and the host's offsets (taken whenever no round is in flight, so the
host stays the authority) go up in one upload, the host reads ``(count,
gs)`` once, and each slot's host offset follows its count at the harvest.
A tick with no speculating slot runs the plain decode block. Async ticks
under speculation (``auto`` resolves to them, as in JAX) dispatch round
t+1 before harvesting round t: its proposals extend each slot's history
with round t's drafts (a wrong guess costs acceptance, never exactness),
and its positions come from the device, since the host's offsets lag a
round in flight.

Speculation with a draft engine (``draft_engine``, a dense
``PipelineEngine`` of a small model with the target's slots, chunk and
vocabulary): each slot's prompt is prefilled into the draft's cache too
(``draft_pos``, chunk for chunk beside the target's), and a round is two
captured graphs, the draft's K proposal steps (``spec_propose_cb``, one
graph per (K, sampler branch)) and the target's T=K verify with the
draft's distributions; the draft's device offsets move by K and rewind by
``count - K`` on the device, and its host offsets follow the counts the
harvest reads. Rounds are ``spec_k`` wide (or adapt per slot with
``spec_window_max``). A tick that cannot speculate (a slot wants logprobs
or is near the capacity) runs a plain block and then feeds the chain it
consumed, ``[prev_tok, block[:-1]]``, through the draft's caches
(``spec_replay_cb``, counted in ``fallback_ticks``). A draft engine forces
sync ticks: each round's proposals depend on the last round's counts.

Observability (JAX's, single host): ``health()`` and
``scheduler_thread_live()`` (``close()`` marks the thread wedged when its
join times out), and the ``/metrics`` read-outs ``stats``,
``page_stats``, ``kv_read_stats``, ``hbm_bytes_per_token_stats``,
``latency_stats`` (inter-token and queue-wait histograms),
``tick_timing_stats``, ``spec_stats``, ``resilience_stats`` and
``prefix_stats``. Each runs on the scrape's thread and reads host counters
(under the batcher's locks where JAX takes them); none reads the card.
Request tracing (``tracing.py``): ``generate_step(_trace=...)`` binds a
timeline that gets ``queue_wait``, ``prefill``, ``decode_tick`` (or
``spec_round``) spans and ``submit``, ``first_token``, ``preempt`` and
``finish`` marks; with tracing off each site is one ``is None`` branch.
Under ``--trace-profile`` each dispatched decode block runs inside an
``mst.decode_block`` profiler range.

KV movement (``kv_transfer.py``, JAX's spill tier): with ``spill_bytes``
a preempted request's page chain is exported (a gather on the tick's
stream) into a host-memory LRU tier whose flusher thread copies it out;
its resume imports the pages into fresh pool pages and restores its
generator state, window and last token, instead of re-prefilling. With
``spill_cold_after`` a decoding slot whose consumer stopped reading for
that many ticks is spilled the same way and parked off the waiting line
until the consumer catches up. ``kv_prefetch`` stages a spilled block on
the card (a side stream, from pinned memory) while its request waits, so
the import's scatter waits on an event instead of the host waiting for
the copy. A failed export, import or prefetch is counted, logged, and the
request re-prefills. Prefix store (``prefix_store``, one
``prefix_store.PrefixStore`` per server): admissions lease the pages of a
registered prompt prefix copy-on-write (device tier) or import its demoted
block (host tier) and prefill only the rest; a finished prefill registers
its prefix under its chained chunk digests, and the entry's last release
exports it to the host tier.

Migration (JAX's drain movers): ``migrate_out`` makes the scheduler thread
quiesce and end every stream with a ``RequestMigratedError`` whose
``ResumeState`` carries the request's prompt, history, sampler state
(generator state and window) and its page chain exported into a host
block (or its spilled block); the replica set re-places it through
``generate_step(_resume=...)`` on another batcher, which imports the block
at admission (or, without one, folds the history and re-prefills), so a
greedy or seeded stream continues exactly. A draining batcher refuses new
work with ``ReplicaDrainingError``.

Disaggregated serving (JAX's prefill-only protocol):
``generate_step(_prefill_only=True)`` admits a request that needs one
token here. When its prefill completes and its first token is emitted,
the slot is parked; the tick exports its page chain (a gather on the
tick's stream, the copy to the host left to the consumer: the disagg
coordinator calls ``to_host`` on its own thread), frees the slot before
the decode dispatch, and ends the stream with a ``HandoffReadyError``
carrying the :class:`ResumeState`. The parked slots' window rows come to
the host in one copy.

Brownout (``set_pressure``, the fleet controller's ladder): level 1 pauses
prefix-store insertion, level 2 sheds speculation (per slot, lowest
acceptance first, through the tracker; a fixed-K draft engine pauses),
level 3 sheds it everywhere and halves the queue bound. The ``spec.draft``
fault site degrades one speculative round to a plain block, counted in
``spec_stats()["draft_faults"]``.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.cache import kv_row_bytes, rewind_slot_offset, slot_table
from mlx_sharding_tpu_torch.kv_transfer import KVSpillTier, export_block, import_block
from mlx_sharding_tpu_torch.generate import (
    BLOCK_KINDS,
    LOGPROB_TOPK,
    TokenLogprobs,
    block_lp_outputs,
    block_token_logprobs,
)
from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.graphs import StepGraphs, close_worker, open_worker
from mlx_sharding_tpu_torch.resilience import (
    Deadlines,
    HandoffReadyError,
    QueueFullError,
    ReplicaDrainingError,
    RequestMigratedError,
    RequestTimeoutError,
    ResumeState,
)
from mlx_sharding_tpu_torch.speculative import AcceptanceTracker, NgramDraftProposer
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.sample import (
    BIAS_WIDTH,
    SamplerParams,
    make_sampler_params,
    sample_token_batched,
    select_rows,
    set_sampler_slot,
    stack_sampler_params,
    window_mask,
)
from mlx_sharding_tpu_torch.utils.observability import (
    ITL_BUCKETS_S,
    LATENCY_BUCKETS_S,
    Histogram,
)

logger = logging.getLogger(__name__)

# Retry-After clamps for 429 sheds: the estimate comes from the observed
# completion rate, bounded so that a mis-sampled rate can neither tell
# clients "come back now" nor park them for minutes
RETRY_AFTER_FLOOR_S = 1.0
RETRY_AFTER_CEIL_S = 30.0
RETRY_AFTER_WINDOW_S = 30.0


def estimate_retry_after(backlog: int, finish_times, now: float) -> float:
    """When should a shed client retry (JAX ``estimate_retry_after``)?
    ``backlog`` requests must finish before the queue has room;
    ``finish_times`` are monotonic completion stamps. The drain rate is
    completions in the window over the window's span, the estimate
    ``backlog / rate`` clamped to the floor and the ceiling; with no
    completion in the window the queue is not draining and the answer is
    the ceiling."""
    recent = [t for t in finish_times if now - t <= RETRY_AFTER_WINDOW_S]
    if not recent:
        return RETRY_AFTER_CEIL_S
    span = max(now - min(recent), 1e-3)
    rate = len(recent) / span
    return min(RETRY_AFTER_CEIL_S, max(RETRY_AFTER_FLOOR_S, backlog / rate))


@dataclass(eq=False)  # identity semantics
class _Request:
    prompt: np.ndarray  # (T,) int64
    sp: SamplerParams
    seed: int
    max_tokens: int
    rep_context: int
    want_logprobs: bool = False
    out: queue.Queue = field(default_factory=queue.Queue)
    cancelled: bool = False
    slot: int = -1
    produced: int = 0
    prefill_pos: int = 0  # next prompt index to prefill; admission is chunked
    waited_for_pages: bool = False
    # overcommit: admission order (the oldest admitted request is never
    # preempted), the tokens emitted since the last (re)admission (folded
    # into the prompt on preemption, so the resume re-prefills them), and
    # the stashed sampler state of an exact resume: the slot generator's
    # state and its window row (on the device)
    admit_seq: Optional[int] = None
    history: list = field(default_factory=list)
    resume_gen: Optional[torch.Tensor] = None
    resume_recent: Optional[torch.Tensor] = None
    preempted_at: list = field(default_factory=list)  # tokens produced at each preemption
    deadlines: Optional[Deadlines] = None
    # the sampler settings as submitted: a multi-host batcher broadcasts
    # them (``parallel.multihost._assign_msg``)
    temperature: float = 0.0
    top_p: float = 1.0
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[dict] = None
    draft_pos: int = 0  # next prompt index the draft engine prefills
    # the target's logits at its last prompt chunk, while the draft catches up
    last_logits: Optional[torch.Tensor] = None
    # prefix sharing: the rolling keys of the prompt's full pages (memoized,
    # reset when the prompt folds) and the chain _fits found for admission
    pkeys: Optional[list] = None
    chain: Optional[list] = None
    # the prefix store: the prompt's chained chunk digests (memoized, reset
    # when the prompt folds), the ("device" | "host", cover) plan _fits
    # found, and the PrefixLease the slot holds on shared pages
    sdigests: Optional[list] = None
    splan: Optional[tuple] = None
    lease: Optional[object] = None
    # the pod's prefix fetch (JAX ``_podfetch``): None = not consulted,
    # "pending" = a fetch in flight (admission holds the request), "done"
    podfetch: Optional[str] = None
    # KV movement: a block of this request waits in the spill tier, or
    # (``block``) a block handed in with a migrated request; the cold-slot
    # scan's consumed count and the ticks it has not moved
    spilled: bool = False
    block: Optional[object] = None
    consumed_seen: int = 0
    cold_ticks: int = 0
    # disaggregated serving: emit the first token, then end the stream with
    # HandoffReadyError(ResumeState) instead of decoding
    prefill_only: bool = False
    # tracing: the bound timeline (None when off or not sampled; a
    # server-owned one is retired by the server), and the perf_counter
    # stamps of the queue-wait and inter-token histograms
    trace: Optional[object] = None
    trace_own: bool = False
    t_submit: float = 0.0
    t_last_emit: float = 0.0


@dataclass
class _InflightBlock:
    """A dispatched decode block: its stacked outputs on their way to the
    host, the event that says they landed (None on the CPU), and the slots
    it ran for."""

    outs: torch.Tensor  # (K, M, 1) tokens, or (K, M, 2 + 2·LOGPROB_TOPK) float64
    event: Optional[torch.cuda.Event]
    live: list  # [(slot, req)] at dispatch
    want_lp: bool
    # with a draft engine: the block's first input tokens (M, 1), on the host
    prev_tok: Optional[torch.Tensor] = None


@dataclass
class _InflightSpec:
    """A dispatched speculative round: its ``(count, gs)`` on their way to
    the host ((K + 1, M) int64: row 0 the counts, then the tokens), the
    event that says they landed, the slots it ran for, and each slot's
    policy window, cap and proposals."""

    outs: torch.Tensor
    event: Optional[torch.cuda.Event]
    live: list
    wins: dict
    wcaps: np.ndarray
    guess: dict  # slot -> the drafts it proposed, the next round's history guess


class ContinuousBatcher:
    """Drives a :class:`PipelineEngine` (``microbatches=M``, paged or
    dense) as an M-slot continuous-batching server backend. ``generate_step`` has the
    contract of ``Generator.generate_step``; the server calls it without
    its generation lock (``concurrent = True``). ``cuda_graphs=False`` runs
    the prefill chunks and decode blocks eagerly on the card (for checks
    and measurements)."""

    concurrent = True
    # generate_step takes request_timeout / ttft_timeout / stall_timeout and
    # enforces them; the server forwards deadlines only to such generators
    supports_deadlines = True
    # generate_step takes _trace (a tracing.RequestTrace) and stamps its
    # spans; the server begins a timeline only for such generators
    supports_trace = True
    # generate_step takes _resume (a ResumeState): the dispatcher re-places
    # migrated streams only onto batchers that advertise it
    supports_resume = True
    # generate_step takes _prefill_only=True (disaggregated serving): the
    # stream delivers the first token, then ends with HandoffReadyError
    # carrying the request's ResumeState
    supports_prefill_only = True

    def __init__(self, engine, *, repetition_window: int = 64, decode_block: int = 8,
                 policy: str = "fifo", prefix_cache: bool = False, overcommit: bool = False,
                 draft_engine=None, spec_k: int = 4, draft: str = "auto",
                 spec_window_max: Optional[int] = None,
                 spec_clock: Optional[Callable[[], float]] = None,
                 max_queue: Optional[int] = None,
                 async_sched: str = "auto", spill_bytes: Optional[int] = None,
                 spill_cold_after: Optional[int] = None, kv_prefetch: str = "auto",
                 prefix_store=None, cuda_graphs: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue is not None and (not isinstance(max_queue, int) or max_queue < 1):
            raise ValueError(f"max_queue must be a positive int, got {max_queue!r}")
        if policy not in ("fifo", "first_fit"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if async_sched not in ("on", "off", "auto"):
            raise ValueError(f"async_sched must be 'on', 'off' or 'auto', got {async_sched!r}")
        if draft not in ("auto", "off", "ngram", "engine"):
            raise ValueError(f"draft must be 'auto', 'off', 'ngram' or 'engine', got {draft!r}")
        # the draft MODE: 'auto' is engine iff a draft engine was handed in
        spec_mode = draft
        if spec_mode == "auto":
            spec_mode = "engine" if draft_engine is not None else "off"
        if spec_mode == "engine" and draft_engine is None:
            raise ValueError("draft='engine' needs a draft engine (--draft-model)")
        if spec_mode != "engine" and draft_engine is not None:
            raise ValueError(f"a draft engine was given but draft={draft!r} — drop the draft "
                             "engine or select draft='engine'/'auto'")
        stages = getattr(engine, "num_stages", 1)
        # an engine whose stages span processes: rank 0's batcher and the
        # workers' mirrors replay one op stream (JAX's refusals at
        # process_count() > 1, message for message)
        multi = getattr(engine, "procs", None) is not None
        if spec_mode == "ngram" and stages != 1:
            raise ValueError("speculative continuous batching needs a pp=1 engine (the verify "
                             "wants the keep_all vectorized body)")
        if spec_mode == "ngram" and multi:
            # the mirror protocol has no speculative op: a controller-local
            # round would desync the mirrored op streams
            raise ValueError("--draft ngram is not supported in multi-host serving: worker "
                             "mirrors replay plain decode ticks only; run it on single-host "
                             "replicas (e.g. behind --replicas) instead")
        draft_stages = getattr(draft_engine, "num_stages", 1)
        if draft_engine is not None and (stages != 1 or draft_stages != 1):
            raise ValueError("speculative continuous batching needs pp=1 engines")
        if spec_window_max is not None:
            if (isinstance(spec_window_max, bool) or not isinstance(spec_window_max, int)
                    or spec_window_max < 2):
                raise ValueError(f"spec_window_max must be an int >= 2, got "
                                 f"{spec_window_max!r}")
            if spec_mode == "off":
                raise ValueError("spec_window_max needs a draft mode — select --draft ngram or "
                                 "--draft engine")
        if draft_engine is not None:
            # the draft engine mirrors the target's slot structure (same M,
            # same chunking) with its own dense KV cache
            tv = getattr(engine.model.config, "vocab_size", None)
            dv = getattr(draft_engine.model.config, "vocab_size", None)
            if tv != dv:
                # draft token ids index the target's embedding and logprob rows
                raise ValueError(f"draft vocab ({dv}) must match target vocab ({tv}) — "
                                 "speculation exchanges raw token ids between the models")
            if getattr(draft_engine, "paged", False):
                raise ValueError("the draft engine must be dense (no pool_pages)")
            if draft_engine.microbatches != engine.microbatches:
                raise ValueError("draft engine must match the target's slots")
            if draft_engine.prefill_chunk != engine.prefill_chunk:
                raise ValueError("draft engine must match the target's prefill chunk")
            if draft_engine.max_seq < engine.max_seq:
                raise ValueError("draft engine max_seq must cover the target's")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        paged = getattr(engine, "pool_pages", None) is not None
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires a paged engine (pool_pages): sharing "
                             "is page-granular")
        if prefix_store is not None:
            if not paged:
                raise ValueError("the prefix store requires a paged engine (pool_pages): "
                                 "prefix reuse is page-granular")
            if prefix_cache:
                raise ValueError("prefix_cache and prefix_store are mutually exclusive — the "
                                 "fleet-wide store subsumes the slot-local prefix cache "
                                 "(--prompt-cache); drop --prompt-cache")
            if draft_engine is not None:
                raise ValueError("the prefix store is incompatible with a draft engine: the "
                                 "draft's dense KV has no shareable pages, so a store hit "
                                 "would leave it attending to unprefilled state")
            if multi:
                # lookup, lease and import are host-side page-table decisions
                # outside the op stream the workers mirror
                raise ValueError("the prefix store is not supported in multi-host serving: "
                                 "store hits rewrite page tables host-side, outside the "
                                 "mirrored op stream; run it on single-host replicas (e.g. "
                                 "behind --replicas) instead")
        if overcommit and not paged:
            raise ValueError("overcommit admission requires a paged engine (pool_pages)")
        if overcommit and multi:
            # preemption and re-import are host-side decisions that rewrite
            # page tables and pop the free list outside the mirrored stream
            raise ValueError("overcommit admission is not supported in multi-host serving: "
                             "preemption/resume rewrites page tables and free lists "
                             "host-side, outside the op stream worker ranks mirror; run "
                             "overcommit on single-host replicas (e.g. behind --replicas) "
                             "instead")
        if spill_bytes is not None:
            if isinstance(spill_bytes, bool) or not isinstance(spill_bytes, int) \
                    or spill_bytes <= 0:
                raise ValueError(f"spill_bytes must be a positive byte count, got "
                                 f"{spill_bytes!r}")
            if not paged:
                raise ValueError("KV spill (--spill-bytes) requires a paged engine "
                                 "(pool_pages): spilling moves pool pages")
            if draft_engine is not None:
                # the draft's dense KV has no page chain to export
                raise ValueError("KV spill is incompatible with a draft engine — "
                                 "speculative slots re-prefill on preemption")
        if spill_cold_after is not None:
            if isinstance(spill_cold_after, bool) or not isinstance(spill_cold_after, int) \
                    or spill_cold_after < 1:
                raise ValueError(f"spill_cold_after must be an int >= 1 (ticks), got "
                                 f"{spill_cold_after!r}")
            if spill_bytes is None:
                raise ValueError("spill_cold_after needs a spill tier to spill into — "
                                 "set spill_bytes (--spill-bytes)")
            if multi:
                # a rank-local cold spill would desync the mirrored op streams
                raise ValueError("cold-slot spill is not supported in multi-host serving")
        if kv_prefetch not in ("on", "off", "auto"):
            raise ValueError(f"kv_prefetch must be 'on', 'off' or 'auto', got {kv_prefetch!r}")
        if kv_prefetch == "on" and spill_bytes is None:
            raise ValueError("kv_prefetch='on' needs a spill tier to prefetch from — "
                             "set spill_bytes (--spill-bytes)")
        if async_sched == "on" and draft_engine is not None:
            # the next round's proposals depend on this round's accept counts
            raise ValueError("async_sched='on' is incompatible with a draft engine; use 'auto' "
                             "(resolves to sync when speculating)")
        if async_sched == "on" and multi:
            # the mirrors replay the op stream a tick at a time; a rank-local
            # lookahead block would desync them
            raise ValueError("async_sched='on' is not supported in multi-host serving")
        # async ticks: "auto" resolves as the JAX rule does; with no draft
        # engine and one host, plain decode and n-gram rounds are pure
        # device-side chains
        self.async_sched = async_sched
        self._async = async_sched == "on" or (async_sched == "auto" and draft_engine is None
                                              and not multi)
        self.async_reason = (
            "async ticks: async_sched='on'" if async_sched == "on" else
            "sync ticks: async_sched='off'" if async_sched == "off" else
            "sync ticks: auto resolved to sync — the draft engine's speculative rounds harvest "
            "per-round accept counts that the next round's proposals depend on, so there is no "
            "device-side chain to run ahead on" if draft_engine is not None else
            "sync ticks: auto resolved to sync — multi-host worker mirrors replay the op stream "
            "per broadcast tick; a rank-local lookahead block would desync them" if multi else
            "async ticks: auto resolved to async — n-gram drafts are host-built (no draft "
            "engine, no draft KV), so the speculative round chains pure device-side like a "
            "plain decode block" if spec_mode == "ngram" else
            "async ticks: auto resolved to async — plain single-host decode is a pure "
            "device-side chain"
        )
        logger.info("%s", self.async_reason)
        self.engine = engine
        self.paged = paged
        self.M = engine.microbatches
        self.W = repetition_window
        self.policy = policy
        self.overcommit = overcommit
        self.decode_block = max(1, decode_block)
        # speculation: windows adapt per slot along the ladder up to
        # spec_window_max (8 by default) for n-gram drafts always, for a
        # draft engine only when spec_window_max is given (else every round
        # is spec_k wide)
        self._spec_mode = spec_mode
        self.spec_k = spec_k
        if spec_mode == "ngram" or (spec_mode == "engine" and spec_window_max is not None):
            self.spec_tracker: Optional[AcceptanceTracker] = AcceptanceTracker(
                self.M, w_max=spec_window_max or 8,
                clock=clock if spec_clock is None else spec_clock)
            self._w_max = self.spec_tracker.rungs[-1]
        else:
            self.spec_tracker = None
            self._w_max = spec_k if spec_mode == "engine" else 0
        self._ngram = NgramDraftProposer() if spec_mode == "ngram" else None
        # overcommit growth covers the furthest write ahead of the host's
        # emitted counts: a decode block or a T=K verify, twice that when a
        # block runs ahead of them
        reach = max(self.decode_block, self._w_max)
        if spec_mode == "engine":
            reach = max(reach, spec_k)
        self._grow_ahead = (2 if self._async else 1) * reach
        self.rounds = 0  # verify rounds x slots
        self.accepted_tokens = 0  # tokens emitted by speculating slots
        self.draft_tokens = 0  # proposal tokens offered to verifies
        self.verify_ticks = 0  # ticks that ran a speculative round
        # ticks that fell back to a plain block with a draft engine, and the
        # tokens replayed through the draft to keep its caches in step
        self.fallback_ticks = 0
        self.replayed_tokens = 0
        self.spec_draft_faults = 0  # spec.draft faults: that tick ran a plain block
        # the slot offsets on the device, which every decode block and
        # verify plans from and moves (the host's are taken whenever exact)
        self._dev_off = torch.zeros(self.M, dtype=torch.int64, device=engine.device)
        self._waiting: list[_Request] = []
        self._submit: queue.Queue = queue.Queue()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        # the decode block dispatched and not yet harvested (async ticks)
        self._inflight = None  # an _InflightBlock or an _InflightSpec
        # deadlines and admission control: every deadline and Retry-After
        # reads this clock; the lock makes the queue bound's check-then-
        # enqueue atomic across HTTP threads and the counters exact
        self._clock = clock
        self.max_queue = max_queue
        self._admission_lock = threading.Lock()
        self.timeouts = 0  # consumer-side deadline expiries
        self.shed_queue_full = 0  # rejected at submission (429)
        self.shed_deadline = 0  # shed while queued: the TTFT budget had gone
        self._finish_times: deque = deque(maxlen=256)  # completion stamps
        # the fleet controller's brownout level (set_pressure): >= 2 sheds
        # speculation, 3 halves the queue bound. Read racily on the tick, as
        # JAX does: it changes at the controller's tick cadence
        self._pressure = 0
        # close() sets it when the scheduler thread outlives its join: the
        # health turns degraded and the thread-live gauge drops to 0
        self.thread_wedged = False
        # always-on latency histograms: inter-token gaps at the emit path,
        # the queue wait at slot assignment (host stamps only)
        self._h_itl = Histogram(ITL_BUCKETS_S, "ContinuousBatcher._h_itl")
        self._h_queue_wait = Histogram(LATENCY_BUCKETS_S, "ContinuousBatcher._h_queue_wait")
        # --trace-profile, resolved once (the server configures tracing
        # before it builds the batcher)
        self._trace_profile = tracing.profile_enabled()

        # the pool: a request holds pages from admission until it finishes
        # (or is preempted); dense slot caches need no page accounting
        if paged:
            self.cache, self.table = engine.init_cache_paged()
            self._free_pages = list(range(engine.pool_pages - 1, -1, -1))
        else:
            self.cache, self.table = engine.init_cache(), slot_table(self.M)
            self._free_pages = []
        self._pages_of: dict[int, list[int]] = {}
        self.pages_high_water = 0
        # the analytic KV-read accounting of a paged pool (JAX
        # _account_kv_read): K+V bytes of one position over every layer,
        # and the weight bytes one decode step streams
        self.kv_path = engine.paged_attention
        self.kv_bytes_read_last_tick = 0
        self.kv_bytes_read_total = 0
        self.weight_bytes_per_token_last = 0.0
        self.kv_bytes_per_token_last = 0.0
        self._kv_row_bytes = kv_row_bytes(self.cache)
        # each stage's device: a staged block is prefetched stage by stage
        self._kv_devices = list(getattr(engine, "stage_devices", [engine.device]))
        # prefix sharing: a page's refcount is the slots mapping it plus 1
        # if the index holds it; index-only pages are cached, not free, and
        # evicted least recently used when admission or growth runs short
        self.prefix_cache = bool(prefix_cache)
        self._page_ref: dict[int, int] = {}
        self._prefix_index: "OrderedDict[bytes, int]" = OrderedDict()
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefix_evictions = 0

        # per-slot sampler state on the card
        dev = engine.device
        self.sp = stack_sampler_params([make_sampler_params(device="cpu")] * self.M,
                                       width=BIAS_WIDTH, device=dev)
        # row m's penalty window: the last rep_context entries of its buffer
        self.rep_mask = window_mask(self.W, [self.W] * self.M, dev)
        self.recent = torch.full((self.M, self.W), -1, dtype=torch.int64, device=dev)
        self.generators = [torch.Generator(device=dev) for _ in range(self.M)]
        self.last_tok = torch.zeros((self.M, 1), dtype=torch.int64, device=dev)
        self.active = [False] * self.M  # a slot decodes iff its prefill completed
        # the batcher's graphs in a memory pool of their own: batchers over
        # one model (replicas) capture on their own threads, and a retired
        # one gives its pool back (release_memory)
        # (an engine that captures each stage's share of a step on its own,
        # its stages on distinct devices, leaves the batcher none to capture)
        self.graphs = (StepGraphs(dev, torch.cuda.graph_pool_handle())
                       if dev.type == "cuda" and cuda_graphs
                       and not getattr(engine, "per_stage_graphs", False) else None)
        self._worker = self.graphs is not None
        if self._worker:
            open_worker()  # a capture's sync check must spare this thread's syncs
        # the draft engine's own caches, offsets (host and device), sampling
        # generators and graphs
        self.draft = draft_engine
        if draft_engine is not None:
            self.dcache, self.dtable = draft_engine.init_cache(), slot_table(self.M)
            self._ddev_off = torch.zeros(self.M, dtype=torch.int64, device=dev)
            self.dgenerators = [torch.Generator(device=dev) for _ in range(self.M)]
            self.dgraphs = (StepGraphs(dev, torch.cuda.graph_pool_handle())
                            if self.graphs is not None else None)

        self._slots: list[Optional[_Request]] = [None] * self.M
        self._prefill_rr = 0  # round-robin cursor for admission fairness
        self._admit_counter = 0
        # counters of the work the batcher ran (the smoke checks launch
        # counts against them)
        self.prefill_chunks = 0
        self.draft_prefill_chunks = 0
        self.decode_steps = 0
        # host clock inside the blocks' dispatches and harvests (a quiesce's
        # harvest included)
        self.decode_seconds = 0.0
        self.page_waits = 0  # requests that found a free slot but not enough pages
        self.preemptions = 0
        self.reprefill_tokens = 0  # prompt + history tokens of discard paths

        # KV movement (kv_transfer.py): preempted (and cold) requests' page
        # blocks in a host-memory LRU tier; every counter below is written
        # under _admission_lock
        self._share_hash = getattr(engine, "kv_share_hash", None)
        self._kv_codec = getattr(engine, "kv_codec", None)
        self._compress_hash = getattr(engine, "kv_compress_hash", None)
        self.spill_bytes = spill_bytes
        self.spill = KVSpillTier(spill_bytes) if spill_bytes else None
        self.spills = 0  # blocks exported to the tier at preemption or cold spill
        self.spill_hits = 0  # resumes served by a block import
        self.spill_fallbacks = 0  # export, import or budget failures: re-prefills
        # drained and migrated requests: exported by migrate_out, resumed
        # through generate_step(_resume=...)
        self.migrations_out = 0
        self.migrations_in = 0
        self.handoffs_out = 0  # prefill-only requests handed to a decode pool
        # prefill-only requests whose first token was emitted this tick:
        # _handoff_out exports them before the tick's decode dispatch
        self._handoff_ready: list[_Request] = []
        # the drain flag: migrate_out sets it (under _start_lock) and it
        # stays set, so the batcher is retired
        self._migrate_requested = False
        self.spill_cold_after = spill_cold_after
        self.kv_prefetch = kv_prefetch
        self._prefetch_on = kv_prefetch == "on" or (kv_prefetch == "auto"
                                                    and self.spill is not None)
        self._parked: list[_Request] = []  # cold-spilled, off the waiting line
        self.cold_spills = 0
        self.cold_wakes = 0
        self.prefetches = 0  # host-to-device stages enqueued
        self.prefetch_hits = 0  # imports that took a staged block
        self.demand_imports = 0  # imports that copied the host payload themselves
        self.prefetch_faults = 0  # cache.prefetch faults: the demand path
        # the fleet prefix store (prefix_store.py), shared by the server's
        # batchers; device entries hold this pool's pages
        self.prefix_store = prefix_store
        if prefix_store is not None:
            prefix_store.bind_page_size(engine.page_size)
            prefix_store.bind_share_hash(self._share_hash)
            prefix_store.bind_compress_hash(self._compress_hash)
        self.reset_tick_timing()

    # ------------------------------------------------------------- public
    def generate_step(
        self,
        prompt_tokens,
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        repetition_penalty: Optional[float] = None,
        repetition_context_size: int = 20,
        logit_bias: Optional[dict[int, float]] = None,
        seed: Optional[int] = None,
        max_tokens: int = 256,
        want_logprobs: bool = False,
        request_timeout: Optional[float] = None,
        ttft_timeout: Optional[float] = None,
        stall_timeout: Optional[float] = None,
        _resume: Optional[ResumeState] = None,
        _prefill_only: bool = False,
        _trace=None,
    ):
        """Validate and enqueue at once (every rejection raises on the
        calling thread, before any request state exists; a full queue
        raises ``QueueFullError``, a draining batcher
        ``ReplicaDrainingError``); returns the token stream ``(token,
        TokenLogprobs or None)``, whose waits the deadlines bound.
        ``_resume``: a stream migrated off another batcher continues here
        (JAX's re-placement): its block is imported at admission, or
        without one its history folds into the prompt and re-prefills, its
        sampler state restored either way. ``_prefill_only`` (the disagg
        coordinator's): the stream ends after the first token with a
        ``HandoffReadyError`` carrying the request's state. ``_trace``: the server's
        timeline for the request; without one the request begins its own
        on the process tracer (None when off)."""
        with self._start_lock:
            draining = self._migrate_requested
        if draining:
            # retired: the dispatcher re-places on another replica
            raise ReplicaDrainingError()
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        produced0, hist, block = 0, [], None
        resume_gen = resume_recent = None
        if _resume is not None:
            produced0 = int(_resume.produced)
            if produced0 >= max_tokens:
                raise ValueError(f"resumed request already produced {produced0} of "
                                 f"{max_tokens} tokens")
            hist = [int(t) for t in (_resume.history or [])]
            if len(hist) > produced0:
                # history is the tokens emitted since the last fold: a suffix
                # of what the client saw, never longer than it
                raise ValueError(f"resume state inconsistent: produced={produced0} but "
                                 f"history carries {len(hist)} tokens")
            block = _resume.block
            if block is not None and (not self.paged or self.draft is not None):
                block = None  # no pool to import into: fold instead
            # the sampler state travels even beside a block: a failed import
            # folds and re-prefills, and must continue the exported draws
            resume_gen, resume_recent = _resume.resume_keys, _resume.resume_recent
            if block is None and hist:
                prompt = np.concatenate([prompt, np.asarray(hist, np.int64)])
                hist = []
        budget = max_tokens - produced0
        total = (block.n_tokens if block is not None else prompt.size) + budget
        if total > self.engine.max_seq:
            raise ValueError(f"prompt ({prompt.size}) + max_tokens ({max_tokens}) exceeds KV "
                             f"capacity {self.engine.max_seq}")
        # the request's whole need must fit the pool alone: an overcommitted
        # request that is the only one left can then always grow to its end
        need = -(-total // self.engine.page_size)
        if self.paged and need > self.engine.pool_pages:
            raise ValueError(f"request needs {need} pages, pool has {self.engine.pool_pages} — "
                             "it could never be admitted")
        width = self.sp.bias_indices.shape[1]
        if logit_bias and len(logit_bias) > width:
            raise ValueError(f"logit_bias with {len(logit_bias)} entries exceeds the "
                             f"scheduler's per-slot bias width {width}")
        if repetition_penalty is not None and repetition_context_size > self.W:
            # silently shrinking the window would make concurrent output
            # diverge from the serial path for the same request
            raise ValueError(f"repetition_context_size {repetition_context_size} exceeds the "
                             f"scheduler's window {self.W}")
        deadlines = None
        if any(v is not None for v in (ttft_timeout, request_timeout, stall_timeout)):
            deadlines = Deadlines.start(ttft_timeout=ttft_timeout,
                                        request_timeout=request_timeout,
                                        stall_timeout=stall_timeout, clock=self._clock)
        req = _Request(
            prompt=prompt,
            sp=make_sampler_params(temperature, top_p, repetition_penalty, logit_bias,
                                   device="cpu"),
            seed=time.time_ns() & 0x7FFFFFFF if seed is None else int(seed),
            max_tokens=max_tokens,
            rep_context=min(repetition_context_size, self.W),
            want_logprobs=want_logprobs,
            deadlines=deadlines,
            prefill_only=bool(_prefill_only),
            temperature=temperature,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            logit_bias=logit_bias,
        )
        if _resume is not None:
            req.produced, req.history, req.block = produced0, hist, block
            if resume_gen is not None:
                req.resume_gen = torch.as_tensor(resume_gen)
            if resume_recent is not None:
                req.resume_recent = torch.as_tensor(resume_recent)
            with self._admission_lock:
                self.migrations_in += 1
        tr = _trace
        if tr is None:
            tr = tracing.begin()
            req.trace_own = tr is not None
        req.trace = tr
        req.t_submit = time.perf_counter()
        if tr is not None:
            tr.note(prompt_tokens=int(prompt.size), max_tokens=int(max_tokens),
                    prefill_only=bool(_prefill_only), resumed=_resume is not None)
            tr.point("submit")
        self._ensure_running()
        if self.max_queue is None:
            self._submit.put(req)
            return self._consume(req)
        with self._admission_lock:
            # exact across submitters; soft by at most the one request the
            # scheduler thread is moving from the submit queue to the line
            depth = self._submit.qsize() + len(self._waiting)
            bound = self.max_queue
            if self._pressure >= 3:
                # brownout level 3: shed at half the bound, so the queue
                # wait stays short while the fleet is saturated
                bound = max(1, bound // 2)
            if depth >= bound:
                self.shed_queue_full += 1
                if tr is not None:
                    tr.point("shed", depth=depth, bound=bound)
                    if req.trace_own:
                        tracing.finish(tr)
                raise QueueFullError(depth, bound, retry_after_s=estimate_retry_after(
                    max(1, depth - bound + 1), self._finish_times, self._clock()))
            self._submit.put(req)
        return self._consume(req)

    def _consume(self, req: _Request):
        """The request's token stream. Its waits are bounded by its
        deadlines: the TTFT before the first token, the stall watchdog
        between tokens (before the first too, when there is no TTFT
        budget), and the total budget throughout, whichever expires first.
        An expiry cancels the request (the next tick reclaims its slot and
        pages) and raises ``RequestTimeoutError`` at once."""
        dl = req.deadlines
        first = True
        try:
            while True:
                kind, timeout = None, None
                if dl is not None:
                    now = self._clock()
                    cands = []
                    if first and dl.ttft_deadline is not None:
                        cands.append(("ttft", dl.ttft_deadline - now))
                    if dl.total_deadline is not None:
                        cands.append(("total", dl.total_deadline - now))
                    if dl.stall_timeout is not None and (not first or dl.ttft_deadline is None):
                        cands.append(("stall", dl.stall_timeout))
                    if cands:
                        kind, timeout = min(cands, key=lambda t: t[1])
                        timeout = max(0.0, timeout)
                try:
                    item = req.out.get() if timeout is None else req.out.get(timeout=timeout)
                except queue.Empty:
                    req.cancelled = True
                    with self._admission_lock:
                        self.timeouts += 1
                    budget = (dl.stall_timeout if kind == "stall" else
                              (dl.ttft_deadline if kind == "ttft" else dl.total_deadline)
                              - dl.submitted_at)
                    raise RequestTimeoutError(kind, self._clock() - dl.submitted_at,
                                              budget) from None
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                first = False
                yield item
        finally:
            req.cancelled = True  # the scheduler reclaims the slot next tick

    def warm_up(self, blocks=BLOCK_KINDS) -> dict:
        """Capture, before the first request and with every slot idle, the
        prefill chunk of every offset below ``max_seq``, the decode blocks
        of each (sampled, logprobs) kind in ``blocks`` (all four by default;
        a caller that serves fewer kinds names them, and any other is
        captured on first use) and, under speculation, the round of every
        window, greedy and sampled as ``blocks`` has them: the n-gram
        verify, or the draft engine's proposals and the verify, with the
        draft's prefill chunks and its replay of a block. Their warm-ups
        write only the scratch page (or slot). Returns the graphs captured,
        their capture seconds and the pools' bytes (both models' with a
        draft engine); ``{}`` without graphs. Call it before the scheduler
        thread starts. An engine that captures each stage's share of a step
        on its own (its batcher has no graphs) runs the same chunks and
        blocks, so its stage programs are captured here (over several
        processes every rank runs them in lockstep); its stats are the
        engine's."""
        stage_graphs = (self.graphs is None and self.draft is None
                        and getattr(self.engine, "per_stage_graphs", False)
                        and self.engine._graphs_for(self.cache).graphs is not None)
        if stage_graphs:
            eng, c = self.engine, self.engine.prefill_chunk
            eng.prefill_inputs(np.zeros(c, np.int64), self.M, c, self.table)  # row M: scratch
            for off in range(0, eng.max_seq, c):
                eng.prefill_step(self.cache, off)
            for kind in sorted({sampled for sampled, _ in blocks}):
                for want_lp in sorted({lp for sampled, lp in blocks if sampled == kind}):
                    self._run_block(want_lp, kind)
            torch.cuda.synchronize(eng.device)
            return eng._graphs_for(self.cache).stats()
        if self.graphs is None:
            return {}
        engines = [(self.engine, self.cache, self.table, self.graphs)]
        if self.draft is not None:
            engines.append((self.draft, self.dcache, self.dtable, self.dgraphs))
        for eng, cache, table, graphs in engines:
            c = eng.prefill_chunk
            eng.prefill_inputs(np.zeros(c, np.int64), self.M, c, table)  # row M: scratch
            for off in range(0, eng.max_seq, c):
                graphs.run(("prefill", off), functools.partial(eng.prefill_step, cache, off))
        windows = (self.spec_tracker.rungs if self.spec_tracker is not None else
                   (self.spec_k,) if self.draft is not None else ())
        for kind in sorted({sampled for sampled, _ in blocks}):
            for want_lp in sorted({lp for sampled, lp in blocks if sampled == kind}):
                self._run_block(want_lp, kind)
            for k in windows:
                if self.draft is not None:
                    self._run_round(k, np.ones(self.M, np.int32), kind)
                else:
                    self._run_verify(k, np.zeros((k, self.M), np.int32),
                                     np.ones(self.M, np.int32), kind, exact=True)
        if self.draft is not None:
            self._run_replay(np.zeros((self.decode_block, self.M), np.int64))
        torch.cuda.synchronize(self.engine.device)
        graphs = [g for _, _, _, g in engines]
        return {"graphs": sum(g.captures for g in graphs),
                "seconds": sum(g.capture_seconds for g in graphs),
                "pool_bytes": sum(g.pool_bytes() for g in graphs)}

    def tick_timing_stats(self) -> dict:
        """Per-tick timing (JAX ``tick_timing_stats``): ``device_blocked_ms``
        is the harvest's wait on its block's event, ``host_ms`` the rest of
        the tick's wall time. Only ticks that harvested a block count."""
        n = max(1, self._tick_count)
        return {
            "path": "async" if self._async else "sync",
            "host_ms_last": self.tick_host_ms_last,
            "device_blocked_ms_last": self.tick_device_blocked_ms_last,
            "host_ms_avg": 1000.0 * self._tick_host_s_total / n,
            "device_blocked_ms_avg": 1000.0 * self._tick_blocked_s_total / n,
            "ticks": self._tick_count,
            # the resume's import: the host's wait inside import_block, ~0
            # when a prefetch staged the pages, the whole host-to-device
            # copy on a demand import
            "kv_import_ms_last": self.tick_kv_import_ms_last,
            "kv_import_s_total": self._tick_kv_import_s_total,
        }

    def reset_tick_timing(self):
        """Zero the tick-timing accumulators (a benchmark resets them after
        its warm-up request)."""
        self.tick_host_ms_last = 0.0
        self.tick_device_blocked_ms_last = 0.0
        self._tick_host_s_total = 0.0
        self._tick_blocked_s_total = 0.0
        self._tick_count = 0
        self.tick_kv_import_ms_last = 0.0
        self._tick_kv_import_s_total = 0.0

    def page_stats(self) -> Optional[tuple[int, int, int]]:
        """(pool pages, pages in use, high-water mark); pages that only the
        prefix index holds count as in use. None on dense slot caches."""
        if not self.paged:
            return None
        total = self.engine.pool_pages
        return total, total - len(self._free_pages), self.pages_high_water

    def resilience_stats(self) -> dict:
        """The deadline and shedding counters, the queue bound and the
        thread's liveness (JAX ``resilience_stats``, the entries the port
        carries)."""
        live = self.scheduler_thread_live()  # its own lock, taken before ours
        with self._admission_lock:
            return {"timeouts": self.timeouts, "brownout_level": self._pressure,
                    "shed_queue_full": self.shed_queue_full,
                    "shed_deadline": self.shed_deadline, "max_queue": self.max_queue,
                    "scheduler_thread_live": live, "preemptions": self.preemptions,
                    "spills": self.spills, "spill_hits": self.spill_hits,
                    "spill_fallbacks": self.spill_fallbacks,
                    "migrations_out": self.migrations_out,
                    "migrations_in": self.migrations_in,
                    "handoffs_out": self.handoffs_out}

    def stats(self) -> tuple[int, int, int]:
        """(slots, active slots, queued requests). ``_slots`` belongs to the
        scheduler thread: this is a racy snapshot by design (a gauge)."""
        with self._admission_lock:
            queued = self._submit.qsize() + len(self._waiting)
        return self.M, sum(1 for r in self._slots if r is not None), queued

    def set_pressure(self, level: int):
        """The brownout ladder's level from the fleet controller (JAX's):
        level >= 1 pauses prefix-store insertion (hits still serve), >= 2
        sheds speculation (per slot, lowest acceptance first, with a tracker;
        a fixed-K draft engine pauses), 3 sheds it everywhere and halves the
        queue bound. Idempotent; levels outside [0, 3] are clamped."""
        lvl = max(0, min(3, int(level)))
        with self._admission_lock:
            self._pressure = lvl
        store = self.prefix_store
        if store is not None:
            store.pause_inserts(lvl >= 1)

    def _live_locked(self) -> bool:
        """``scheduler_thread_live``'s body; the caller holds ``_start_lock``."""
        if self.thread_wedged:
            return False
        t = self._thread
        return t is None or t.is_alive() or self._stop

    def scheduler_thread_live(self) -> bool:
        """True while the scheduler thread is healthy: running, cleanly
        stopped, or not yet started; False once ``close()`` saw its join
        time out (a tick wedged)."""
        with self._start_lock:
            return self._live_locked()

    def spill_stats(self) -> Optional[dict]:
        """KV spill, migration and prefetch counters and the tier's
        occupancy (JAX ``spill_stats``, the ``mst_kv_spill_*``,
        ``mst_kv_migration_*`` and ``mst_kv_prefetch_*`` families); None on
        dense slot caches. The tier's stats are read before the admission
        lock is taken, so the two locks never nest."""
        if not self.paged:
            return None
        spill = self.spill
        tier = spill.stats() if spill is not None else {}
        with self._admission_lock:
            out = {
                "enabled": spill is not None,
                "spills": self.spills,
                "spill_hits": self.spill_hits,
                "spill_fallbacks": self.spill_fallbacks,
                "migrations_out": self.migrations_out,
                "migrations_in": self.migrations_in,
                "reprefill_tokens": self.reprefill_tokens,
                "preemptions": self.preemptions,
                "cold_spills": self.cold_spills,
                "cold_wakes": self.cold_wakes,
                "parked": len(self._parked),
                "prefetch_enabled": self._prefetch_on,
                "prefetches": self.prefetches,
                "prefetch_hits": self.prefetch_hits,
                "demand_imports": self.demand_imports,
                "prefetch_faults": self.prefetch_faults,
            }
        for key in ("budget_bytes", "bytes_in_use", "blocks", "blocks_host", "evictions",
                    "rejects", "rejects_oversize", "rejects_closed"):
            out[key] = tier.get(key, 0)
        out["tier_hits"] = tier.get("hits", 0)
        out["tier_misses"] = tier.get("misses", 0)
        out["hit_rate"] = tier.get("hit_rate", 0.0)
        return out

    def health(self) -> dict:
        """``/health``'s view: ``status`` ok, draining (closed) or degraded
        (a wedged thread); ``serving`` decides 200 against 503."""
        with self._start_lock:
            live = self._live_locked()
            draining = self._stop or self._migrate_requested
        if not live:
            # a wedged thread beats draining: the operator must see the leak
            return {"status": "degraded", "serving": False, "scheduler_thread_live": False}
        if draining:
            return {"status": "draining", "serving": False, "scheduler_thread_live": live}
        return {"status": "ok", "serving": True, "scheduler_thread_live": live}

    def kv_read_stats(self) -> Optional[tuple[str, int, int]]:
        """(attention path, KV bytes read by the last decode tick, total);
        None on dense slot caches. Analytic: ragged counts the page-rounded
        rows each live slot occupies, gather the whole view of every slot."""
        if not self.paged:
            return None
        return self.kv_path, self.kv_bytes_read_last_tick, self.kv_bytes_read_total

    def hbm_bytes_per_token_stats(self) -> Optional[dict]:
        """{"weights", "kv"}: the bytes a decoded token streamed on the last
        decode tick (the same analytic model); None on dense slot caches."""
        if not self.paged:
            return None
        return {"weights": self.weight_bytes_per_token_last,
                "kv": self.kv_bytes_per_token_last}

    def latency_stats(self) -> dict:
        """The inter-token and queue-wait histograms as
        ``Histogram.to_dict`` snapshots."""
        return {"itl": self._h_itl.to_dict(), "queue_wait": self._h_queue_wait.to_dict()}

    def prefix_stats(self) -> Optional[tuple[int, int, int, int, int]]:
        """(queries, hits, tokens reused, evictions, cached pages); None
        unless the prefix cache is on."""
        if not self.prefix_cache:
            return None
        return (self.prefix_queries, self.prefix_hits, self.prefix_tokens_reused,
                self.prefix_evictions, len(self._prefix_index))

    def spec_stats(self) -> Optional[dict]:
        """Speculation counters (JAX ``spec_stats``); None when the batcher
        never speculates."""
        if self._spec_mode == "off":
            return None
        out = {
            "mode": self._spec_mode,
            "window_max": self._w_max,
            "rounds": self.rounds,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": self.accepted_tokens / max(1, self.draft_tokens),
            "fallback_ticks": self.fallback_ticks,
            "replayed_tokens": self.replayed_tokens,
            "draft_faults": self.spec_draft_faults,
        }
        if self.spec_tracker is not None:
            out.update(self.spec_tracker.stats())
        return out

    def close(self, timeout: float = 10.0):
        """Stop the scheduler thread; every stream still open ends."""
        with self._start_lock:
            self._stop = True
            t = self._thread
        if t is not None:
            if t.is_alive():
                self._submit.put(None)  # wake the idle wait
            t.join(timeout=timeout)
            if t.is_alive():
                # a wedged tick: the daemon thread cannot be reclaimed, so
                # record the leak (/health degraded, the live gauge 0) and
                # keep the victims' timelines past the ring
                with self._start_lock:
                    self.thread_wedged = True
                tracing.auto_snapshot("wedge:scheduler")
                logger.error("scheduler thread failed to exit within %.0fs — a tick is wedged; "
                             "the thread is abandoned and /health reports degraded", timeout)
        if self.spill is not None:
            self.spill.close()
        if self.prefix_store is not None:
            # the pool behind this engine's device entries goes with it; the
            # host tier's blocks stay (they hold their own bytes)
            self.prefix_store.drop_owner(self)
        if self._worker:
            self._worker = False
            close_worker()
        # what the engines hold beyond their tensors: a shared-weight lease
        # drops its ref here (drain, retirement and hot-swap all end here)
        self.engine.close()
        if self.draft is not None:
            self.draft.close()

    @property
    def weights_shared(self) -> bool:
        """Whether the engine aliases a shared resident model (the
        ``mst_replica_weights_shared`` gauge reads it through the replica
        set)."""
        return bool(getattr(self.engine, "weights_shared", False))

    def release_memory(self) -> None:
        """Drop a closed batcher's card memory: its KV pool, its step graphs
        and their memory pool (the draft engine's too). A retired replica
        stays in its replica set's list, so without this each drain would
        leak what it held; the caller then empties the allocator's cache.
        Refuses while the scheduler thread lives (a wedged tick may still
        touch the pool)."""
        with self._start_lock:
            t = self._thread
        if t is not None and t.is_alive():
            raise RuntimeError("release_memory needs a closed batcher whose thread has exited")
        self.graphs = self.dgraphs = None
        self.cache = None
        if self.draft is not None:
            self.dcache = None

    # ------------------------------------------------------------ internals
    def _ensure_running(self):
        with self._start_lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(target=self._loop, name="continuous-batcher",
                                                daemon=True)
                self._thread.start()

    def _pages_needed(self, n_prompt: int, max_tokens: int) -> int:
        return -(-(n_prompt + max_tokens) // self.engine.page_size)

    def _need_pages(self, req: _Request, block=None) -> int:
        """Pages to map at admission: reserve mode claims the whole prompt +
        max_tokens need up front; overcommit only the current need, the
        prompt plus ``_grow_ahead`` tokens (capped by what is left to emit),
        and grows per block in :meth:`_grow_for_decode`. A request resuming
        from a block (``block``, or its entry in the spill tier) sizes from
        the block's KV rows: at least its pages, plus the same headroom."""
        remaining = max(1, req.max_tokens - req.produced)
        if req.prefill_only:
            # it emits one token here before its block leaves for the decode
            # pool: its decode budget would starve this pool's admission
            remaining = 1
        if block is None:
            block = req.block
        if block is None and req.spilled and self.spill is not None:
            block = self.spill.peek(req)
        if block is not None:
            ahead = min(self._grow_ahead, remaining) if self.overcommit else remaining
            return max(block.n_pages, -(-(block.n_tokens + ahead) // self.engine.page_size))
        if self.overcommit:
            return self._pages_needed(req.prompt.size, min(self._grow_ahead, remaining))
        return self._pages_needed(req.prompt.size, remaining)

    def _fits(self, req: _Request) -> bool:
        """The request's pages fit the free and evictable pages, less the
        registered chain it would map; the chain's own pages are not
        eviction fodder. Only a fitting request hands its chain to
        :meth:`_assign_slot` (the same admission pass)."""
        if not self.paged:
            req.chain = None
            return True  # dense slots: a free slot is the whole need
        if req.spilled and (self.spill is None or not self.spill.contains(req)):
            # the tier evicted the block since the spill: the discard path,
            # so the pages below are sized for the folded prompt
            req.spilled = False
            self._fold_history(req)
            with self._admission_lock:
                self.spill_fallbacks += 1
            logger.warning("spilled KV block evicted before its resume; re-prefilling")
        need = self._need_pages(req)
        if req.block is not None or req.spilled:
            # the resume path: refresh a spilled block so budget pressure
            # evicts a colder one; an import takes fresh pages, no chain
            if req.spilled:
                self.spill.touch(req)
            req.chain = None
            return need <= len(self._free_pages) + self._evictable_pages()
        if self.prefix_store is not None:
            # the store's longest-prefix match instead of the slot-local
            # chain: a device hit discounts the pages it leases, a host hit
            # nothing (its import scatters into fresh pages)
            if getattr(self.prefix_store, "federation", None) is not None \
                    and req.podfetch != "done":
                # the pod federation is attached: hold the request until the
                # waiting line's pass has classified it or its fetch landed
                # (the worker flips the flag on every outcome), so the
                # prefix is not prefilled twice; the flag is only read here
                return False
            req.splan = None
            plan = self._store_lookup(req)
            discount = plan[1] if plan is not None and plan[0] == "device" else 0
            ok = need - discount <= len(self._free_pages) + self._evictable_pages()
            if ok and plan is not None:
                req.splan = plan
            return ok
        chain = self._prefix_lookup(req)
        ok = need - len(chain) <= len(self._free_pages) + self._evictable_pages(
            exclude=[p for _, p in chain])
        req.chain = chain if ok else None
        return ok

    # ------------------------------------------------------ prefix sharing
    def _prefix_keys(self, req: _Request) -> list:
        """One rolling key per full prompt page: blake2b over the tokens of
        pages 0..i, chained, so the prompt is hashed once. Memoized on the
        request."""
        if req.pkeys is None:
            page = self.engine.page_size
            h = hashlib.blake2b(digest_size=16)
            keys = []
            for i in range(req.prompt.size // page):
                h.update(req.prompt[i * page : (i + 1) * page].tobytes())
                keys.append(h.digest())
            req.pkeys = keys
        return req.pkeys

    def _prefix_lookup(self, req: _Request) -> list:
        """The longest chain of registered pages [(key, page)] covering a
        page-aligned prefix of the prompt, one token short of the whole
        prompt at most: the last prompt token goes through prefill for the
        logits of the first sample."""
        if not self.prefix_cache:
            return []
        keys = self._prefix_keys(req)
        chain = []
        for i in range((req.prompt.size - 1) // self.engine.page_size):
            p = self._prefix_index.get(keys[i])
            if p is None:
                break
            chain.append((keys[i], p))
        return chain

    def _evictable_pages(self, exclude=()) -> int:
        ex = set(exclude)
        return sum(1 for p in self._prefix_index.values()
                   if self._page_ref.get(p) == 1 and p not in ex)

    def _evict_for(self, n_needed: int):
        """Drop least recently used index entries whose page no slot maps
        until the free list holds ``n_needed`` pages (or nothing is left)."""
        while len(self._free_pages) < n_needed:
            victim = next((k for k, p in self._prefix_index.items()
                           if self._page_ref.get(p) == 1), None)
            if victim is None:
                return
            p = self._prefix_index.pop(victim)
            self._page_ref.pop(p, None)
            self._free_pages.append(p)
            self.prefix_evictions += 1

    def _claim_fresh(self, n: int) -> list:
        """``n`` pages off the free list, each referenced once."""
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._page_ref[p] = 1
        return pages

    def _register_prefix(self, req: _Request):
        """A finished prefill's full prompt pages join the index under
        their keys (decode writes start past them, so they never change
        while registered); a key already there is only touched."""
        pages = self._pages_of.get(req.slot, [])
        for i, key in enumerate(self._prefix_keys(req)):
            if key in self._prefix_index:
                self._prefix_index.move_to_end(key)
                continue
            self._prefix_index[key] = pages[i]
            self._page_ref[pages[i]] = self._page_ref.get(pages[i], 0) + 1

    def _write_table_row(self, slot: int, pages: list):
        """Publish a slot's pages in the host table (the next decode plan
        and prefill upload it); unmapped entries stay at the scratch page."""
        row = np.full((self.engine.slot_pages,), self.engine.pool_pages, np.int32)
        row[: len(pages)] = pages
        self.table[slot] = row
        in_use = self.engine.pool_pages - len(self._free_pages)
        self.pages_high_water = max(self.pages_high_water, in_use)

    def _unref_pages(self, pages):
        """Drop one reference to each page; a page nothing else holds goes
        back to the free list."""
        for p in pages:
            r = self._page_ref.get(p, 1) - 1
            if r <= 0:
                self._page_ref.pop(p, None)
                self._free_pages.append(p)
            else:
                self._page_ref[p] = r

    def _release_pages(self, slot: int):
        """Drop the slot's reference to each of its pages."""
        self._unref_pages(self._pages_of.pop(slot, []))

    # -------------------------------------------------------- prefix store
    def _store_digests(self, req: _Request) -> list:
        """The prompt's chained chunk digests for the store (memoized; reset
        when the prompt folds)."""
        if req.sdigests is None:
            req.sdigests = self.prefix_store.digests_for(req.prompt)
        return req.sdigests

    def _store_lookup(self, req: _Request) -> Optional[tuple]:
        """The store's longest-prefix match for ``req``, safe to poll; a
        ``cache.prefix_lookup`` fault is counted and reads as no hit (plain
        prefill)."""
        digests = self._store_digests(req)
        if not digests:
            return None
        try:
            with tracing.bind(req.trace):  # the store's prefix_lookup span
                return self.prefix_store.lookup(self, digests)
        except Exception as e:  # noqa: BLE001 — a sick store degrades to plain prefill
            # counted; polled each tick while the request waits, so not a warning
            self.prefix_store.count_lookup_fault()
            logger.debug("prefix-store lookup failed (plain prefill): %s", e)
            return None

    def _store_admit(self, req: _Request, plan: tuple, n: int) -> Optional[tuple]:
        """The admission half of a store hit: ``(pages, reused tokens)`` for
        the slot, or None for plain prefill (the plan went stale).

        Device plan: lease the entry's pages copy-on-write (the slot's own
        reference on each, beside the entry's) and take fresh pages for the
        rest; prefill and decode write past the prefix. Host plan: take the
        whole need fresh, import the tier's block into the prefix pages
        (staged by a prefetch, or the counted demand import), and register
        them as a device entry. A failed import keeps the pages and
        prefills from token 0: the stream is exact either way."""
        store = self.prefix_store
        kind, cover = plan
        digests = self._store_digests(req)
        if len(digests) < cover:
            return None  # the prompt changed since the plan
        if kind == "device":
            lease = store.acquire(self, digests, cover)
            if lease is None:
                store.count_lookup("miss", digests)
                return None  # demoted since _fits: plain prefill
            store.count_lookup("device")
            for p in lease.pages:
                self._page_ref[p] += 1
            tail: list = []
            try:
                self._evict_for(n - cover)
                for _ in range(n - cover):
                    tail.append(self._free_pages.pop())
            except BaseException:
                # the headroom _fits saw is gone: give back the pages, the
                # slot's claims and the lease, or the entry never demotes
                self._free_pages.extend(tail)
                for p in lease.pages:
                    self._page_ref[p] -= 1
                lease.release()
                raise
            for p in tail:
                self._page_ref[p] = 1
            req.lease = lease
            return list(lease.pages) + tail, lease.n_tokens
        block = store.host_block(digests[cover - 1])
        if block is None:
            store.count_lookup("miss", digests)
            return None  # evicted since _fits: plain prefill
        store.count_lookup("host")
        self._evict_for(n)
        pages = self._claim_fresh(n)
        page = self.engine.page_size
        try:
            staged = block.is_prefetched
            t0 = time.perf_counter()
            with tracing.bind(req.trace):
                import_block(self.cache, block, pages[:cover], share_hash=self._share_hash,
                             codec=self._kv_codec)
            dt = time.perf_counter() - t0
            self.tick_kv_import_ms_last = dt * 1e3
            self._tick_kv_import_s_total += dt
            tr = req.trace
            if tr is not None:
                tr.add("handoff_import", t0, t0 + dt, kind="prefix_store", pages=cover,
                       staged=staged)
            store.count_import(staged=staged, n_tokens=cover * page)
            with self._admission_lock:
                if staged:
                    self.prefetch_hits += 1
                else:
                    self.demand_imports += 1
        except Exception as e:  # noqa: BLE001 — the pages are the slot's: prefill them all
            store.count_import_fault()
            logger.warning("prefix-store block import failed (re-prefill): %s", e)
            return pages, 0
        block.drop_prefetch()  # the staged copies served their one import
        lease = store.register(self, digests[:cover], pages[:cover],
                               req.prompt[: cover * page], cover * page * self._kv_row_bytes,
                               force=True)
        if lease is not None:
            for p in lease.pages:
                self._page_ref[p] += 1  # the promoted entry's own claim
            req.lease = lease
        return pages, cover * page

    def _store_insert(self, req: _Request):
        """Register a finished prefill's page-aligned prefix in the store
        (its insertion policy decides): bookkeeping only, no device work.
        The request holds the entry's first lease."""
        store = self.prefix_store
        digests = self._store_digests(req)
        if not digests:
            return
        k = len(digests)
        pages = self._pages_of.get(req.slot, [])[:k]
        if len(pages) < k:
            return
        page = self.engine.page_size
        lease = store.register(self, digests, pages, req.prompt[: k * page],
                               k * page * self._kv_row_bytes)
        if lease is None:
            return
        for p in lease.pages:
            self._page_ref[p] += 1  # the entry's own claim on each page
        req.lease = lease

    def _drop_prefix_lease(self, req: _Request):
        """Release ``req``'s lease once; on the entry's last release its
        pages are exported to the host tier and go back to the pool."""
        lease, req.lease = req.lease, None
        if lease is None:
            return
        entry = lease.release()
        if entry is not None:
            self._demote_prefix_entry(entry)

    def _demote_prefix_entry(self, entry):
        """Last-release demotion: export the entry's pages as a pure-prefix
        block (the gather enqueued on the tick's stream; the tier's flusher
        copies it out) under its full-chain digest, then return the pages.
        Skipped when the host tier already holds the digest; a failure
        drops the prefix (re-prefilled on its next use)."""
        store = self.prefix_store
        digest = entry.digests[-1]
        try:
            if not store.host_contains(digest):
                block = export_block(
                    self.cache, entry.pages, page_size=self.engine.page_size,
                    n_tokens=len(entry.pages) * self.engine.page_size, prompt=entry.tokens,
                    history=[], produced=0, resume_gen=None, resume_recent=None,
                    share_hash=self._share_hash, codec=self._kv_codec)
                store.host_put(digest, block)
        except Exception as e:  # noqa: BLE001 — the prefix is dropped, never the stream
            store.count_demote_drop()
            logger.warning("prefix demotion export failed (prefix dropped): %s", e)
        self._unref_pages(entry.pages)

    def _pod_fetch_waiting(self):
        """Consult the pod for head-of-line waiting requests whose prefix
        missed the local store (``pod.PodPrefixFederation``, JAX's): when a
        live peer advertises the digest, a worker thread pulls the owner's
        block into the local host tier while admission holds the request
        on its ``podfetch`` flag. Every failure resolves the flag and the
        request prefills plain. The federation is called from here and the
        worker only, never from the tick's device work."""
        store = self.prefix_store
        fed = getattr(store, "federation", None) if store is not None else None
        if fed is None or not self._waiting:
            return
        for req in self._waiting[:4]:
            if req.cancelled or req.spilled or req.block is not None \
                    or req.podfetch is not None:
                continue
            digests = self._store_digests(req)
            if not digests or self._store_lookup(req) is not None:
                req.podfetch = "done"  # nothing to federate, or a local hit
                continue
            req.podfetch = "pending"
            threading.Thread(target=self._pod_fetch_one, args=(req, digests[-1]),
                             name="mst-pod-prefix-fetch", daemon=True).start()

    def _pod_fetch_one(self, req: _Request, digest: bytes):
        """One waiting request's federated fetch (the federation counts each
        outcome); on success the next store lookup finds the host-tier
        block and admission imports it."""
        try:
            self.prefix_store.federation.fetch(digest)
        except Exception as e:  # noqa: BLE001 — degrade to plain prefill
            logger.debug("pod prefix fetch failed (plain prefill): %s", e)
        req.podfetch = "done"

    def _prefetch_store_waiting(self):
        """Stage the host-tier prefix blocks of requests near the head of
        the waiting line (at most two a tick), so their admission's import
        waits on an event instead of copying."""
        store = self.prefix_store
        if store is None or not self._waiting:
            return
        budget = 2
        for req in self._waiting[:4]:
            if budget == 0:
                break
            if req.cancelled or req.spilled or req.block is not None:
                continue
            plan = self._store_lookup(req)
            if plan is None or plan[0] != "host":
                continue
            block = store.host_block(self._store_digests(req)[plan[1] - 1])
            if block is None or not block.is_host or block.is_prefetched:
                continue
            budget -= 1
            try:
                block.prefetch(device=self._kv_devices, codec=self._kv_codec)
                with self._admission_lock:
                    self.prefetches += 1
            except Exception as e:  # noqa: BLE001 — the demand import still serves it
                with self._admission_lock:
                    self.prefetch_faults += 1
                logger.warning("prefix block prefetch failed (demand import): %s", e)

    def _assign_slot(self, req: _Request, slot: int):
        """Claim ``slot`` and its pages for ``req``: the registered chain
        its prompt starts with (claimed before evicting, so that eviction
        reclaims only other index-only pages) and fresh pages for the rest;
        the offset and the prefill start past the reused prefix; the
        request's sampler row and window size. Its generator and window
        contents are set when its prefill completes."""
        # the queue wait ends here: submission (or re-queue after a
        # preemption) to slot assignment
        now = time.perf_counter()
        if req.t_submit:
            self._h_queue_wait.observe(max(0.0, now - req.t_submit))
        tr = req.trace
        if tr is not None:
            tr.add("queue_wait", req.t_submit or now, now, slot=slot)
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        block = self._take_block(req)
        if block is not None and self._import_block(req, slot, block):
            return
        reused = 0
        if self.paged:
            n = self._need_pages(req)
            if self.prefix_store is not None:
                # one admission is one token of the store's insert budget
                self.prefix_store.note_admission()
                splan, req.splan = req.splan, None
                got = self._store_admit(req, splan, n) if splan else None
                if got is None and splan is None:
                    self.prefix_store.count_lookup("miss", self._store_digests(req) or None)
                if got is not None:
                    # prefill only past the leased (or imported) prefix; as
                    # in JAX, the slot's speculation window is not reset here
                    pages, reused = got
                    self._pages_of[slot] = pages
                    self._write_table_row(slot, pages)
                    self.cache.offsets[slot] = reused
                    self._write_sampler_row(req, slot)
                    self._slots[slot] = req
                    req.slot = slot
                    req.prefill_pos = reused
                    return
            chain = req.chain if req.chain is not None else self._prefix_lookup(req)
            req.chain = None
            reused = len(chain) * self.engine.page_size
            if self.prefix_cache:
                self.prefix_queries += 1
                if chain:
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += reused
                for key, _ in chain:
                    self._prefix_index.move_to_end(key)
            shared = [p for _, p in chain]
            for p in shared:
                self._page_ref[p] += 1
            self._evict_for(n - len(shared))
            pages = shared + self._claim_fresh(n - len(shared))
            self._pages_of[slot] = pages
            self._write_table_row(slot, pages)
        self.cache.offsets[slot] = reused
        if self.draft is not None:
            # the draft mirrors the slot from position 0 (no page sharing)
            self.dcache.offsets[slot] = 0
            req.draft_pos = 0
        self._write_sampler_row(req, slot)
        if self.spec_tracker is not None:
            # new stream in the slot: window back to the probe rung, no
            # carried-over acceptance history from the previous occupant
            self.spec_tracker.reset(slot)
        self._slots[slot] = req
        req.slot = slot
        req.prefill_pos = reused

    def _write_sampler_row(self, req: _Request, slot: int):
        """The request's sampler settings and window size in the slot's
        rows."""
        set_sampler_slot(self.sp, slot, req.sp)
        self.rep_mask[slot] = window_mask(self.W, [req.rep_context], self.rep_mask.device)[0]

    def _take_block(self, req: _Request):
        """The request's pending block: one handed in with a migrated
        request, or its block in the spill tier if it was spilled; one the
        tier evicted since the spill degrades to the discard path here
        (fold and re-prefill, still exact from the stashed sampler state)."""
        if req.block is not None:
            block, req.block = req.block, None
            return block
        if not req.spilled:
            return None
        req.spilled = False
        block = self.spill.take(req) if self.spill is not None else None
        if block is None:
            self._fold_history(req)
            with self._admission_lock:
                self.spill_fallbacks += 1
            logger.warning("spilled KV block evicted before its resume; re-prefilling")
        return block

    def _import_block(self, req: _Request, slot: int, block) -> bool:
        """Admission by import: take the request's pages, scatter the
        block's pages into them (on the tick's stream, before any later
        step reads them), and restore what the block carries, offset,
        generator state, window and last token, so the next decode step
        emits what the uninterrupted run would. Any failure (``cache.import``,
        a corrupt block, the pool short) gives back what was taken, folds
        the history and returns False: the caller re-prefills, and nothing
        reached the consumer."""
        if not self.paged or self.draft is not None:
            self._fold_history(req)
            return False
        page = self.engine.page_size
        pages: list = []
        try:
            if block.page_size != page:
                raise ValueError(f"block page_size {block.page_size} != pool page {page}")
            data_pages = block.n_pages
            need = max(self._need_pages(req, block=block), data_pages)
            self._evict_for(need)
            if len(self._free_pages) < need:
                raise RuntimeError(f"target pool exhausted mid-import: need {need} pages, "
                                   f"{len(self._free_pages)} free")
            pages = self._claim_fresh(need)
            # read before the import consumes the stage: a flushed block with
            # a stage is a prefetch hit, without one a demand import; a block
            # not yet flushed is neither
            was_host, was_staged = block.is_host, block.is_prefetched
            t0 = time.perf_counter()
            with tracing.bind(req.trace):
                import_block(self.cache, block, pages[:data_pages],
                             share_hash=self._share_hash, codec=self._kv_codec)
            dt = time.perf_counter() - t0
            self.tick_kv_import_ms_last = dt * 1e3
            self._tick_kv_import_s_total += dt
            tr = req.trace
            if tr is not None:
                tr.add("handoff_import", t0, t0 + dt, pages=data_pages, staged=was_staged)
            if was_host:
                with self._admission_lock:
                    if was_staged:
                        self.prefetch_hits += 1
                    else:
                        self.demand_imports += 1
        except Exception as e:  # noqa: BLE001 — every failure is the re-prefill fallback
            logger.warning("KV block import failed (re-prefilling): %s", e)
            self._unref_pages(pages)
            self._fold_history(req)
            with self._admission_lock:
                self.spill_fallbacks += 1
            return False
        self._pages_of[slot] = pages
        self._write_table_row(slot, pages)
        self.cache.offsets[slot] = block.n_tokens  # the next step writes row n_tokens
        self._write_sampler_row(req, slot)
        dev = self.recent.device
        self.recent[slot].copy_(block.resume_recent.to(dev, non_blocking=True))
        self.generators[slot].set_state(block.resume_gen)
        self.last_tok[slot, 0] = block.last_tok
        self.active[slot] = True
        req.resume_gen = req.resume_recent = None
        req.history = [int(t) for t in block.history]
        self._slots[slot] = req
        req.slot = slot
        req.prefill_pos = req.draft_pos = req.prompt.size
        with self._admission_lock:
            self.spill_hits += 1
        return True

    def _admit_waiting(self):
        """Shed queued requests whose TTFT budget has gone (their prefill
        would be wasted), then admit. fifo: strict order, a head that does
        not fit holds the line. first_fit: requests that fit pass the ones
        that do not (which keep their place)."""
        if self._waiting:
            now = self._clock()
            for req in [r for r in self._waiting
                        if not r.cancelled and r.produced == 0 and r.deadlines is not None
                        and r.deadlines.ttft_deadline is not None
                        and now > r.deadlines.ttft_deadline]:
                self._waiting.remove(req)
                with self._admission_lock:
                    self.shed_deadline += 1
                req.cancelled = True
                dl = req.deadlines
                req.out.put(RequestTimeoutError("queue", now - dl.submitted_at,
                                                dl.ttft_deadline - dl.submitted_at))
        for req in [r for r in self._waiting if r.cancelled]:
            self._waiting.remove(req)
            self._drop_spill(req)  # its block leaves the tier with the stream
            req.out.put(None)
        while None in self._slots and self._waiting:
            pick = None
            for i, req in enumerate(self._waiting):
                if self._fits(req):
                    pick = i
                    break
                if not req.waited_for_pages:
                    req.waited_for_pages = True
                    self.page_waits += 1
                if self.policy == "fifo":
                    return
            if pick is None:
                return
            self._assign_slot(self._waiting.pop(pick), self._slots.index(None))

    @staticmethod
    def _chunk_at(prompt: np.ndarray, pos: int, c: int):
        """One right-padded prefill chunk at ``pos``: (chunk (c,), n_valid)."""
        chunk = prompt[pos : pos + c]
        n_valid = chunk.size
        if n_valid < c:
            chunk = np.pad(chunk, (0, c - n_valid))
        return chunk, n_valid

    def _prefill_done(self, req: _Request) -> bool:
        """Admission prefill is complete on the target (which may start past
        a reused prefix) and, with a draft engine, on the draft (which
        always starts from 0)."""
        return req.prefill_pos >= req.prompt.size and (
            self.draft is None or req.draft_pos >= req.prompt.size)

    def _first_sample(self, logits: torch.Tensor, slot: int, want_lp: bool = False):
        """The first token of the request in ``slot`` from its prefill
        logits, with the slot's own settings, window and generator, and its
        logprob summary when ``want_lp`` (over several processes sampled on
        the rank that holds the head: the engine's ``shared_sample``)."""
        def run():
            masked = torch.where(self.rep_mask[slot : slot + 1], self.recent[slot : slot + 1],
                                 torch.full_like(self.recent[slot : slot + 1], -1))
            tok, logprobs = sample_token_batched([self.generators[slot]], logits.reshape(1, -1),
                                                 select_rows(self.sp, [slot]), masked,
                                                 sampled=self._slots[slot].sp.temperature > 0)
            return tok, (block_lp_outputs(tok, logprobs) if want_lp else None)

        tok, lp = self.engine.shared_sample(run, 1, want_lp)
        self.recent[slot] = torch.cat([self.recent[slot, 1:], tok])
        return tok, lp

    def _prefill_one_chunk(self, req: _Request):
        """One prefill chunk of a request being admitted (a replay of the
        chunk offset's graph on the card), on the target and, with a draft
        engine, on the draft, each at its own position; when both are done,
        set the slot's generator and window, sample the first token from the
        target's last logits and start the slot decoding."""
        eng, slot, c = self.engine, req.slot, self.engine.prefill_chunk
        tr = req.trace
        t0 = time.perf_counter() if tr is not None else 0.0
        if req.prefill_pos < req.prompt.size:
            chunk, n_valid = self._chunk_at(req.prompt, req.prefill_pos, c)
            logits = eng.prefill_slot(chunk, slot, self.cache, n_valid, self.table,
                                      graphs=self.graphs)
            self.prefill_chunks += 1
            req.prefill_pos += n_valid
            if req.prefill_pos >= req.prompt.size:
                req.last_logits = logits
        if self.draft is not None and req.draft_pos < req.prompt.size:
            chunk, n_valid = self._chunk_at(req.prompt, req.draft_pos, c)
            self.draft.prefill_slot(chunk, slot, self.dcache, n_valid, self.dtable,
                                    graphs=self.dgraphs)
            self.draft_prefill_chunks += 1
            req.draft_pos += n_valid
        if tr is not None:
            tr.add("prefill", t0, time.perf_counter(), slot=req.slot, pos=req.prefill_pos,
                   chunk=c)
        if not self._prefill_done(req):
            return
        logits, req.last_logits = req.last_logits, None
        if self.prefix_cache:
            self._register_prefix(req)
        elif self.prefix_store is not None and req.lease is None:
            # a slot admitted through the store holds its lease already
            self._store_insert(req)
        # Set the window and the generator only NOW: other slots' decode
        # steps ran between this request's chunks and shifted every row of
        # the window, so a row set at assignment would be mangled by now
        if req.resume_gen is not None:
            # a preempted request resumes: the stashed state continues its
            # draws and its window where they stopped, so the token sampled
            # below is the one its uninterrupted run samples next
            self.recent[slot] = req.resume_recent
            self.generators[slot].set_state(req.resume_gen)
            req.resume_gen = req.resume_recent = None
        else:
            row = np.full((self.W,), -1, np.int64)
            tail = req.prompt[-req.rep_context:] if req.rep_context else req.prompt[:0]
            if tail.size:
                row[self.W - tail.size:] = tail
            self.recent[slot] = upload(row, self.recent.device)
            self.generators[slot].manual_seed(req.seed)
        if self.draft is not None:
            # the draft's sampled proposals draw from a stream of their own
            self.dgenerators[slot].manual_seed((req.seed + 1) & 0x7FFFFFFF)
        tok, summary = self._first_sample(logits, slot, req.want_logprobs)
        self.last_tok[slot] = tok
        self.active[slot] = True
        lp = None
        if req.want_logprobs:
            chosen, top_v, top_i = (x.cpu().numpy() for x in summary)
            lp = TokenLogprobs(float(chosen[0]), top_i[0], top_v[0])
        self._emit(req, int(tok[0]), lp)
        if req.prefill_only and req.slot >= 0:
            # the first token is the prefill replica's whole work: park the
            # request; the tick exports its block and frees the slot before
            # the decode dispatch, so the slot never enters a decode block
            self._handoff_ready.append(req)

    def _emit(self, req: _Request, token: int, logprobs):
        now = time.perf_counter()
        if req.produced == 0:
            tr = req.trace
            if tr is not None:
                tr.point("first_token", slot=req.slot)
        elif req.t_last_emit:
            self._h_itl.observe(now - req.t_last_emit)
        req.t_last_emit = now
        req.produced += 1
        req.history.append(token)
        req.out.put((token, logprobs))
        if req.produced >= req.max_tokens:
            self._finish(req)

    def _vacate(self, req: _Request):
        """Take ``req`` out of its slot: the slot stops decoding from the
        next dispatch and its pages go back to the pool at once. Safe while
        a lookahead block still writes them: every later writer of a
        recycled page (another slot's growth for a later block, admission
        prefill, which quiesces first) is enqueued after it on the stream."""
        slot = req.slot
        self.active[slot] = False
        if self.paged:
            self._release_pages(slot)
            # the lease is the store entry's lifetime: its last release
            # exports the prefix (a gather enqueued after every block that
            # could still write a page the slot held)
            self._drop_prefix_lease(req)
        self._slots[slot] = None
        req.slot = -1

    def _finish(self, req: _Request):
        if req.slot >= 0:
            inf = self._inflight
            if self.paged and isinstance(inf, _InflightBlock) and any(
                    s == req.slot and r is req for s, r in inf.live):
                # the lookahead block's dispatch moved the offset one block
                # past the slot's end
                rewind_slot_offset(self.cache, req.slot, self.decode_block)
            self._vacate(req)
        # a completion stamp for the Retry-After estimate; reaped
        # cancellations free queue room all the same
        with self._admission_lock:
            self._finish_times.append(self._clock())
        tr = req.trace
        if tr is not None:
            tr.point("finish", produced=req.produced)
            if req.trace_own:
                # a server-owned timeline is retired by the server after
                # its last write
                tracing.finish(tr)
        req.out.put(None)

    def _reap_cancelled(self):
        for req in list(self._slots):
            if req is not None and req.cancelled:
                self._finish(req)

    # ---------------------------------------------------------- overcommit
    def _fold_history(self, req: _Request):
        """The discard path: the emitted tokens join the prompt, so the
        resume re-prefills them (the slot's KV is gone). Any block the
        request had is given up."""
        req.spilled = False
        req.block = None
        if req.history:
            with self._admission_lock:
                self.reprefill_tokens += req.prompt.size + len(req.history)
            req.prompt = np.concatenate([req.prompt, np.asarray(req.history, np.int64)])
            req.history = []
            req.pkeys = None  # the prompt changed: its keys are stale
            req.sdigests = None  # and so are its store digests
        req.splan = None  # any admission plan predates the fold

    def _spill_block(self, req: _Request) -> bool:
        """Export ``req``'s page chain into the spill tier: a gather enqueued
        on the tick's stream (after every block that wrote those pages),
        the copy to the host left to the tier's flusher thread. False on
        any failure (no tier, the budget, ``cache.export``): the caller
        takes the discard path."""
        if self.spill is None or not req.history:
            return False
        page = self.engine.page_size
        # valid rows: the last emitted token's K/V is not written yet (it is
        # last_tok, the next step's input)
        n_tokens = req.prompt.size + max(0, len(req.history) - 1)
        n_pages = -(-max(1, n_tokens) // page)
        pages = self._pages_of.get(req.slot, [])[:n_pages]
        ok = False
        try:
            if len(pages) != n_pages:
                raise RuntimeError(f"slot holds {len(pages)} of its {n_pages} pages")
            block = export_block(
                self.cache, pages, page_size=page, n_tokens=n_tokens, prompt=req.prompt,
                history=req.history, produced=req.produced, resume_gen=req.resume_gen,
                resume_recent=req.resume_recent, share_hash=self._share_hash,
                codec=self._kv_codec)
            ok = self.spill.put(req, block)
            if not ok:
                logger.warning("the spill tier refused slot %d's block (budget); "
                               "re-prefilling", req.slot)
        except Exception as e:  # noqa: BLE001 — the discard path still serves it
            logger.warning("KV spill export failed for slot %d (re-prefilling): %s", req.slot, e)
        req.spilled = ok
        with self._admission_lock:
            if ok:
                self.spills += 1
            else:
                self.spill_fallbacks += 1
        return ok

    def _suspend_slot(self, req: _Request):
        """Vacate ``req``'s slot, keeping what an exact resume needs. A
        request that decodes stashes its generator's state and its window
        row (a device copy; this runs only quiesced, so the row holds
        exactly the emitted tokens) and exports its pages to the spill tier
        when there is one, or else folds its tokens into its prompt;
        mid-prefill there is nothing to keep and its prefill restarts.
        Preemption and cold-slot spill share it; the caller decides where
        the request goes."""
        slot = req.slot
        tr = req.trace
        t0 = time.perf_counter() if tr is not None else 0.0
        if self._prefill_done(req):
            req.resume_gen = self.generators[slot].get_state()
            req.resume_recent = self.recent[slot].clone()
            with tracing.bind(tr):  # the export's kv_export span
                if not self._spill_block(req):
                    self._fold_history(req)
        req.chain = None
        req.splan = None
        req.prefill_pos = req.draft_pos = 0
        req.last_logits = None
        self._vacate(req)
        if tr is not None:
            tr.add("spill", t0, time.perf_counter(), slot=slot, spilled=req.spilled)

    def _preempt(self, req: _Request):
        """Evict an admitted request to the head of the waiting line (pool
        exhaustion under overcommit). Preemption goes newest first, so
        repeated inserts at 0 keep the victims in admission order."""
        with self._admission_lock:
            self.preemptions += 1
        req.preempted_at.append(req.produced)
        tr = req.trace
        if tr is not None:
            tr.point("preempt", slot=req.slot)
        self._suspend_slot(req)
        # back on the line: the queue-wait clock restarts
        req.t_submit = time.perf_counter()
        self._waiting.insert(0, req)

    # ------------------------------------------------------ KV residency
    def _cold_candidates(self) -> list:
        """Decoding slots whose consumer stopped reading: ``produced -
        out.qsize()`` is what it consumed, and a slot with a backlog whose
        count has not moved for ``spill_cold_after`` scans is cold. Host
        bookkeeping only."""
        if self.spill_cold_after is None or self.spill is None:
            return []
        cold = []
        for req in self._slots:
            if req is None or req.cancelled or req.prefill_only:
                continue
            if not self._prefill_done(req) or not req.history:
                continue
            backlog = req.out.qsize()
            consumed = req.produced - backlog
            if backlog > 0 and consumed == req.consumed_seen:
                req.cold_ticks += 1
            else:
                req.cold_ticks = 0
            req.consumed_seen = consumed
            if req.cold_ticks >= self.spill_cold_after:
                cold.append(req)
        return cold

    def _spill_cold(self, cold: list):
        """Suspend cold slots and park them off the waiting line: they hold
        no pages and do not count against admission until their consumer
        catches up (:meth:`_wake_parked`). The async caller quiesces
        first."""
        for req in cold:
            if req.slot < 0:
                # the quiesce's harvest finished it after the scan
                continue
            with self._admission_lock:
                self.cold_spills += 1
            tr = req.trace
            if tr is not None:
                tr.point("cold_spill", slot=req.slot)
            self._suspend_slot(req)
            req.cold_ticks = 0
            self._parked.append(req)

    def _wake_parked(self):
        """Re-queue, at the head of the waiting line, the parked requests
        whose consumer caught up (backlog drained), starting their block's
        prefetch; reap the cancelled ones."""
        if not self._parked:
            return
        keep, woken = [], []
        for req in self._parked:
            if req.cancelled:
                self._drop_spill(req)
                req.out.put(None)
                continue
            (woken if req.out.qsize() == 0 else keep).append(req)
        self._parked = keep
        if not woken:
            return
        now = time.perf_counter()
        for req in woken:
            req.cold_ticks = 0
            req.t_submit = now  # back on the line: the queue wait restarts
            tr = req.trace
            if tr is not None:
                tr.point("wake")
            self._prefetch_block(req)
            with self._admission_lock:
                self.cold_wakes += 1
        self._waiting[:0] = woken

    def _prefetch_block(self, req: _Request):
        """Stage ``req``'s spilled block on the card ahead of its import
        (:meth:`KVPageBlock.prefetch`: a copy on a side stream, nothing
        waited on). A block not yet flushed needs none. A
        ``cache.prefetch`` fault is counted: the import takes the demand
        path."""
        if not self._prefetch_on or self.spill is None or not req.spilled:
            return
        block = self.spill.peek(req)
        if block is None:
            return
        self.spill.touch(req)  # about to be imported: keep it from the LRU
        if not block.is_host or block.is_prefetched:
            return
        try:
            tr = req.trace
            t0 = time.perf_counter() if tr is not None else 0.0
            block.prefetch(device=self._kv_devices, codec=self._kv_codec)
            if tr is not None:
                tr.add("prefetch", t0, time.perf_counter(), pages=block.n_pages)
            with self._admission_lock:
                self.prefetches += 1
        except Exception as e:  # noqa: BLE001 — the demand import still serves it
            with self._admission_lock:
                self.prefetch_faults += 1
            logger.warning("KV prefetch failed (demand import): %s", e)

    def _prefetch_waiting(self):
        """Stage the blocks of spilled requests near the head of the waiting
        line (at most two a tick), then the prefix store's host blocks."""
        if self._prefetch_on and self.spill is not None:
            budget = 2
            for req in self._waiting[:4]:
                if budget == 0:
                    break
                if req.spilled and not req.cancelled:
                    self._prefetch_block(req)
                    budget -= 1
        self._pod_fetch_waiting()
        self._prefetch_store_waiting()

    def _drop_spill(self, req: _Request):
        req.spilled = False
        if self.spill is not None:
            self.spill.drop(req)

    # ------------------------------------------------------------ migration
    def stage_resume(self, state) -> bool:
        """Stage an incoming resume block on the card before its request is
        submitted (``generate_step(..., _resume=state)``): the copy runs on a
        side stream while the tick's work goes on, and the admission's
        import waits on its event. True when a stage was enqueued; a failure
        is counted and leaves the demand import."""
        block = getattr(state, "block", None)
        if block is None or not getattr(block, "is_host", False) or block.is_prefetched:
            return False
        try:
            block.prefetch(device=self._kv_devices, codec=self._kv_codec)
            with self._admission_lock:
                self.prefetches += 1
            return True
        except Exception as e:  # noqa: BLE001 — the demand import still serves it
            with self._admission_lock:
                self.prefetch_faults += 1
            logger.warning("resume block prefetch failed (demand import): %s", e)
            return False

    def migrate_out(self, deadline: float = 30.0) -> int:
        """Evacuate every request (a replica drain): the scheduler thread
        quiesces at its next tick and ends each stream with a
        ``RequestMigratedError`` carrying a :class:`ResumeState`, with the
        request's pages exported into a host block when the export works,
        or its prompt and history for an exact re-prefill elsewhere. New
        submissions raise ``ReplicaDrainingError`` from now on; the flag is
        permanent (retirement), so the caller closes the batcher after.
        Returns the requests migrated before ``deadline`` (seconds on the
        batcher's clock)."""
        with self._admission_lock:
            base = self.migrations_out
        with self._start_lock:
            self._migrate_requested = True
            t = self._thread
        if t is None or not t.is_alive():
            # never started or already stopped: nothing admitted to migrate
            return 0
        self._submit.put(None)  # wake the idle wait
        t0 = self._clock()
        while self._clock() - t0 < deadline:
            if not t.is_alive():
                break
            with self._admission_lock:
                queued = self._submit.qsize() + len(self._waiting)
            if queued == 0 and not any(r is not None for r in self._slots):
                break
            time.sleep(0.01)
        with self._admission_lock:
            return self.migrations_out - base

    def _migrate_all_out(self):
        """The scheduler thread's half of :meth:`migrate_out`, quiesced (no
        block in flight), so each slot's generator state and window hold
        exactly its emitted tokens: every admitted request's state is
        exported and its slot freed, then every waiting or parked one's
        (its spilled block, if any, travels). A teardown, not a tick: the
        copies to the host here are synchronous."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if req.cancelled:
                self._vacate(req)
                self._drop_spill(req)
                req.out.put(None)
                continue
            tr = req.trace
            t0 = time.perf_counter()
            with tracing.bind(tr):
                state = self._export_resume_state(req, slot)
            if tr is not None:
                tr.add("migration", t0, time.perf_counter(), slot=slot,
                       block=state.block is not None)
            self._vacate(req)
            req.out.put(RequestMigratedError(state))
            with self._admission_lock:
                self.migrations_out += 1
        self._drain_submissions()
        for req in self._waiting + self._parked:
            if req.cancelled:
                self._drop_spill(req)
                req.out.put(None)
                continue
            tr = req.trace
            t0 = time.perf_counter()
            with tracing.bind(tr):
                state = self._export_resume_state(req, -1)
            if tr is not None:
                tr.add("migration", t0, time.perf_counter(), queued=True)
            req.out.put(RequestMigratedError(state))
            with self._admission_lock:
                self.migrations_out += 1
        self._waiting.clear()
        self._parked.clear()

    def _export_resume_state(self, req: _Request, slot: int, *, host: bool = True,
                             recent: Optional[torch.Tensor] = None) -> ResumeState:
        """A request's portable :class:`ResumeState`. A decoding request in
        ``slot`` gets its generator state and window (``recent``: the row
        already on the host) captured and its page chain exported; a
        waiting one that was spilled hands over its tier block. With
        ``host`` the block is moved to the host (any stage on this card
        dropped first), since it must outlive the engine; without, it holds
        the gather's device tensors and the consumer copies it (the disagg
        handoff). Any failure (a ``cache.export`` fault, the pages short,
        the copy) is counted and degrades to a blockless state: the target
        folds the history and re-prefills, exact all the same, since the
        sampler state travels."""
        if slot >= 0 and self._prefill_done(req):
            req.resume_gen = self.generators[slot].get_state()
            req.resume_recent = self.recent[slot].cpu() if recent is None else recent
        block, req.block = req.block, None  # one a previous migration brought
        if block is None and req.spilled:
            req.spilled = False
            block = self.spill.take(req) if self.spill is not None else None
        if (block is None and slot >= 0 and self.paged and self.draft is None
                and self._prefill_done(req) and req.history):
            page = self.engine.page_size
            # the last emitted token's K/V is not written yet: it is the
            # next step's input
            n_tokens = req.prompt.size + max(0, len(req.history) - 1)
            n_pages = -(-max(1, n_tokens) // page)
            pages = self._pages_of.get(slot, [])[:n_pages]
            try:
                if len(pages) != n_pages:
                    raise RuntimeError(f"slot holds {len(pages)} of its {n_pages} pages")
                block = export_block(
                    self.cache, pages, page_size=page, n_tokens=n_tokens, prompt=req.prompt,
                    history=req.history, produced=req.produced, resume_gen=req.resume_gen,
                    resume_recent=req.resume_recent, share_hash=self._share_hash,
                    codec=self._kv_codec)
            except Exception as e:  # noqa: BLE001 — the blockless state still resumes
                block = None
                with self._admission_lock:
                    self.spill_fallbacks += 1
                logger.warning("KV export failed for slot %d (the target re-prefills): %s",
                               slot, e)
        if block is not None and host:
            try:
                block.drop_prefetch()  # a stage holds this card's memory
                block.to_host()
            except Exception as e:  # noqa: BLE001 — the blockless state still resumes
                block = None
                with self._admission_lock:
                    self.spill_fallbacks += 1
                logger.warning("drain host copy failed for slot %d (re-prefill there): %s",
                               slot, e)
        return ResumeState(
            prompt=np.asarray(req.prompt, np.int64),
            history=[int(t) for t in req.history],
            produced=req.produced,
            block=block,
            resume_keys=req.resume_gen,
            resume_recent=req.resume_recent,
        )

    def _handoff_out(self):
        """End this tick's prefill-only requests (JAX ``_handoff_out``):
        export each parked request's page chain (a gather on the tick's
        stream, no copy to the host: the disagg coordinator makes it on the
        request's consumer thread, so this replica's next ticks run under
        it), free its slot and pages, and end its stream with a
        ``HandoffReadyError`` carrying the :class:`ResumeState`. Runs after
        the prefill section and before the decode dispatch, with nothing in
        flight (the tick quiesced for the prefill), so a released slot is
        inactive in the next decode block's upload. The parked slots' window
        rows come to the host in one copy; a generator's state is host
        memory already."""
        ready, self._handoff_ready = self._handoff_ready, []
        live = [r for r in ready if r.slot >= 0]
        rows = {}
        keep = [r.slot for r in live if not r.cancelled]
        if keep:
            host = self.recent[keep].cpu()
            rows = {slot: host[i] for i, slot in enumerate(keep)}
        for req in live:
            if req.cancelled:
                self._finish(req)
                continue
            slot = req.slot
            tr = req.trace
            t0 = time.perf_counter() if tr is not None else 0.0
            with tracing.bind(tr):
                state = self._export_resume_state(req, slot, host=False, recent=rows[slot])
            if tr is not None:
                # the disagg handoff's first part, on the prefill replica;
                # the coordinator records the transfer
                tr.add("handoff_export", t0, time.perf_counter(), slot=slot)
            # the pages go back to the pool now: their next writer (an
            # admission's prefill) is enqueued after the gather on this stream
            self._vacate(req)
            req.out.put(HandoffReadyError(state))
            with self._admission_lock:
                self.handoffs_out += 1
                self._finish_times.append(self._clock())

    def _growth_want(self, req: _Request) -> int:
        """Pages ``req`` needs mapped before the next block: its next write
        (prompt + emitted - 1; the first sampled token writes no KV yet)
        plus ``_grow_ahead``, capped by the most it can ever touch."""
        emitted = len(req.history)
        offset = req.prompt.size + max(0, emitted - 1)
        cap = self._pages_needed(req.prompt.size, emitted + (req.max_tokens - req.produced))
        return min(-(-(offset + self._grow_ahead) // self.engine.page_size), cap)

    def _grow_for_decode(self):
        """Before a decode block, map every decoding slot's pages for the
        block's writes, oldest request first; on pool exhaustion preempt the
        newest-admitted request. The oldest is never preempted, and a lone
        request's whole need fits the pool (``generate_step``), so progress
        is guaranteed; the last request left fails loudly rather than wedge
        against the scratch page."""
        decoding = sorted(((slot, req) for slot, req in enumerate(self._slots)
                           if req is not None and self._prefill_done(req)),
                          key=lambda t: t[1].admit_seq)
        for slot, req in decoding:
            while self._slots[slot] is req:  # a victim skips its own growth
                n_more = self._growth_want(req) - len(self._pages_of.get(slot, ()))
                if n_more <= 0:
                    break
                self._evict_for(n_more)
                if len(self._free_pages) >= n_more:
                    pages = self._pages_of[slot]
                    pages.extend(self._claim_fresh(n_more))
                    self._write_table_row(slot, pages)
                    break
                victims = [r for r in self._slots if r is not None]
                if len(victims) <= 1:
                    req.out.put(RuntimeError(
                        f"KV page pool exhausted: slot {slot} needs {n_more} more page(s) for "
                        f"its next decode block but only {len(self._free_pages)} are free and "
                        "no other request remains to preempt"))
                    self._finish(req)
                    break
                self._preempt(max(victims, key=lambda r: r.admit_seq))

    def _growth_fits(self) -> bool:
        """True iff the next :meth:`_grow_for_decode` covers every decoding
        slot from the free and evictable pages alone, so that it cannot
        preempt. The
        emitted counts are one block stale under async ticks, which the
        doubled ``_grow_ahead`` covers."""
        if not self.overcommit:
            return True
        need = sum(max(0, self._growth_want(req) - len(self._pages_of.get(slot, ())))
                   for slot, req in enumerate(self._slots)
                   if req is not None and self._prefill_done(req))
        return need <= len(self._free_pages) + self._evictable_pages()

    # --------------------------------------------------------- speculation
    def _spec_ok(self) -> bool:
        """A tick can take the speculative round iff no decoding slot wants
        logprob summaries (the verify does not compute them) and every
        decoding slot has window-max rows of KV headroom: the verify writes
        up to that many positions, and a write past the capacity would
        fail on the card. Ticks that fail the check run a plain decode
        block."""
        if self._pressure >= 2 and self.spec_tracker is None:
            # fixed-K draft engine: brownout level 2 pauses speculation (with
            # a tracker the shed is per slot, in effective_windows)
            return False
        k = (2 if self._async else 1) * self._w_max
        for req in self._slots:
            if req is None or not self._prefill_done(req):
                continue
            if req.want_logprobs:
                return False
            # history counts tokens since the last prompt fold, so prompt +
            # history is the slot's true KV frontier even after a resume
            if req.prompt.size + max(0, len(req.history) - 1) + k > self.engine.max_seq:
                return False
        return True

    def _spec_draft_ok(self) -> bool:
        """The ``spec.draft`` fault site, before each speculative round's
        proposals: a fault makes that tick a plain block, counted, and no
        stream changes (a draft engine replays the block as usual)."""
        try:
            inject("spec.draft", engine=id(self))
        except Exception:  # noqa: BLE001 — any fault degrades the one round
            self.spec_draft_faults += 1
            return False
        return True

    def _spec_plan(self, live):
        """``(K, wins)``: the round's width (the widest live window) and
        each live slot's window from its controller (``spec_k`` for every
        slot of a draft engine without one), or None when no slot
        speculates (the tick runs a plain block)."""
        if self.spec_tracker is None:
            return self.spec_k, {slot: self.spec_k for slot, _ in live}
        wins = self.spec_tracker.effective_windows([slot for slot, _ in live], self._pressure)
        k = max(wins.values(), default=0)
        if k < 2:
            return None
        return k, wins

    def _device_plan(self, inputs, steps: int):
        """The plan of ``steps`` positions from the slot offsets: the
        host's when ``inputs.reset`` says they are exact, else the device's
        own. Returns the plan and the offsets it starts from."""
        off = torch.where(inputs.reset.bool(), inputs.offsets.long(), self._dev_off)
        return self.engine.device_plan(off, inputs, steps), off

    def _verify_step(self, k: int, inputs, sampled: bool) -> torch.Tensor:
        """One verify of every slot from ``last_tok``, planned on the
        device, carries and the device offsets (by each slot's count)
        updated in place; its ``(count, gs)`` as one (K + 1, M) tensor.
        Device work only."""
        plan, off = self._device_plan(inputs, k)
        gs, count, nxt = self.engine.spec_verify_ngram_cb(k)(
            self.last_tok, self.cache, plan, inputs.drafts, inputs.wcap, recent=self.recent,
            generators=self.generators, sp=self.sp, rep_mask=self.rep_mask, sampled=sampled)
        self.last_tok.copy_(nxt)
        self._dev_off.copy_(off + count)
        return torch.cat([count[None], gs])

    def _run_verify(self, k: int, drafts: np.ndarray, wcaps: np.ndarray, sampled: bool, *,
                    exact: bool) -> torch.Tensor:
        """Upload the round's inputs in one copy (``exact``: no speculative
        round is in flight, so the host's offsets are exact) and enqueue the
        verify (a replay of the graph of (K, sampler branch) on the card);
        its static output, nothing read back."""
        inputs = self.engine.device_inputs(("verify", k), self.table, self.active,
                                           self.cache.offsets, exact, drafts, wcaps)
        step = functools.partial(self._verify_step, k, inputs, sampled)
        if self.graphs is None:
            return step()
        return self.graphs.run(("verify", k, sampled), step,
                               state=(self.last_tok, self.recent, self._dev_off),
                               generators=self.generators if sampled else ())

    def _propose_step(self, k: int, inputs, sampled: bool):
        """The draft engine's K proposal steps for every slot from
        ``last_tok`` (the target's next inputs), planned on the device from
        the draft's offsets, which then move by K for every active slot; the
        drafts (K, M) and, ``sampled``, their distributions (K, M, V), else
        None. Device work only."""
        d = self.draft
        off = torch.where(inputs.reset.bool(), inputs.offsets.long(), self._ddev_off)
        drafts, qlps = d.spec_propose_cb(k)(
            self.last_tok, self.dcache, d.device_plan(off, inputs, k), recent=self.recent,
            generators=self.dgenerators, sp=self.sp, rep_mask=self.rep_mask, sampled=sampled)
        self._ddev_off.copy_(off + k * inputs.active)
        return drafts, qlps

    def _round_step(self, k: int, proposals, inputs, sampled: bool) -> torch.Tensor:
        """The target's verify of the draft engine's ``proposals`` (the
        propose graph's outputs), then the draft's rewind on the device: it
        consumed K rows a slot and keeps the ``count`` the target accepted.
        Its ``(count, gs)`` as one (K + 1, M) tensor. Device work only."""
        plan, off = self._device_plan(inputs, k)
        drafts, qlps = proposals
        gs, count, nxt = self.engine.spec_verify_cb(k)(
            self.last_tok, self.cache, plan, drafts, inputs.wcap, qlps=qlps, recent=self.recent,
            generators=self.generators, sp=self.sp, rep_mask=self.rep_mask, sampled=sampled)
        self.last_tok.copy_(nxt)
        self._dev_off.copy_(off + count)
        self._ddev_off.add_(torch.where(inputs.active.bool(), count - k, 0))
        return torch.cat([count[None], gs])

    def _run_round(self, k: int, wcaps: np.ndarray, sampled: bool) -> torch.Tensor:
        """Enqueue one draft-engine round: the draft's K steps (a replay of
        its graph of (K, sampler branch)) and the target's verify with the
        draft's distributions (one graph per (K, sampler branch)), each from
        its host offsets, exact under the sync ticks a draft engine runs.
        Its static ``(count, gs)``, nothing read back."""
        d = self.draft
        dinputs = d.device_inputs(("propose", k), self.dtable, self.active, self.dcache.offsets,
                                  True)
        step = functools.partial(self._propose_step, k, dinputs, sampled)
        proposals = step() if self.dgraphs is None else self.dgraphs.run(
            ("propose", k, sampled), step, state=(self._ddev_off,),
            generators=self.dgenerators if sampled else ())
        inputs = self.engine.device_inputs(("verify", k), self.table, self.active,
                                           self.cache.offsets, True, np.zeros((k, self.M)),
                                           wcaps)
        step = functools.partial(self._round_step, k, proposals, inputs, sampled)
        if self.graphs is None:
            return step()
        return self.graphs.run(("verify", k, sampled), step,
                               state=(self.last_tok, self.recent, self._dev_off, self._ddev_off),
                               generators=self.generators if sampled else ())

    def _replay_step(self, inputs) -> None:
        """The draft engine's replay of a plain block's chain (the inputs'
        drafts), planned from its offsets, which then move by the block.
        Device work only."""
        d, k = self.draft, self.decode_block
        off = torch.where(inputs.reset.bool(), inputs.offsets.long(), self._ddev_off)
        d.spec_replay_cb(k)(inputs.drafts, self.dcache, d.device_plan(off, inputs, k))
        self._ddev_off.copy_(off + k * inputs.active)

    def _run_replay(self, chain: np.ndarray) -> None:
        """Feed ``chain`` (K, M), the tokens a plain block consumed, through
        the draft's caches (a replay of its graph on the card) and move the
        draft's host offsets with them."""
        inputs = self.draft.device_inputs(("replay", self.decode_block), self.dtable,
                                          self.active, self.dcache.offsets, True, chain,
                                          np.ones(self.M))
        step = functools.partial(self._replay_step, inputs)
        if self.dgraphs is None:
            step()
        else:
            self.dgraphs.run(("replay", self.decode_block), step, state=(self._ddev_off,))
        self.draft.advance_offsets(self.dcache, self.active, self.decode_block)

    def _dispatch_spec(self, prev=None) -> Optional[_InflightSpec]:
        """Grow the pool under overcommit, then enqueue one speculative round
        for every decoding slot: n-gram proposals up to each slot's window
        and one T=K verify with per-slot caps. A slot whose window is 0
        rides along with a cap of 1 and emits its correction token only.
        ``prev``: the work in flight (async ticks), not yet harvested: the
        host's history lags it, so a round in flight lends its drafts as the
        history's guess, and the offsets come from the device. Returns the
        round's handle without waiting, or None when no slot speculates
        (the caller runs a plain block)."""
        if self.overcommit:
            self._grow_for_decode()
        live = [(slot, req) for slot, req in enumerate(self._slots)
                if req is not None and self._prefill_done(req)]
        if not live:
            return None
        plan = self._spec_plan(live)
        if plan is None:
            return None
        k, wins = plan
        t0 = time.perf_counter()
        # the T=K verify reads each slot's gathered view, whatever the
        # decode tick's path (JAX's accounting)
        self._account_kv_read(live, 1, path="gather")
        sampled = any(req.sp.temperature > 0 for _, req in live)
        wcaps = np.ones((self.M,), np.int32)
        guess = {}
        if self.draft is not None:
            for slot, _ in live:
                wcaps[slot] = max(1, wins.get(slot, 0))
            outs = self._run_round(k, wcaps, sampled)
            return self._inflight_spec(outs, t0, live, wins, wcaps, guess)
        prev_guess = prev.guess if isinstance(prev, _InflightSpec) else {}
        drafts = np.zeros((k, self.M), np.int32)
        for slot, req in live:
            w = wins.get(slot, 0)
            if w < 2:
                continue
            toks = np.concatenate([req.prompt, np.asarray(req.history, np.int64),
                                   prev_guess.get(slot, np.zeros(0, np.int64))])
            d, n_valid = self._ngram.propose(toks, w)
            drafts[:w, slot] = d
            wcaps[slot] = min(w, max(1, n_valid))
            guess[slot] = d[: wcaps[slot]]
        outs = self._run_verify(k, drafts, wcaps, sampled,
                               exact=not isinstance(prev, _InflightSpec))
        return self._inflight_spec(outs, t0, live, wins, wcaps, guess)

    def _inflight_spec(self, outs, t0: float, live, wins, wcaps, guess) -> _InflightSpec:
        """Start the copy of a dispatched round's ``(count, gs)`` to pinned
        host memory with an event after it; the round's handle."""
        event = None
        if outs.is_cuda:
            host = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
            host.copy_(outs, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            outs = host
        self.verify_ticks += 1
        self.decode_seconds += time.perf_counter() - t0
        return _InflightSpec(outs=outs, event=event, live=live, wins=wins, wcaps=wcaps,
                             guess=guess)

    def _harvest_spec(self, inf: Optional[_InflightSpec]):
        """Wait for a round's ``(count, gs)`` (its one read), move each
        slot's host offset by its count, emit each slot's accepted prefix
        and correction token, and train each speculating slot's window on
        the verify's verdict."""
        if inf is None:
            return
        t0 = time.perf_counter()
        if inf.event is not None:
            inf.event.synchronize()
        blocked = time.perf_counter() - t0
        self.tick_device_blocked_ms_last = blocked * 1000.0
        self._tick_blocked_s_total += blocked
        self._tick_count += 1
        outs = inf.outs.numpy()
        counts, gs = outs[0], outs[1:]
        self.rounds += len(inf.live)
        for _, r in inf.live:
            rtr = r.trace
            if rtr is not None:
                rtr.add("spec_round", t0, t0 + blocked, slot=r.slot, window=gs.shape[0])
        for slot, req in inf.live:
            if req.slot == slot:
                self.cache.offsets[slot] += int(counts[slot])
                if self.draft is not None:
                    # the draft took K rows and kept the accepted ones
                    self.dcache.offsets[slot] += int(counts[slot])
        for slot, req in inf.live:
            emitted = 0
            for j in range(int(counts[slot])):
                if req.slot != slot:
                    break  # finished (max_tokens) earlier in this round
                self._emit(req, int(gs[j, slot]), None)
                emitted += 1
            w = inf.wins.get(slot, 0)
            if w >= 2:
                # count what reached the consumer; a disabled slot's
                # correction token is plain decode, not an acceptance
                self.accepted_tokens += emitted
                self.draft_tokens += int(inf.wcaps[slot])
                if self.spec_tracker is not None and req.slot == slot:
                    # train on the verify's verdict, not the truncated emission
                    self.spec_tracker.observe(slot, w, int(counts[slot]))
        self.decode_seconds += time.perf_counter() - t0

    def _spec_tick(self) -> bool:
        """Make this tick a speculative round if it can; False means the
        caller runs a plain decode block (speculation off, gated by
        :meth:`_spec_ok` or faulted at ``spec.draft``, or no slot speculates
        this round)."""
        if self._spec_mode == "off" or not (self._spec_ok() and self._spec_draft_ok()):
            return False
        inf = self._dispatch_spec()
        if inf is None:
            return False
        self._harvest_spec(inf)
        return True

    # -------------------------------------------------------------- decode
    def _decode_steps(self, inputs, want_lp: bool, sampled: bool) -> torch.Tensor:
        """``decode_block`` steps from ``last_tok`` over a plan made on the
        device from the slot offsets (:meth:`_device_plan`), carries and the
        device offsets (by the block's steps for every active slot) updated
        in place; their stacked outputs. Device work only."""
        plan, off = self._device_plan(inputs, self.decode_block)
        eng, tok, outs = self.engine, self.last_tok, []
        for j in range(self.decode_block):
            tok, lp = eng.decode_cb(
                tok, self.cache, plan, j, recent=self.recent, generators=self.generators,
                sp=self.sp, rep_mask=self.rep_mask, sampled=sampled, want_lp=want_lp,
            )
            if want_lp:
                chosen, top_v, top_i = lp
                outs.append(torch.cat([tok.double(), chosen[:, None].double(),
                                       top_v.double(), top_i.double()], dim=1))
            else:
                outs.append(tok)
        self.last_tok.copy_(tok)
        self._dev_off.copy_(off + self.decode_block * inputs.active)
        return torch.stack(outs)

    def _run_block(self, want_lp: bool, sampled: bool, exact: bool = True) -> torch.Tensor:
        """Upload the block's inputs and enqueue it (a replay on the card);
        its stacked outputs (on the card, the graph's static outputs, which
        its next replay overwrites), nothing read back. ``exact``: the
        host's offsets are exact (no speculative round is in flight), so
        the block takes them.

        The inputs go into the persistent buffer that the block in flight
        (async ticks) also reads: their upload is enqueued after that
        block's replay on the same stream, so it cannot land before the
        block has run. Keep every block, upload and prefill on one
        stream."""
        k = self.decode_block
        inputs = self.engine.device_inputs(("decode", k), self.table, self.active,
                                           self.cache.offsets, exact)
        step = functools.partial(self._decode_steps, inputs, want_lp, sampled)
        if self.graphs is None:
            return step()
        return self.graphs.run(("decode", k, want_lp, sampled), step,
                               state=(self.last_tok, self.recent, self._dev_off),
                               generators=self.generators if sampled else ())

    def _dispatch_block(self, prev=None) -> Optional[_InflightBlock]:
        """Grow the pool under overcommit, enqueue one decode block over
        every decoding slot, advance their host offsets, and start the copy
        of its outputs to pinned host memory with an event after it:
        nothing waits for the card here. The active set is frozen for the
        block (a slot that finishes mid-block keeps computing; its extra
        tokens land in its own pages or the scratch page and are dropped at
        the harvest). ``prev``: the work in flight (async ticks)."""
        if self.overcommit:
            self._grow_for_decode()
        live = [(slot, req) for slot, req in enumerate(self._slots)
                if req is not None and self._prefill_done(req)]
        if not live:
            return None
        t0 = time.perf_counter()
        want_lp = any(req.want_logprobs for _, req in live)
        sampled = any(req.sp.temperature > 0 for _, req in live)
        prev_tok = None
        if self.draft is not None:
            # the block's first inputs: a draft engine replays the chain the
            # block consumes (copied before the block overwrites them)
            prev_tok = torch.empty(self.last_tok.shape, dtype=self.last_tok.dtype,
                                   pin_memory=self.last_tok.is_cuda)
            prev_tok.copy_(self.last_tok, non_blocking=True)
        # analytic gauge; under async ticks the lengths are a block stale
        self._account_kv_read(live, self.decode_block)
        exact = not isinstance(prev, _InflightSpec)
        if self._trace_profile:
            # --trace-profile: the block's launches inside one profiler range
            with tracing.profile_span("mst.decode_block"):
                outs = self._run_block(want_lp, sampled, exact=exact)
        else:
            outs = self._run_block(want_lp, sampled, exact=exact)
        event = None
        if outs.is_cuda:
            # copied before the next replay overwrites the static outputs
            host = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
            host.copy_(outs, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            outs = host
        self.engine.advance_offsets(self.cache, self.active, self.decode_block)
        self.decode_steps += self.decode_block
        self.decode_seconds += time.perf_counter() - t0
        return _InflightBlock(outs=outs, event=event, live=live, want_lp=want_lp,
                              prev_tok=prev_tok)

    def _account_kv_read(self, live, steps: int, path: Optional[str] = None):
        """The analytic KV bytes a dispatch reads (JAX ``_account_kv_read``):
        ragged, each live slot's page-rounded rows; gather, every slot's
        whole view; and the weight and KV bytes a decoded token streams.
        Host arithmetic only."""
        if not self.paged or not live:
            return
        page = self.engine.page_size
        if (path or self.kv_path) == "ragged":
            rows = sum(-(-(req.prompt.size + max(0, req.produced - 1) + 1) // page) * page
                       for _, req in live)
        else:
            rows = len(live) * self.engine.slot_pages * page
        b = rows * self._kv_row_bytes * steps
        self.kv_bytes_read_last_tick = b
        self.kv_bytes_read_total += b
        # weights stream once a step whatever the slots; KV does not amortize
        self.kv_bytes_per_token_last = b / (len(live) * steps)
        self.weight_bytes_per_token_last = self.engine.weight_stream_bytes / len(live)

    def _harvest(self, inf: Optional[_InflightBlock]):
        """Wait for a block's outputs to land on the host (its event only:
        a block dispatched after it keeps running) and emit them per slot;
        tokens of a slot that finished earlier in the block, or under the
        lookahead, are dropped."""
        if inf is None:
            return
        t0 = time.perf_counter()
        if inf.event is not None:
            inf.event.synchronize()
        blocked = time.perf_counter() - t0
        self.tick_device_blocked_ms_last = blocked * 1000.0
        self._tick_blocked_s_total += blocked
        self._tick_count += 1
        # each traced request's span reuses the harvest's own stamps
        for _, r in inf.live:
            rtr = r.trace
            if rtr is not None:
                rtr.add("decode_tick", t0, t0 + blocked, slot=r.slot, block=self.decode_block)
        outs = inf.outs.numpy()
        toks = outs[..., 0].astype(np.int64)  # (K, M)
        lp_outs = None
        if inf.want_lp:
            k = LOGPROB_TOPK
            lp_outs = (toks, outs[..., 1], outs[..., 2 : 2 + k], outs[..., 2 + k :].astype(np.int64))
        if self.draft is not None and inf.live:
            # a tick that fell back to a plain block: the target took K
            # positions, so the draft takes the chain they consumed (step j
            # consumed toks[j - 1], step 0 prev_tok), or its later proposals
            # attend to stale rows and acceptance collapses
            chain = np.concatenate([inf.prev_tok.numpy().reshape(1, -1), toks[:-1]])
            self._run_replay(chain)
            self.fallback_ticks += 1
            self.replayed_tokens += self.decode_block * len(inf.live)
        for j in range(toks.shape[0]):
            for slot, req in inf.live:
                if req.slot != slot:  # finished (or preempted) earlier
                    continue
                lp = None
                if inf.want_lp and req.want_logprobs:
                    lp = block_token_logprobs(lp_outs, j, slot)
                self._emit(req, int(toks[j, slot]), lp)
        self.decode_seconds += time.perf_counter() - t0

    def _harvest_any(self, inf):
        """Harvest whichever work ``inf`` is: a decode block or, under
        speculation, a round."""
        if isinstance(inf, _InflightSpec):
            self._harvest_spec(inf)
        else:
            self._harvest(inf)

    def _quiesce(self):
        """Harvest the work in flight, if any, so that every consequence of
        it (tokens, finishes, freed pages, the carries) has landed."""
        inf, self._inflight = self._inflight, None
        self._harvest_any(inf)

    # --------------------------------------------------------------- ticks
    def _drain_submissions(self, block: bool = False):
        try:
            while True:
                req = self._submit.get(timeout=0.2) if block else self._submit.get_nowait()
                block = False
                if req is not None:
                    self._waiting.append(req)
        except queue.Empty:
            pass

    def _decoding(self) -> bool:
        return any(r is not None and self._prefill_done(r) for r in self._slots)

    def _prefilling(self) -> list:
        return [r for r in self._slots if r is not None and not self._prefill_done(r)]

    def _admit_and_prefill(self):
        """Admit, then prefill: one chunk while anything decodes (round
        robin over the admitting requests), every admitting request's next
        chunk otherwise."""
        self._admit_waiting()
        prefilling = self._prefilling()
        if prefilling:
            if self._decoding():
                self._prefill_rr += 1
                self._prefill_one_chunk(prefilling[self._prefill_rr % len(prefilling)])
            else:
                for req in prefilling:
                    self._prefill_one_chunk(req)

    def _idle_wait(self):
        """Nothing to run: wait (bounded, so parked requests still get their
        wake poll) for the next request."""
        self._drain_submissions(block=True)
        self._wake_parked()
        self._admit_waiting()

    def _residency(self):
        """The KV residency passes of a tick: spill the cold slots (the async
        caller quiesces first: suspension reads sampler state and rewrites
        page tables), wake the parked requests whose consumer caught up,
        and stage the blocks of requests about to be admitted."""
        cold = self._cold_candidates()
        if cold:
            self._quiesce()
            self._spill_cold(cold)
        self._wake_parked()
        self._prefetch_waiting()

    def _tick(self):
        """Sync tick: reap, the residency passes, admit, prefill, then one
        speculative round (:meth:`_spec_tick`) or one decode block over
        every decoding slot, dispatched and harvested."""
        if self._migrate_requested:
            self._migrate_all_out()
            self._drain_submissions(block=True)
            return
        self._reap_cancelled()
        self._drain_submissions()
        self._residency()
        self._admit_and_prefill()
        if self._handoff_ready:
            self._handoff_out()  # prefill-only completions leave before the block
        if self._decoding():
            if not self._spec_tick():
                self._decode_once()
        elif not any(self._slots):
            self._idle_wait()

    def _decode_once(self):
        """One decode block, dispatched and harvested: the sync tick's
        composition point (JAX's), which the multi-host batcher overrides to
        broadcast the op first."""
        self._harvest(self._dispatch_block())

    def _tick_async(self):
        """Async tick: dispatch decode block (or speculative round) t+1
        before harvesting block t, so the harvest waits only on work that
        ran while the host did the rest of its tick. Admission prefill (it
        samples on the host and rewrites slot state), growth that could
        preempt (it reads sampler state), idling and a drain quiesce
        first."""
        if self._migrate_requested:
            # a drain: the block in flight lands, then every stream ends with
            # its ResumeState; the idle wait keeps the loop from spinning
            self._quiesce()
            self._migrate_all_out()
            self._drain_submissions(block=True)
            return
        self._reap_cancelled()
        self._drain_submissions()
        self._residency()
        if (self._waiting and None in self._slots) or self._prefilling():
            self._quiesce()
        self._admit_and_prefill()
        if self._handoff_ready:
            # prefill-only completions leave before the dispatch (nothing is
            # in flight: the prefill above quiesced)
            self._handoff_out()
        if self._decoding():
            if not self._growth_fits():
                self._quiesce()
            prev, self._inflight = self._inflight, None
            nxt = None
            if self._spec_mode == "ngram" and self._spec_ok() and self._spec_draft_ok():
                nxt = self._dispatch_spec(prev)
            self._inflight = nxt if nxt is not None else self._dispatch_block(prev)
            self._harvest_any(prev)
        else:
            self._quiesce()  # a lookahead block of slots that have finished
            if not any(self._slots):
                self._idle_wait()

    def _end_all(self, item):
        """End every stream, in a slot, waiting, parked or still submitted,
        with ``item``: the error of a failed tick, or None at shutdown. A
        slot's prefix lease is released without a demotion (its pool is
        reset or going away with the batcher)."""
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._slots[slot] = None
                req.slot = -1
                lease, req.lease = req.lease, None
                if lease is not None:
                    lease.release()
                req.out.put(item)
        self.active = [False] * self.M
        for req in self._waiting + self._parked:
            req.out.put(item)
        self._waiting.clear()
        self._parked.clear()
        while True:
            try:
                req = self._submit.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.out.put(item)

    def _fail_all(self, exc: BaseException):
        """A failed tick ends every stream with the error and resets the
        pool wholesale: its contents are no longer trusted. The block in
        flight is dropped unread."""
        logger.exception("scheduler tick failed", exc_info=exc)
        # an incident: keep the streams' timelines past the ring
        tracing.auto_snapshot("scheduler_fail")
        self._inflight = None
        if self.prefix_store is not None:
            # the entries of this pool point at pages the reset frees: the
            # slots' leases become orphans whose release is a no-op
            self.prefix_store.drop_owner(self)
        self._end_all(exc)
        if self.spill is not None:
            self.spill.clear()  # the spilled requests' streams just ended
        if self.paged:
            self._pages_of.clear()
            self._page_ref.clear()
            self._prefix_index.clear()
            self._free_pages = list(range(self.engine.pool_pages - 1, -1, -1))

    def run_tick(self):
        """One tick (async or sync as resolved), timed: a tick that
        harvested a block adds its host time (its wall time less the
        harvest's wait) to the tick timing. The scheduler thread loops on
        it; a caller that drives the batcher on its own thread may too."""
        t0, b0, c0 = time.perf_counter(), self._tick_blocked_s_total, self._tick_count
        (self._tick_async if self._async else self._tick)()
        if self._tick_count > c0:
            host = max(0.0, time.perf_counter() - t0 - (self._tick_blocked_s_total - b0))
            self.tick_host_ms_last = host * 1000.0
            self._tick_host_s_total += host

    def _loop(self):
        with torch.no_grad():
            while not self._stop:
                try:
                    self.run_tick()
                except Exception as exc:  # noqa: BLE001 — a dead scheduler would hang every consumer
                    self._fail_all(exc)
            try:
                self._quiesce()  # the lookahead block lands before the streams end
            except Exception as exc:  # noqa: BLE001
                self._fail_all(exc)
        self._end_all(None)  # graceful shutdown
