"""Continuous batching over the paged KV pool (port of the single-host,
non-speculative subset of ``mlx_sharding_tpu/scheduler.py::ContinuousBatcher``).

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
  where it stopped (the JAX package's discard path; the spill tier comes
  with KV movement).
- While anything decodes, one prefill chunk runs per tick, round-robin
  over the admitting requests; with nothing decoding they all advance.
- A decode block reads the card once: right after its dispatch its outputs
  are copied to pinned host memory and an event is recorded, and the
  harvest waits on that event alone. On a CUDA device the block's K steps
  are one captured CUDA graph per (K, logprobs, sampler branch), JAX's
  ``decode_block_prog``, and each prefill chunk one graph per chunk offset
  (``PipelineEngine.prefill_step``), JAX's ``prefill_slot``.

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

Not yet ported, and refused at construction: prefix sharing, KV spill and
prefetch, speculation, the queue bound, the prefix store; deadlines,
tracing and metrics are not carried.
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.cache import rewind_slot_offset
from mlx_sharding_tpu_torch.generate import (
    LOGPROB_TOPK,
    TokenLogprobs,
    block_lp_outputs,
    block_token_logprobs,
)
from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.graphs import StepGraphs, model_pool
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

logger = logging.getLogger(__name__)


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


@dataclass
class _InflightBlock:
    """A dispatched decode block: its stacked outputs on their way to the
    host, the event that says they landed (None on the CPU), and the slots
    it ran for."""

    outs: torch.Tensor  # (K, M, 1) tokens, or (K, M, 2 + 2·LOGPROB_TOPK) float64
    event: Optional[torch.cuda.Event]
    live: list  # [(slot, req)] at dispatch
    want_lp: bool


class ContinuousBatcher:
    """Drives a :class:`PipelineEngine` (``microbatches=M``, paged) as an
    M-slot continuous-batching server backend. ``generate_step`` has the
    contract of ``Generator.generate_step``; the server calls it without
    its generation lock (``concurrent = True``). ``cuda_graphs=False`` runs
    the prefill chunks and decode blocks eagerly on the card (for checks
    and measurements)."""

    concurrent = True

    def __init__(self, engine, *, repetition_window: int = 64, decode_block: int = 8,
                 policy: str = "fifo", prefix_cache: bool = False, overcommit: bool = False,
                 draft_engine=None, spec_k: int = 4, draft: str = "auto",
                 spec_window_max: Optional[int] = None, max_queue: Optional[int] = None,
                 async_sched: str = "auto", spill_bytes: Optional[int] = None,
                 spill_cold_after: Optional[int] = None, kv_prefetch: str = "auto",
                 prefix_store=None, cuda_graphs: bool = True):
        if policy not in ("fifo", "first_fit"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if async_sched not in ("on", "off", "auto"):
            raise ValueError(f"async_sched must be 'on', 'off' or 'auto', got {async_sched!r}")
        if draft not in ("auto", "off", "ngram", "engine"):
            raise ValueError(f"draft must be 'auto', 'off', 'ngram' or 'engine', got {draft!r}")
        if kv_prefetch not in ("on", "off", "auto"):
            raise ValueError(f"kv_prefetch must be 'on', 'off' or 'auto', got {kv_prefetch!r}")
        # each names the ROADMAP queue 1 item that ports it
        unported = {
            "prefix_cache (prefix sharing over the pool)": (prefix_cache, "slice 3, item 3"),
            "draft_engine / draft / spec_k / spec_window_max (speculation)": (
                draft_engine is not None or draft not in ("auto", "off") or spec_k != 4
                or spec_window_max is not None, "slice 4"),
            "spill_bytes / spill_cold_after / kv_prefetch (KV spill)": (
                spill_bytes is not None or spill_cold_after is not None or kv_prefetch == "on",
                "slice 3, item 4, after slice 7's kv_transfer.py"),
            "max_queue (the queue bound)": (max_queue is not None, "slice 3, item 7"),
            "prefix_store (the fleet prefix store)": (prefix_store is not None, "slice 7"),
        }
        for what, (asked, item) in unported.items():
            if asked:
                raise NotImplementedError(f"ContinuousBatcher {what} is not yet ported "
                                          f"(ROADMAP queue 1, {item})")
        if overcommit and getattr(engine, "pool_pages", None) is None:
            raise ValueError("overcommit admission requires a paged engine (pool_pages)")
        # async ticks: "auto" resolves as the JAX rule does; with no draft
        # engine and one host, plain decode is a pure device-side chain
        self.async_sched = async_sched
        self._async = async_sched != "off"
        self.async_reason = (
            "async ticks: async_sched='on'" if async_sched == "on" else
            "sync ticks: async_sched='off'" if async_sched == "off" else
            "async ticks: auto resolved to async — plain single-host decode is a pure "
            "device-side chain"
        )
        logger.info("%s", self.async_reason)
        self.engine = engine
        self.M = engine.microbatches
        self.W = repetition_window
        self.policy = policy
        self.overcommit = overcommit
        self.decode_block = max(1, decode_block)
        # overcommit growth covers the furthest write ahead of the host's
        # emitted counts: one block, two when a block runs ahead of them
        self._grow_ahead = (2 if self._async else 1) * self.decode_block
        self._waiting: list[_Request] = []
        self._submit: queue.Queue = queue.Queue()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        # the decode block dispatched and not yet harvested (async ticks)
        self._inflight: Optional[_InflightBlock] = None

        # the pool: a request holds pages from admission until it finishes
        # (or is preempted)
        self.cache, self.table = engine.init_cache_paged()
        self._free_pages = list(range(engine.pool_pages - 1, -1, -1))
        self._pages_of: dict[int, list[int]] = {}
        self.pages_high_water = 0

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
        self.graphs = (StepGraphs(dev, model_pool(engine.model))
                       if dev.type == "cuda" and cuda_graphs else None)

        self._slots: list[Optional[_Request]] = [None] * self.M
        self._prefill_rr = 0  # round-robin cursor for admission fairness
        self._admit_counter = 0
        # counters of the work the batcher ran (the smoke checks launch
        # counts against them)
        self.prefill_chunks = 0
        self.decode_steps = 0
        # host clock inside the blocks' dispatches and harvests (a quiesce's
        # harvest included)
        self.decode_seconds = 0.0
        self.page_waits = 0  # requests that found a free slot but not enough pages
        self.preemptions = 0
        self.reprefill_tokens = 0  # prompt + history tokens of preempted requests
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
    ):
        """Validate and enqueue at once (every rejection raises on the
        calling thread, before any request state exists); returns the
        token stream ``(token, TokenLogprobs or None)``."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        total = prompt.size + max_tokens
        if total > self.engine.max_seq:
            raise ValueError(f"prompt ({prompt.size}) + max_tokens ({max_tokens}) exceeds KV "
                             f"capacity {self.engine.max_seq}")
        # the request's whole need must fit the pool alone: an overcommitted
        # request that is the only one left can then always grow to its end
        need = -(-total // self.engine.page_size)
        if need > self.engine.pool_pages:
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
        req = _Request(
            prompt=prompt,
            sp=make_sampler_params(temperature, top_p, repetition_penalty, logit_bias,
                                   device="cpu"),
            seed=time.time_ns() & 0x7FFFFFFF if seed is None else int(seed),
            max_tokens=max_tokens,
            rep_context=min(repetition_context_size, self.W),
            want_logprobs=want_logprobs,
        )
        self._ensure_running()
        self._submit.put(req)
        return self._consume(req)

    def _consume(self, req: _Request):
        try:
            while True:
                item = req.out.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            req.cancelled = True  # the scheduler reclaims the slot next tick

    def warm_up(self) -> dict:
        """Capture, before the first request and with every slot idle, the
        prefill chunk of every offset below ``max_seq`` and the decode
        blocks (greedy and sampled, with and without logprobs), into the
        model's graph pool: their warm-ups write only the scratch page.
        Returns the graphs captured, their capture seconds and the pool's
        bytes; ``{}`` without graphs. Call it before the scheduler thread
        starts."""
        if self.graphs is None:
            return {}
        eng, c = self.engine, self.engine.prefill_chunk
        eng.prefill_inputs(np.zeros(c, np.int64), self.M, c, self.table)  # row M: scratch
        for off in range(0, eng.max_seq, c):
            self.graphs.run(("prefill", off), functools.partial(eng.prefill_step, self.cache, off))
        for sampled in (False, True):
            for want_lp in (False, True):
                self._run_block(want_lp, sampled)
        torch.cuda.synchronize(eng.device)
        return {"graphs": self.graphs.captures, "seconds": self.graphs.capture_seconds,
                "pool_bytes": self.graphs.pool_bytes()}

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
        }

    def reset_tick_timing(self):
        """Zero the tick-timing accumulators (a benchmark resets them after
        its warm-up request)."""
        self.tick_host_ms_last = 0.0
        self.tick_device_blocked_ms_last = 0.0
        self._tick_host_s_total = 0.0
        self._tick_blocked_s_total = 0.0
        self._tick_count = 0

    def page_stats(self) -> tuple[int, int, int]:
        """(pool pages, pages in use, high-water mark)."""
        total = self.engine.pool_pages
        return total, total - len(self._free_pages), self.pages_high_water

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
                logger.error("scheduler thread failed to exit within %.0fs", timeout)

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

    def _need_pages(self, req: _Request) -> int:
        """Pages to map at admission: reserve mode claims the whole prompt +
        max_tokens need up front; overcommit only the current need, the
        prompt plus ``_grow_ahead`` tokens (capped by what is left to emit),
        and grows per block in :meth:`_grow_for_decode`."""
        remaining = max(1, req.max_tokens - req.produced)
        if self.overcommit:
            return self._pages_needed(req.prompt.size, min(self._grow_ahead, remaining))
        return self._pages_needed(req.prompt.size, remaining)

    def _fits(self, req: _Request) -> bool:
        return self._need_pages(req) <= len(self._free_pages)

    def _write_table_row(self, slot: int, pages: list):
        """Publish a slot's pages in the host table (the next decode plan
        and prefill upload it); unmapped entries stay at the scratch page."""
        row = np.full((self.engine.slot_pages,), self.engine.pool_pages, np.int32)
        row[: len(pages)] = pages
        self.table[slot] = row
        in_use = self.engine.pool_pages - len(self._free_pages)
        self.pages_high_water = max(self.pages_high_water, in_use)

    def _release_pages(self, slot: int):
        self._free_pages.extend(self._pages_of.pop(slot, []))

    def _assign_slot(self, req: _Request, slot: int):
        """Claim ``slot`` and its pages for ``req``: offset 0, the request's
        sampler row and window size. Its generator and window contents are
        set when its prefill completes."""
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        pages = [self._free_pages.pop() for _ in range(self._need_pages(req))]
        self._pages_of[slot] = pages
        self._write_table_row(slot, pages)
        self.cache.offsets[slot] = 0
        set_sampler_slot(self.sp, slot, req.sp)
        self.rep_mask[slot] = window_mask(self.W, [req.rep_context], self.rep_mask.device)[0]
        self._slots[slot] = req
        req.slot = slot
        req.prefill_pos = 0

    def _admit_waiting(self):
        """fifo: strict order, a head that does not fit holds the line.
        first_fit: requests that fit pass the ones that do not (which keep
        their place)."""
        for req in [r for r in self._waiting if r.cancelled]:
            self._waiting.remove(req)
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
        return req.prefill_pos >= req.prompt.size

    def _first_sample(self, logits: torch.Tensor, slot: int):
        """The first token of the request in ``slot`` from its prefill
        logits, with the slot's own settings, window and generator."""
        masked = torch.where(self.rep_mask[slot : slot + 1], self.recent[slot : slot + 1],
                             torch.full_like(self.recent[slot : slot + 1], -1))
        tok, logprobs = sample_token_batched([self.generators[slot]], logits.reshape(1, -1),
                                             select_rows(self.sp, [slot]), masked,
                                             sampled=self._slots[slot].sp.temperature > 0)
        self.recent[slot] = torch.cat([self.recent[slot, 1:], tok])
        return tok, logprobs

    def _prefill_one_chunk(self, req: _Request):
        """One prefill chunk of a request being admitted (a replay of the
        chunk offset's graph on the card); on its last chunk, set the
        slot's generator and window, sample the first token and start the
        slot decoding."""
        eng, slot = self.engine, req.slot
        chunk, n_valid = self._chunk_at(req.prompt, req.prefill_pos, eng.prefill_chunk)
        logits = eng.prefill_slot(chunk, slot, self.cache, n_valid, self.table,
                                  graphs=self.graphs)
        self.prefill_chunks += 1
        req.prefill_pos += n_valid
        if not self._prefill_done(req):
            return
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
        tok, logprobs = self._first_sample(logits, slot)
        self.last_tok[slot] = tok
        self.active[slot] = True
        lp = None
        if req.want_logprobs:
            chosen, top_v, top_i = (x.cpu().numpy() for x in block_lp_outputs(tok, logprobs))
            lp = TokenLogprobs(float(chosen[0]), top_i[0], top_v[0])
        self._emit(req, int(tok[0]), lp)

    def _emit(self, req: _Request, token: int, logprobs):
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
        self._release_pages(slot)
        self._slots[slot] = None
        req.slot = -1

    def _finish(self, req: _Request):
        if req.slot >= 0:
            inf = self._inflight
            if inf is not None and any(s == req.slot and r is req for s, r in inf.live):
                # the lookahead block's dispatch moved the offset one block
                # past the slot's end
                rewind_slot_offset(self.cache, req.slot, self.decode_block)
            self._vacate(req)
        req.out.put(None)

    def _reap_cancelled(self):
        for req in list(self._slots):
            if req is not None and req.cancelled:
                self._finish(req)

    # ---------------------------------------------------------- overcommit
    def _fold_history(self, req: _Request):
        """The discard path: the emitted tokens join the prompt, so the
        resume re-prefills them (the slot's KV is gone)."""
        if req.history:
            self.reprefill_tokens += req.prompt.size + len(req.history)
            req.prompt = np.concatenate([req.prompt, np.asarray(req.history, np.int64)])
            req.history = []

    def _suspend_slot(self, req: _Request):
        """Vacate ``req``'s slot, keeping what an exact resume needs. A
        request that decodes stashes its generator's state and its window
        row (a device copy; this runs only quiesced, so the row holds
        exactly the emitted tokens) and folds its tokens into its prompt;
        mid-prefill there is nothing to keep and its prefill restarts."""
        slot = req.slot
        if self._prefill_done(req):
            req.resume_gen = self.generators[slot].get_state()
            req.resume_recent = self.recent[slot].clone()
            self._fold_history(req)
        req.prefill_pos = 0
        self._vacate(req)

    def _preempt(self, req: _Request):
        """Evict an admitted request to the head of the waiting line (pool
        exhaustion under overcommit). Preemption goes newest first, so
        repeated inserts at 0 keep the victims in admission order."""
        self.preemptions += 1
        req.preempted_at.append(req.produced)
        self._suspend_slot(req)
        self._waiting.insert(0, req)

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
                if len(self._free_pages) >= n_more:
                    pages = self._pages_of[slot]
                    pages.extend(self._free_pages.pop() for _ in range(n_more))
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
        slot from the free pages alone, so that it cannot preempt. The
        emitted counts are one block stale under async ticks, which the
        doubled ``_grow_ahead`` covers."""
        if not self.overcommit:
            return True
        need = sum(max(0, self._growth_want(req) - len(self._pages_of.get(slot, ())))
                   for slot, req in enumerate(self._slots)
                   if req is not None and self._prefill_done(req))
        return need <= len(self._free_pages)

    # -------------------------------------------------------------- decode
    def _decode_steps(self, plan, want_lp: bool, sampled: bool) -> torch.Tensor:
        """``decode_block`` steps over ``plan`` (the engine's persistent plan
        of that many steps) from ``last_tok``, carries updated in place;
        their stacked outputs. Device work only."""
        eng, tok, outs = self.engine, self.last_tok, []
        for j in range(self.decode_block):
            tok, logprobs = eng.decode_cb(
                tok, self.cache, plan, j, recent=self.recent, generators=self.generators,
                sp=self.sp, rep_mask=self.rep_mask, sampled=sampled,
            )
            if want_lp:
                chosen, top_v, top_i = block_lp_outputs(tok[:, 0], logprobs)
                outs.append(torch.cat([tok.double(), chosen[:, None].double(),
                                       top_v.double(), top_i.double()], dim=1))
            else:
                outs.append(tok)
        self.last_tok.copy_(tok)
        return torch.stack(outs)

    def _run_block(self, want_lp: bool, sampled: bool) -> torch.Tensor:
        """Plan and enqueue one block (a replay on the card); its stacked
        outputs (on the card, the graph's static outputs, which its next
        replay overwrites), nothing read back.

        The plan goes into the persistent buffer that the block in flight
        (async ticks) also reads: its upload is enqueued after that block's
        replay on the same stream, so it cannot land before the block has
        run. Keep every block, plan upload and prefill on one stream."""
        k = self.decode_block
        plan = self.engine.decode_plan(self.cache, self.table, self.active, k)
        step = functools.partial(self._decode_steps, plan, want_lp, sampled)
        if self.graphs is None:
            return step()
        return self.graphs.run(("decode", k, want_lp, sampled), step,
                               state=(self.last_tok, self.recent),
                               generators=self.generators if sampled else ())

    def _dispatch_block(self) -> Optional[_InflightBlock]:
        """Grow the pool under overcommit, enqueue one decode block over
        every decoding slot, advance their host offsets, and start the copy
        of its outputs to pinned host memory with an event after it:
        nothing waits for the card here. The active set is frozen for the
        block (a slot that finishes mid-block keeps computing; its extra
        tokens land in its own pages or the scratch page and are dropped at
        the harvest)."""
        if self.overcommit:
            self._grow_for_decode()
        live = [(slot, req) for slot, req in enumerate(self._slots)
                if req is not None and self._prefill_done(req)]
        if not live:
            return None
        t0 = time.perf_counter()
        want_lp = any(req.want_logprobs for _, req in live)
        sampled = any(req.sp.temperature > 0 for _, req in live)
        outs = self._run_block(want_lp, sampled)
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
        return _InflightBlock(outs=outs, event=event, live=live, want_lp=want_lp)

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
        outs = inf.outs.numpy()
        toks = outs[..., 0].astype(np.int64)  # (K, M)
        lp_outs = None
        if inf.want_lp:
            k = LOGPROB_TOPK
            lp_outs = (toks, outs[..., 1], outs[..., 2 : 2 + k], outs[..., 2 + k :].astype(np.int64))
        for j in range(toks.shape[0]):
            for slot, req in inf.live:
                if req.slot != slot:  # finished (or preempted) earlier
                    continue
                lp = None
                if inf.want_lp and req.want_logprobs:
                    lp = block_token_logprobs(lp_outs, j, slot)
                self._emit(req, int(toks[j, slot]), lp)
        self.decode_seconds += time.perf_counter() - t0

    def _quiesce(self):
        """Harvest the block in flight, if any, so that every consequence of
        it (tokens, finishes, freed pages, the carries) has landed."""
        inf, self._inflight = self._inflight, None
        self._harvest(inf)

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
        """Nothing to run: wait (bounded) for the next request."""
        self._drain_submissions(block=True)
        self._admit_waiting()

    def _tick(self):
        """Sync tick: reap, admit, prefill, then one decode block over every
        decoding slot, dispatched and harvested."""
        self._reap_cancelled()
        self._drain_submissions()
        self._admit_and_prefill()
        if self._decoding():
            self._harvest(self._dispatch_block())
        elif not any(self._slots):
            self._idle_wait()

    def _tick_async(self):
        """Async tick: dispatch decode block t+1 before harvesting block t,
        so the harvest waits only on a block that ran while the host did
        the rest of its tick. Admission prefill (it samples on the host and
        rewrites slot state), growth that could preempt (it reads sampler
        state) and idling quiesce first."""
        self._reap_cancelled()
        self._drain_submissions()
        if (self._waiting and None in self._slots) or self._prefilling():
            self._quiesce()
        self._admit_and_prefill()
        if self._decoding():
            if not self._growth_fits():
                self._quiesce()
            prev, self._inflight = self._inflight, None
            self._inflight = self._dispatch_block()
            self._harvest(prev)
        else:
            self._quiesce()  # a lookahead block of slots that have finished
            if not any(self._slots):
                self._idle_wait()

    def _end_all(self, item):
        """End every stream, in a slot, waiting or still submitted, with
        ``item``: the error of a failed tick, or None at shutdown."""
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._slots[slot] = None
                req.slot = -1
                req.out.put(item)
        self.active = [False] * self.M
        for req in self._waiting:
            req.out.put(item)
        self._waiting.clear()
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
        self._inflight = None
        self._end_all(exc)
        self._pages_of.clear()
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
