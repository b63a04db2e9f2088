"""Disaggregated prefill/decode serving: role-split pools + KV handoff
(copied from ``mlx_sharding_tpu/disagg.py``; the pools are the port's
replica sets of ``ContinuousBatcher`` replicas, the handoff block a
``kv_transfer.KVPageBlock``; the pod leg ships it to a remote decode host
through ``pod.PodHandoff``).

Monolithic replicas make one engine own a request for its whole lifetime,
so long prefills and steady decode ticks fight for the same device and
TTFT / decode-throughput SLOs cannot be tuned independently. This module
splits the lifetime in two, per TPLA (arXiv:2508.15881): a PREFILL pool
runs flash-prefill at high arithmetic intensity and emits the first token;
the request's KV then ships to a DECODE pool replica as the checksummed
``KVPageBlock`` built in ``kv_transfer.py``, and that replica owns the
stream through completion.

Topology::

      request ──> DisaggCoordinator
                    │ route (prefix affinity / stickiness still apply)
                    ▼
              [prefill pool]  — ContinuousBatchers, _prefill_only=True
                    │ first token ──────────────> client (TTFT met)
                    │ HandoffReadyError(ResumeState)
                    ▼
              block.to_host()  — consumer-thread DMA, overlapped with the
                    │            prefill replica's next ticks (PRESERVE,
                    │            arXiv:2501.08192)
                    ▼
              [decode pool]   — least-loaded replica imports the block
                    │            (one scatter, no re-prefill) and resumes
                    ▼            token-exactly from the delivered prefix
                  client  <──  tokens 2..n

The handoff never stalls either pool's ticks: the prefill scheduler
exports the block dispatch-only (``_handoff_out``: a gather on the
tick's stream, no host read) and leaves the device→host copy to THIS module,
which runs it on the request's own consumer thread; the decode replica
imports at admission through the existing resume machinery.

Degradation contract — a stream, once started, is NEVER dropped while any
replica in either pool lives:

- ``disagg.handoff`` fault (or any handoff-control failure): serve in
  place — the prefill pool resumes the stream itself and decodes it to
  completion. Counted ``handoff_fault``.
- ``to_host`` / ``cache.export`` failure: the block is dropped and the
  handoff proceeds blockless — the decode replica folds the delivered
  history into the prompt and re-prefills, still token-exact (the sampler
  PRNG row and repetition window travel in the ``ResumeState``). Counted
  ``block_dropped``.
- ``cache.import`` failure on the decode replica: the scheduler's own
  import fallback re-prefills from the fold — no coordinator involvement.
- prefill pool unavailable before any token: the decode pool serves the
  request monolithically (prefill included). Counted
  ``prefill_unavailable``. Admission saturation (``QueueFullError``) is
  NOT remapped — 429 + ``Retry-After`` is the correct answer, and routing
  the overflow at the decode pool would break its SLO isolation.
- a pool dies mid-stream after its own retries are exhausted: the
  coordinator rebuilds a blockless ``ResumeState`` from its delivered-
  token record and resumes on the other pool (greedy streams token-exact;
  sampled streams reseed, as for crash failover).

Autoscaling stays per-pool: each role's ``ReplicaSet`` gets its own
``FleetAutoscaler`` over its own ``pool_pressure`` (see ``fleet.py``), so
a prefill storm scales the prefill pool and cannot trigger decode-pool
spawns (and vice versa).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.resilience import (
    HandoffReadyError,
    QueueFullError,
    RequestTimeoutError,
    ResumeState,
)
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.clock import MONOTONIC, Clock
from mlx_sharding_tpu_torch.utils.locks import make_lock
from mlx_sharding_tpu_torch.utils.observability import HANDOFF_BUCKETS_MS, Histogram


def _pct(sorted_ms: list, q: float) -> Optional[float]:
    """Nearest-rank percentile over an already-sorted sample; None when
    empty (gauge-grade — the handoff window is a bounded deque)."""
    if not sorted_ms:
        return None
    k = min(len(sorted_ms) - 1, max(0, int(round(q / 100 * len(sorted_ms))) - 1))
    return sorted_ms[k]


class DisaggCoordinator:
    """Two-phase request ownership over role-tagged replica pools.

    ``generate_step`` has the same contract as ``ReplicaSet``'s — eager
    validation errors surface on first ``next()``, then a token stream —
    so the server drives it unchanged. Every prefill replica must speak
    the prefill-only protocol (``supports_prefill_only``) and every decode
    replica the resume protocol (``supports_resume``); both are checked at
    construction, not at the first handoff."""

    concurrent = True  # the server must not serialize requests around us
    supports_sessions = True  # stickiness applies to the prefill leg

    def __init__(self, prefill_pool, decode_pool, *,
                 handoff_window: int = 512, prefix_store=None,
                 clock: Clock = MONOTONIC):
        for rep in getattr(prefill_pool, "replicas", [prefill_pool]):
            if not getattr(rep, "supports_prefill_only", False):
                raise ValueError(
                    "every prefill-pool replica must support prefill-only "
                    "admission (ContinuousBatcher); got "
                    f"{type(rep).__name__}"
                )
        for rep in getattr(prefill_pool, "replicas", [prefill_pool]):
            if getattr(rep, "_spec_mode", "off") != "off":
                raise ValueError(
                    "prefill-pool replicas must not speculate: a prefill "
                    "replica emits one token per request before the "
                    "handoff, so draft windows there are pure ballast — "
                    "build the pool with draft='off' (decode replicas "
                    "keep theirs)"
                )
        for rep in getattr(decode_pool, "replicas", [decode_pool]):
            if not getattr(rep, "supports_resume", False):
                raise ValueError(
                    "every decode-pool replica must support the resume "
                    f"protocol; got {type(rep).__name__}"
                )
        self.prefill = prefill_pool
        self.decode = decode_pool
        self.clock = clock
        # pod-scale cross-host handoff (pod.PodHandoff), attached by the
        # pod fleet after construction: when set, phase 2 may ship the
        # block to a less-loaded REMOTE decode host instead of the local
        # decode pool, with the same never-drop degradation ladder
        self.pod = None
        # fleet-wide prefix store (optional): when the WHOLE prompt is
        # already covered — a device entry on some decode replica or a
        # host-tier block — phase 1 is pure overhead, so generate_step
        # skips the prefill pool entirely and the decode pool serves from
        # token 0 (its admission imports/leases the covered prefix)
        self.prefix_store = prefix_store
        self._lock = make_lock("DisaggCoordinator._lock")
        self.handoffs = 0          # completed prefill→decode handoffs
        self.handoff_bytes = 0     # sum of shipped block payloads
        self.handoffs_compressed = 0  # handoffs shipped as compressed latents
        self.store_skips = 0       # full store hits that skipped phase 1
        self.fallbacks: dict = {}  # degradation counts by kind
        self._ms: deque = deque(maxlen=handoff_window)  # DMA+control ms
        # cumulative handoff-latency histogram: unlike the windowed deque
        # above, never resets, so /metrics can render a Prometheus-grade
        # ``mst_disagg_handoff_ms_bucket`` family that survives scrapes
        self._ms_hist = Histogram(HANDOFF_BUCKETS_MS,
                                  "DisaggCoordinator._ms_hist")

    # ---------------------------------------------------------- serving
    @property
    def supports_trace(self) -> bool:
        """``_trace`` is forwarded verbatim to both pools, so one request
        timeline spans the prefill leg, the handoff, and the decode leg —
        advertise it only when every leg will honor it."""
        return (getattr(self.prefill, "supports_trace", False)
                and getattr(self.decode, "supports_trace", False))

    @property
    def supports_deadlines(self) -> bool:
        return (getattr(self.prefill, "supports_deadlines", False)
                and getattr(self.decode, "supports_deadlines", False))

    @property
    def brownout(self):
        """The decode pool's brownout governs generation caps (that is
        where decode saturation lives); prefill's is the fallback."""
        return (getattr(self.decode, "brownout", None)
                or getattr(self.prefill, "brownout", None))

    def attach_pod(self, pod_handoff) -> None:
        """Wire the cross-host leg in (pod.PodFleet calls this): phase 2
        consults ``pod_handoff.pick_remote()`` per handoff and may serve
        the decode leg on a remote host."""
        self.pod = pod_handoff

    def _count(self, kind: str):
        with self._lock:
            self.fallbacks[kind] = self.fallbacks.get(kind, 0) + 1

    def generate_step(self, prompt_tokens, **kw):
        emitted: list = []  # every token the client saw, both phases
        trackable = True    # ints only; else cross-pool resume is refused

        def _track(item) -> bool:
            tok = item[0] if isinstance(item, (tuple, list)) else item
            try:
                emitted.append(int(tok))
                return True
            except (TypeError, ValueError):
                return False

        def _serve(pool, resume, fwd):
            nonlocal trackable
            f = dict(fwd, _resume=resume) if resume is not None else fwd
            it = pool.generate_step(prompt_tokens, **f)
            try:
                for item in it:
                    if trackable:
                        trackable = _track(item)
                    yield item
            except GeneratorExit:
                it.close()
                raise

        # resume/fallback legs drop the routing + TTFT kwargs: the first
        # token was already delivered, so stickiness and the TTFT budget
        # belong to the prefill leg alone. The TTFT value stays alive as
        # the inter-token watchdog it would have defaulted to.
        resume_kw = dict(kw)
        resume_kw.pop("_session", None)
        ttft = resume_kw.pop("ttft_timeout", None)
        if ttft is not None and resume_kw.get("stall_timeout") is None:
            resume_kw["stall_timeout"] = ttft

        # ---- phase 0: fleet-store full-hit check — when the store already
        # covers the ENTIRE prompt (a decode replica's device entry or a
        # host-tier block), dispatching to the prefill pool would prefill
        # nothing: skip phase 1 outright and let the decode pool serve
        # from token 0, admission leasing/importing the covered prefix.
        # A sick store (injected ``cache.prefix_lookup``) degrades to the
        # normal two-phase path — never a wrong or dropped stream.
        state: Optional[ResumeState] = None
        monolithic = False
        skip_prefill = False
        if self.prefix_store is not None:
            try:
                skip_prefill = self.prefix_store.covers_full(prompt_tokens)
            except Exception:  # noqa: BLE001 — advisory check only
                skip_prefill = False
        if skip_prefill:
            with self._lock:
                self.store_skips += 1
            monolithic = True  # decode-pool-first, original kwargs

        # ---- phase 1: the prefill pool delivers the first token
        if not monolithic:
            it = self.prefill.generate_step(
                prompt_tokens, _prefill_only=True, **kw
            )
            try:
                for item in it:
                    if trackable:
                        trackable = _track(item)
                    yield item
                return  # max_tokens == 1: the stream completed during prefill
            except GeneratorExit:
                it.close()
                raise
            except HandoffReadyError as exc:
                state = exc.state  # the expected exit: run the handoff below
            except (ValueError, RequestTimeoutError):
                raise  # bad request / blown budget — not a placement problem
            except QueueFullError:
                if not emitted:
                    raise  # saturation: 429 + Retry-After, do not spill the
                    # overflow onto the decode pool (that is the SLO leak
                    # disaggregation exists to close)
                self._count("prefill_failed")  # mid-replacement full queues
            except Exception:
                if emitted and not trackable:
                    raise  # tokens delivered, no exact continuation possible
                if emitted:
                    self._count("prefill_failed")
                else:
                    # nothing delivered yet: the decode pool serves the whole
                    # request monolithically — degraded, never dropped
                    self._count("prefill_unavailable")
                    monolithic = True

        # ---- phase 2: handoff (or fallback re-placement)
        if state is not None:
            target = self.decode
            tr = kw.get("_trace")
            t0 = self.clock()
            tp0 = time.perf_counter()
            with tracing.bind(tr):
                try:
                    inject("disagg.handoff",
                           n_bytes=getattr(state.block, "nbytes", 0))
                except Exception:
                    # handoff-control failure: serve in place — the prefill
                    # pool finishes the stream it started
                    self._count("handoff_fault")
                    target = self.prefill
                if state.block is not None:
                    try:
                        # the export was dispatch-only on the prefill tick;
                        # THIS is the device→host DMA, on the request's own
                        # consumer thread so both pools keep ticking under it
                        state.block.to_host()
                    except Exception:
                        state.block = None  # fold re-prefill stays token-exact
                        self._count("block_dropped")
            if target is self.decode:
                # nbytes reads AFTER to_host: a compressed-latent block
                # (kv_compress) counts its wire size — what actually moved
                nbytes = getattr(state.block, "nbytes", 0) or 0
                compressed = (
                    getattr(state.block, "compress_kind", None) is not None
                )
                ms = (self.clock() - t0) * 1000.0
                with self._lock:
                    self.handoffs += 1
                    self.handoff_bytes += int(nbytes)
                    if compressed:
                        self.handoffs_compressed += 1
                    self._ms.append(ms)
                self._ms_hist.observe(ms)
                if tr is not None:
                    tr.add("handoff_transfer", tp0, time.perf_counter(),
                           bytes=int(nbytes), compressed=compressed)
            elif tr is not None:
                tr.point("handoff_fault")
            # ---- pod leg: a remote decode host may be less loaded than
            # the local decode pool. serve_remote ships the block through
            # the ``pod.handoff`` fault site and relays the remote tokens
            # back; ANY failure raises PodHandoffFallback (counted by the
            # handoff, by kind) and the request continues on the local
            # plan below — cross-host never weakens the never-drop ladder.
            if target is self.decode and self.pod is not None \
                    and self.pod.pick_remote() is not None:
                from mlx_sharding_tpu_torch.pod import PodHandoffFallback

                it = self.pod.serve_remote(state, resume_kw)
                try:
                    for item in it:
                        if trackable:
                            trackable = _track(item)
                        yield item
                    return
                except GeneratorExit:
                    it.close()
                    raise
                except PodHandoffFallback as exc:
                    if not exc.keep_block or exc.tokens_relayed:
                        # the block is gone (shipped/corrupt) or the remote
                        # already advanced the stream: rebuild a blockless
                        # resume from the coordinator's own delivered-token
                        # record — the existing token-exact fold path
                        state = ResumeState(
                            prompt=prompt_tokens, history=list(emitted),
                            produced=len(emitted),
                        )
            plan = [target, self.decode if target is self.prefill
                    else self.prefill]
            fwd = resume_kw
        elif monolithic:
            # full serve (prefill included): original kwargs, TTFT intact
            plan, fwd = [self.decode, self.prefill], kw
        else:
            # prefill leg died after delivering tokens: blockless resume,
            # decode pool first (it is the decode phase anyway)
            state = ResumeState(prompt=prompt_tokens, history=list(emitted),
                                produced=len(emitted))
            plan, fwd = [self.decode, self.prefill], resume_kw

        last: Optional[BaseException] = None
        for k, pool in enumerate(plan):
            try:
                yield from _serve(pool, state, fwd)
                return
            except GeneratorExit:
                raise
            except (ValueError, RequestTimeoutError):
                raise
            except Exception as exc:
                last = exc
                if emitted and not trackable:
                    raise
                if k + 1 < len(plan):
                    self._count(
                        f"{getattr(pool, 'role', None) or 'pool'}_failed"
                    )
                    if emitted:
                        # carry the full delivered prefix to the next pool
                        state = ResumeState(
                            prompt=prompt_tokens, history=list(emitted),
                            produced=len(emitted),
                        )
                        fwd = resume_kw
        raise last

    # ---------------------------------------------------- observability
    def handoff_stats(self) -> dict:
        """Counters for ``mst_disagg_handoff_*`` and the /health handoff
        block: completed handoffs, shipped bytes, DMA+control latency
        percentiles over the last window, degradation counts by kind."""
        with self._lock:
            ms = sorted(self._ms)
            return {
                "handoffs": self.handoffs,
                "bytes_total": self.handoff_bytes,
                "handoffs_compressed": self.handoffs_compressed,
                "store_skips": self.store_skips,
                "fallbacks": dict(self.fallbacks),
                "ms_p50": _pct(ms, 50),
                "ms_p99": _pct(ms, 99),
                "window": len(ms),
                "ms_hist": self._ms_hist.to_dict(),
            }

    def latency_stats(self) -> Optional[dict]:
        """Pool batchers' cumulative latency histograms (ITL, queue-wait)
        merged across both roles — same shape as a single batcher's."""
        per = [s for s in (
            getattr(self.prefill, "latency_stats", lambda: None)(),
            getattr(self.decode, "latency_stats", lambda: None)(),
        ) if s]
        if not per:
            return None
        return {k: Histogram.merge_dicts([s[k] for s in per if k in s])
                for k in set().union(*per)}

    def stats(self):
        """(slots, active, queued) summed over both pools."""
        ps, pa, pq = self.prefill.stats()
        ds, da, dq = self.decode.stats()
        return ps + ds, pa + da, pq + dq

    def replica_stats(self) -> list:
        """Both pools' per-replica snapshots, role-tagged (indices repeat
        across pools; the role label disambiguates the gauge lines)."""
        return list(self.prefill.replica_stats()) \
            + list(self.decode.replica_stats())

    def fleet_stats(self) -> dict:
        """Aggregate fleet gauges plus per-role ``pools`` blocks (the
        /metrics renderer emits ``mst_fleet_size{role=...}`` from them)."""
        pf, df = self.prefill.fleet_stats(), self.decode.fleet_stats()
        events: dict = {}
        for src in (pf, df):
            for k, v in src.get("autoscale_events", {}).items():
                events[k] = events.get(k, 0) + v
        out = {"role": None, "pools": [pf, df], "autoscale_events": events}
        for k in ("size", "total", "retired", "draining", "sticky_sessions",
                  "affinity_entries", "affinity_hits", "sticky_hits",
                  "weights_shared"):
            out[k] = pf.get(k, 0) + df.get(k, 0)
        return out

    def resilience_stats(self) -> dict:
        """Both pools' aggregates summed, plus the coordinator's handoff
        counters — one dict shaped like a ReplicaSet's so /metrics code
        paths need no disagg special-casing."""
        pr, dr = self.prefill.resilience_stats(), self.decode.resilience_stats()
        agg: dict = {}
        for k in set(pr) | set(dr):
            a, b = pr.get(k), dr.get(k)
            if k == "max_queue":
                agg[k] = (None if a is None and b is None
                          else (a or 0) + (b or 0))
            elif k == "scheduler_thread_live":
                agg[k] = bool(a if a is not None else True) \
                    and bool(b if b is not None else True)
            else:
                agg[k] = (a or 0) + (b or 0)
        h = self.handoff_stats()
        agg["handoffs"] = h["handoffs"]
        agg["handoff_fallbacks"] = sum(h["fallbacks"].values())
        return agg

    def spill_stats(self) -> Optional[dict]:
        per = [s for s in (self.prefill.spill_stats(),
                           self.decode.spill_stats()) if s is not None]
        if not per:
            return None
        agg: dict = {"enabled": any(s.get("enabled") for s in per)}
        for k in set().union(*per) - {"enabled"}:
            vals = [s.get(k, 0) for s in per]
            agg[k] = sum(v or 0 for v in vals)
        return agg

    def spec_stats(self) -> Optional[dict]:
        """Decode-pool speculation telemetry only — prefill replicas never
        speculate (enforced at construction), so the decode pool IS the
        coordinator's whole speculation story."""
        fn = getattr(self.decode, "spec_stats", None)
        return fn() if fn is not None else None

    def page_stats(self):
        per = [t for t in (self.prefill.page_stats(),
                           self.decode.page_stats()) if t is not None]
        if not per:
            return None
        return tuple(sum(col) for col in zip(*per))

    def set_pressure(self, level: int):
        self.prefill.set_pressure(level)
        self.decode.set_pressure(level)

    def health(self) -> dict:
        """Role blocks from both pools. ``serving`` while EITHER pool has
        a live replica — the degradation ladder can run the whole request
        lifecycle on one pool; ``ok`` only when both report ok."""
        ph, dh = self.prefill.health(), self.decode.health()
        if ph["status"] == dh["status"] == "ok":
            status = "ok"
        elif "draining" in (ph["status"], dh["status"]):
            status = "draining"
        else:
            status = "degraded"
        return {
            "status": status,
            "serving": bool(ph["serving"] or dh["serving"]),
            "disagg": True,
            "pools": {"prefill": ph, "decode": dh},
            "handoff": self.handoff_stats(),
        }

    def close(self):
        self.prefill.close()
        self.decode.close()
