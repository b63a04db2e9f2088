"""Data-parallel serving: independent engine replicas behind one
dispatcher (copied from ``mlx_sharding_tpu/replicas.py``; the dispatcher is
framework-free, its replicas are the port's batchers).

``--replicas R`` builds R independent engines, each a ``PipelineEngine``
under a ``ContinuousBatcher``, and routes each request to the best-scored
replica. On one card the replicas co-locate and alias one resident copy of
the weights (``weights.WeightStore``); each keeps its own KV pool, step
graphs, stream of work and scheduler thread.

Routing score: a replica's load is ``inflight + queue_depth`` (the queue
depth comes from its batcher's own admission stats). Two placement signals
may override pure least-loaded, both behind a load-imbalance escape hatch
(``route_imbalance``): session stickiness (``_session`` request key → the
replica that served the session last, keeping its KV/prompt-cache warm) and
prefix-cache affinity (chained page digests of the prompt → the replica
whose prompt cache holds the longest prefix). Requests with a tight TTFT
budget drop the escape hatch to zero — no deadline-headroom, no affinity
detour.

Elasticity: ``add_replica()`` appends a freshly spawned replica (indices are
stable; retired slots keep their position) and ``drain()`` retires one with
zero dropped streams. The controller that calls them under queue pressure
is ``fleet.FleetAutoscaler``; this module provides the mechanisms plus the
``autoscale_events`` / ``replica_stats()`` / ``fleet_stats()`` surfaces
that /metrics and /health report.

Requests route once and normally stay put; when a stream must leave its
replica anyway — graceful drain or a mid-stream crash — it migrates as a
``ResumeState`` (see ``kv_transfer``): the replica (or the dispatcher's own
delivered-token record) captures prompt + emitted history + sampler state
+ optionally the host-materialized KV page block, and the dispatcher
re-places the request on a healthy replica, resuming from the last token
the client saw.

Resilience: the dispatcher is also the failure domain boundary. A replica
that keeps failing dispatches is circuit-broken out of routing (consecutive
failures ≥ ``breaker_threshold`` opens the breaker for ``probe_interval``
seconds; after that ONE live request is let through as a half-open probe —
success closes the breaker, failure re-opens it). Requests that fail before
their first token retry on another replica. Started streams migrate only
when a token-exact continuation is possible: the target must advertise
``supports_resume`` and every delivered token must have been trackable —
otherwise the failure surfaces to the client as before. ``drain(i)``
retires a replica without dropping work: it stops routing to *i*, asks its
batcher to ``migrate_out()`` every admitted request, waits for in-flight
dispatches to unwind, then closes it. While at least one replica lives the
set keeps serving and ``health()`` reports degraded, not dead.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Optional

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.resilience import (
    HandoffReadyError,
    QueueFullError,
    ReplicasUnavailableError,
    RequestMigratedError,
    RequestTimeoutError,
    ResumeState,
)
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.clock import MONOTONIC, WALL_SLEEP, Clock, SleepFn
from mlx_sharding_tpu_torch.utils.digests import chunk_digests
from mlx_sharding_tpu_torch.utils.locks import make_lock, note_acquire, note_release
from mlx_sharding_tpu_torch.utils.observability import Histogram


class _ResumeUnsupported(Exception):
    """Internal: the picked replica can't continue a migrated stream
    (no ``supports_resume``). Not a failure — just the wrong target."""


class ReplicaSet:
    """``generate_step`` dispatcher over independent replica generators.

    Routing: lowest ``inflight + queue_depth`` score, ties to the lowest
    index — deterministic and state-light (no cross-replica queues; a
    replica's own ContinuousBatcher provides intra-replica queueing when
    built with ``--concurrent``). Session stickiness and prefix-cache
    affinity may override the score within ``route_imbalance`` load units,
    except for tight-TTFT requests (see module docstring). Circuit-broken
    replicas are skipped; a half-open replica receives at most one probe
    request at a time."""

    concurrent = True  # the server must not serialize requests around us
    supports_sessions = True  # the server may forward a _session key

    def __init__(self, replicas: list, *, breaker_threshold: int = 3,
                 probe_interval: float = 5.0, resume_streams: bool = True,
                 route_imbalance: int = 4, affinity_page: int = 128,
                 tight_ttft_s: float = 10.0, role: Optional[str] = None,
                 prefix_store=None, clock: Clock = MONOTONIC,
                 sleep: SleepFn = WALL_SLEEP):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        # injectable time source + wait primitive: breaker open/half-open
        # stamps and the drain unwind loop run on these, so the fleet
        # simulator can drive the whole dispatcher in virtual time
        self._clock = clock
        self._sleep = sleep
        # disaggregated serving: pools are role-tagged ("prefill"/"decode")
        # so fleet gauges, health blocks and autoscale events say which
        # pool they describe; None keeps the monolithic (unlabeled) forms
        self.role = role
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if probe_interval <= 0:
            raise ValueError("probe_interval must be positive")
        self.replicas = list(replicas)
        self.breaker_threshold = breaker_threshold
        self.probe_interval = probe_interval
        # crash-safe re-placement: when a replica dies mid-stream, rebuild
        # the request from the dispatcher's delivered-token record and
        # resume it on a healthy replica (False restores the old raise)
        self.resume_streams = bool(resume_streams)
        n = len(self.replicas)
        self._inflight = [0] * n
        self.served = [0] * n  # lifetime dispatch counts (retries included)
        self.failures = [0] * n  # lifetime dispatch failures
        self.breaker_opens = [0] * n  # closed→open transitions
        self._fails_consec = [0] * n
        # drain lifecycle (all under _lock): draining = migrate_out in
        # progress, no new dispatches, in-flight streams unwinding;
        # retired = permanently out of routing (drain completed)
        self._draining = [False] * n     # routing quarantine (sticky on failure)
        self._drain_active = [False] * n  # a drain() call is currently running
        self._retired = [False] * n
        self.drains = 0            # completed drain() calls
        self.migrated_streams = 0  # resumed attempts that delivered a token
        # monotonic stamp until which the breaker holds the replica out of
        # routing; 0 = closed. Past the stamp the replica is HALF-OPEN: one
        # request may probe it (_probing guards against a probe stampede).
        self._open_until = [0.0] * n
        self._probing = [False] * n
        self._lock = make_lock("ReplicaSet._lock")
        # non-concurrent replicas (plain engines) serve one request at a
        # time each; per-replica locks replace the server's global one
        self._serial_locks: list = [
            None if getattr(r, "concurrent", False)
            else make_lock("ReplicaSet._serial_locks[*]")
            for r in self.replicas
        ]
        # retirement callback (server wiring): invoked with the replica
        # object after drain() closes and retires it, so the owner can
        # recycle what the replica held (the server frees the card's cached
        # blocks). Failures are logged, never raised: a broken recycle hook
        # must not fail an otherwise-clean drain.
        self.on_retire = None
        # ---------------------------------------- load-aware routing state
        if route_imbalance < 0:
            raise ValueError("route_imbalance must be >= 0")
        if affinity_page < 1:
            raise ValueError("affinity_page must be >= 1")
        self.route_imbalance = route_imbalance
        self.affinity_page = affinity_page
        self.tight_ttft_s = tight_ttft_s
        # chained prompt-chunk digest -> replica index that last served it
        # (mirrors the batcher's prefix-cache page chaining, so a hit here
        # means that replica's prompt cache plausibly holds the prefix)
        self._affinity: OrderedDict = OrderedDict()
        self._affinity_cap = 8192
        # session key -> replica index that served the session last
        self._sticky: OrderedDict = OrderedDict()
        self._sticky_cap = 4096
        self.route_affinity_hits = 0
        self.route_sticky_hits = 0
        # fleet-wide prefix store (optional): a replica that HOLDS the
        # prompt's prefix as a live device entry beats the digest-affinity
        # guess — the hint is ground truth (zero-copy lease on admission)
        # where the affinity map is only a plausible-warmth memory
        self.prefix_store = prefix_store
        self.route_store_hits = 0
        # ------------------------------------------------- elastic fleet
        # autoscale event counters, written by the fleet controller via
        # record_autoscale_event (kind -> count; /metrics renders them)
        self.autoscale_events: dict = {}
        # FleetAutoscaler / BrownoutController attach themselves here so
        # health() can surface them and close() can stop the loop
        self.brownout = None
        self._controller = None

    @property
    def supports_deadlines(self) -> bool:
        """Deadline kwargs can be forwarded only when every replica
        understands them (mixed sets would crash on the plain engines)."""
        with self._lock:
            reps = list(self.replicas)
        return all(getattr(r, "supports_deadlines", False) for r in reps)

    @property
    def supports_trace(self) -> bool:
        """A ``_trace`` handle is forwarded verbatim to the picked replica;
        advertise it only when every replica accepts the kwarg."""
        with self._lock:
            reps = list(self.replicas)
        return all(getattr(r, "supports_trace", False) for r in reps)

    # ------------------------------------------------------------- routing
    def _breaker_state(self, j: int, now: float) -> str:
        if self._open_until[j] == 0:
            return "closed"
        return "half_open" if now >= self._open_until[j] else "open"

    def _affinity_chunks(self, prompt) -> list:
        """Chained digests over fixed ``affinity_page``-token chunks of the
        prompt, mirroring the prefix-cache page chaining: matching the
        first k digests means sharing a k-page prefix. The chain itself
        lives in ``utils.digests`` — the ONE content-address the prefix
        store keys on too, so a router hit and a store hit can never
        disagree about what "same prefix" means. Non-int prompts (or
        prompts shorter than one page) contribute no affinity signal."""
        try:
            return chunk_digests(prompt, self.affinity_page, max_chunks=32)
        except (TypeError, ValueError):
            return []

    def _queue_depths(self) -> list:
        """Per-replica queue-depth snapshot for routing, gathered OUTSIDE
        ``_lock``: a replica's stats() takes its own admission lock, and we
        must not order ours ahead of it. Racy by a tick — gauge-grade is
        all a routing hint needs."""
        with self._lock:
            reps = list(self.replicas)
            retired = list(self._retired)
        out = []
        for j, r in enumerate(reps):
            q = 0
            if not retired[j] and hasattr(r, "stats"):
                try:
                    _, _, q = r.stats()
                except Exception:  # noqa: BLE001 — a sick replica scores 0
                    q = 0
            out.append(q)
        return out

    def _route(self, closed: list, depths: list, chunks: list,
               session, tight: bool, hint=None) -> int:
        """Pick from the closed-breaker candidates (``_lock`` held).
        Stickiness, then the prefix-store owner hint, then affinity may
        override least-loaded — but only within ``route_imbalance`` load
        units of the best candidate, and never for tight-TTFT requests
        (their deadline headroom can't absorb a deeper queue)."""
        def load(j):
            return self._inflight[j] + (depths[j] if j < len(depths) else 0)

        base = min(load(j) for j in closed)
        tol = 0 if tight else self.route_imbalance
        if session is not None:
            s = self._sticky.get(session)
            if s in closed and load(s) - base <= tol:
                self.route_sticky_hits += 1
                return s
        if hint is not None:
            # the store says this replica holds the prompt's prefix as a
            # live DEVICE entry right now — admission there is a zero-copy
            # lease, so it outranks the affinity map's plausible warmth
            for j in closed:
                if self.replicas[j] is hint and load(j) - base <= tol:
                    self.route_store_hits += 1
                    return j
        if chunks:
            best, best_n = None, 0
            for j in closed:
                if load(j) - base > tol:
                    continue
                n = 0
                for k in chunks:
                    if self._affinity.get(k) != j:
                        break
                    n += 1
                if n > best_n:
                    best, best_n = j, n
            if best is not None:
                self.route_affinity_hits += 1
                return best
        return min(closed, key=lambda j: (load(j), j))

    def _remember_route(self, i: int, chunks: list, session):
        """Record the placement (``_lock`` held) so the NEXT request with
        this session/prefix lands on the same warm replica."""
        if session is not None:
            self._sticky[session] = i
            self._sticky.move_to_end(session)
            while len(self._sticky) > self._sticky_cap:
                self._sticky.popitem(last=False)
        for k in chunks:
            self._affinity[k] = i
            self._affinity.move_to_end(k)
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)

    def _pick(self, exclude=(), *, prompt=None, session=None,
              tight: bool = False) -> tuple[int, bool]:
        chunks = self._affinity_chunks(prompt) if prompt is not None else []
        hint = None
        if self.prefix_store is not None and prompt is not None:
            # OUTSIDE _lock: the store takes its own lock (never nested
            # under ours), and a sick store must not break routing
            try:
                hint = self.prefix_store.owner_hint(prompt)
            except Exception:  # noqa: BLE001 — hint is advisory only
                hint = None
        depths = self._queue_depths()
        with self._lock:
            now = self._clock()
            closed, half_open = [], []
            retry_eta = None  # earliest half-open retry among open breakers
            for j in range(len(self.replicas)):
                if j in exclude or self._draining[j] or self._retired[j]:
                    continue
                state = self._breaker_state(j, now)
                if state == "closed":
                    closed.append(j)
                elif state == "half_open" and not self._probing[j]:
                    half_open.append(j)
                elif state == "half_open":
                    # a probe is in flight — its verdict lands imminently
                    retry_eta = 0.0 if retry_eta is None else retry_eta
                else:
                    eta = self._open_until[j] - now
                    retry_eta = eta if retry_eta is None else min(retry_eta, eta)
            probe = False
            if half_open:
                # recovery beats load balance: route this request as the
                # probe, or an idle fleet would never close the breaker
                i = half_open[0]
                self._probing[i] = True
                probe = True
                note_acquire("replica.probe", (id(self), i))
            elif closed:
                i = self._route(closed, depths, chunks, session, tight, hint)
                self._remember_route(i, chunks, session)
            else:
                raise ReplicasUnavailableError(
                    "no replica available: every replica is circuit-broken "
                    "or already failed this request",
                    retry_after_s=retry_eta,
                )
            self._inflight[i] += 1
            self.served[i] += 1
            return i, probe

    def _done(self, i: int, probe: bool = False):
        with self._lock:
            self._inflight[i] -= 1
            if probe:
                # the probe ticket must come back on EVERY exit path (bad
                # request, queue-full, consumer close, crash) — a leaked
                # ticket would bar the replica from ever being probed again
                self._probing[i] = False
                note_release("replica.probe", (id(self), i))

    def _record_success(self, i: int):
        with self._lock:
            self._fails_consec[i] = 0
            self._open_until[i] = 0.0
            self._probing[i] = False

    def _record_failure(self, i: int):
        opened = False
        with self._lock:
            self.failures[i] += 1
            self._fails_consec[i] += 1
            self._probing[i] = False
            now = self._clock()
            if self._open_until[i] > 0:
                # failed half-open probe: straight back to open
                self._open_until[i] = now + self.probe_interval
            elif self._fails_consec[i] >= self.breaker_threshold:
                self._open_until[i] = now + self.probe_interval
                self.breaker_opens[i] += 1
                opened = True
        if opened:
            # flight recorder: freeze the recent request timelines at the
            # moment a replica is circuit-broken out of routing (outside
            # _lock — the tracer takes its own lock)
            tracing.auto_snapshot(f"breaker_open:replica{i}")

    @staticmethod
    def _note_token(emitted: list, item) -> bool:
        """Record a delivered token for crash-resume accounting. Items are
        ``(token, logprobs)`` pairs from the engines (or bare tokens from
        simple generators); False means the token wasn't an integer and the
        stream can no longer be resumed exactly."""
        tok = item[0] if isinstance(item, (tuple, list)) else item
        try:
            emitted.append(int(tok))
            return True
        except (TypeError, ValueError):
            return False

    def generate_step(self, prompt_tokens, **kw):
        # routing hints: session key (popped — replicas don't see it) and
        # deadline headroom (a tight TTFT budget disables warm-placement
        # detours — the request can't afford a deeper queue)
        session = kw.pop("_session", None)
        ttft = kw.get("ttft_timeout")
        tight = (
            isinstance(ttft, (int, float)) and not isinstance(ttft, bool)
            and ttft < self.tight_ttft_s
        )
        excluded: set[int] = set()
        last_exc: Optional[BaseException] = None
        # caller-seeded resume (disagg handoff: the coordinator re-places a
        # stream whose first tokens were delivered by the OTHER pool) —
        # distinct from `replaced`, which marks in-pool drain/crash hops
        resume: Optional[ResumeState] = kw.pop("_resume", None)
        replaced = False
        emitted: list = []  # every token delivered to the client so far
        trackable = True    # ints only; else crash-resume is refused
        if resume is not None:
            # seed the delivered-token record with the tokens the client
            # already saw, so a crash HERE rebuilds the full stream (an
            # empty seed would resume with the handed-off prefix missing)
            for t in list(resume.history or []):
                if not self._note_token(emitted, t):
                    trackable = False
                    break
        while True:
            try:
                i, probe = self._pick(
                    excluded, prompt=prompt_tokens, session=session,
                    tight=tight,
                )
            except ReplicasUnavailableError:
                if last_exc is not None:
                    raise last_exc  # concrete failure beats the generic 503
                raise
            started = False
            try:
                with self._lock:
                    rep = self.replicas[i]
                    serial = self._serial_locks[i]
                fwd = kw
                if resume is not None:
                    if not getattr(rep, "supports_resume", False):
                        # a resumed stream needs the _resume protocol; a
                        # plain engine would re-run from scratch and
                        # double-emit — try the other replicas instead
                        raise _ResumeUnsupported()
                    fwd = dict(kw, _resume=resume)
                inject("replica.dispatch", replica=i)
                tr = kw.get("_trace")
                if tr is not None:
                    tr.point("dispatch", replica=i, probe=probe,
                             resumed=resume is not None)
                if serial is not None:
                    with serial:
                        for item in rep.generate_step(prompt_tokens, **fwd):
                            if not started:
                                started = True
                                if replaced:
                                    with self._lock:
                                        self.migrated_streams += 1
                            if trackable:
                                trackable = self._note_token(emitted, item)
                            yield item
                else:
                    for item in rep.generate_step(prompt_tokens, **fwd):
                        if not started:
                            started = True
                            if replaced:
                                with self._lock:
                                    self.migrated_streams += 1
                        if trackable:
                            trackable = self._note_token(emitted, item)
                        yield item
                self._record_success(i)
                return
            except GeneratorExit:
                # The consumer closed the stream early — under the server
                # this is the COMMON success path (eos / stop word hit, so
                # it.close()s the stream). Tokens flowed, the replica did
                # its job: record the success, or a recovered probe would
                # stay half-open forever and ordinary early exits would
                # never reset the failure streak.
                if started:
                    self._record_success(i)
                raise
            except _ResumeUnsupported:
                excluded.add(i)  # keep last_exc: it names the real failure
            except ValueError:
                raise  # bad request — the replica is healthy
            except HandoffReadyError:
                # disaggregated prefill: the replica completed its phase and
                # the stream ends with the ResumeState for the decode pool.
                # A successful exit — no breaker strike, no in-pool
                # re-placement; the DisaggCoordinator above catches it
                self._record_success(i)
                raise
            except RequestMigratedError as exc:
                # graceful drain: the replica ended the stream with the
                # complete ResumeState (KV block or prompt+history). Not a
                # failure — no breaker strike; re-place and continue the
                # client's stream where it left off
                resume = exc.state
                replaced = True
                excluded.add(i)
                last_exc = exc
                tr = kw.get("_trace")
                if tr is not None:
                    tr.point("drain_migrate", replica=i)
            except QueueFullError as exc:
                # saturation (or ReplicaDrainingError, its drain-time
                # subtype), not sickness: no breaker penalty, but try the
                # other replicas before giving the client a 429
                excluded.add(i)
                last_exc = exc
            except RequestTimeoutError as exc:
                # the request's own budget is spent — a retry would only
                # blow it further. Only expiries that mark a WEDGED engine
                # (mid-stream stall, blown total budget) strike the breaker;
                # ttft/queue expiries are saturation, and client-settable
                # budgets must not circuit-break healthy-but-busy replicas
                if exc.kind in ("stall", "total"):
                    self._record_failure(i)
                raise
            except Exception as exc:  # noqa: BLE001 — any replica-side crash
                self._record_failure(i)
                if started:
                    if not (self.resume_streams and trackable):
                        raise  # tokens delivered, no exact resume possible
                    # crash-safe re-placement: rebuild the request from the
                    # dispatcher's own delivered-token record. Greedy
                    # streams resume token-exact; sampled streams reseed
                    # (the PRNG rows died with the replica) — distribution-
                    # correct, not bit-exact
                    resume = ResumeState(
                        prompt=prompt_tokens,
                        history=list(emitted),
                        produced=len(emitted),
                    )
                    replaced = True
                excluded.add(i)
                last_exc = exc
                tr = kw.get("_trace")
                if tr is not None:
                    tr.point("failover", replica=i,
                             resumed=started and replaced)
            finally:
                self._done(i, probe)

    # -------------------------------------------------------------- drain
    def drain(self, i: int, deadline: float = 30.0) -> dict:
        """Gracefully retire replica ``i``: stop routing to it, migrate its
        admitted requests off (each stream ends with a
        ``RequestMigratedError`` whose ``ResumeState`` this dispatcher
        re-places on a healthy replica — the client never notices), wait
        for in-flight dispatches to unwind, then close and retire it.

        Failure semantics: if the migration step itself fails (injected
        ``replica.drain`` fault, wedged batcher), the replica stays
        QUARANTINED — ``draining`` keeps new work away while the still-
        flowing streams finish — and the error surfaces so the operator can
        retry. The replica is never closed while un-migrated streams could
        be truncated; if in-flight dispatches don't unwind by ``deadline``
        it is retired without closing (``closed: False`` in the result) and
        the leak is logged."""
        if not isinstance(i, int) or isinstance(i, bool):
            raise ValueError(f"replica index must be an int; got {i!r}")
        with self._lock:
            n = len(self.replicas)
            if not 0 <= i < n:
                raise ValueError(
                    f"replica index must be in [0, {n}); got {i!r}"
                )
            if self._retired[i]:
                return {"replica": i, "migrated": 0, "closed": True,
                        "already_retired": True}
            if self._drain_active[i]:
                raise ValueError(f"replica {i} is already draining")
            others = [
                j for j in range(n)
                if j != i and not self._retired[j] and not self._draining[j]
            ]
            if not others:
                raise ValueError(
                    "cannot drain the last live replica — the migrated "
                    "requests would have nowhere to resume"
                )
            self._drain_active[i] = True
            self._draining[i] = True
            r = self.replicas[i]
        try:
            inject("replica.drain", replica=i)
            migrated = (
                r.migrate_out(deadline=deadline)
                if hasattr(r, "migrate_out") else 0
            )
        except Exception:
            # leave the replica quarantined (draining=True: no new routes,
            # in-flight streams keep flowing) and surface the failure —
            # the operator calls drain() again to retry; nothing was dropped
            logging.getLogger(__name__).exception(
                "drain of replica %d failed mid-migration; replica "
                "quarantined, retry drain()", i,
            )
            with self._lock:
                self._drain_active[i] = False
            raise
        deadline_at = self._clock() + deadline
        while self._clock() < deadline_at:
            with self._lock:
                if self._inflight[i] == 0:
                    break
            self._sleep(0.01)
        with self._lock:
            leaked = self._inflight[i]
        closed = False
        if leaked == 0:
            if hasattr(r, "close"):
                r.close()
            closed = True
            # replica fully out: hand its resources back. Retired-without-
            # closing replicas keep theirs — their streams are still
            # unwinding on that device.
            hook = self.on_retire
            if hook is not None:
                try:
                    hook(r)
                except Exception:  # noqa: BLE001 — recycling is best-effort
                    logging.getLogger(__name__).exception(
                        "on_retire hook failed for replica %d", i
                    )
        else:
            logging.getLogger(__name__).warning(
                "replica %d retired with %d dispatches still unwinding — "
                "left unclosed to avoid truncating their streams",
                i, leaked,
            )
        with self._lock:
            self._retired[i] = True
            self._draining[i] = False
            self._drain_active[i] = False
            self.drains += 1
        return {"replica": i, "migrated": migrated, "closed": closed}

    # ------------------------------------------------------ elastic fleet
    def add_replica(self, replica) -> int:
        """Append a freshly spawned replica to the fleet (the autoscaler's
        scale-up mechanism). Indices are stable — retired slots keep their
        position — so the new replica takes the next index, which is
        returned. The replica is routable immediately."""
        with self._lock:
            self.replicas.append(replica)
            self._serial_locks.append(
                None if getattr(replica, "concurrent", False)
                else make_lock("ReplicaSet._serial_locks[*]")
            )
            self._inflight.append(0)
            self.served.append(0)
            self.failures.append(0)
            self.breaker_opens.append(0)
            self._fails_consec.append(0)
            self._draining.append(False)
            self._drain_active.append(False)
            self._retired.append(False)
            self._open_until.append(0.0)
            self._probing.append(False)
            return len(self.replicas) - 1

    def record_autoscale_event(self, kind: str):
        """Count a fleet-controller event (spawn/drain/*_failed/...) for
        the ``mst_autoscale_events_total`` metric."""
        with self._lock:
            self.autoscale_events[kind] = self.autoscale_events.get(kind, 0) + 1

    def attach_controller(self, controller):
        """Bind the FleetAutoscaler so close() stops its loop and health()
        reports its state. Called by the controller's own __init__."""
        self._controller = controller
        self.brownout = getattr(controller, "brownout", None)

    def set_pressure(self, level: int):
        """Forward the brownout ladder level to every live replica that
        understands it (ContinuousBatcher.set_pressure)."""
        with self._lock:
            reps = [
                r for j, r in enumerate(self.replicas) if not self._retired[j]
            ]
        for r in reps:
            if hasattr(r, "set_pressure"):
                r.set_pressure(level)

    # ------------------------------------------------------- observability
    def stats(self):
        """Aggregate (slots, active, queued) across replicas for /metrics.
        Non-batcher replicas count as one slot each, active while a request
        is in flight."""
        with self._lock:
            inflight = list(self._inflight)
            reps = list(self.replicas)
        slots = active = queued = 0
        for i, r in enumerate(reps):
            if hasattr(r, "stats"):  # replica stats outside our lock: the
                s, a, q = r.stats()  # batcher takes its own admission lock
                slots, active, queued = slots + s, active + a, queued + q
            else:
                slots += 1
                active += min(inflight[i], 1)
                queued += max(inflight[i] - 1, 0)
        return slots, active, queued

    def pool_load(self) -> dict:
        """One heartbeat-sized load summary for the pod control plane:
        slot occupancy plus live-replica count, so a remote prefill host
        can price THIS pool as a decode target (``free`` slots) and the
        pod autoscaler can weigh its pressure by real capacity. Everything
        here is gauge-grade — stale by one pod tick by design."""
        slots, active, queued = self.stats()
        return {
            "slots": slots,
            "active": active,
            "queued": queued,
            "free": max(0, slots - active),
            "live": self.fleet_stats()["size"],
        }

    def replica_stats(self) -> list:
        """Per-replica routing/breaker snapshot for /metrics: inflight,
        queue depth, breaker state (numeric: 0 closed / 1 half-open /
        2 open), drain lifecycle. Queue depths come from each replica's own
        stats() OUTSIDE our lock (see _queue_depths)."""
        with self._lock:
            now = self._clock()
            reps = list(self.replicas)
            snap = []
            for j in range(len(reps)):
                state = self._breaker_state(j, now)
                snap.append({
                    "replica": j,
                    "role": self.role,
                    "inflight": self._inflight[j],
                    "breaker": state,
                    "breaker_state":
                        {"closed": 0, "half_open": 1, "open": 2}[state],
                    "draining": self._draining[j],
                    "retired": self._retired[j],
                })
        for j, r in enumerate(reps):
            q = 0
            if not snap[j]["retired"] and hasattr(r, "stats"):
                try:
                    _, _, q = r.stats()
                except Exception:  # noqa: BLE001 — gauge, not a contract
                    q = 0
            snap[j]["queue_depth"] = q
            # cross-replica shared weights (weights.WeightStore): which
            # replicas alias a resident tree vs own a private copy
            snap[j]["weights_shared"] = bool(
                getattr(r, "weights_shared", False)
            )
        return snap

    def fleet_stats(self) -> dict:
        """Fleet-level gauges: live size, retirements, autoscale event
        counts, and routing-cache occupancy/hits."""
        with self._lock:
            total = len(self.replicas)
            live = total - sum(self._retired)
            return {
                "role": self.role,
                "size": live,
                "total": total,
                "retired": sum(self._retired),
                "draining": sum(self._draining),
                "autoscale_events": dict(self.autoscale_events),
                "sticky_sessions": len(self._sticky),
                "affinity_entries": len(self._affinity),
                "affinity_hits": self.route_affinity_hits,
                "sticky_hits": self.route_sticky_hits,
                "store_hits": self.route_store_hits,
                "weights_shared": sum(
                    1 for j, r in enumerate(self.replicas)
                    if not self._retired[j]
                    and getattr(r, "weights_shared", False)
                ),
            }

    def page_stats(self):
        with self._lock:
            reps = list(self.replicas)
        totals = [r.page_stats() for r in reps if hasattr(r, "page_stats")]
        totals = [t for t in totals if t is not None]
        if not totals:
            return None
        return tuple(sum(col) for col in zip(*totals))

    def resilience_stats(self) -> dict:
        """Deadline/shedding/migration counters summed across replica
        batchers, plus the dispatcher's own drain/re-placement counts."""
        agg = {"timeouts": 0, "shed_queue_full": 0, "shed_deadline": 0,
               "max_queue": None, "scheduler_thread_live": True}
        summed = ("preemptions", "spills", "spill_hits", "spill_fallbacks",
                  "migrations_out", "migrations_in", "handoffs_out")
        for k in summed:
            agg[k] = 0
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            if not hasattr(r, "resilience_stats"):
                continue
            s = r.resilience_stats()
            agg["timeouts"] += s["timeouts"]
            agg["shed_queue_full"] += s["shed_queue_full"]
            agg["shed_deadline"] += s["shed_deadline"]
            for k in summed:
                agg[k] += s.get(k, 0)
            if s["max_queue"] is not None:
                agg["max_queue"] = (agg["max_queue"] or 0) + s["max_queue"]
            agg["scheduler_thread_live"] = (
                agg["scheduler_thread_live"] and s["scheduler_thread_live"]
            )
        with self._lock:
            agg["drains"] = self.drains
            agg["migrated_streams"] = self.migrated_streams
        return agg

    def latency_stats(self) -> Optional[dict]:
        """Cumulative latency histograms (ITL, queue-wait) merged across
        replica batchers — the /metrics renderer sees ONE fleet-wide
        histogram per family, not per-replica fragments. None when no
        replica keeps them (plain engines)."""
        with self._lock:
            reps = list(self.replicas)
        per = []
        for r in reps:
            fn = getattr(r, "latency_stats", None)
            if fn is None:
                continue
            s = fn()
            if s:
                per.append(s)
        if not per:
            return None
        return {k: Histogram.merge_dicts([s[k] for s in per if k in s])
                for k in set().union(*per)}

    def spill_stats(self) -> Optional[dict]:
        """KV spill/migration counters summed across replica batchers (the
        ``mst_kv_*`` gauge source when serving through a ReplicaSet), plus
        the dispatcher's crash/drain re-placement count. None when no
        replica has a paged pool."""
        with self._lock:
            reps = list(self.replicas)
        per = [
            r.spill_stats() for r in reps
            if hasattr(r, "spill_stats")
        ]
        per = [s for s in per if s is not None]
        if not per:
            return None
        agg: dict = {"enabled": any(s.get("enabled") for s in per)}
        for k in ("spills", "spill_hits", "spill_fallbacks",
                  "migrations_out", "migrations_in", "reprefill_tokens",
                  "preemptions", "budget_bytes", "bytes_in_use", "blocks",
                  "evictions", "rejects"):
            agg[k] = sum(s.get(k, 0) for s in per)
        with self._lock:
            agg["migrated_streams"] = self.migrated_streams
            agg["drains"] = self.drains
        return agg

    def spec_stats(self) -> Optional[dict]:
        """Speculation telemetry summed across replica batchers (the
        ``mst_spec_*`` gauge source when serving through a ReplicaSet).
        None when no replica speculates, so a non-speculating fleet's
        /metrics exposition stays label-free."""
        with self._lock:
            reps = list(self.replicas)
        per = [
            s for r in reps
            if hasattr(r, "spec_stats")
            for s in [r.spec_stats()]
            if s is not None
        ]
        if not per:
            return None
        agg: dict = {
            "mode": per[0].get("mode"),
            "window_max": max(s.get("window_max", 0) for s in per),
        }
        for k in ("rounds", "draft_tokens", "accepted_tokens",
                  "fallback_ticks", "replayed_tokens", "draft_faults",
                  "disabled_slots", "shed_events"):
            agg[k] = sum(s.get(k, 0) for s in per)
        agg["accept_rate"] = (
            agg["accepted_tokens"] / max(1, agg["draft_tokens"])
        )
        return agg

    def health(self) -> dict:
        """Partial-capacity health: ``draining`` while a drain is in
        progress, degraded (still serving) while at least one replica
        lives, dead only when none do. Retired replicas left the fleet on
        purpose — they don't count against ``ok``."""
        with self._lock:
            now = self._clock()
            reps = list(self.replicas)
            states = [
                self._breaker_state(j, now) for j in range(len(reps))
            ]
            consec = list(self._fails_consec)
            fails = list(self.failures)
            draining = list(self._draining)
            retired = list(self._retired)
        per, live = [], 0
        for j, r in enumerate(reps):
            entry = {"replica": j, "breaker": states[j],
                     "consecutive_failures": consec[j], "failures": fails[j]}
            if retired[j]:
                entry["state"] = "retired"
            elif draining[j]:
                entry["state"] = "draining"
            sub = r.health() if hasattr(r, "health") else None
            alive = states[j] != "open"
            if sub is not None:
                entry["engine"] = sub["status"]
                alive = alive and sub["serving"]
            if alive and not retired[j] and not draining[j]:
                live += 1
            per.append(entry)
        n = len(reps)
        expected = n - sum(retired)
        status = (
            "draining" if any(draining)
            else ("ok" if live == expected else "degraded")
        )
        out = {
            "status": status,
            "serving": live >= 1,
            "replicas_total": n,
            **({"role": self.role} if self.role is not None else {}),
            "replicas_live": live,
            "replicas_draining": sum(draining),
            "replicas_retired": sum(retired),
            "replicas": per,
        }
        # elastic-fleet surfaces (attached by fleet.FleetAutoscaler)
        ctrl, bro = self._controller, self.brownout
        if ctrl is not None:
            out["autoscaler"] = ctrl.state()
        if bro is not None:
            out["brownout"] = bro.state()
        return out

    def close(self):
        ctrl = self._controller
        if ctrl is not None:
            ctrl.stop()
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            if hasattr(r, "close"):
                r.close()
