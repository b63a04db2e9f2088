"""Elastic fleet control: autoscaler loop + overload brownout ladder
(copied from ``mlx_sharding_tpu/fleet.py``, standard library only; the
replica set and the batchers it drives are the port's).

``replicas.py`` provides the mechanisms — score-based routing,
``add_replica()``, ``drain()`` with zero dropped streams — and this module
provides the POLICY that drives them, organized around graceful
degradation: every failure path lands on a state at least as good as the
static fleet the operator configured.

Two controllers:

**BrownoutController** — a degradation ladder between "healthy" and the
429 shed. Pressure is a scalar where 1.0 ≈ the fleet exactly saturated
(``(active + queued) / slots``, plus a shed-rate kicker). Levels:

====== ==========================================================
level  degradation (cumulative)
====== ==========================================================
0      healthy — no intervention
1      cap ``max_tokens`` (long generations are the cheapest ballast),
       and pause prefix-store INSERTION (demotion exports are deferrable
       churn; serving hits stays on — hits SHED load, they don't add it)
2      … and shed speculation (draft compute goes to real tokens).
       Schedulers with an AcceptanceTracker shed per-slot, lowest
       acceptance first — streams where drafting demonstrably pays keep
       their windows; legacy fixed-K engine mode pauses globally
3      … and tighten admission to half the queue bound (shed earlier,
       shallower queues, bounded queue-wait)
====== ==========================================================

Escalation is immediate (overload must be answered now); de-escalation
steps down ONE level per ``dwell_s`` below the exit threshold, so a noisy
load signal can't make serving quality oscillate.

**FleetAutoscaler** — a background loop (or a fake-clock-driven ``tick()``
in tests) that watches the fleet's queue/shed signals and:

- spawns a replica through the pluggable ``factory`` (any zero-arg
  callable returning a replica — a ``ReplicaFactory``) after pressure has
  stayed above ``scale_up_pressure`` for ``scale_up_sustain_s``;
- drains the least-loaded replica after pressure has stayed below
  ``scale_down_pressure`` for ``scale_down_sustain_s``;
- respects ``min_replicas``/``max_replicas`` bounds and a shared
  ``cooldown_s`` between scaling actions (hysteresis: the sustain windows
  reset whenever pressure crosses back).

Failure semantics (the robustness contract): an injected or real failure
at ``replica.spawn``, ``replica.drain``, or ``autoscaler.tick`` records an
autoscale event, quarantines scaling behind the cooldown, and leaves the
CURRENT fleet serving — never a dropped stream, never a wedged loop.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.clock import MONOTONIC, Clock
from mlx_sharding_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)


def pool_pressure(slots: int, active: int, queued: int,
                  shed_delta: int) -> float:
    """Load pressure of ONE replica pool: utilization
    ``(active + queued) / slots`` plus a shed kicker (each admission shed
    since the last sample counts 0.25, saturating at +1 — a shedding pool
    is over pressure 1.0 by definition, whatever the instantaneous queue
    looks like).

    Module-level so every consumer prices load identically — and so the
    disaggregated coordinator can run one autoscaler per ROLE pool over
    that pool's own signals. Folding prefill-bound and decode-bound queues
    into one fleet-wide scalar was the bug: a prefill storm inflated the
    shared pressure and spawned decode replicas that then idled (and vice
    versa). Each pool's pressure must see only its own slots/queue/sheds."""
    return (active + queued) / max(1, slots) + min(1.0, 0.25 * shed_delta)


def aggregate_pressure(host_infos: list) -> float:
    """Pod-wide pressure: the slot-weighted mean of per-host pool
    pressures. Each entry is a host heartbeat's fleet block
    (``{"pressure": float, "slots": int, ...}``); hosts with no slots
    (draining out, just died) contribute nothing. Slot weighting matters:
    a saturated 2-slot host must not read as urgent as a saturated
    32-slot host — the pod autoscaler prices capacity, not host count."""
    num = den = 0.0
    for info in host_infos:
        slots = max(0, int(info.get("slots", 0) or 0))
        if slots <= 0:
            continue
        num += float(info.get("pressure", 0.0) or 0.0) * slots
        den += slots
    return num / den if den else 0.0


class BrownoutController:
    """Degradation ladder (see module docstring). ``observe(pressure)`` is
    the only input; the outputs are ``state()`` / the level predicates the
    server and scheduler consult per request."""

    LEVELS = 3

    def __init__(self, *, enter=(0.85, 1.25, 2.0), exit=(0.5, 0.9, 1.5),
                 caps=(512, 256, 96), dwell_s: float = 5.0,
                 clock: Clock = MONOTONIC):
        if len(enter) != self.LEVELS or len(exit) != self.LEVELS:
            raise ValueError(f"enter/exit need {self.LEVELS} thresholds")
        if len(caps) != self.LEVELS:
            raise ValueError(f"caps needs {self.LEVELS} entries")
        if any(x >= e for x, e in zip(exit, enter)):
            raise ValueError("each exit threshold must be below its enter")
        if list(enter) != sorted(enter):
            raise ValueError("enter thresholds must be non-decreasing")
        if dwell_s < 0:
            raise ValueError("dwell_s must be >= 0")
        self.enter = tuple(enter)
        self.exit = tuple(exit)
        self.caps = tuple(caps)
        self.dwell_s = dwell_s
        self.clock = clock
        self._level = 0
        self._below_since: Optional[float] = None
        self._lock = make_lock("BrownoutController._lock")

    def observe(self, pressure: float) -> int:
        """Feed one pressure sample; returns the (possibly new) level."""
        with self._lock:
            target = 0
            for k, thr in enumerate(self.enter):
                if pressure >= thr:
                    target = k + 1
            now = self.clock()
            if target > self._level:
                self._level = target  # escalate immediately
                self._below_since = None
            elif self._level > 0 and pressure <= self.exit[self._level - 1]:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.dwell_s:
                    self._level -= 1  # one rung per dwell — no oscillation
                    self._below_since = now
            else:
                self._below_since = None
            return self._level

    def level(self) -> int:
        with self._lock:
            return self._level

    def max_tokens_cap(self) -> Optional[int]:
        with self._lock:
            return self.caps[self._level - 1] if self._level > 0 else None

    def state(self) -> dict:
        with self._lock:
            lvl = self._level
            return {
                "level": lvl,
                "max_tokens_cap": self.caps[lvl - 1] if lvl > 0 else None,
                "speculation_disabled": lvl >= 2,
                # HOW level >= 2 sheds is the scheduler's call: per-slot
                # lowest-acceptance-first with an AcceptanceTracker
                # (losing streams drop their windows first), a global
                # pause in legacy fixed-K engine mode. The ladder only
                # publishes the level; this names the contract.
                "speculation_shed": (
                    "lowest-acceptance-first" if 2 <= lvl < 3
                    else "all" if lvl >= 3 else None
                ),
                "admission_tightened": lvl >= 3,
            }


class FleetAutoscaler:
    """Scale/brownout decision loop over a :class:`ReplicaSet`.

    All decision logic lives in :meth:`tick` with an injectable ``clock``,
    so hysteresis/cooldown behavior is testable without sleeping; ``start``
    merely runs ``tick`` every ``interval_s`` on a daemon thread. The
    controller attaches itself to the replica set (``attach_controller``)
    so ``rs.close()`` stops the loop and ``rs.health()`` reports
    ``autoscaler`` + ``brownout`` blocks."""

    def __init__(self, replica_set, factory: Optional[Callable] = None, *,
                 min_replicas: int = 1, max_replicas: Optional[int] = None,
                 interval_s: float = 2.0,
                 scale_up_pressure: float = 0.75,
                 scale_up_sustain_s: float = 5.0,
                 scale_down_pressure: float = 0.25,
                 scale_down_sustain_s: float = 30.0,
                 cooldown_s: float = 15.0,
                 drain_deadline_s: float = 30.0,
                 brownout: Optional[BrownoutController] = None,
                 enable_brownout: bool = True,
                 role: Optional[str] = None,
                 clock: Clock = MONOTONIC):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if scale_down_pressure >= scale_up_pressure:
            raise ValueError(
                "scale_down_pressure must be below scale_up_pressure"
            )
        if min(scale_up_sustain_s, scale_down_sustain_s, cooldown_s) < 0:
            raise ValueError("sustain/cooldown windows must be >= 0")
        self.rs = replica_set
        # which pool this controller scales; inherits the replica set's
        # role tag so one autoscaler per role pool reads (and reacts to)
        # only that pool's pressure — see pool_pressure()
        self.role = role if role is not None \
            else getattr(replica_set, "role", None)
        self.factory = factory
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = interval_s
        self.scale_up_pressure = scale_up_pressure
        self.scale_up_sustain_s = scale_up_sustain_s
        self.scale_down_pressure = scale_down_pressure
        self.scale_down_sustain_s = scale_down_sustain_s
        self.cooldown_s = cooldown_s
        self.drain_deadline_s = drain_deadline_s
        self.clock = clock
        self.brownout = (
            brownout if brownout is not None
            else (BrownoutController(clock=clock) if enable_brownout else None)
        )
        self._lock = make_lock("FleetAutoscaler._lock")
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._last_scale_at: Optional[float] = None
        self._last_shed = 0
        self._last_level = 0
        self.ticks = 0
        self.tick_errors = 0
        self.spawns = 0
        self.spawn_failures = 0
        self.last_spawn_s = None  # wall time of the last factory() call —
        # the aliased-vs-full-reload A/B number shared weights exist to move
        self.drains = 0
        self.drain_failures = 0
        self.degraded = False  # last scale action failed → static fleet
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        replica_set.attach_controller(self)

    # ------------------------------------------------------------ signals
    def _signals(self) -> tuple:
        """(slots, active, queued, shed_total, live) — everything the
        decision needs, gathered BEFORE our lock (each accessor takes the
        replica set's / batchers' own locks)."""
        slots, active, queued = self.rs.stats()
        res = self.rs.resilience_stats()
        shed = res.get("shed_queue_full", 0) + res.get("shed_deadline", 0)
        fleet = self.rs.fleet_stats()
        return slots, active, queued, shed, fleet["size"]

    def _pick_drain_victim(self) -> Optional[int]:
        """Least-loaded live replica; ties to the HIGHEST index so the
        newest spawn retires first (its cache is the coldest)."""
        per = self.rs.replica_stats()
        cands = [
            p for p in per if not p["retired"] and not p["draining"]
        ]
        if len(cands) <= 1:
            return None
        return min(
            cands, key=lambda p: (p["inflight"] + p["queue_depth"],
                                  -p["replica"])
        )["replica"]

    # ----------------------------------------------------------- decision
    def tick(self) -> dict:
        """One control decision. Returns what it observed and did (tests
        and ``/admin/autoscaler`` read it). Never raises: any failure —
        including an injected ``autoscaler.tick`` fault — degrades to the
        static fleet and is recorded as an autoscale event."""
        now = self.clock()
        try:
            inject("autoscaler.tick")
            slots, active, queued, shed, live = self._signals()
        except Exception:  # noqa: BLE001 — a sick controller must not serve
            logger.exception("autoscaler tick failed; fleet left as-is")
            with self._lock:
                self.tick_errors += 1
            self.rs.record_autoscale_event("tick_error")
            return {"error": True}
        max_reps = self.max_replicas if self.max_replicas is not None else live
        action = None
        with self._lock:
            self.ticks += 1
            shed_delta = max(0, shed - self._last_shed)
            self._last_shed = shed
            # THIS pool's pressure only (see pool_pressure): slots/queue/
            # sheds all come from self.rs, so a storm on the other role's
            # pool can't trigger spawns here
            pressure = pool_pressure(slots, active, queued, shed_delta)
            in_cooldown = (
                self._last_scale_at is not None
                and now - self._last_scale_at < self.cooldown_s
            )
            if (pressure >= self.scale_up_pressure
                    and self.factory is not None and live < max_reps):
                if self._up_since is None:
                    self._up_since = now
                if (now - self._up_since >= self.scale_up_sustain_s
                        and not in_cooldown):
                    action = "spawn"
            else:
                self._up_since = None
            if (action is None and pressure <= self.scale_down_pressure
                    and live > self.min_replicas):
                if self._down_since is None:
                    self._down_since = now
                if (now - self._down_since >= self.scale_down_sustain_s
                        and not in_cooldown):
                    action = "drain"
            elif action is None:
                self._down_since = None
        out = {"pressure": round(pressure, 3), "live": live,
               "action": action, "brownout": 0}
        if self.brownout is not None:
            level = self.brownout.observe(pressure)
            out["brownout"] = level
            with self._lock:
                changed, self._last_level = level != self._last_level, level
            if changed:
                self.rs.set_pressure(level)
                self.rs.record_autoscale_event(f"brownout_level_{level}")
        if action == "spawn":
            out["action"] = self._spawn(now)
        elif action == "drain":
            out["action"] = self._drain(now)
        return out

    def _spawn(self, now: float) -> str:
        try:
            inject("replica.spawn")
            t0 = self.clock()
            rep = self.factory()
            spawn_s = self.clock() - t0
            if rep is None:
                raise RuntimeError("replica factory returned None")
        except Exception:  # noqa: BLE001 — degrade to the static fleet
            logger.exception(
                "replica spawn failed; serving continues on the current "
                "fleet (retry after cooldown)"
            )
            with self._lock:
                self.spawn_failures += 1
                self.degraded = True
                self._last_scale_at = now  # quarantine behind the cooldown
                self._up_since = None
            self.rs.record_autoscale_event("spawn_failed")
            return "spawn_failed"
        idx = self.rs.add_replica(rep)
        with self._lock:
            self.spawns += 1
            self.last_spawn_s = spawn_s
            self.degraded = False
            self._last_scale_at = now
            self._up_since = None
        self.rs.record_autoscale_event("spawn")
        logger.info("autoscaler (%s) spawned replica %d",
                    self.role or "fleet", idx)
        return "spawn"

    def _drain(self, now: float) -> str:
        victim = self._pick_drain_victim()
        if victim is None:
            with self._lock:
                self._down_since = None
            return "drain_skipped"
        try:
            self.rs.drain(victim, deadline=self.drain_deadline_s)
        except Exception:  # noqa: BLE001 — quarantined, streams intact
            logger.exception(
                "autoscaler drain of replica %d failed; replica stays "
                "quarantined (retry after cooldown)", victim,
            )
            with self._lock:
                self.drain_failures += 1
                self.degraded = True
                self._last_scale_at = now
                self._down_since = None
            self.rs.record_autoscale_event("drain_failed")
            return "drain_failed"
        with self._lock:
            self.drains += 1
            self.degraded = False
            self._last_scale_at = now
            self._down_since = None
        self.rs.record_autoscale_event("drain")
        logger.info("autoscaler (%s) drained replica %d",
                    self.role or "fleet", victim)
        return "drain"

    # ------------------------------------------------------- pod surface
    def pressure(self) -> float:
        """Instantaneous pool pressure for the pod heartbeat — the same
        :func:`pool_pressure` the decision loop prices, sampled without
        touching the shed-delta bookkeeping (``tick()`` owns that)."""
        slots, active, queued = self.rs.stats()
        return pool_pressure(slots, active, queued, 0)

    def headroom(self) -> dict:
        """How much THIS host's pool can still grow/shrink — the pod
        autoscaler's per-host entry in the pod-wide free list."""
        live = self.rs.fleet_stats()["size"]
        max_reps = self.max_replicas if self.max_replicas is not None else live
        return {
            "live": live,
            "spawnable": max(0, max_reps - live) if self.factory else 0,
            "drainable": max(0, live - self.min_replicas),
        }

    def spawn_one(self) -> str:
        """Pod-autoscaler nudge: spawn now if bounds allow, with the same
        failure quarantine as an organic scale-up. Returns the action
        string (``spawn`` / ``spawn_failed`` / ``spawn_skipped``)."""
        now = self.clock()
        live = self.rs.fleet_stats()["size"]
        max_reps = self.max_replicas if self.max_replicas is not None else live
        if self.factory is None or live >= max_reps:
            return "spawn_skipped"
        return self._spawn(now)

    def drain_one(self) -> str:
        """Pod-autoscaler nudge: drain the least-loaded replica if bounds
        allow (``drain`` / ``drain_failed`` / ``drain_skipped``)."""
        now = self.clock()
        if self.rs.fleet_stats()["size"] <= self.min_replicas:
            return "drain_skipped"
        return self._drain(now)

    # --------------------------------------------------------- loop/state
    def start(self):
        """Run ``tick()`` every ``interval_s`` on a daemon thread (no-op if
        already running)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop_evt.clear()
            t = threading.Thread(
                target=self._run, name="mst-autoscaler", daemon=True
            )
            self._thread = t
        t.start()

    def _run(self):
        while not self._stop_evt.wait(self.interval_s):
            self.tick()

    def stop(self):
        with self._lock:
            self._stop_evt.set()
            t, self._thread = self._thread, None
        if t is not None:  # join OUTSIDE the lock: the loop thread's tick()
            t.join(timeout=10.0)  # takes _lock and must be able to finish

    def state(self) -> dict:
        with self._lock:
            return {
                "running": self._thread is not None,
                **({"role": self.role} if self.role is not None else {}),
                "ticks": self.ticks,
                "tick_errors": self.tick_errors,
                "spawns": self.spawns,
                "spawn_failures": self.spawn_failures,
                "last_spawn_s": self.last_spawn_s,
                "drains": self.drains,
                "drain_failures": self.drain_failures,
                "degraded": self.degraded,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "cooldown_s": self.cooldown_s,
            }
