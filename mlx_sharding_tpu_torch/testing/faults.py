"""Fault-injection harness (copied from ``mlx_sharding_tpu/testing/
faults.py``, standard library only; the resource ledger's ``note_acquire``
/ ``note_release`` notes on arming are left out with the ledger, slice 11).

Deterministic failure testing needs a way to *make* the steady-state
disasters happen on demand: a wedged engine tick, a replica that stalls or
errors, a multi-host exchange that never completes, a client that vanishes
mid-SSE-stream. This module plants named injection points at those sites —
``inject("<site>")`` calls that are a single dict lookup when nothing is
armed — and lets tests (or an operator, via ``MST_FAULTS``) arm them with a
delay, a gate (block until released), or an exception.

Sites wired into the serving stack:

- ``scheduler.tick``      — top of every ContinuousBatcher scheduler tick
  (arm a gate/delay here to wedge the engine mid-generation); ctx
  ``engine=id(batcher)`` (match it to target one batcher among several)
- ``scheduler.harvest``   — the harvest boundary of a dispatched decode
  block, just before THE tick sync (kill the in-flight block here to test
  that the async pipeline sheds cleanly: no wedged slots, pages returned)
- ``replica.dispatch``    — before a ReplicaSet routes a request into a
  replica; ctx ``replica=<i>`` (match to delay/fail one specific replica)
- ``multihost.exchange``  — top of every ControlPlane collective (raise
  :class:`DropExchange` to simulate a peer that never arrives)
- ``server.sse_write``    — every SSE chunk write in the HTTP layer (raise
  ``BrokenPipeError`` to kill a stream mid-generation)
- ``cache.export``        — top of every KV page-block export (preemption
  spill / drain migration; raise here to force the blockless fallback)
- ``cache.import``        — top of every KV page-block import at resume
  (raise here to force a re-prefill instead of a block re-import)
- ``cache.prefetch``      — top of ``KVPageBlock.prefetch`` (the overlapped
  host→device stage; raise here to force the counted demand-import path —
  the stream must still resume token-exact)
- ``replica.drain``       — entry of ``ReplicaSet.drain(i)``, after the
  replica is marked draining; ctx ``replica=<i>`` (kill a drain
  mid-migration to test the quarantine-and-retry path)
- ``autoscaler.tick``     — top of every FleetAutoscaler control tick
  (raise/delay here to prove a sick controller leaves the static fleet
  serving and never drops a stream)
- ``replica.spawn``       — before the autoscaler's ReplicaFactory builds
  a new replica (raise here to test scale-up failure degrading to the
  current fleet)
- ``disagg.handoff``      — the prefill→decode handoff control point in
  the DisaggCoordinator, after the first token but before the block's
  device→host copy; ctx ``n_bytes=<block payload>`` (raise here to force
  serve-in-place: the prefill pool finishes the stream itself)
- ``cache.prefix_lookup`` — top of every PrefixStore LPM probe (admission
  lookup, disagg full-hit check); ctx ``engine=id(batcher)`` or
  ``probe="covers"`` (raise here to prove a sick store degrades to plain
  prefill — the stream is never wrong and never drops)
- ``pod.handoff``         — the cross-host prefill→decode handoff control
  point in ``PodHandoff.serve_remote``, before any wire work; ctx
  ``n_bytes=<block payload>`` (raise here to force the origin's local
  plan — serve-in-place with the block intact, never a dropped stream)
- ``pod.prefix_fetch``    — top of ``PodPrefixFederation.fetch``, before
  the pod-view owner lookup; ctx ``digest=<hex>`` (raise here to prove a
  sick federation degrades to plain prefill — counted in
  ``stats()["fallbacks"]["fetch_fault"]``, the stream is never wrong and
  never drops)
- ``cache.compress``      — top of every compressed-latent KV encode and
  decode (``kv_compress.KVCompressCodec``); ctx ``op="encode"`` (raise
  to prove a faulted compressor ships the block RAW — counted, never
  lost) or ``op="decode"`` (raise to prove a faulted reconstruction
  lands on the consumer's counted re-prefill path — never a wrong or
  dropped stream)
- ``spec.draft``          — before each speculative round's draft
  proposals (n-gram lookup or draft-engine forward); ctx
  ``engine=id(batcher)`` (raise here to prove a sick draft source
  degrades THAT tick to plain decode — counted in
  ``spec_stats()["draft_faults"]``, streams stay token-exact and are
  never dropped)

Programmatic use (the fault-injection test suite)::

    from mlx_sharding_tpu_torch.testing import faults
    gate = threading.Event()
    f = faults.arm("scheduler.tick", gate=gate, after=2, times=1)
    ...            # tick 3 blocks until gate.set(); f.fired counts hits
    faults.disarm()

Env activation (``MST_FAULTS``), for wedging a live deployment::

    MST_FAULTS="scheduler.tick:delay=5:times=1,replica.dispatch:exc=runtime"

Every armed fault auto-expires after ``times`` firings (default: forever),
and gates wait at most ``GATE_MAX_WAIT_S`` so a forgotten ``gate.set()``
can never hang a suite."""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


# safety bound on gate waits: a test that forgets to release its gate gets
# a slow test, not a hung interpreter
GATE_MAX_WAIT_S = 30.0


class FaultError(RuntimeError):
    """Default exception raised by an armed fault with ``exc=True``."""


class DropExchange(Exception):
    """Raised at ``multihost.exchange`` to simulate a collective whose peer
    never arrives; ControlPlane converts it into its dead-plane path."""


_EXC_NAMES = {
    "fault": FaultError,
    "runtime": RuntimeError,
    "broken_pipe": BrokenPipeError,
    "timeout": TimeoutError,
    "drop": DropExchange,
}


@dataclass
class Fault:
    site: str
    delay: float = 0.0
    gate: Optional[threading.Event] = None
    exc: object = None  # exception instance/class, or None
    times: Optional[int] = None  # firings before auto-disarm; None = forever
    after: int = 0  # skip the first N hits (arm "on the Nth call")
    match: Optional[dict] = None  # ctx subset that must match to fire
    fired: int = 0  # observability for test assertions
    skipped: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _applies(self, ctx: dict) -> bool:
        if self.match:
            for k, v in self.match.items():
                if ctx.get(k) != v:
                    return False
        with self._lock:
            if self.times is not None and self.fired >= self.times:
                return False
            if self.skipped < self.after:
                self.skipped += 1
                return False
            self.fired += 1
            return True

    def trigger(self):
        if self.gate is not None:
            self.gate.wait(timeout=GATE_MAX_WAIT_S)
        if self.delay > 0:
            time.sleep(self.delay)
        if self.exc is not None:
            e = self.exc
            raise e() if isinstance(e, type) else e


# site -> list[Fault]; empty dict == fully disarmed (the inject fast path)
_ARMED: dict[str, list[Fault]] = {}
_ARM_LOCK = threading.Lock()

# parse-failure accounting (see _parse_env): lifetime count of MST_FAULTS
# entries that were dropped as malformed, exported to /metrics as
# ``mst_faults_malformed_total`` so a typo'd fault spec in a live
# deployment is a visible counter, not just a log line at boot
_MALFORMED = 0
# strict mode: tests (and MST_FAULTS_STRICT=1 deployments) turn the
# warning into a raise — a chaos campaign must not silently run with half
# its schedule dropped
_STRICT = False


class MalformedFaultSpec(ValueError):
    """A ``MST_FAULTS`` entry failed to parse under strict mode."""


def set_strict(enabled: bool) -> None:
    """Toggle strict parsing of fault specs (tests arm this so a typo in a
    campaign schedule fails loudly instead of quietly doing nothing)."""
    global _STRICT
    with _ARM_LOCK:
        _STRICT = bool(enabled)


def malformed_total() -> int:
    """Lifetime count of dropped-as-malformed fault specs."""
    with _ARM_LOCK:
        return _MALFORMED


def armed_sites() -> dict[str, int]:
    """Currently armed sites -> armed-fault count, for the
    ``mst_faults_armed{site}`` gauge: a fault left armed in a live
    deployment (a forgotten MST_FAULTS, a campaign that didn't disarm)
    should be visible on every scrape, not discovered during an incident."""
    with _ARM_LOCK:
        return {site: len(lst) for site, lst in _ARMED.items() if lst}


def arm(
    site: str,
    *,
    delay: float = 0.0,
    gate: Optional[threading.Event] = None,
    exc: object = None,
    times: Optional[int] = None,
    after: int = 0,
    match: Optional[dict] = None,
) -> Fault:
    """Arm a fault at ``site``; returns the Fault for assertions."""
    f = Fault(site=site, delay=delay, gate=gate, exc=exc, times=times,
              after=after, match=match)
    with _ARM_LOCK:
        _ARMED.setdefault(site, []).append(f)
    return f


def disarm(site: Optional[str] = None):
    """Disarm one site, or everything when ``site`` is None."""
    with _ARM_LOCK:
        if site is None:
            _ARMED.clear()
        else:
            _ARMED.pop(site, None)


def inject(site: str, **ctx):
    """Injection point: no-op unless a matching fault is armed at ``site``.
    May sleep (delay/gate) and/or raise (exc) per the armed fault."""
    if not _ARMED:  # fast path: nothing armed anywhere
        return
    for f in _ARMED.get(site, ()):
        if f._applies(ctx):
            try:
                # stamp the degradation on the victim request's timeline
                # and snapshot the flight recorder BEFORE the fault fires —
                # after trigger() the stack is already unwinding. Lazy
                # import: faults must stay importable from anywhere without
                # dragging the tracing module in at arm time.
                from mlx_sharding_tpu_torch import tracing

                tracing.record_fault(site)
            except Exception:  # noqa: BLE001 — tracing never blocks a fault
                pass
            f.trigger()


def _parse_env(spec: str):
    """``MST_FAULTS="site:key=val:key=val,site2:..."`` — flag-activated
    faults for wedging a live deployment without code changes."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site, kw = fields[0], {}
        try:
            for kv in fields[1:]:
                k, _, v = kv.partition("=")
                if k == "delay":
                    kw["delay"] = float(v)
                elif k == "times":
                    kw["times"] = int(v)
                elif k == "after":
                    kw["after"] = int(v)
                elif k == "exc":
                    kw["exc"] = _EXC_NAMES[v]
                elif k:
                    raise KeyError(k)  # unknown key: count it, don't guess
            arm(site, **kw)
        except (KeyError, ValueError) as e:
            global _MALFORMED
            with _ARM_LOCK:
                _MALFORMED += 1
                strict = _STRICT
            if strict:
                raise MalformedFaultSpec(
                    f"malformed MST_FAULTS entry {part!r}"
                ) from e
            # a malformed fault spec must never take down serving — faults
            # are a debugging tool, not a dependency
            import logging

            logging.getLogger(__name__).warning(
                "ignoring malformed MST_FAULTS entry %r", part
            )


if os.environ.get("MST_FAULTS_STRICT", "").lower() in ("1", "true", "yes"):
    set_strict(True)
if os.environ.get("MST_FAULTS"):
    _parse_env(os.environ["MST_FAULTS"])
