"""Per-request span tracing (copied from ``mlx_sharding_tpu/tracing.py``,
standard library only): a flight recorder of request timelines with a
Chrome ``trace_event`` export.

A :class:`RequestTrace` records typed spans (``queue_wait``,
``prefix_lookup``, ``prefill``, ``decode_tick``, ``sse_write``, the
handoff's ``handoff_export`` and ``handoff_transfer``, spill, wake,
prefetch, migration) and instant marks (``submit``, ``first_token``, ``preempt``,
``finish``). Finished traces land in a bounded ring (``--trace-buffer N``)
that serves ``GET /admin/trace/{request_id}`` and ``GET /admin/trace/dump``
as ``chrome://tracing`` JSON.

Cost contract: with ``--trace off`` (the default: the module's tracer
starts unconfigured) every site is one attribute load and one ``is None``
branch; no span object, timestamp or lock is touched. Spans never read the
card: a decode tick's span reuses the harvest's own timestamps.

Sampling: ``--trace sample`` traces one request in ``sample_n`` (a counter,
no clock and no random draw); ``--trace on`` traces all.

Post-mortems: :func:`auto_snapshot` freezes the live and ring traces into a
bounded list of snapshots; the batcher calls it when ``close()`` finds its
thread wedged and when a tick fails.

Timebase: ``time.perf_counter()`` throughout. Chrome ``ts`` values are
microseconds from the tracer's epoch, so every trace of a dump shares one
timeline.

Left out with the slices that need them: the chaos-campaign stamp of a
snapshot (the simulator, slice 11) and the lock-order ledger's notes on
``bind`` (the static-analysis tooling, slice 11).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional

from mlx_sharding_tpu_torch.utils.locks import make_lock

# the typed span vocabulary: one lane per type in the Chrome export
SPAN_TYPES = (
    "queue_wait",
    "prefix_lookup",
    "prefill",
    "handoff_export",
    "handoff_transfer",
    "handoff_import",
    "decode_tick",
    "spill",
    "wake",
    "prefetch",
    "migration",
    "sse_write",
)

# hard bound per trace: a runaway stream degrades to a truncated timeline
# (with a drop counter), never to unbounded memory
MAX_SPANS_PER_TRACE = 4096
# snapshots kept (each a frozen copy of live + ring at incident time)
MAX_SNAPSHOTS = 8


class RequestTrace:
    """One request's span timeline. Every mutation is under a leaf lock:
    spans arrive from the scheduler thread while the server thread may be
    exporting."""

    __slots__ = ("request_id", "t0", "_lock", "_spans", "_marks", "_meta",
                 "_dropped", "done")

    def __init__(self, request_id: str, t0: Optional[float] = None):
        self.request_id = str(request_id)
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self._lock = make_lock("RequestTrace._lock")
        self._spans: list = []  # (name, t0, t1, args) perf_counter seconds
        self._marks: list = []  # (name, t, args) instant events
        self._meta: dict = {}
        self._dropped = 0
        self.done = False

    # ------------------------------------------------------------ recording
    def add(self, name: str, t0: float, t1: float, **args):
        """Record a completed span with endpoints the caller measured, so
        the lock is held for the append only."""
        with self._lock:
            if len(self._spans) >= MAX_SPANS_PER_TRACE:
                self._dropped += 1
                return
            self._spans.append((name, float(t0), float(t1), args or None))

    def point(self, name: str, **args):
        """Record an instant event (first token, preemption, finish)."""
        t = time.perf_counter()
        with self._lock:
            if len(self._marks) >= MAX_SPANS_PER_TRACE:
                self._dropped += 1
                return
            self._marks.append((name, t, args or None))

    @contextlib.contextmanager
    def timed(self, name: str, **args):
        """Span context manager for sites off the tick's hot path (the
        prefix store's lookup, the KV transfer's export and import)."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add(name, t0, time.perf_counter(), **args)

    def note(self, **meta):
        """Attach request metadata (prompt tokens, max tokens)."""
        with self._lock:
            self._meta.update(meta)

    # ------------------------------------------------------------- reading
    def freeze(self) -> dict:
        """A consistent copy for snapshots and export."""
        with self._lock:
            return {
                "request_id": self.request_id,
                "t0": self.t0,
                "spans": list(self._spans),
                "marks": list(self._marks),
                "meta": dict(self._meta),
                "dropped": self._dropped,
                "done": self.done,
            }


class Tracer:
    """The flight recorder: live traces by request id, a bounded ring of
    finished traces, and frozen incident snapshots."""

    def __init__(self, *, mode: str = "off", buffer: int = 256,
                 sample_n: int = 8, profile: bool = False):
        if mode not in ("off", "sample", "on"):
            raise ValueError(f"trace mode must be off/sample/on, got {mode!r}")
        if buffer < 1:
            raise ValueError(f"trace buffer must be >= 1, got {buffer}")
        if sample_n < 1:
            raise ValueError(f"sample_n must be >= 1, got {sample_n}")
        self.mode = mode
        self.buffer = int(buffer)
        self.sample_n = int(sample_n)
        self.profile = bool(profile)
        self.epoch = time.perf_counter()  # shared timebase for dumps
        self._lock = make_lock("Tracer._lock")
        self._live: dict = {}  # request_id -> RequestTrace
        self._ring: deque = deque(maxlen=self.buffer)
        self._snapshots: list = []  # (reason, [frozen trace, ...])
        self._seq = 0  # begin() calls (the sampling base)
        self._started = 0  # traces actually created

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    # ----------------------------------------------------------- lifecycle
    def begin(self, request_id: Optional[str] = None) -> Optional[RequestTrace]:
        """Start tracing one request; None when off or not sampled, and
        every site downstream then short-circuits on the None check."""
        if self.mode == "off":
            return None
        with self._lock:
            self._seq += 1
            if self.mode == "sample" and (self._seq - 1) % self.sample_n:
                return None
            if request_id is None:
                request_id = f"req-{self._seq}"
            tr = RequestTrace(request_id)
            self._live[tr.request_id] = tr
            self._started += 1
            return tr

    def finish(self, tr: Optional[RequestTrace]):
        """Retire a trace into the ring (None is accepted)."""
        if tr is None:
            return
        with tr._lock:
            tr.done = True
        with self._lock:
            self._live.pop(tr.request_id, None)
            self._ring.append(tr)

    # ------------------------------------------------------------- reading
    def get(self, request_id: str) -> Optional[dict]:
        """The frozen trace of ``request_id`` from the live table, the ring
        or the snapshots (newest first)."""
        with self._lock:
            tr = self._live.get(request_id)
            ring = list(self._ring)
            snaps = list(self._snapshots)
        if tr is not None:
            return tr.freeze()
        for cand in reversed(ring):
            if cand.request_id == request_id:
                return cand.freeze()
        for _, frozen in reversed(snaps):
            for f in frozen:
                if f["request_id"] == request_id:
                    return f
        return None

    def dump(self) -> list:
        """Frozen copies of every ring and live trace (oldest first)."""
        with self._lock:
            traces = list(self._ring) + list(self._live.values())
        return [t.freeze() for t in traces]

    def snapshot(self, reason: str) -> dict:
        """Freeze the recorder for a post-mortem under ``reason`` (``wedge:
        scheduler``, ``scheduler_fail``); the originals keep recording."""
        frozen = self.dump()
        with self._lock:
            self._snapshots.append((reason, frozen))
            while len(self._snapshots) > MAX_SNAPSHOTS:
                self._snapshots.pop(0)
        return {"reason": reason, "traces": frozen}

    def snapshots(self) -> list:
        with self._lock:
            snaps = list(self._snapshots)
        return [{"reason": r, "traces": f} for r, f in snaps]

    def stats(self) -> dict:
        with self._lock:
            return {
                "mode": self.mode,
                "buffer": self.buffer,
                "sample_n": self.sample_n,
                "profile": self.profile,
                "live": len(self._live),
                "ring": len(self._ring),
                "snapshots": len(self._snapshots),
                "begun": self._seq,
                "sampled": self._started,
            }

    # -------------------------------------------------------------- export
    def export_request(self, request_id: str) -> Optional[dict]:
        frozen = self.get(request_id)
        if frozen is None:
            return None
        return chrome_trace([frozen], epoch=self.epoch)

    def export_dump(self) -> dict:
        out = chrome_trace(self.dump(), epoch=self.epoch)
        with self._lock:
            snaps = list(self._snapshots)
        out["snapshots"] = [{"reason": r, "requests": [f["request_id"] for f in frozen]}
                            for r, frozen in snaps]
        return out


# --------------------------------------------------------- chrome export
def _lane(name: str) -> int:
    """A stable tid per span type, so every request renders the same lanes."""
    try:
        return SPAN_TYPES.index(name) + 1
    except ValueError:
        return len(SPAN_TYPES) + 1


def chrome_trace(frozen_traces: list, *, epoch: float) -> dict:
    """Chrome ``trace_event`` JSON (``chrome://tracing``, Perfetto): one
    process per request, one thread lane per span type, ``ts``/``dur`` in
    microseconds from ``epoch``."""
    events = []
    for pid, f in enumerate(frozen_traces, start=1):
        rid = f["request_id"]
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"request {rid}"},
        })
        for lane_name in SPAN_TYPES:
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": _lane(lane_name), "args": {"name": lane_name},
            })
        for name, t0, t1, args in f["spans"]:
            events.append({
                "name": name, "ph": "X", "cat": "request",
                "ts": round((t0 - epoch) * 1e6, 1),
                "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                "pid": pid, "tid": _lane(name),
                "args": dict(args or {}, request_id=rid),
            })
        for name, t, args in f["marks"]:
            events.append({
                "name": name, "ph": "i", "s": "p", "cat": "request",
                "ts": round((t - epoch) * 1e6, 1),
                "pid": pid, "tid": _lane(name.split(":", 1)[0]),
                "args": dict(args or {}, request_id=rid),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------- module-level wiring
_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()
_TLS = threading.local()


def configure(mode: str = "off", *, buffer: int = 256, sample_n: int = 8,
              profile: bool = False) -> Tracer:
    """Install the process-wide tracer (``--trace``, ``--trace-buffer``,
    ``--trace-sample``, ``--trace-profile``), replacing any earlier one."""
    global _TRACER
    t = Tracer(mode=mode, buffer=buffer, sample_n=sample_n, profile=profile)
    with _TRACER_LOCK:
        _TRACER = t
    return t


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def begin(request_id: Optional[str] = None) -> Optional[RequestTrace]:
    """Start a trace on the process tracer (None when off)."""
    t = _TRACER
    if t is None:
        return None
    return t.begin(request_id)


def finish(tr: Optional[RequestTrace]):
    t = _TRACER
    if t is not None:
        t.finish(tr)


# ------------------------------------------------------ thread-local bind
def current() -> Optional[RequestTrace]:
    """The trace bound to the calling thread (see :class:`bind`)."""
    return getattr(_TLS, "trace", None)


class bind:
    """Bind ``tr`` (possibly None) to the calling thread for a region, so
    leaf code can stamp the right request through :func:`current`."""

    __slots__ = ("_tr", "_prev")

    def __init__(self, tr: Optional[RequestTrace]):
        self._tr = tr

    def __enter__(self):
        self._prev = getattr(_TLS, "trace", None)
        _TLS.trace = self._tr
        return self._tr

    def __exit__(self, *exc):
        _TLS.trace = self._prev
        return False


# ------------------------------------------------------------ post-mortem
def auto_snapshot(reason: str):
    """Freeze the flight recorder on an incident; a no-op when off."""
    t = _TRACER
    if t is not None and t.enabled:
        try:
            t.snapshot(reason)
        except Exception:  # noqa: BLE001 — a sick recorder must never worsen an incident
            pass


def record_fault(site: str):
    """Stamp the bound request's timeline with a fault that fired at
    ``site``, then snapshot."""
    tr = current()
    if tr is not None:
        tr.point(f"fault:{site}", site=site)
    auto_snapshot(f"fault:{site}")


# -------------------------------------------------- profiler bridging
def profile_enabled() -> bool:
    t = _TRACER
    return bool(t is not None and t.enabled and t.profile)


def profile_span(name: str):
    """A ``torch.profiler.record_function`` range around a decode block
    (``--trace-profile``), so host spans line up with the card's kernels in
    a ``--profile-dir`` capture."""
    from torch.profiler import record_function

    return record_function(name)
