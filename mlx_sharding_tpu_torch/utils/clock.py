"""Injectable time sources (copied from ``mlx_sharding_tpu/utils/clock.py``,
standard library only): the one place serving code gets "now" from.

Every controller in the stack (breakers, the drain's unwind loop, request
deadlines) does arithmetic on a monotonic "now". Production code takes
``clock: Clock = MONOTONIC`` (and, where it also waits, ``sleep: SleepFn =
WALL_SLEEP``) and never calls ``time.monotonic()`` / ``time.sleep()``
directly on a deadline path; tests inject a hand-stepped fake
(:class:`VirtualClock`).
"""

from __future__ import annotations

import time
from typing import Callable, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """A zero-arg callable returning monotonic seconds. ``time.monotonic``
    satisfies it; so does :class:`VirtualClock` and every test FakeClock."""

    def __call__(self) -> float: ...


# the production defaults, importable by name so call sites read as intent
# ("this is the injectable slot, wired to the real clock") rather than as
# one more ad-hoc time.monotonic reference
MONOTONIC: Callable[[], float] = time.monotonic
WALL_SLEEP: Callable[[float], None] = time.sleep

SleepFn = Callable[[float], None]


class VirtualClock:
    """A monotonic clock that only moves when told to.

    Callable (so it drops into any ``clock=`` slot) and explicitly
    steppable. ``advance``/``set`` enforce monotonicity — simulated time
    never runs backward, exactly like the clock it stands in for."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt!r}")
        self._now += dt
        return self._now

    def set(self, t: float) -> float:
        """Jump to absolute time ``t`` (no-op when ``t`` is in the past —
        the event loop may deliver same-timestamp events in sequence)."""
        if t > self._now:
            self._now = float(t)
        return self._now

    def __repr__(self) -> str:
        return f"VirtualClock(t={self._now:.6f})"
