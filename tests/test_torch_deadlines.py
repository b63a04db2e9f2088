"""The port's queue bound and deadlines in the continuous batcher against the
JAX package's batcher (the tiny config and engine of
``tests/test_torch_scheduler.py``), with the batchers' ticks run on the
test's thread and their clocks injected:

- ``estimate_retry_after`` and the ``QueueFullError`` of a full queue (its
  depth, bound and ``retry_after_s``) equal for the same queue state and
  clock;
- a queued request whose TTFT budget has gone is shed at admission with a
  ``"queue"`` timeout, counted in ``shed_deadline``;
- the TTFT, total and stall expiries at the consumer raise the same kind of
  ``RequestTimeoutError``, count one timeout, and the next tick frees the
  slot and every page;
- the copied ``Deadlines`` keeps the source's validation and stamps."""

import time

import numpy as np
import pytest

from mlx_sharding_tpu import resilience as jresilience
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu_torch import resilience, scheduler
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_scheduler import _engine, _jax_engine, models  # noqa: F401
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

PROMPT = [int(t) for t in np.random.default_rng(5).integers(1, 300, size=13)]


class Clock:
    """The monotonic clock plus a skew that the test moves, or a frozen
    time. (The JAX batcher stamps a request's deadlines on
    ``time.monotonic`` and compares them on its own clock, so the deadline
    tests skew the real clock instead of replacing it.)"""

    def __init__(self, frozen=None):
        self.skew, self.frozen = 0.0, frozen

    def __call__(self):
        return self.frozen if self.frozen is not None else time.monotonic() + self.skew


def _pair(models, clock, **kw):
    """(JAX batcher, port batcher) on the same weights and clock, their
    scheduler threads never started: ticks run on the test's thread."""
    jb = jscheduler.ContinuousBatcher(_jax_engine(models), decode_block=3, clock=clock, **kw)
    tb = ContinuousBatcher(_engine(models), decode_block=3, clock=clock, **kw)
    for b in (jb, tb):
        b._ensure_running = lambda: None
    return jb, tb


def _tick(b):
    if isinstance(b, jscheduler.ContinuousBatcher):
        return (b._tick_async if b._async else b._tick)()
    return b.run_tick()


def test_retry_after_estimate_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        now = 1000.0
        stamps = list(now - rng.random(int(rng.integers(0, 40))) * 60)
        backlog = int(rng.integers(1, 20))
        assert scheduler.estimate_retry_after(backlog, stamps, now) == \
            jscheduler.estimate_retry_after(backlog, stamps, now)


def test_full_queue_raises_the_same_retry_after_as_jax(models):
    clock = Clock(frozen=100.0)
    pair = _pair(models, clock, max_queue=2)
    errors = []
    for b in pair:
        b._finish_times.extend([90.0, 95.0, 97.5, 99.0])
        for _ in range(2):
            b.generate_step(PROMPT, max_tokens=4)
        with pytest.raises(Exception) as info:
            b.generate_step(PROMPT, max_tokens=4)
        errors.append(info.value)
        assert b._submit.qsize() == 2
    jerr, terr = errors
    assert isinstance(terr, resilience.QueueFullError)
    assert isinstance(jerr, jresilience.QueueFullError)
    assert (terr.depth, terr.max_queue, terr.retry_after_s) == \
        (jerr.depth, jerr.max_queue, jerr.retry_after_s)
    assert str(terr) == str(jerr)
    assert pair[1].resilience_stats()["shed_queue_full"] == pair[0].shed_queue_full == 1
    for b in pair:
        b.close()


@pytest.mark.parametrize("bad", [0, -1, 1.5, "4"])
def test_max_queue_validation_matches_jax(models, bad):
    with pytest.raises(ValueError) as want:
        jscheduler.ContinuousBatcher(_jax_engine(models), max_queue=bad)
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(_engine(models), max_queue=bad)
    assert str(got.value) == str(want.value)


def test_queued_request_past_its_ttft_is_shed(models):
    clock = Clock()
    for b in _pair(models, clock):
        stream = b.generate_step(PROMPT, max_tokens=4, ttft_timeout=5.0)
        b._drain_submissions()
        clock.skew = 10.0
        b._admit_waiting()
        assert not b._waiting and all(r is None for r in b._slots)
        with pytest.raises(Exception) as info:
            next(stream)
        assert type(info.value).__name__ == "RequestTimeoutError"
        assert info.value.kind == "queue" and info.value.budget_s == 5.0
        assert b.shed_deadline == 1 and b.timeouts == 0
        assert b.page_stats()[1] == 0
        clock.skew = 0.0
        b.close()


def _first_token(b, stream):
    """Tick until the request's first token is out; returns it."""
    req = next(r for r in list(b._submit.queue) + b._waiting)
    for _ in range(50):
        if not req.out.empty():
            return next(stream)
        _tick(b)
    raise AssertionError("no first token")


@pytest.mark.parametrize("kind", ["ttft", "total", "stall"])
def test_consumer_expiry_frees_the_slot_and_its_pages(models, kind):
    """``ttft``: the request holds a slot and pages (admitted, no prefill
    yet) when its TTFT budget runs out at the consumer. ``total`` and
    ``stall``: it has emitted its first tokens; the total budget runs out
    on the clock, or no token comes for the stall watchdog's 50 ms. Each
    raises that kind, counts one timeout, and the next tick reaps the
    request: its slot and every page are free again."""
    clock = Clock()
    got = []
    for b in _pair(models, clock):
        kw = {"ttft": dict(ttft_timeout=2.0), "total": dict(request_timeout=30.0),
              "stall": dict(stall_timeout=0.05)}[kind]
        stream = b.generate_step(PROMPT, max_tokens=40, **kw)
        req = list(b._submit.queue)[0]
        if kind == "ttft":
            b._drain_submissions()
            b._admit_waiting()
            assert req.slot >= 0 and b.page_stats()[1] > 0
            clock.skew = 3.0
        else:
            _first_token(b, stream)
            while not req.out.empty():
                next(stream)
            if kind == "total":
                clock.skew = 60.0
        with pytest.raises(Exception) as info:
            next(stream)
        err = info.value
        got.append((type(err).__name__, err.kind, err.budget_s, b.timeouts, b.shed_deadline))
        assert req.cancelled
        _tick(b)
        assert b.page_stats()[1] == 0 and all(r is None for r in b._slots)
        clock.skew = 0.0
        b.close()
    want_budget = {"ttft": 2.0, "total": 30.0, "stall": 0.05}[kind]
    assert got[0] == got[1] == ("RequestTimeoutError", kind, want_budget, 1, 0)


def test_stall_defaults_to_the_ttft_budget():
    for mod in (jresilience, resilience):
        d = mod.Deadlines.start(ttft_timeout=2.0, request_timeout=9.0, clock=lambda: 10.0)
        assert (d.submitted_at, d.ttft_deadline, d.total_deadline, d.stall_timeout) == \
            (10.0, 12.0, 19.0, 2.0)


@pytest.mark.parametrize("bad", [0, -1.0, True, "5"])
def test_deadline_validation_matches_the_source(bad):
    for name in ("ttft_timeout", "request_timeout", "stall_timeout"):
        with pytest.raises(ValueError) as want:
            jresilience.Deadlines.start(**{name: bad})
        with pytest.raises(ValueError) as got:
            resilience.Deadlines.start(**{name: bad})
        assert str(got.value) == str(want.value)
