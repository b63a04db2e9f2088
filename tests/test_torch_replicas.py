"""The port's replica set (``replicas.py``) and the batcher's drain movers
against the JAX package's, on the CPU.

Dispatcher cases (``tests/test_replicas.py``, the replica cases of
``tests/test_resilience.py`` and the stub cases of
``tests/test_kv_transfer.py``) run the same scripted fake replicas through
both packages' ``ReplicaSet`` on a virtual clock and compare everything
the sets report: routing (least-loaded, ties, session stickiness, prefix
affinity and its imbalance escape, the tight-TTFT rule), the breaker (open,
half-open probe, a failed probe, recovery, ``replica.dispatch``),
``ReplicasUnavailableError``, the error classes, re-placement of a migrated
and of a crashed stream, the drain (validation, retirement, the
``replica.drain`` fault's quarantine and a retry) and every stats surface.

Real batchers (the tiny f32 Llama of ``tests/test_torch_scheduler.py``,
paged, two replicas of two slots): a drain of replica 0 while a greedy
stream decodes moves it with its block, token-exact and equal to the same
drain through JAX's replica set and to the undrained run, with JAX's
migration counters; with ``cache.export`` armed the drain degrades to a
blockless resume, still exact; a parked (cold-spilled) stream's state
migrates with its tokens, as JAX's does.

Left out: several devices per replica (private slices) and the pod (later
slices); the autoscaler and brownout are in ``tests/test_torch_fleet.py``,
the disaggregated pools in ``tests/test_torch_disagg.py``."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import resilience as jres
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu.utils.clock import VirtualClock as JClock
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch import resilience as tres
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults as tfaults
from mlx_sharding_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_scheduler import models  # noqa: F401

ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
PACKAGES = {
    "jax": (jreplicas, jres, jfaults, JClock),
    "port": (treplicas, tres, tfaults, VirtualClock),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    tfaults.disarm()
    jfaults.disarm()


# ------------------------------------------------------------------ fakes
class Stub:
    """A scriptable replica: fails on demand with ``exc``, resumes a
    migrated stream from its ``produced`` offset, and reports fixed stats."""

    concurrent = True
    supports_deadlines = True
    supports_resume = True

    def __init__(self, res, script=(1, 2, 3, 4, 5), stats=(2, 0, 0)):
        self.res = res
        self.script = list(script)
        self.fail = False
        self.exc = RuntimeError("injected replica crash")
        self.calls = 0
        self.resumes = []
        self._stats = stats
        self.migrations = 0
        self.closed = False
        self.weights_shared = True

    def generate_step(self, prompt_tokens, _resume=None, **kw):
        self.calls += 1
        self.resumes.append(None if _resume is None else (_resume.produced,
                                                         list(_resume.history)))
        if self.fail:
            raise self.exc
        start = _resume.produced if _resume is not None else 0
        yield from [(t, None) for t in self.script[start:]]

    def migrate_out(self, deadline=30.0):
        self.migrations += 1
        return 2

    def close(self):
        self.closed = True

    def stats(self):
        return self._stats

    def page_stats(self):
        return (10, 4, 6)

    def resilience_stats(self):
        return {"timeouts": 1, "shed_queue_full": 2, "shed_deadline": 3, "max_queue": 4,
                "scheduler_thread_live": True, "preemptions": 1, "spills": 2,
                "spill_hits": 1, "spill_fallbacks": 0, "migrations_out": 1,
                "migrations_in": 2}

    def latency_stats(self):
        return {"itl": {"bounds": [0.1, 1.0], "counts": [1, 2, 3], "sum": 4.5, "count": 6}}

    def spill_stats(self):
        return {"enabled": True, "spills": 2, "spill_hits": 1, "spill_fallbacks": 0,
                "migrations_out": 1, "migrations_in": 2, "reprefill_tokens": 7,
                "preemptions": 1, "budget_bytes": 100, "bytes_in_use": 10, "blocks": 1,
                "evictions": 0, "rejects": 0}

    def spec_stats(self):
        return {"mode": "ngram", "window_max": 8, "rounds": 4, "draft_tokens": 8,
                "accepted_tokens": 6}

    def health(self):
        return {"status": "ok", "serving": True}


class Migrating(Stub):
    """Emits two tokens, then ends the stream the way a draining batcher
    does."""

    def generate_step(self, prompt_tokens, _resume=None, **kw):
        self.calls += 1
        yield (1, None)
        yield (2, None)
        raise self.res.RequestMigratedError(self.res.ResumeState(
            prompt=np.asarray(prompt_tokens, np.int32), history=[1, 2], produced=2))


class Crashing(Stub):
    """Emits two tokens, then dies (no migration protocol)."""

    supports_resume = False

    def generate_step(self, prompt_tokens, _resume=None, **kw):
        self.calls += 1
        yield (1, None)
        yield (2, None)
        raise RuntimeError("replica died mid-stream")


def _both(scenario):
    """Run ``scenario(package modules)`` for the JAX package and the port;
    their records must be equal."""
    records = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert records["port"] == records["jax"]
    return records["port"]


def _toks(stream):
    return [t for t, _ in stream]


# --------------------------------------------------------------- routing
def test_routing_equals_jax():
    """Ties go to the lowest index; a held stream tips the next request to
    the idle replica; a session sticks to its replica within the imbalance
    allowance; a prompt's prefix pulls it to the replica that served the
    prefix; a tight TTFT budget takes least-loaded only."""
    def scenario(rep, res, faults, clock):
        r0, r1 = Stub(res), Stub(res)
        rs = rep.ReplicaSet([r0, r1], affinity_page=4, route_imbalance=1, clock=clock())
        rec = [_toks(rs.generate_step([1])) for _ in range(2)]
        held = rs.generate_step([1])
        next(held)
        rec.append(_toks(rs.generate_step([1])))
        rec.append(list(rs.served))
        held.close()
        prompt = list(range(12))
        held = rs.generate_step(prompt)  # on replica 0: its prefix is remembered
        next(held)
        rec.append(_toks(rs.generate_step(prompt)))  # 0 is busy, within imbalance 1
        held.close()
        rec.append(_toks(rs.generate_step([5], _session="s")))
        rec.append(_toks(rs.generate_step([6], _session="s")))
        rec.append(_toks(rs.generate_step(prompt, ttft_timeout=1.0)))
        rec += [list(rs.served), rs.route_affinity_hits, rs.route_sticky_hits,
                rs.fleet_stats(), rs.supports_deadlines, rs.supports_trace]
        return rec

    rec = _both(scenario)
    assert rec[3] == [3, 1] and rec[-5] > 0


# --------------------------------------------------------------- breaker
def test_breaker_and_unavailable_equal_jax():
    """Failures open the breaker; traffic skips the replica; past the probe
    interval one request probes it (a failing probe re-opens it, a healthy
    one closes it); every replica down raises the concrete error, then
    ``ReplicasUnavailableError`` with the earliest probe ETA; the
    ``replica.dispatch`` site fails one targeted replica."""
    def scenario(rep, res, faults, clock):
        vc = clock()
        r0, r1 = Stub(res), Stub(res)
        rs = rep.ReplicaSet([r0, r1], breaker_threshold=2, probe_interval=5.0, clock=vc,
                            sleep=vc.advance)
        r0.fail = True
        rec = [_toks(rs.generate_step([1])) for _ in range(2)]
        rec += [list(rs.failures), list(rs.breaker_opens), rs.health()]
        calls0 = r0.calls
        rec.append(_toks(rs.generate_step([1])))
        rec.append(r0.calls == calls0)
        vc.advance(6.0)
        rec.append(_toks(rs.generate_step([1])))  # the probe fails: reopened
        rec.append(rs._breaker_state(0, vc()))
        vc.advance(6.0)
        r0.fail = False
        rec.append(_toks(rs.generate_step([1])))  # the probe succeeds
        rec += [rs.health(), rs.replica_stats()]
        r0.fail = r1.fail = True
        with pytest.raises(RuntimeError, match="injected replica crash"):
            list(rs.generate_step([1]))
        rec.append(list(rs.failures))
        try:
            list(rs.generate_step([1]))
        except RuntimeError as e:  # the concrete failure, or no replica at all
            rec.append((type(e).__name__, getattr(e, "retry_after_s", None)))
        r0.fail = r1.fail = False
        vc.advance(6.0)
        rec.append(_toks(rs.generate_step([1])))
        faults.arm("replica.dispatch", exc=RuntimeError("dispatch fault"),
                   match={"replica": 1})
        rs2 = rep.ReplicaSet([Stub(res), Stub(res)], breaker_threshold=1, probe_interval=60,
                             clock=vc)
        held = rs2.generate_step([1])
        next(held)
        rec.append(_toks(rs2.generate_step([1])))  # routed to 1, fails, served by 0
        held.close()
        rec += [list(rs2.failures), rs2.health()["status"], rs2.health()["replicas_live"]]
        faults.disarm()
        return rec

    rec = _both(scenario)
    assert rec[2] == [2, 0] and rec[-2] == "degraded"


def test_error_classes_equal_jax():
    """Queue-full and draining retry elsewhere without a strike; a bad
    request raises at once; TTFT and queue expiries take no strike, stall
    and total ones do; a probe's ticket comes back on every exit."""
    def scenario(rep, res, faults, clock):
        r0, r1 = Stub(res), Stub(res)
        rs = rep.ReplicaSet([r0, r1], clock=clock())
        r0.fail, r0.exc = True, res.QueueFullError(4, 4)
        rec = [_toks(rs.generate_step([1])), list(rs.failures)]
        r0.exc = res.ReplicaDrainingError()
        rec.append(_toks(rs.generate_step([1])))
        r1.fail, r1.exc = True, res.QueueFullError(4, 4)
        with pytest.raises(res.QueueFullError):
            list(rs.generate_step([1]))
        r0.exc, r1.fail = ValueError("empty prompt"), False
        calls1 = r1.calls
        with pytest.raises(ValueError):
            list(rs.generate_step([1]))
        rec.append(r1.calls == calls1)
        for kind in ("ttft", "queue", "stall", "total"):
            r0.exc = res.RequestTimeoutError(kind, 1.0, 1.0)
            with pytest.raises(res.RequestTimeoutError):
                list(rs.generate_step([1]))
            rec.append((kind, list(rs.failures)))
        rec.append(list(rs._probing))
        return rec

    _both(scenario)


# ------------------------------------------------------ re-placement, drain
def test_replacement_and_drain_equal_jax():
    """A migrated stream is re-placed seamlessly (no strike); a crashed one
    is rebuilt from the dispatcher's delivered tokens (a strike), or raised
    with resume off; the drain retires a replica (validation, idempotent
    re-drain, the last live replica kept, ``on_retire``); an armed
    ``replica.drain`` quarantines the replica and a retry completes."""
    def scenario(rep, res, faults, clock):
        rec = []
        r1 = Stub(res)
        rs = rep.ReplicaSet([Migrating(res), r1], clock=clock())
        rec += [_toks(rs.generate_step([9, 9])), r1.resumes, rs.migrated_streams,
                list(rs.failures)]
        r1 = Stub(res)
        rs = rep.ReplicaSet([Crashing(res), r1], clock=clock())
        rec += [_toks(rs.generate_step([9, 9])), r1.resumes, list(rs.failures),
                rs.migrated_streams]
        rs = rep.ReplicaSet([Crashing(res), Stub(res)], resume_streams=False, clock=clock())
        with pytest.raises(RuntimeError, match="died mid-stream"):
            list(rs.generate_step([9, 9]))
        vc = clock()
        r0, r1 = Stub(res), Stub(res)
        rs = rep.ReplicaSet([r0, r1], clock=vc, sleep=vc.advance)
        retired = []
        rs.on_retire = retired.append
        faults.arm("replica.drain", exc=RuntimeError("drain fault"), times=1)
        with pytest.raises(RuntimeError, match="drain fault"):
            rs.drain(0)
        rec += [r0.closed, rs.drains, rs.health()]
        rec.append(_toks(rs.generate_step([5])))  # quarantined: replica 1 serves
        rec.append(rs.drain(0))
        rec += [r0.closed, r0.migrations, rs.drains, retired == [r0], rs.health()]
        rec.append(rs.drain(0))
        for bad in (1, 7, True):
            with pytest.raises(ValueError) as e:
                rs.drain(bad)
            rec.append(str(e.value))
        return rec

    rec = _both(scenario)
    assert rec[0] == [1, 2, 3, 4, 5] and rec[1] == [(2, [1, 2])]


def test_stats_surfaces_equal_jax():
    """stats, page_stats, pool_load, replica_stats, fleet_stats,
    resilience_stats, latency_stats (histograms merged), spill_stats,
    spec_stats and health over stub replicas, with a replica added, an
    autoscale event and a drain; ``set_pressure`` reaches each replica."""
    def scenario(rep, res, faults, clock):
        vc = clock()
        reps = [Stub(res, stats=(2, 1, 3)), Stub(res, stats=(2, 0, 1))]
        rs = rep.ReplicaSet(reps, clock=vc, sleep=vc.advance)
        pressures = []
        extra = Stub(res, stats=(4, 2, 0))
        extra.set_pressure = pressures.append
        rec = [rs.add_replica(extra)]
        rs.record_autoscale_event("spawn")
        rs.set_pressure(2)
        rs.drain(1)
        for name in ("stats", "page_stats", "pool_load", "replica_stats", "fleet_stats",
                     "resilience_stats", "latency_stats", "spill_stats", "spec_stats",
                     "health"):
            rec.append((name, getattr(rs, name)()))
        rec.append(pressures)
        rs.close()
        rec.append([r.closed for r in reps + [extra]])
        return rec

    _both(scenario)


# ---------------------------------------------------------- real batchers
def _jax_pair(models):
    jm, params, _ = models
    import jax

    devices = jax.devices()
    reps = [jscheduler.ContinuousBatcher(
        JPipelineEngine(jm, params, make_mesh(pp=1, devices=devices[i:i + 1]),
                        cache_dtype=jnp.float32, **ENGINE), decode_block=3)
        for i in range(2)]
    return jreplicas.ReplicaSet(reps)


def _port_pair(models, **kw):
    return treplicas.ReplicaSet([
        ContinuousBatcher(PipelineEngine(models[2], device="cpu", **ENGINE), decode_block=3,
                          **kw) for _ in range(2)])


def _drive_drain(rs, prompt, max_tokens, arm=None):
    """One greedy stream on replica 0; once its first tokens arrived,
    replica 0 is drained (with ``arm`` armed for the drain). Returns the
    stream and the drain's result."""
    toks, err = [], []
    started = threading.Event()

    def consume():
        try:
            for t, _ in rs.generate_step(prompt, max_tokens=max_tokens):
                toks.append(t)
                if len(toks) >= 3:
                    started.set()
        except Exception as e:  # noqa: BLE001 — asserted below
            err.append(e)
            started.set()

    th = threading.Thread(target=consume)
    th.start()
    assert started.wait(60)
    assert rs.served[0] == 1
    if arm is not None:
        arm()
    out = rs.drain(0)
    th.join(timeout=60)
    assert not th.is_alive() and not err, err
    return toks, out


def _undrained(models, prompt, n):
    alone = ContinuousBatcher(PipelineEngine(models[2], device="cpu", **ENGINE),
                              decode_block=3)
    try:
        return _toks(alone.generate_step(prompt, max_tokens=n))
    finally:
        alone.close()


PROMPT, TOKENS = [3, 17, 42, 5, 9, 11, 2, 8, 13], 30


def test_drain_migrates_a_live_stream_like_jax(models):
    """Replica 0 drained while a greedy stream decodes: the client's stream
    is the undrained run's, token for token, in both packages; the block
    moved with it (replica 1 imported it); the drain's result, the
    migration counters and /health are JAX's; the retired batcher gives its
    pool and graphs back."""
    want = _undrained(models, PROMPT, TOKENS)
    out = {}
    for name, make in (("jax", _jax_pair), ("port", _port_pair)):
        rs = make(models)
        try:
            toks, result = _drive_drain(rs, PROMPT, TOKENS)
            r0, r1 = rs.replicas
            out[name] = (toks, result, rs.migrated_streams, rs.drains,
                         r0.resilience_stats()["migrations_out"],
                         r1.resilience_stats()["migrations_in"],
                         r0.resilience_stats()["spill_fallbacks"], rs.health()["status"],
                         rs.health()["replicas_retired"])
            if name == "port":
                assert r1.spill_stats()["spill_hits"] == 1  # imported, not re-prefilled
                assert r0.health()["status"] == "draining"
                r0.release_memory()
                assert r0.cache is None and r0.graphs is None
        finally:
            rs.close()
    assert out["port"][0] == want
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"replica": 0, "migrated": 1, "closed": True}


def test_drain_export_fault_degrades_to_a_blockless_resume(models):
    """``cache.export`` armed for the drain: the migration carries no block
    (a counted fallback), the survivor folds the history and re-prefills,
    and the stream is still the undrained run's."""
    want = _undrained(models, PROMPT, TOKENS)
    rs = _port_pair(models)
    try:
        toks, result = _drive_drain(
            rs, PROMPT, TOKENS,
            arm=lambda: tfaults.arm("cache.export", exc=tfaults.FaultError))
        r0, r1 = rs.replicas
        assert toks == want and result["migrated"] == 1
        assert r0.resilience_stats()["spill_fallbacks"] == 1
        assert r1.spill_stats()["spill_hits"] == 0 and r1.migrations_in == 1
    finally:
        rs.close()


def test_drain_migrates_parked_and_waiting_streams(models):
    """``migrate_out`` with a stream parked by cold-slot spill (its reader
    stopped), one decoding and one waiting for a slot: each stream ends
    with a ``RequestMigratedError`` whose ``ResumeState`` carries what it
    emitted (the parked one its block), and each resumes exactly on a
    fresh batcher; a new submission is refused with
    ``ReplicaDrainingError``."""
    tm = models[2]
    engine = {**ENGINE, "pool_pages": 16}
    jobs = [([3, 17, 42], 40), ([9, 4, 4, 6], 40), ([5, 5, 2], 30)]
    ref = ContinuousBatcher(PipelineEngine(tm, device="cpu", **engine), decode_block=3)
    want = [_toks(ref.generate_step(p, max_tokens=n)) for p, n in jobs]
    ref.close()
    b = ContinuousBatcher(PipelineEngine(tm, device="cpu", **engine), decode_block=3,
                          spill_bytes=64 << 20, spill_cold_after=2, async_sched="off")
    b.spill._flush_async = False
    b._ensure_running = lambda: None
    streams, reqs = [], []
    for p, n in jobs:
        streams.append(b.generate_step(p, max_tokens=n))
        reqs.append(b._submit.queue[-1])
    got = [[], [], []]

    def read(i):
        while not reqs[i].out.empty():
            got[i].append(next(streams[i])[0])

    with torch.no_grad():
        for _ in range(20):  # stream 0 is never read; stream 1 always
            b.run_tick()
            read(1)
            if b._parked:
                break
        assert b._parked and b._parked[0] is reqs[0], "the cold stream was not parked"
        with b._start_lock:
            b._migrate_requested = True
        b.run_tick()
    with pytest.raises(tres.ReplicaDrainingError):
        b.generate_step([1, 2], max_tokens=2)
    states = {}
    for i, s in enumerate(streams):
        try:
            for t, _ in s:
                got[i].append(t)
        except tres.RequestMigratedError as e:
            states[i] = e.state
    assert sorted(states) == [0, 1, 2] and b.migrations_out == 3
    assert states[0].block is not None and states[0].produced == len(got[0]) > 0
    fresh = ContinuousBatcher(PipelineEngine(tm, device="cpu", **engine), decode_block=3)
    try:
        for i, (p, n) in enumerate(jobs):
            rest = _toks(fresh.generate_step(p, max_tokens=n, _resume=states[i]))
            assert got[i] + rest == want[i], i
        assert fresh.migrations_in == 3 and fresh.spill_hits >= 1
    finally:
        fresh.close()
        b.close()
