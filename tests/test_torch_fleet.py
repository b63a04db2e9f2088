"""The port's fleet controller (``fleet.py``: ``BrownoutController`` and
``FleetAutoscaler``) and the batcher's brownout rungs against the JAX
package's, on the CPU.

The controller cases of ``tests/test_fleet.py`` and the autoscaler cases
of ``tests/test_weight_sharing.py`` run the same fakes on the same fake
clock through both packages' controllers and replica sets, and every
decision, level, event and ``state()`` must be equal: the ladder (immediate
escalation, one rung down per dwell, the dwell reset, validation), the
autoscaler (sustain windows, cooldown, the min and max clamps, the drain
victim, spawn, drain and tick faults, the brownout level published to the
replicas and to ``health()``, a spawn fault through ``aliased_spawn``
leaving the weight store's refs as they were, ``last_spawn_s``, the
thread loop), Retry-After, the fleet families of ``/metrics``, and the
servers' brownout cap with its headers and ``POST /admin/autoscaler``.

``set_pressure`` on port batchers against JAX's (the tiny f32 Llama of
``tests/test_torch_scheduler.py``): level 1 pauses the prefix store's
insertion, level 2 sheds speculation lowest-acceptance-first with a
tracker and pauses a fixed-K draft engine, level 3 sheds it all and
halves the queue bound; the ``spec.draft`` fault site degrades one round
to a plain block, counted in ``draft_faults``, with streams equal to
JAX's. Left out: the pod autoscaler (``aggregate_pressure``'s heartbeats
come with the pod)."""

import http.client
import itertools
import json
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import fleet as jfleet
from mlx_sharding_tpu import prefix_store as jprefix
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu import weights as jweights
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu.utils import observability as jobs
from mlx_sharding_tpu_torch import fleet as tfleet
from mlx_sharding_tpu_torch import prefix_store as tprefix
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch import scheduler as tscheduler
from mlx_sharding_tpu_torch import weights as tweights
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.testing import faults as tfaults
from mlx_sharding_tpu_torch.utils import observability as tobs
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import _jax_provider
from tests.test_torch_scheduler import ENGINE, models  # noqa: F401

PACKAGES = {
    "jax": dict(fleet=jfleet, replicas=jreplicas, faults=jfaults, scheduler=jscheduler,
                obs=jobs, weights=jweights, api=japi),
    "port": dict(fleet=tfleet, replicas=treplicas, faults=tfaults, scheduler=tscheduler,
                 obs=tobs, weights=tweights, api=tapi),
}
REPEAT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    tfaults.disarm()
    jfaults.disarm()


def _both(scenario):
    """``scenario(pkg)`` through each package; the records must be equal."""
    seen = {name: scenario(pkg) for name, pkg in PACKAGES.items()}
    assert seen["port"] == seen["jax"]
    return seen["port"]


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


class _Stub:
    concurrent = True

    def __init__(self, tokens=(1, 2, 3)):
        self.tokens = list(tokens)
        self.closed = False

    def generate_step(self, prompt_tokens, **kw):
        yield from [(t, None) for t in self.tokens]

    def close(self):
        self.closed = True


class _LoadStub(_Stub):
    """Its (slots, active, queued) is set by the test: the autoscaler's
    pressure signal under full control."""

    def __init__(self):
        super().__init__()
        self.load = (1, 0, 0)
        self.pressure_seen = None

    def stats(self):
        return self.load

    def set_pressure(self, level):
        self.pressure_seen = level


def _fleet(pkg, clk, factory=None, n=2, **kw):
    reps = [_LoadStub() for _ in range(n)]
    rs = pkg["replicas"].ReplicaSet(reps)
    ctrl = pkg["fleet"].FleetAutoscaler(rs, factory, clock=clk, **kw)
    return rs, reps, ctrl


def _spawner(spawned):
    def factory():
        r = _LoadStub()
        spawned.append(r)
        return r
    return factory


# --------------------------------------------------------------- brownout
def test_brownout_escalates_immediately_steps_down_one_rung_per_dwell():
    def scenario(pkg):
        clk = FakeClock()
        b = pkg["fleet"].BrownoutController(dwell_s=5.0, clock=clk)
        out = [b.observe(0.5), b.observe(2.5), b.state(), b.observe(0.1)]
        for _ in range(3):
            clk.advance(5.0)
            out += [b.observe(0.1), b.max_tokens_cap(), b.state()]
        return out

    out = _both(scenario)
    assert out[:2] == [0, 3] and out[3] == 3 and out[-3] == 0


def test_brownout_dwell_resets_when_pressure_returns():
    def scenario(pkg):
        clk = FakeClock()
        b = pkg["fleet"].BrownoutController(dwell_s=5.0, clock=clk)
        out = [b.observe(1.0), b.observe(0.1)]
        clk.advance(4.0)
        out.append(b.observe(1.0))
        clk.advance(4.0)
        return out + [b.observe(0.1), b.level()]

    assert _both(scenario)[-1] == 1


@pytest.mark.parametrize("kw", [dict(enter=(1.0, 0.9, 2.0)), dict(exit=(0.9, 1.3, 2.1)),
                                dict(caps=(1, 2)), dict(enter=(1.0, 2.0)), dict(dwell_s=-1)],
                         ids=["enter-order", "exit-above-enter", "caps", "enter-len", "dwell"])
def test_brownout_validation(kw):
    def scenario(pkg):
        with pytest.raises(ValueError) as info:
            pkg["fleet"].BrownoutController(**kw)
        return str(info.value)

    _both(scenario)


@pytest.mark.parametrize("kw", [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                                dict(interval_s=0), dict(scale_down_pressure=0.8),
                                dict(cooldown_s=-1)],
                         ids=["min", "max-below-min", "interval", "down-above-up", "cooldown"])
def test_autoscaler_validation(kw):
    def scenario(pkg):
        with pytest.raises(ValueError) as info:
            pkg["fleet"].FleetAutoscaler(object(), **kw)
        return str(info.value)

    _both(scenario)


# ------------------------------------------------------------- autoscaler
def test_scale_up_hysteresis_cooldown_and_max_clamp():
    def scenario(pkg):
        clk, spawned = FakeClock(), []
        rs, reps, ctrl = _fleet(pkg, clk, _spawner(spawned), max_replicas=3,
                                scale_up_sustain_s=5.0, cooldown_s=20.0)
        for r in reps:
            r.load = (1, 1, 2)  # pressure 3.0
        out = [ctrl.tick()]  # the sustain window anchored
        for dt in (5.0, 5.0, 30.0):
            clk.advance(dt)
            out.append(ctrl.tick())
        return out, len(spawned), rs.fleet_stats(), ctrl.state(), ctrl.headroom()

    out, n, fleet, state, _ = _both(scenario)
    assert [o["action"] for o in out] == [None, "spawn", None, None] and n == 1
    assert fleet["size"] == 3 and fleet["autoscale_events"]["spawn"] == 1
    assert state["spawns"] == 1 and state["last_spawn_s"] == 0.0


def test_scale_down_drains_least_loaded_and_respects_min():
    def scenario(pkg):
        clk = FakeClock()
        rs, reps, ctrl = _fleet(pkg, clk, None, n=3, min_replicas=2, scale_down_sustain_s=10.0,
                                cooldown_s=0.0, drain_deadline_s=0.2)
        out = [ctrl.tick()]
        clk.advance(10.0)
        out.append(ctrl.tick())
        clk.advance(60.0)
        out.append(ctrl.tick())
        return out, [r.closed for r in reps], rs.fleet_stats()["size"], ctrl.state()

    out, closed, size, _ = _both(scenario)
    # an all-idle tie drains the highest index (the newest spawn)
    assert out[1]["action"] == "drain" and closed == [False, False, True] and size == 2


def test_spawn_failure_degrades_to_static_fleet_then_recovers():
    def scenario(pkg):
        clk, spawned = FakeClock(), []
        rs, reps, ctrl = _fleet(pkg, clk, _spawner(spawned), max_replicas=3,
                                scale_up_sustain_s=5.0, cooldown_s=20.0)
        for r in reps:
            r.load = (1, 1, 2)
        pkg["faults"].arm("replica.spawn", exc=RuntimeError, times=1)
        out = [ctrl.tick()]
        clk.advance(5.0)
        out += [ctrl.tick(), ctrl.state(), len(spawned), dict(rs.fleet_stats())]
        out.append([t for t, _ in rs.generate_step([1, 2, 3])])  # the static fleet serves
        clk.advance(25.0)
        out.append(ctrl.tick())  # re-anchors the sustain window
        clk.advance(5.0)
        out += [ctrl.tick(), ctrl.state(), len(spawned)]
        pkg["faults"].disarm()
        return out

    out = _both(scenario)
    assert out[1]["action"] == "spawn_failed" and out[2]["degraded"]
    assert out[-3]["action"] == "spawn" and not out[-2]["degraded"] and out[-1] == 1


def test_drain_failure_quarantines_and_keeps_serving():
    def scenario(pkg):
        clk = FakeClock()
        rs, reps, ctrl = _fleet(pkg, clk, None, n=3, min_replicas=1, scale_down_sustain_s=10.0,
                                cooldown_s=30.0, drain_deadline_s=0.2)
        pkg["faults"].arm("replica.drain", exc=RuntimeError, times=1)
        out = [ctrl.tick()]
        clk.advance(10.0)
        out += [ctrl.tick(), ctrl.state(), rs.fleet_stats()["autoscale_events"],
                [(p["draining"], p["retired"]) for p in rs.replica_stats()],
                [t for t, _ in rs.generate_step([1, 2, 3])]]
        pkg["faults"].disarm()
        return out

    out = _both(scenario)
    assert out[1]["action"] == "drain_failed" and out[2]["drain_failures"] == 1
    assert (True, False) in out[4]  # quarantined, not retired


def test_tick_fault_degrades_not_raises():
    def scenario(pkg):
        rs, _, ctrl = _fleet(pkg, FakeClock(), None)
        pkg["faults"].arm("autoscaler.tick", exc=RuntimeError, times=1)
        out = [ctrl.tick(), ctrl.state()["tick_errors"], rs.fleet_stats()["autoscale_events"]]
        pkg["faults"].disarm()
        return out + [ctrl.tick()]

    out = _both(scenario)
    assert out[0] == {"error": True} and "pressure" in out[-1]


def test_brownout_level_propagates_to_replicas_and_health():
    def scenario(pkg):
        rs, reps, ctrl = _fleet(pkg, FakeClock(), None)
        for r in reps:
            r.load = (1, 1, 2)  # pressure 3.0, past the top rung's entry
        out = [ctrl.tick(), [r.pressure_seen for r in reps],
               rs.fleet_stats()["autoscale_events"]]
        health = rs.health()
        return out + [health["brownout"], health["autoscaler"]]

    out = _both(scenario)
    assert out[0]["brownout"] == 3 and out[1] == [3, 3] and out[3]["level"] == 3


def test_spawn_one_drain_one_and_headroom():
    def scenario(pkg):
        clk, spawned = FakeClock(), []
        rs, _, ctrl = _fleet(pkg, clk, _spawner(spawned), max_replicas=3, cooldown_s=0.0,
                             drain_deadline_s=0.2)
        out = [ctrl.headroom(), ctrl.spawn_one(), ctrl.spawn_one(), ctrl.headroom(),
               ctrl.drain_one(), ctrl.drain_one(), ctrl.drain_one(), ctrl.pressure()]
        return out + [ctrl.state()]

    out = _both(scenario)
    assert out[1:3] == ["spawn", "spawn_skipped"] and out[4:7] == ["drain", "drain",
                                                                  "drain_skipped"]


def test_autoscaler_spawn_fault_keeps_store_consistent():
    """A replica.spawn fault through ``aliased_spawn`` degrades the
    controller to the static fleet with the store's refs as they were."""

    class _Tree:
        weight_bytes = 100

    def scenario(pkg):
        w = pkg["weights"]
        store = w.WeightStore()
        key = w.WeightKey(checkpoint="fleet", stage_bounds=(("auto", 1),), dtype="float32",
                          quant="tp1", placement="pp=1|0")
        holder = store.acquire(key, _Tree)

        def factory():
            return w.aliased_spawn(store, key, _Tree, lambda lease: (_ for _ in ()).throw(
                RuntimeError("spawn boom")))

        clk = FakeClock()
        rs, reps, ctrl = _fleet(pkg, clk, factory, max_replicas=3, scale_up_sustain_s=5.0,
                                cooldown_s=20.0)
        for r in reps:
            r.load = (1, 1, 2)
        ctrl.tick()
        clk.advance(5.0)
        out = [ctrl.tick(), ctrl.state()["degraded"], store.refs(key)]
        return out + [holder.release()]

    assert _both(scenario) == [{"pressure": 3.0, "live": 2, "action": "spawn_failed",
                                "brownout": 3}, True, 1, True]


def test_autoscaler_thread_loop_spawns_under_load():
    """The real thread: sustained pressure spawns a third replica while
    streams flow; ``stop()`` joins."""
    def scenario(pkg):
        spawned = []
        rs, reps, ctrl = _fleet(pkg, time.monotonic, _spawner(spawned), max_replicas=3,
                                interval_s=0.02, scale_up_sustain_s=0.05, cooldown_s=10.0)
        for r in reps:
            r.load = (1, 1, 2)
        ctrl.start()
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not spawned:
                time.sleep(0.01)
            out = [len(spawned), [t for t, _ in rs.generate_step([1, 2, 3])],
                   rs.fleet_stats()["size"], ctrl.state()["running"]]
        finally:
            ctrl.stop()
            rs.close()
        return out + [ctrl.state()["running"]]

    assert _both(scenario) == [1, [1, 2, 3], 3, True, False]


# ------------------------------------------------------------ retry-after
@pytest.mark.parametrize("args", [(5, [], 100.0), (5, [10.0], 100.0),
                                  (5, [90.0 + i for i in range(10)], 100.0),
                                  (1, [99.9] * 50, 100.0),
                                  (10_000, [90.0 + i for i in range(10)], 100.0)],
                         ids=["no-drain", "stale", "rate", "floor", "ceiling"])
def test_estimate_retry_after_equals_jax(args):
    _both(lambda pkg: pkg["scheduler"].estimate_retry_after(*args))


# ---------------------------------------------------------- observability
def test_metrics_render_fleet_gauges():
    def scenario(pkg):
        rs = pkg["replicas"].ReplicaSet([_Stub(), _Stub()])
        for kind in ("spawn", "spawn", "drain_failed"):
            rs.record_autoscale_event(kind)
        rs.brownout = pkg["fleet"].BrownoutController(clock=FakeClock())
        rs.brownout.observe(1.5)
        text = pkg["obs"].ServingMetrics(batcher_fn=lambda: rs).render()
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith(("mst_autoscale", "mst_brownout", "mst_fleet_size",
                                        "mst_replica_", "# TYPE mst_autoscale",
                                        "# TYPE mst_brownout")))

    lines = _both(scenario)
    assert 'mst_autoscale_events_total{kind="spawn"} 2' in lines
    assert "mst_brownout_level 2" in lines


# ------------------------------------------------------------ server glue
def _provider(name, gen):
    if name == "jax":
        return _jax_provider(gen)
    return tapi.ModelProvider(gen, ByteTokenizer(), model_name="tiny")


def _serve(pkg, provider):
    srv = pkg["api"].make_server(provider, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    headers = {k: v for k, v in resp.getheaders() if k.startswith(("X-MST-B", "X-MST-M"))}
    conn.close()
    return resp.status, headers, data


def test_server_brownout_cap_headers_and_session_forwarding():
    """The ladder at level 2 caps a 4000-token request to 256, with both
    headers; the session rides along (JAX's)."""

    class Gen:
        concurrent = True
        supports_sessions = True

        def __init__(self):
            self.kw = None

        def generate_step(self, prompt_tokens, **kw):
            self.kw = kw
            yield from [(65, None), (66, None)]

    class FakeFleet:
        def __init__(self, brownout):
            self.brownout = brownout

    seen = {}
    for name, pkg in PACKAGES.items():
        bro = pkg["fleet"].BrownoutController(clock=FakeClock())
        bro.observe(1.5)  # level 2: cap 256
        gen = Gen()
        provider = _provider(name, gen)
        provider.fleet = FakeFleet(bro)
        srv, th = _serve(pkg, provider)
        try:
            status, headers, _ = _post(srv.server_address[1], "/v1/completions",
                                       {"prompt": "hi", "max_tokens": 4000,
                                        "session_id": "alice"})
            kw = dict(gen.kw)
            # under --disagg the decode pool's ladder (the tuple's last) caps
            bro0 = pkg["fleet"].BrownoutController(clock=FakeClock())
            provider.fleet = (FakeFleet(bro0), FakeFleet(bro))
            disagg = _post(srv.server_address[1], "/v1/completions",
                           {"prompt": "hi", "max_tokens": 300})
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=30)
        seen[name] = (status, headers, kw["max_tokens"], kw["_session"], disagg[:2],
                      gen.kw["max_tokens"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == (200, {"X-MST-Brownout-Level": "2",
                                      "X-MST-Max-Tokens-Capped": "256"}, 256, "alice")


def test_admin_autoscaler_endpoint():
    """400 without a controller; with one, ``enabled`` starts it and the
    answer carries its state and its ladder's; a tuple answers per pool;
    a non-boolean ``enabled`` is a 400 (JAX's answers)."""

    def fake_fleet(pkg):
        class FakeFleet:
            def __init__(self):
                self.brownout = pkg["fleet"].BrownoutController(clock=FakeClock())
                self.started = self.stopped = 0

            def start(self):
                self.started += 1

            def stop(self):
                self.stopped += 1

            def state(self):
                return {"running": bool(self.started and not self.stopped), "ticks": 0}

        return FakeFleet()

    seen = {}
    for name, pkg in PACKAGES.items():
        provider = _provider(name, _Stub())
        srv, th = _serve(pkg, provider)
        port = srv.server_address[1]
        try:
            out = [_post(port, "/admin/autoscaler", {})]
            provider.fleet = fake_fleet(pkg)
            out += [_post(port, "/admin/autoscaler", {"enabled": True}),
                    _post(port, "/admin/autoscaler", {"enabled": 1}),
                    provider.fleet.started]
            provider.fleet = (fake_fleet(pkg), fake_fleet(pkg))
            out.append(_post(port, "/admin/autoscaler", {"enabled": False}))
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=30)
        seen[name] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][0] == 400 and seen["port"][1][0] == 200
    assert seen["port"][1][2]["brownout"]["level"] == 0 and seen["port"][3] == 1
    assert len(seen["port"][4][2]["pools"]) == 2


# ------------------------------------------------------- batcher brownout
class SpecClock:
    def __init__(self):
        self.n = itertools.count()

    def __call__(self):
        return 0.25 * next(self.n)


def _jax_batcher(models, **kw):
    jm, params, _ = models
    eng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                          paged_attention="ragged", **kw.pop("engine", ENGINE))
    return jscheduler.ContinuousBatcher(eng, decode_block=3, async_sched="off", **kw)


def _port_batcher(models, **kw):
    eng = PipelineEngine(models[2], device="cpu", **kw.pop("engine", ENGINE))
    return tscheduler.ContinuousBatcher(eng, decode_block=3, async_sched="off", **kw)


def _pair(models, **kw):
    return {"jax": _jax_batcher(models, **dict(kw)), "port": _port_batcher(models, **dict(kw))}


def test_pressure_level_1_pauses_store_insertion(models):
    out = {}
    for name, pkg_store in (("jax", jprefix), ("port", tprefix)):
        store = pkg_store.PrefixStore(host_bytes=1 << 20)
        b = (_jax_batcher if name == "jax" else _port_batcher)(models, prefix_store=store)
        try:
            seen = []
            for level in (1, 0, 3, 7, -1):
                b.set_pressure(level)
                seen.append((store.inserts_paused, b.resilience_stats()["brownout_level"]))
            out[name] = seen
        finally:
            b.close()
            store.close()
    assert out["port"] == out["jax"]
    assert out["port"] == [(True, 1), (False, 0), (True, 3), (True, 3), (False, 0)]


def test_pressure_level_2_sheds_speculation_like_jax(models):
    """Trackers trained alike: level 2 sheds the lowest-acceptance half of
    the live slots, level 3 all of them, level 0 none; a fixed-K draft
    engine pauses at level 2 (``_spec_ok``)."""
    engine = dict(ENGINE, microbatches=4)
    pair = _pair(models, engine=engine, draft="ngram", spec_window_max=4,
                 spec_clock=lambda: 0.0)
    try:
        plans = {}
        for name, b in pair.items():
            tr = b.spec_tracker
            for slot, count in zip([1, 2, 3], [2, 3, 4]):
                tr.observe(slot, 2, 2)
                tr.observe(slot, 4, count)
            live = [(s, None) for s in range(4)]
            seen = []
            for level in (2, 3, 0):
                b.set_pressure(level)
                seen.append(b._spec_plan(live))
            plans[name] = (seen, b.spec_stats()["shed_events"])
        assert plans["port"] == plans["jax"]
        (shed2, shed3, clear), events = plans["port"]
        assert sorted(w for w in shed2[1].values()).count(0) == 2 and shed3 is None
        assert all(w > 0 for w in clear[1].values()) and events == 4
    finally:
        for b in pair.values():
            b.close()
    jm, params, tm = models
    fixed = {
        "jax": _jax_batcher(models, draft_engine=JPipelineEngine(
            jm, params, pipeline_mesh(1), microbatches=ENGINE["microbatches"],
            max_seq=ENGINE["max_seq"], cache_dtype=jnp.float32,
            prefill_chunk=ENGINE["prefill_chunk"])),
        "port": _port_batcher(models, draft_engine=PipelineEngine(
            tm, device="cpu", microbatches=ENGINE["microbatches"], max_seq=ENGINE["max_seq"],
            prefill_chunk=ENGINE["prefill_chunk"])),
    }
    try:
        gates = {}
        for name, b in fixed.items():
            seen = []
            for level in (0, 2, 0):
                b.set_pressure(level)
                seen.append(b._spec_ok())
            gates[name] = seen
        assert gates["port"] == gates["jax"] == [True, False, True]
    finally:
        for b in fixed.values():
            b.close()


def test_pressure_level_3_halves_the_queue_bound(models, monkeypatch):
    """With the scheduler thread held off, the queue holds what was
    submitted: at level 3 a bound of 4 sheds at 2, with JAX's error and
    counters."""
    pair = _pair(models, max_queue=4)
    seen = {}
    try:
        for name, b in pair.items():
            monkeypatch.setattr(b, "_ensure_running", lambda: None)
            b.set_pressure(3)
            b.generate_step([1, 2, 3], max_tokens=2)
            b.generate_step([1, 2, 3], max_tokens=2)
            with pytest.raises(Exception) as info:
                b.generate_step([1, 2, 3], max_tokens=2)
            b.set_pressure(0)
            b.generate_step([1, 2, 3], max_tokens=2)
            res = b.resilience_stats()
            seen[name] = (type(info.value).__name__, str(info.value), info.value.depth,
                          info.value.max_queue, res["shed_queue_full"], res["brownout_level"])
    finally:
        for b in pair.values():
            b.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "QueueFullError" and seen["port"][2:4] == (2, 2)


def test_spec_draft_fault_degrades_one_round_like_jax(models):
    """``spec.draft`` armed once: that tick runs a plain block, counted in
    ``draft_faults``; the streams equal JAX's and the unfaulted run, and at
    brownout level 2 (shed) too."""
    jobs = [(REPEAT, dict(max_tokens=16)), ([3, 17, 42], dict(max_tokens=10))]

    def run(b, faults=None):
        if faults is not None:
            faults.arm("spec.draft", exc=faults.FaultError, times=1)
        tick = (b._tick if isinstance(b, jscheduler.ContinuousBatcher) else None)
        items, _ = serve_on_this_thread(b, jobs, tick=tick)
        return [[t for t, _ in s] for s in items]

    seen = {}
    for name, faults in (("jax", jfaults), ("port", tfaults)):
        make = _jax_batcher if name == "jax" else _port_batcher
        b = make(models, draft="ngram", spec_clock=SpecClock())
        try:
            got = run(b, faults)
            st = b.spec_stats()
            seen[name] = (got, st["draft_faults"], st["rounds"])
        finally:
            b.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == 1 and seen["port"][2] > 0
    clean = _port_batcher(models, draft="ngram", spec_clock=SpecClock())
    shed = _port_batcher(models, draft="ngram", spec_clock=SpecClock())
    shed.set_pressure(3)
    try:
        assert run(clean) == seen["port"][0]
        assert run(shed) == seen["port"][0] and shed.spec_stats()["rounds"] == 0
    finally:
        clean.close()
        shed.close()
