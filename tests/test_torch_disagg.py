"""Disaggregated serving in the port (``disagg.py`` and the batcher's
prefill-only protocol) against the JAX package's, on the CPU: one prefill
and one decode replica (the tiny f32 Llama of
``tests/test_torch_scheduler.py``, paged, two slots each).

- Greedy streams through the port's coordinator token-identical to JAX's
  coordinator and to a monolithic port batcher, over an f32 pool and an
  int8 pool, sync and async ticks; a seeded sampled stream equal to the
  monolithic run; the handoffs, their bytes, ``handoffs_out`` and
  ``migrations_in`` as JAX counts them.
- Every rung of the degradation ladder with JAX's counts: the
  ``disagg.handoff`` fault serves in place, a ``cache.export`` fault hands
  off blockless, a ``cache.import`` fault re-prefills on the decode
  replica, either pool's dispatch failing, and ``QueueFullError`` before a
  token not remapped; the construction checks; the full prefix-store hit
  that skips the prefill pool; one autoscaler per pool, each on its own
  pool's pressure.

Left out: the pod leg (``attach_pod``, the remote decode host) and several
devices per pool, which come with the pod and the parallel slices. The
servers' disagg surfaces are in ``tests/test_torch_disagg_server.py``."""

import jax
import jax.numpy as jnp
import pytest
import torch

from mlx_sharding_tpu import disagg as jdisagg
from mlx_sharding_tpu import fleet as jfleet
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import resilience as jres
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch import disagg as tdisagg
from mlx_sharding_tpu_torch import fleet as tfleet
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch import resilience as tres
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults as tfaults
from tests.test_torch_scheduler import models  # noqa: F401

ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
PACKAGES = {"jax": (jdisagg, jreplicas, jres, jfaults, jfleet),
            "port": (tdisagg, treplicas, tres, tfaults, tfleet)}
# greedy over one and two pages, and a stream that ends inside its prefill
GREEDY = [
    ([3, 17, 42], dict(max_tokens=24)),
    ([5, 11, 250, 8, 13, 2, 9, 40, 7, 1], dict(max_tokens=16)),
    ([7, 7, 2, 1], dict(max_tokens=1)),
]
SAMPLED = ([9, 4, 4, 6], dict(temperature=0.9, top_p=0.85, seed=321, repetition_penalty=1.3,
                              repetition_context_size=8, max_tokens=20))


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


def _jax_coordinator(models, kv_dtype, first_device):
    jm, params, _ = models
    devices = jax.devices()

    def batcher(i):
        eng = JPipelineEngine(jm, params, make_mesh(pp=1, devices=devices[i:i + 1]),
                              cache_dtype=jnp.float32, kv_dtype=kv_dtype, **ENGINE)
        return jscheduler.ContinuousBatcher(eng, decode_block=3, async_sched="off")

    return jdisagg.DisaggCoordinator(
        jreplicas.ReplicaSet([batcher(first_device)], role="prefill"),
        jreplicas.ReplicaSet([batcher(first_device + 1)], role="decode"))


def _batcher(models, kv_dtype=None, async_sched="off", **kw):
    return ContinuousBatcher(PipelineEngine(models[2], device="cpu", kv_dtype=kv_dtype,
                                            **ENGINE),
                             decode_block=3, async_sched=async_sched, **kw)


def _coordinator(models, kv_dtype=None, async_sched="off"):
    return tdisagg.DisaggCoordinator(
        treplicas.ReplicaSet([_batcher(models, kv_dtype, async_sched)], role="prefill"),
        treplicas.ReplicaSet([_batcher(models, kv_dtype, async_sched)], role="decode"))


@pytest.fixture(scope="module")
def jax_coordinators(models):
    """JAX's coordinators, built once: an f32 pool and an int8 pool."""
    cos = {None: _jax_coordinator(models, None, 0), "int8": _jax_coordinator(models, "int8", 2)}
    yield cos
    for co in cos.values():
        co.close()


def _toks(stream):
    return [t for t, _ in stream]


def _refs(gen, jobs):
    return [_toks(gen.generate_step(p, **kw)) for p, kw in jobs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("async_sched", ["off", "on"])
def test_handoff_streams_match_jax_and_monolithic(models, jax_coordinators, kv_dtype,
                                                  async_sched):
    """Greedy streams through the port's coordinator equal JAX's coordinator's
    and a monolithic port batcher's, with a real block shipped: the
    handoffs, their bytes and the pools' counters as JAX's."""
    jco = jax_coordinators[kv_dtype]
    jh0, jr0 = jco.handoff_stats(), jco.resilience_stats()
    want = _refs(jco, GREEDY)
    mono = _batcher(models, kv_dtype, async_sched)
    co = _coordinator(models, kv_dtype, async_sched)
    try:
        assert _refs(mono, GREEDY) == want
        assert _refs(co, GREEDY) == want
        h, r = co.handoff_stats(), co.resilience_stats()
    finally:
        co.close()
        mono.close()
    jh, jr = jco.handoff_stats(), jco.resilience_stats()
    assert set(h) == set(jh)
    assert h["handoffs"] == jh["handoffs"] - jh0["handoffs"] == 2  # max_tokens=1 stays put
    assert h["bytes_total"] == jh["bytes_total"] - jh0["bytes_total"] > 0
    assert h["fallbacks"] == {} and jh["fallbacks"] == jh0["fallbacks"]
    assert h["window"] == 2 and h["ms_p50"] is not None and h["ms_hist"]["count"] == 2
    for key in ("handoffs", "handoffs_out", "migrations_in", "spill_fallbacks"):
        assert r[key] == jr[key] - jr0[key], key


@pytest.mark.parametrize("async_sched", ["off", "on"])
def test_sampled_stream_matches_monolithic(models, async_sched):
    """A seeded top-p stream continues on the decode replica from the
    generator state the block carries: equal to the monolithic run."""
    mono = _batcher(models, async_sched=async_sched)
    co = _coordinator(models, async_sched=async_sched)
    try:
        assert _refs(co, [SAMPLED]) == _refs(mono, [SAMPLED])
        assert co.handoff_stats()["handoffs"] == 1
    finally:
        co.close()
        mono.close()


def _arm(faults, case):
    if case == "handoff_fault":
        faults.arm("disagg.handoff", exc=faults.FaultError, times=1)
    elif case == "export_fault":
        faults.arm("cache.export", exc=faults.FaultError, times=1)
    elif case == "import_fault":
        faults.arm("cache.import", exc=faults.FaultError, times=1)
    elif case == "decode_down":
        faults.arm("replica.dispatch", exc=faults.FaultError, after=1, times=1)
    elif case == "prefill_down":
        faults.arm("replica.dispatch", exc=faults.FaultError, times=1)


@pytest.mark.parametrize("case", ["handoff_fault", "export_fault", "import_fault",
                                  "decode_down", "prefill_down"])
def test_degradation_ladder_counts_match_jax(models, jax_coordinators, case):
    """Each rung with the same fault armed in both packages: the stream is
    the clean run's, and the coordinator's and pools' counts move as
    JAX's."""
    jco = jax_coordinators[None]
    prompt, kw = GREEDY[1]
    co = _coordinator(models)
    try:
        clean = _toks(co.generate_step(prompt, **kw))
        got = {}
        for name, gen, faults in (("jax", jco, jfaults), ("port", co, tfaults)):
            h0, r0 = gen.handoff_stats(), gen.resilience_stats()
            _arm(faults, case)
            toks = _toks(gen.generate_step(prompt, **kw))
            faults.disarm()
            h, r = gen.handoff_stats(), gen.resilience_stats()
            got[name] = {
                "tokens": toks,
                "handoffs": h["handoffs"] - h0["handoffs"],
                "shipped": h["bytes_total"] > h0["bytes_total"],
                "fallbacks": {k: v - h0["fallbacks"].get(k, 0)
                              for k, v in h["fallbacks"].items()
                              if v != h0["fallbacks"].get(k, 0)},
                **{k: r[k] - r0[k] for k in ("handoffs_out", "migrations_in",
                                             "spill_fallbacks", "spill_hits")},
            }
    finally:
        co.close()
    assert got["port"] == got["jax"]
    assert got["port"]["tokens"] == clean
    want = {"handoff_fault": {"handoff_fault": 1}, "export_fault": {}, "import_fault": {},
            "decode_down": {"decode_failed": 1},
            "prefill_down": {"prefill_unavailable": 1}}[case]
    assert got["port"]["fallbacks"] == want
    if case == "export_fault":
        # the block never forms: a blockless handoff, nothing shipped
        assert got["port"]["handoffs"] == 1 and not got["port"]["shipped"]


def test_queue_full_before_tokens_is_not_remapped():
    """A saturated prefill pool answers 429 (JAX's): the overflow is not
    spilled onto the decode pool."""
    for pkg in PACKAGES.values():
        disagg, _, res, _, _ = pkg

        class FullPool:
            role = "prefill"
            supports_prefill_only = True

            def generate_step(self, prompt_tokens, **kw):
                raise res.QueueFullError(4, 4)
                yield  # pragma: no cover

        class IdlePool:
            role = "decode"
            supports_resume = True
            served = 0

            def generate_step(self, prompt_tokens, **kw):
                self.served += 1
                yield from [(1, None)]

        decode = IdlePool()
        co = disagg.DisaggCoordinator(FullPool(), decode)
        with pytest.raises(res.QueueFullError):
            list(co.generate_step([1, 2, 3], max_tokens=4))
        assert decode.served == 0 and co.handoff_stats()["fallbacks"] == {}


def test_pool_capabilities_validated_at_construction(models):
    """The construction checks with JAX's messages: a prefill pool without
    the prefill-only protocol, a decode pool without resume, a speculating
    prefill replica."""

    class Plain:
        def generate_step(self, prompt_tokens, **kw):
            yield from ()

    ok = type("Cap", (Plain,), {"supports_prefill_only": True, "supports_resume": True})()
    ngram = {"jax": type("Spec", (Plain,), {"supports_prefill_only": True,
                                            "_spec_mode": "ngram"})(),
             "port": _batcher(models, draft="ngram")}
    try:
        msgs = {}
        for name, pkg in PACKAGES.items():
            disagg = pkg[0]
            got = []
            for prefill, decode in ((Plain(), ok), (ok, Plain()), (ngram[name], ok)):
                with pytest.raises(ValueError) as info:
                    disagg.DisaggCoordinator(prefill, decode)
                got.append(str(info.value).replace("Spec", "ContinuousBatcher"))
            msgs[name] = got
        assert msgs["port"] == msgs["jax"]
    finally:
        ngram["port"].close()


class _Pool:
    """A stub pool for the coordinator's routing: serves three tokens,
    counts its calls, and (as a prefill pool) ends with a blockless
    handoff after its first token."""

    def __init__(self, res, role, prefill_only=False):
        self.res, self.role, self.calls = res, role, []
        self.supports_prefill_only = True
        self.supports_resume = True
        self.prefill_only = prefill_only

    def generate_step(self, prompt_tokens, **kw):
        self.calls.append(sorted(kw))
        if self.prefill_only and kw.get("_prefill_only"):
            yield (1, None)
            raise self.res.HandoffReadyError(self.res.ResumeState(
                prompt=list(prompt_tokens), history=[1], produced=1))
        start = kw["_resume"].produced if "_resume" in kw else 0
        yield from [(t, None) for t in (1, 2, 3)[start:]]


def test_full_store_hit_skips_the_prefill_pool():
    """A prefix store covering the whole prompt sends the request straight
    to the decode pool (``store_skips``); a sick store falls back to the
    two-phase path. The same calls and counts in both packages."""

    class Store:
        def __init__(self, answer):
            self.answer = answer

        def covers_full(self, prompt):
            if isinstance(self.answer, Exception):
                raise self.answer
            return self.answer

    seen = {}
    for name, pkg in PACKAGES.items():
        disagg, _, res, _, _ = pkg
        out = []
        for answer in (True, False, RuntimeError("sick store")):
            prefill, decode = _Pool(res, "prefill", True), _Pool(res, "decode")
            co = disagg.DisaggCoordinator(prefill, decode, prefix_store=Store(answer))
            toks = _toks(co.generate_step([1, 2, 3], max_tokens=3))
            out.append((toks, prefill.calls, decode.calls, co.handoff_stats()["store_skips"],
                        co.handoff_stats()["handoffs"]))
        seen[name] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][3] == 1 and seen["port"][0][1] == []  # skipped phase 1
    assert seen["port"][1][4] == 1 and seen["port"][2][4] == 1  # two-phase, one handoff


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _LoadStub:
    concurrent = True

    def __init__(self):
        self.load = (1, 0, 0)
        self.closed = False

    def stats(self):
        return self.load

    def generate_step(self, prompt_tokens, **kw):
        yield from [(t, None) for t in (1, 2, 3)]

    def close(self):
        self.closed = True


def test_pool_pressure_is_per_pool_and_shed_capped():
    for pkg in PACKAGES.values():
        pool_pressure = pkg[4].pool_pressure
        assert pool_pressure(2, 1, 3, 0) == 2.0
        assert pool_pressure(1, 0, 0, 100) == 1.0  # the shed term saturates
        assert pool_pressure(0, 0, 0, 0) == 0.0


def test_prefill_storm_cannot_spawn_decode_replicas():
    """Two role pools, a controller each, a storm on the prefill pool only:
    the prefill controller spawns, the decode controller stays put; the
    same decisions and states in both packages."""
    seen = {}
    for name, pkg in PACKAGES.items():
        _, replicas, _, _, fleet = pkg
        clk = _Clock()
        spawned = {"prefill": 0, "decode": 0}
        pools, ctrls = {}, {}
        for role in ("prefill", "decode"):
            pools[role] = replicas.ReplicaSet([_LoadStub()], role=role)

            def factory(role=role):
                spawned[role] += 1
                return _LoadStub()

            ctrls[role] = fleet.FleetAutoscaler(pools[role], factory, max_replicas=3, clock=clk,
                                                scale_up_sustain_s=5.0, cooldown_s=0.0,
                                                enable_brownout=False)
        pools["prefill"].replicas[0].load = (1, 1, 4)  # pressure 5.0
        first = [ctrl.tick() for ctrl in ctrls.values()]
        clk.t += 5.0
        second = [ctrl.tick() for ctrl in ctrls.values()]
        seen[name] = (first, second, dict(spawned),
                      [pools[r].fleet_stats()["size"] for r in pools],
                      [ctrl.state() for ctrl in ctrls.values()])
        for pool in pools.values():
            pool.close()
    assert seen["port"] == seen["jax"]
    assert [o["action"] for o in seen["port"][1]] == ["spawn", None]
    assert seen["port"][2] == {"prefill": 1, "decode": 0}


def test_handoff_spans_match_jax(models, jax_coordinators):
    """A traced request through both coordinators: the prefill replica's
    ``handoff_export`` and the coordinator's ``handoff_transfer`` (with the
    bytes shipped) on one timeline with both legs' spans, as JAX's."""
    from mlx_sharding_tpu import tracing as jtracing
    from mlx_sharding_tpu_torch import tracing as ttracing

    prompt, kw = GREEDY[1]
    co = _coordinator(models)
    seen = {}
    try:
        for name, gen, tracing in (("jax", jax_coordinators[None], jtracing),
                                   ("port", co, ttracing)):
            tr = tracing.RequestTrace(f"disagg-{name}")
            _toks(gen.generate_step(prompt, _trace=tr, **kw))
            frozen = tr.freeze()
            seen[name] = ([s[0] for s in frozen["spans"]], [m[0] for m in frozen["marks"]],
                          [s[3]["bytes"] for s in frozen["spans"] if s[0] == "handoff_transfer"])
    finally:
        co.close()
    assert seen["port"] == seen["jax"]
    spans, _, shipped = seen["port"]
    assert spans.index("handoff_export") < spans.index("handoff_transfer")
    assert shipped[0] > 0


@pytest.mark.parametrize("async_sched", ["off", "on"])
def test_handoff_releases_the_slot_before_the_next_dispatch(models, async_sched):
    """A prefill-only request beside a decoding one, ticks driven on this
    thread: its handoff runs with nothing in flight (the tick quiesced for
    the prefill), after its first token and before the decode dispatch,
    and every decode block uploaded after it has the slot inactive; the
    decoding stream equals its run alone."""
    b = _batcher(models, async_sched=async_sched)
    alone = _batcher(models, async_sched=async_sched)
    b._ensure_running = lambda: None
    seen, uploads = [], []
    handoff_out, device_inputs = b._handoff_out, b.engine.device_inputs

    def handoff():
        seen.append((b._inflight is None, [r.slot for r in b._handoff_ready]))
        handoff_out()

    def inputs(key, table, active, *args, **kw):
        uploads.append((len(seen), list(active)))
        return device_inputs(key, table, active, *args, **kw)

    b._handoff_out, b.engine.device_inputs = handoff, inputs
    try:
        want = _toks(alone.generate_step([3, 17, 42], max_tokens=12))
        streams = [b.generate_step([3, 17, 42], max_tokens=12),
                   b.generate_step([5, 11, 250, 8, 13, 2, 9, 40, 7, 1], max_tokens=16,
                                   _prefill_only=True)]
        reqs = list(b._submit.queue)
        got, ended, handed = [[], []], [False, False], []
        with torch.no_grad():
            for _ in range(1000):
                for i, (stream, req) in enumerate(zip(streams, reqs)):
                    while not ended[i] and not req.out.empty():
                        try:
                            got[i].append(next(stream)[0])
                        except StopIteration:
                            ended[i] = True
                        except tres.HandoffReadyError as exc:
                            handed.append(exc.state)
                            ended[i] = True
                if all(ended):
                    break
                b.run_tick()
    finally:
        b.close()
        alone.close()
    assert all(ended) and got[0] == want and len(got[1]) == 1
    assert len(handed) == 1 and handed[0].block is not None
    assert len(seen) == 1 and seen[0][0] is True  # nothing in flight at the handoff
    slot = seen[0][1][0]
    after = [active for n, active in uploads if n >= 1]
    assert after and not any(active[slot] for active in after)
    assert b.handoffs_out == 1
