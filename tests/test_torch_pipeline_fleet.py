"""KV movement and the fleet over an engine of two stages: the port's
batcher, replica set, disagg coordinator and autoscaler over pp = 2
engines against the JAX package's over its pp = 2 engines
(``pipeline_mesh(2)`` / ``make_mesh(pp=2)`` over the 8 host devices), on
the CPU in f32, the tiny 4-layer Llama of
``tests/test_torch_pipeline_archs.py`` split 0-2 / 2-4.

- spill on preemption, cold-slot spill with its prefetch, and the prefix
  store's host tier at pp = 2 (both batchers driven tick by tick by
  ``chip_smoke.serve_on_this_thread``, every tier flushing synchronously):
  token-identical streams and every counter equal to JAX's run;
- two pp = 2 replicas with a drain in the middle of a stream, a disagg
  coordinator over pp = 2 pools, and an autoscaler spawn of a pp = 2
  replica: the streams and the counters (migrations, handoffs and their
  bytes, fallbacks by kind) equal to JAX's pp = 2 fleet on the same jobs.

Greedy streams must be token-identical (f32 on both sides, the same
argmax); a block of the even split carries JAX's bytes."""

import threading

import jax
import jax.numpy as jnp
import pytest

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import disagg as jdisagg
from mlx_sharding_tpu import prefix_store as jps
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch import disagg as tdisagg
from mlx_sharding_tpu_torch import prefix_store as tps
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch.cache import StagedKV
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults
from tests.test_torch_kv_residency import COUNTERS
from tests.test_torch_pipeline_archs import _llama, one_torch_thread  # noqa: F401
from tests.test_torch_prefix_store import STORE_COUNTERS

SPILL = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=8, page_size=8)
FLEET = dict(SPILL, pool_pages=10)
GREEDY = [([7, 7, 2, 1], dict(max_tokens=40)), ([9, 4, 4, 6], dict(max_tokens=36))]
COLD_JOBS = [([7, 7, 2, 1], dict(max_tokens=30)), ([9, 4, 4, 6, 1, 3], dict(max_tokens=24))]
COLD = dict(spill_bytes=64 << 20, spill_cold_after=2, kv_prefetch="on")
BASE = [7, 7, 2, 1, 9, 4, 4, 6, 3, 17, 42, 5, 11, 2, 2, 8]
PROMPT, TOKENS = [3, 17, 42, 5, 9, 11, 2, 8, 13], 30


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()
    jfaults.disarm()


def _jengine(llama4, first=0, **kw):
    jm, params, _ = llama4
    devices = jax.devices()
    return JPipelineEngine(jm, params, make_mesh(pp=2, devices=devices[first:first + 2]),
                           cache_dtype=jnp.float32, **kw)


def _tengine(llama4, **kw):
    return PipelineEngine(llama4[2], stages=2, device="cpu", **kw)


def _flush_sync(batcher):
    if batcher.spill is not None:
        batcher.spill._flush_async = False
    if batcher.prefix_store is not None:
        batcher.prefix_store._host._flush_async = False
    return batcher


def _serve(batcher, jobs, **kw):
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        kw["tick"] = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, **kw)
    return [[t for t, _ in s] for s in items]


def _run(batcher, jobs, read, keys, **kw):
    """The streams and the run's increments of ``read()``'s counters."""
    before = read()
    streams = _serve(batcher, jobs, **kw)
    after = read()
    return streams, {k: after[k] - before[k] for k in keys}


def _pair(llama4, engine, **kw):
    """The same batcher in both packages over pp = 2 engines: (JAX, port)."""
    jb = _flush_sync(jscheduler.ContinuousBatcher(_jengine(llama4, **engine), decode_block=3,
                                                  **kw))
    tb = _flush_sync(ContinuousBatcher(_tengine(llama4, **engine), decode_block=3, **kw))
    assert isinstance(tb.cache, StagedKV)
    return jb, tb


def _assert_pool_home(batcher):
    total, in_use, _ = batcher.page_stats()
    assert in_use == 0 and len(batcher._free_pages) == total
    assert batcher.spill_stats()["bytes_in_use"] == 0 and not batcher._parked


@pytest.mark.parametrize("case", ["preemption", "cold_slot"])
def test_spill_and_prefetch_at_pp2_equal_jax(llama4, case):
    """Preemption at pp = 2 spills the newcomer's pages of both stages
    and imports them back, staged ahead (sync ticks); a reader that stops
    for 12 ticks has its slot spilled cold and woken with its block
    prefetched (async ticks): streams and every ``spill_stats`` counter
    equal JAX's pp = 2 batcher's, and nothing is re-prefilled."""
    if case == "preemption":
        kw, jobs, extra = dict(overcommit=True, spill_bytes=64 << 20, async_sched="off"), \
            GREEDY, {}
    else:
        kw, jobs, extra = dict(COLD, async_sched="on"), COLD_JOBS, dict(hold=(0, 3, 12))
    jb, tb = _pair(llama4, SPILL, **kw)
    try:
        want, jstats = _run(jb, jobs, jb.spill_stats, COUNTERS, **extra)
        got, stats = _run(tb, jobs, tb.spill_stats, COUNTERS, **extra)
    finally:
        jb.close()
    assert got == want and stats == jstats
    assert stats["spill_hits"] == stats["spills"] >= 1 and stats["reprefill_tokens"] == 0
    assert stats["prefetch_hits"] >= 1
    if case == "preemption":
        assert stats["preemptions"] >= 1
    else:
        assert stats["cold_spills"] >= 1 and stats["cold_wakes"] == stats["cold_spills"]
    _assert_pool_home(tb)
    tb.close()


def test_prefix_store_at_pp2_equals_jax(llama4):
    """A hot prefix served three times in a row at pp = 2: the first
    request's pages are demoted into the host tier as a staged block at its
    finish, the next two import it; streams and the store's counters equal
    JAX's pp = 2 batcher's."""
    jobs = [(BASE + [t], dict(max_tokens=n)) for t, n in ((5, 40), (9, 12), (3, 12))]
    sequential = {1: (0, 10 ** 9), 2: (1, 10 ** 9)}
    jstore, tstore = jps.PrefixStore(host_bytes=64 << 20), tps.PrefixStore(host_bytes=64 << 20)
    jb = _flush_sync(jscheduler.ContinuousBatcher(_jengine(llama4, **SPILL), decode_block=3,
                                                  prefix_store=jstore))
    tb = _flush_sync(ContinuousBatcher(_tengine(llama4, **SPILL), decode_block=3,
                                       prefix_store=tstore))
    try:
        want, jstats = _run(jb, jobs, jstore.stats, STORE_COUNTERS, start_after=sequential)
        got, stats = _run(tb, jobs, tstore.stats, STORE_COUNTERS, start_after=sequential)
    finally:
        jb.close()
        jstore.close()
    assert got == want and stats == jstats
    assert stats["demotions"] >= 1 and stats["hits_host"] == 2
    assert stats["tokens_reused"] == 2 * len(BASE)
    assert {tstore._host.peek(k).stage_layers for k in tstore._host.keys()} == {(2, 2)}
    tb.close()
    tstore.close()


def _drive_drain(rs):
    """One greedy stream on replica 0, drained once it has 3 tokens."""
    toks, err = [], []
    started = threading.Event()

    def consume():
        try:
            for t, _ in rs.generate_step(PROMPT, max_tokens=TOKENS):
                toks.append(t)
                if len(toks) >= 3:
                    started.set()
        except Exception as e:  # noqa: BLE001 — asserted below
            err.append(e)
            started.set()

    th = threading.Thread(target=consume)
    th.start()
    assert started.wait(120)
    out = rs.drain(0)
    th.join(timeout=120)
    assert not th.is_alive() and not err, err
    return toks, out


def test_drain_of_a_pp2_replica_equals_jax(llama4):
    """Two pp = 2 replicas, replica 0 drained in the middle of a greedy
    stream: the stream is the undrained run's in both packages, the
    block of both stages moved with it (replica 1 imported it), and the
    drain's result and the migration counters equal JAX's."""
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            reps = [jscheduler.ContinuousBatcher(_jengine(llama4, 2 * i, **FLEET),
                                                 decode_block=3) for i in range(2)]
            rs = jreplicas.ReplicaSet(reps)
        else:
            reps = [ContinuousBatcher(_tengine(llama4, **FLEET), decode_block=3)
                    for _ in range(2)]
            rs = treplicas.ReplicaSet(reps)
        try:
            toks, result = _drive_drain(rs)
            r0, r1 = rs.replicas
            out[name] = (toks, result, rs.migrated_streams, rs.drains,
                         r0.resilience_stats()["migrations_out"],
                         r1.resilience_stats()["migrations_in"],
                         r0.resilience_stats()["spill_fallbacks"],
                         r1.spill_stats()["spill_hits"])
        finally:
            rs.close()
    undrained = ContinuousBatcher(_tengine(llama4, **FLEET), decode_block=3)
    try:
        assert out["port"][0] == [t for t, _ in undrained.generate_step(PROMPT,
                                                                          max_tokens=TOKENS)]
    finally:
        undrained.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"replica": 0, "migrated": 1, "closed": True}
    assert out["port"][-1] == 1  # imported, not re-prefilled


def _toks(stream):
    return [t for t, _ in stream]


def test_disagg_over_pp2_pools_equals_jax(llama4):
    """A prefill pool and a decode pool of pp = 2 engines: every greedy
    request's block (both stages' pages) is handed off and imported, the
    streams equal JAX's pp = 2 coordinator's and a monolithic pp = 2
    batcher's, and the handoffs, their bytes (the even split carries JAX's
    bytes) and the fallbacks equal JAX's."""
    jobs = [GREEDY[0], ([3, 17, 42, 5, 11, 2, 8], dict(max_tokens=12))]

    def coordinator(pkg):
        if pkg == "jax":
            make = lambda i: jscheduler.ContinuousBatcher(  # noqa: E731
                _jengine(llama4, 2 * i, **FLEET), decode_block=3, async_sched="off")
            return jdisagg.DisaggCoordinator(jreplicas.ReplicaSet([make(0)], role="prefill"),
                                             jreplicas.ReplicaSet([make(1)], role="decode"))
        make = lambda: ContinuousBatcher(_tengine(llama4, **FLEET), decode_block=3,  # noqa: E731
                                         async_sched="off")
        return tdisagg.DisaggCoordinator(treplicas.ReplicaSet([make()], role="prefill"),
                                         treplicas.ReplicaSet([make()], role="decode"))

    out = {}
    for pkg in ("jax", "port"):
        co = coordinator(pkg)
        try:
            streams = [_toks(co.generate_step(p, **kw)) for p, kw in jobs]
            h, r = co.handoff_stats(), co.resilience_stats()
            out[pkg] = (streams, h["handoffs"], h["bytes_total"], h["fallbacks"],
                        r["handoffs_out"], r["migrations_in"], r["spill_fallbacks"])
        finally:
            co.close()
    mono = ContinuousBatcher(_tengine(llama4, **FLEET), decode_block=3, async_sched="off")
    try:
        assert out["port"][0] == [_toks(mono.generate_step(p, **kw)) for p, kw in jobs]
    finally:
        mono.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2 and out["port"][2] > 0 and out["port"][3] == {}


def test_autoscaler_spawns_a_pp2_replica_aliasing_the_tree(llama4):
    """``build_generator`` with ``num_stages=2`` and ``autoscale``: the
    controller's spawn adds a third pp = 2 replica that aliases the one
    resident tree (three refs, one tree), and the grown set answers every greedy
    request as JAX's pp = 2 batcher does."""
    from mlx_sharding_tpu_torch.server import openai_api as tapi
    from mlx_sharding_tpu_torch.weights import weight_store

    jobs = [(PROMPT, 10), ([5, 9, 2, 7, 11, 3], 9)]
    jb = jscheduler.ContinuousBatcher(_jengine(llama4, **FLEET), decode_block=3)
    try:
        want = [_toks(jb.generate_step(p, max_tokens=n)) for p, n in jobs]
    finally:
        jb.close()
    gen = tapi.build_generator("tiny", model=llama4[2], device="cpu", num_stages=2,
                               concurrent=2, paged_pool=10, max_seq=64, prefill_chunk=8,
                               decode_block=3, replicas=2, autoscale=True, autoscale_max=3,
                               autoscale_interval=3600.0)
    try:
        ctrl = tapi.fleet_controllers(gen)
        assert ctrl.spawn_one() == "spawn"
        assert len(gen.replicas) == 3
        assert all(r.engine.num_stages == 2 for r in gen.replicas)
        assert [e["refs"] for e in weight_store().stats()["entries"]] == [3]
        assert ctrl.state()["spawns"] == 1
        got = [_toks(gen.generate_step(p, max_tokens=n)) for p, n in jobs]
    finally:
        ctrl.stop()
        gen.close()
    assert got == want
    assert weight_store().stats()["trees"] == 0


def test_a_cross_split_store_import_is_refused_and_counted_as_jax(llama4):
    """One prefix store behind a pp = 2 batcher and a pp = 1 one: the
    pp = 2 batcher's demoted block (both stages' pages) is found by the
    pp = 1 batcher, whose import refuses it on the geometry check; the
    request prefills plain with the same stream, and the store counts the
    host hit and the import fault exactly as JAX's store does."""
    jm, params, tm = llama4
    jobs = [(BASE + [5], dict(max_tokens=12))]
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            store = jps.PrefixStore(host_bytes=64 << 20)
            two = jscheduler.ContinuousBatcher(_jengine(llama4, **SPILL), decode_block=3,
                                               prefix_store=store)
            one = jscheduler.ContinuousBatcher(JPipelineEngine(
                jm, params, make_mesh(pp=1, devices=jax.devices()[2:3]),
                cache_dtype=jnp.float32, **SPILL), decode_block=3, prefix_store=store)
        else:
            store = tps.PrefixStore(host_bytes=64 << 20)
            two = ContinuousBatcher(_tengine(llama4, **SPILL), decode_block=3,
                                    prefix_store=store)
            one = ContinuousBatcher(PipelineEngine(tm, device="cpu", **SPILL), decode_block=3,
                                    prefix_store=store)
        store._host._flush_async = False
        try:
            first = _serve(two, jobs)
            before = store.stats()
            second = _serve(one, jobs)
            after = store.stats()
        finally:
            two.close()
            one.close()
            store.close()
        out[pkg] = (first, second, {k: after[k] - before[k] for k in STORE_COUNTERS})
    assert out["port"] == out["jax"]
    first, second, counts = out["port"]
    assert first == second
    assert counts["hits_host"] == 1 and counts["import_faults"] == 1
