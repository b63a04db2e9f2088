"""KV movement, speculation and the fleet over tp = 2 engines: the port's
batcher, replica set, disagg coordinator, autoscaler and server over
engines of two tensor-parallel shards (every shard on ``device="cpu"``)
against the JAX package's over ``make_mesh(tp=2)`` on the 8 host devices,
on the CPU in f32, the tiny 4-layer Llama of
``tests/test_torch_pipeline_archs.py`` (2 KV heads, one a shard).

- spill on preemption, cold-slot spill with its prefetch, and the prefix
  store's host tier at tp = 2 (both batchers driven tick by tick by
  ``chip_smoke.serve_on_this_thread``, every tier flushing synchronously):
  token-identical streams and every counter equal to JAX's run;
- the n-gram batcher at tp = 2, sync and async ticks: JAX's streams and
  ``spec_stats``;
- two tp = 2 replicas with a drain in the middle of a stream, a disagg
  coordinator over tp = 2 pools and an autoscaler spawn of a tp = 2
  replica (one resident tp = 2 tree, aliased by every replica): the
  streams and the counters equal to JAX's tp = 2 fleet on the same jobs;
- the server's ``--tp 2`` with ``--spill-bytes``, ``--prefix-store``,
  ``--replicas 2`` and ``--disagg`` on a tiny checkpoint answering what
  the plain ``--tp 2`` batcher answers, and the parser's messages for the
  draft flags beside ``--tp`` / ``--ep`` JAX's, word for word.

Greedy streams must be token-identical (f32 on both sides, the same
argmax)."""

import jax
import jax.numpy as jnp
import pytest

from mlx_sharding_tpu import disagg as jdisagg
from mlx_sharding_tpu import prefix_store as jps
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch import disagg as tdisagg
from mlx_sharding_tpu_torch import prefix_store as tps
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch.cache import ShardedKV
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.testing import faults
from tests.test_torch_kv_residency import COUNTERS
from tests.test_torch_pipeline_archs import _llama, one_torch_thread  # noqa: F401
from tests.test_torch_pipeline_fleet import (
    BASE,
    COLD,
    COLD_JOBS,
    FLEET,
    GREEDY,
    PROMPT,
    SPILL,
    TOKENS,
    _assert_pool_home,
    _drive_drain,
    _flush_sync,
    _run,
    _serve,
    _toks,
)
from tests.test_torch_prefix_store import STORE_COUNTERS
from tests.test_torch_server_pipeline import _parser_error
from tests.test_torch_spec_batcher import OC_JOBS, SPEC_JOBS, FakeClock
from tests.test_torch_tp_serve import _answer


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("tp_fleet_ckpt"))


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()
    jfaults.disarm()


_JAX_ENGINES: dict = {}


def _jengine(llama4, first=0, **kw):
    """One JAX tp = 2 engine a geometry and device pair for the module:
    its compiled programs serve every batcher built on it."""
    key = (first, tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        jm, params, _ = llama4
        mesh = make_mesh(tp=2, devices=jax.devices()[first:first + 2])
        _JAX_ENGINES[key] = JPipelineEngine(jm, params, mesh, cache_dtype=jnp.float32, **kw)
    return _JAX_ENGINES[key]


def _tengine(llama4, **kw):
    return PipelineEngine(llama4[2], tp=2, device="cpu", **kw)


def _pair(llama4, engine, **kw):
    """The same batcher in both packages over tp = 2 engines: (JAX, port)."""
    jb = _flush_sync(jscheduler.ContinuousBatcher(_jengine(llama4, **engine), decode_block=3,
                                                  **kw))
    tb = _flush_sync(ContinuousBatcher(_tengine(llama4, **engine), decode_block=3, **kw))
    assert isinstance(tb.cache, ShardedKV) and tb.engine.decode_path == "gather"
    return jb, tb


@pytest.mark.parametrize("case", ["preemption", "cold_slot"])
def test_spill_and_prefetch_at_tp2_equal_jax(llama4, case):
    """Preemption at tp = 2 spills the newcomer's whole-head pages and
    imports them back into both shards, staged ahead (sync ticks); a reader
    that stops for 12 ticks has its slot spilled cold and woken with its
    block prefetched (async ticks): streams and every ``spill_stats``
    counter equal JAX's tp = 2 batcher's, and nothing is re-prefilled."""
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


def test_prefix_store_at_tp2_equals_jax(llama4):
    """A hot prefix served three times in a row at tp = 2: the first
    request's pages are demoted into the host tier as one whole-head block
    at its finish, the next two import it into both shards; streams and the
    store's counters equal JAX's tp = 2 batcher's."""
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
    assert {tstore._host.peek(k).k_pages.shape[3] for k in tstore._host.keys()} == {2}
    tb.close()
    tstore.close()


@pytest.mark.parametrize("sched", ["off", "on"], ids=["sync", "async"])
def test_ngram_batcher_at_tp2_equals_jax(llama4, sched):
    """The n-gram batcher over tp = 2 engines, its T = K verify run over
    both shards with the reductions over every position: JAX's streams and
    ``spec_stats``, with overcommit preemption on a 6-page pool too; the
    streams also equal the port's tp = 2 batcher without speculation."""
    kw = dict(draft="ngram", async_sched=sched)
    out = {}
    for pkg in ("jax", "port"):
        streams, stats = [], []
        for jobs, eng, extra in ((SPEC_JOBS, SPILL, {}),
                                 (OC_JOBS, dict(SPILL, microbatches=3, pool_pages=6,
                                                max_seq=64), dict(overcommit=True))):
            if pkg == "jax":
                b = jscheduler.ContinuousBatcher(_jengine(llama4, **eng), decode_block=3,
                                                 spec_clock=FakeClock(), **kw, **extra)
            else:
                b = ContinuousBatcher(_tengine(llama4, **eng), decode_block=3,
                                      spec_clock=FakeClock(), **kw, **extra)
            try:
                streams.append(_serve(b, jobs))
                stats.append((b.spec_stats(), b.preemptions))
            finally:
                b.close()
        out[pkg] = (streams, stats)
    assert out["port"] == out["jax"]
    assert out["port"][1][0][0]["rounds"] > 0 and out["port"][1][0][0]["draft_tokens"] > 0
    assert out["port"][1][1][1] >= 1
    plain = ContinuousBatcher(_tengine(llama4, **SPILL), decode_block=3, async_sched=sched)
    try:
        assert _serve(plain, SPEC_JOBS) == out["port"][0][0]
    finally:
        plain.close()


def test_drain_of_a_tp2_replica_equals_jax(llama4):
    """Two tp = 2 replicas, replica 0 drained in the middle of a greedy
    stream: the stream is the undrained run's in both packages, its
    whole-head block moved with it (replica 1 imported it into both
    shards), and the drain's result and the migration counters equal
    JAX's."""
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
        assert out["port"][0] == _toks(undrained.generate_step(PROMPT, max_tokens=TOKENS))
    finally:
        undrained.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"replica": 0, "migrated": 1, "closed": True}
    assert out["port"][-1] == 1  # imported, not re-prefilled


def test_disagg_over_tp2_pools_equals_jax(llama4):
    """A prefill pool and a decode pool of tp = 2 engines: every greedy
    request's whole-head block is handed off and imported into both of the
    decode engine's shards; the streams equal JAX's tp = 2 coordinator's
    and a monolithic tp = 2 batcher's, and the handoffs, their bytes (JAX's
    global bytes) and the fallbacks equal JAX's."""
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


def test_autoscaler_spawns_a_tp2_replica_aliasing_the_tree(llama4):
    """``build_generator`` with ``tp=2`` and ``autoscale``: the controller's
    spawn adds a third tp = 2 replica that aliases the one resident tp = 2
    tree (three refs, one tree, whose key names tp and ep; every replica's
    shards run the same layer modules, so no second copy of a packed row
    split exists), and the grown set answers every greedy request as JAX's
    tp = 2 batcher does."""
    from mlx_sharding_tpu_torch.weights import weight_store

    jobs = [(PROMPT, 10), ([5, 9, 2, 7, 11, 3], 9)]
    jb = jscheduler.ContinuousBatcher(_jengine(llama4, **FLEET), decode_block=3)
    try:
        want = [_toks(jb.generate_step(p, max_tokens=n)) for p, n in jobs]
    finally:
        jb.close()
    gen = tapi.build_generator("tiny", model=llama4[2], device="cpu", tp=2, concurrent=2,
                               paged_pool=10, max_seq=64, prefill_chunk=8, decode_block=3,
                               replicas=2, autoscale=True, autoscale_max=3,
                               autoscale_interval=3600.0)
    try:
        ctrl = tapi.fleet_controllers(gen)
        assert ctrl.spawn_one() == "spawn"
        assert len(gen.replicas) == 3
        assert all(r.engine.tp == 2 for r in gen.replicas)
        stats = weight_store().stats()
        assert stats["trees"] == 1 and [e["refs"] for e in stats["entries"]] == [3]
        entry = stats["entries"][0]
        assert weight_store().find(entry["digest"]).quant == "tp2:ep1"
        assert entry["placement"].startswith("pp=1,sp=1,ep=1,tp=2|")
        views = {tuple(id(m) for m in r.engine.shard_views[0][1].layers) for r in gen.replicas}
        assert len(views) == 1
        assert ctrl.state()["spawns"] == 1
        got = [_toks(gen.generate_step(p, max_tokens=n)) for p, n in jobs]
    finally:
        ctrl.stop()
        gen.close()
    assert got == want
    assert weight_store().stats()["trees"] == 0


SERVED = {"spill": ["--overcommit", "--spill-bytes", "67108864", "--spill-cold-after", "4"],
          "prefix_store": ["--prefix-store"], "replicas": ["--replicas", "2"],
          "disagg": ["--disagg"]}


@pytest.fixture(scope="module")
def tp2_text(ckpt):
    """What the plain ``--tp 2`` batcher answers on the tiny checkpoint."""
    mp = pytest.MonkeyPatch()
    try:
        gen, text = _answer(ckpt, mp, ["--tp", "2", "--concurrent", "2", "--paged-pool", "16"])
    finally:
        mp.undo()
    return text


@pytest.mark.parametrize("flags", list(SERVED))
def test_server_tp2_serves_movement_and_the_fleet(ckpt, tp2_text, monkeypatch, flags):
    """``--tp 2 --concurrent 2 --paged-pool 16`` with the spill tier, the
    prefix store, two replicas or a disagg pair builds over tp = 2 engines
    and answers the plain ``--tp 2`` batcher's text (in bf16, as the server
    loads the checkpoint, a tp = 2 sum rounds otherwise than tp = 1's, so
    the reference is tp = 2's; its greedy text equals JAX's in
    ``tests/test_torch_tp_serve.py``)."""
    gen, text = _answer(ckpt, monkeypatch, ["--tp", "2", "--concurrent", "2", "--paged-pool",
                                            "16", *SERVED[flags]])
    engines = ([r.engine for r in gen.replicas] if hasattr(gen, "replicas") else
               [r.engine for p in (gen.prefill, gen.decode) for r in p.replicas]
               if hasattr(gen, "prefill") else [gen.engine])
    assert engines and all(e.tp == 2 for e in engines)
    assert text == tp2_text


DRAFT_CHECKS = [["--tp", "2", "--concurrent", "2", "--draft", "ngram"],
                ["--ep", "2", "--concurrent", "2", "--paged-pool", "16", "--draft-model", "d"],
                ["--tp", "2", "--concurrent", "2", "--replicas", "2", "--draft", "ngram"],
                ["--tp", "2", "--concurrent", "2", "--paged-pool", "16", "--disagg",
                 "--draft-model", "d"]]


@pytest.mark.parametrize("argv", DRAFT_CHECKS, ids=[f"draft_{i}" for i in range(4)])
def test_draft_flags_beside_tp_fail_as_jax(argv, capsys):
    """JAX's parser refuses ``--draft-model`` and ``--draft ngram`` beside
    ``--tp`` / ``--ep`` (the batcher's speculation at tp > 1 is a library
    path): the port's fails with the same message."""
    want = _parser_error(japi.main, argv, capsys)
    assert _parser_error(tapi.main, [*argv, "--device", "cpu"], capsys) == want
    assert "--draft" in want


def test_a_second_tp2_engine_over_a_packed_model_aliases_its_placement():
    """Fault 9 of ROADMAP queue 3: a tp = 2 placement of a packed model
    copies the row splits and drops the model's wholes, so a second tp = 2
    engine over the same model raised (it sliced the dropped tensors) where
    JAX places a tree anew and serves. The placement is now the model's:
    the second engine runs the first one's shard modules (no second copy
    of the packed bytes) and both streams equal JAX's tp = 2 engine's."""
    from tests.test_torch_families import jax_pair, port
    from tests.test_torch_tp import _jax_stream

    cfg, jm, params = jax_pair("qwen3", packed=True)
    tm = port(cfg, params)
    prompt = list(range(2, 20))
    want = [t for t, _ in _jax_stream(jm, params, prompt, tp=2, max_tokens=6)]
    engines = [PipelineEngine(tm, tp=2, max_seq=64, prefill_chunk=8, device="cpu",
                              decode_block=4) for _ in range(2)]
    got = [[t for t, _ in e.generate_step(prompt, max_tokens=6)] for e in engines]
    assert got == [want, want]
    layers = [[id(m) for v in e.shard_views[0] for m in v.layers] for e in engines]
    assert layers[0] == layers[1]
