"""The port's n-gram speculation in the continuous batcher
(``ContinuousBatcher(draft="ngram")``) against the JAX package's batcher on
a ``pipeline_mesh(1)`` ragged engine with the same weights (the tiny config
of ``tests/test_torch_scheduler.py``: 2 layers, hidden 32, 3 slots, chunk
8, page 8, f32; decode blocks of 3; sync ticks, and async ones where the
test says so, each package's tick driven as it resolves).

Both batchers are driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), every request submitted first, each
with its own fake speculation clock that advances a quarter second per
read, so disabled windows re-probe at the same rounds in both. Greedy f32
streams must be token-identical to JAX's and to the port's own run with
speculation off (f32 pool), with equal ``spec_stats()``: on the f32 and
the int8 pool, sync and async (whose rounds guess the history from the
round in flight and plan on the device), under overcommit preemption, with
prefix sharing and beside a logprobs request (which pauses speculation).
The device plan equals the host's. The batcher's validation and its async
reasons are held against JAX's messages where both packages have the
case."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_scheduler import ENGINE, _engine, _jobs, models  # noqa: F401

REPEAT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
# repetitive prompts (proposals land at once), the random JOBS mix (the
# model's own output repeats, so later rounds draft from the history),
# a penalised and a biased request
SPEC_JOBS = [
    (REPEAT, dict(max_tokens=20)),
    ([3, 17, 42], dict(max_tokens=10)),
    (REPEAT[:8] * 2, dict(max_tokens=18, repetition_penalty=1.2, repetition_context_size=6)),
    ([9, 1, 9, 1, 9, 1, 9], dict(max_tokens=12, logit_bias={9: 3.0})),
]


# three requests of 37-48 tokens over a pool of 6 pages of 8: the
# overcommit batchers preempt with sync ticks and with async ones (whose
# growth reaches twice as far)
OC_JOBS = [(REPEAT, dict(max_tokens=36)), ([3, 17, 42, 5], dict(max_tokens=40)),
           ([9, 1, 9, 1, 9, 1, 9], dict(max_tokens=38))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps run on one torch thread in this module: under
    the test run's several workers, a thread pool per small op contends for
    the cores and multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self):
        self.n = itertools.count()

    def __call__(self):
        return 0.25 * next(self.n)


def _port(models, kv_dtype=None, pool=ENGINE["pool_pages"], **kw):
    kw.setdefault("spec_clock", FakeClock())
    kw.setdefault("async_sched", "off")
    return ContinuousBatcher(_engine(models, kv_dtype, pool_pages=pool), decode_block=3, **kw)


_JAX_ENGINES: dict = {}


def _jax_engine(models, kv_dtype=None, pool=ENGINE["pool_pages"]):
    """One JAX engine per pool for the module: its compiled programs serve
    every batcher built on it (the port's engines compile nothing)."""
    key = (id(models[0]), kv_dtype, pool)
    if key not in _JAX_ENGINES:
        jm, params, _ = models
        _JAX_ENGINES[key] = JPipelineEngine(jm, params, pipeline_mesh(1),
                                            cache_dtype=jnp.float32, paged_attention="ragged",
                                            kv_dtype=kv_dtype, **{**ENGINE, "pool_pages": pool})
    return _JAX_ENGINES[key]


def _jax(models, kv_dtype=None, pool=ENGINE["pool_pages"], **kw):
    eng = _jax_engine(models, kv_dtype, pool)
    kw.setdefault("spec_clock", FakeClock())
    kw.setdefault("async_sched", "off")
    return jscheduler.ContinuousBatcher(eng, decode_block=3, **kw)


def _jax_tick(batcher):
    return batcher._tick_async if batcher._async else batcher._tick


def _drive(batcher, jobs):
    tick = _jax_tick(batcher) if isinstance(batcher, jscheduler.ContinuousBatcher) else None
    items, _ = serve_on_this_thread(batcher, jobs, tick=tick)
    return [[t for t, _ in s] for s in items]


def _assert_pool_home(batcher):
    total, in_use, _ = batcher.page_stats()
    assert in_use == 0 and all(r is None for r in batcher._slots)


@pytest.mark.parametrize("sched", ["off", "auto"], ids=["sync", "async"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("jobs", ["spec", "mix"])
def test_ngram_streams_match_jax_and_plain_decode(models, kv_dtype, jobs, sched):
    work = SPEC_JOBS if jobs == "spec" else _jobs()
    jb = _jax(models, kv_dtype, draft="ngram", async_sched=sched)
    want = _drive(jb, work)
    port = _port(models, kv_dtype, draft="ngram", async_sched=sched)
    got = _drive(port, work)
    assert port._async is jb._async is (sched == "auto")
    assert got == want
    if kv_dtype is None:
        # an int8 pool's verify attends the round's own rows unquantized, as
        # JAX's does, where plain decode reads them back from the pool
        assert got == _drive(_port(models, kv_dtype, draft="off"), work)
    assert [len(s) for s in got] == [kw["max_tokens"] for _, kw in work]
    assert port.spec_stats() == jb.spec_stats()
    st = port.spec_stats()
    assert st["rounds"] > 0 and st["draft_tokens"] > 0 and port.verify_ticks > 0
    if jobs == "spec":
        assert st["accepted_tokens"] > 0
    _assert_pool_home(port)


@pytest.mark.parametrize("window_max", [2, 4])
def test_spec_window_max_matches_jax(models, window_max):
    jb = _jax(models, draft="ngram", spec_window_max=window_max)
    port = _port(models, draft="ngram", spec_window_max=window_max)
    assert _drive(port, SPEC_JOBS) == _drive(jb, SPEC_JOBS)
    assert port.spec_stats() == jb.spec_stats()
    assert port._grow_ahead == max(3, window_max)


@pytest.mark.parametrize("sched", ["off", "auto"], ids=["sync", "async"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_ngram_with_overcommit_preemption_matches_jax(models, kv_dtype, sched):
    """Over 6 pages with overcommit: both batchers preempt the same requests
    as often, re-prefill the same tokens, and speculate alike; a preempted
    speculating slot resumes on the discard path."""
    jb = _jax(models, kv_dtype, pool=6, draft="ngram", overcommit=True, async_sched=sched)
    want = _drive(jb, OC_JOBS)
    port = _port(models, kv_dtype, pool=6, draft="ngram", overcommit=True, async_sched=sched)
    got = _drive(port, OC_JOBS)
    assert jb.preemptions >= 1
    assert (port.preemptions, port.reprefill_tokens) == (jb.preemptions, jb.reprefill_tokens)
    assert got == want
    assert port.spec_stats() == jb.spec_stats()
    assert port.pages_high_water <= 6
    _assert_pool_home(port)


def test_ngram_with_prefix_sharing_matches_jax(models):
    """Two rounds over a shared 16-token prefix: the second round maps the
    first's registered pages, and speculates past them."""
    shared = REPEAT + [11, 12, 13, 14, 15]
    rounds = [[(shared + [20, 21], dict(max_tokens=12))],
              [(shared + [22], dict(max_tokens=10)), (shared + [23, 24, 25], dict(max_tokens=8))]]
    outs = {}
    for name, batcher in (("jax", _jax(models, draft="ngram", prefix_cache=True)),
                          ("port", _port(models, draft="ngram", prefix_cache=True))):
        outs[name] = [_drive(batcher, jobs) for jobs in rounds]
        outs[name + "_stats"] = (batcher.prefix_stats(), batcher.spec_stats())
    assert outs["port"] == outs["jax"]
    assert outs["port_stats"] == outs["jax_stats"]
    assert outs["port_stats"][0][1] >= 2  # both later requests hit


def test_logprobs_request_pauses_speculation_as_jax_does(models):
    """While a slot wants logprob summaries every tick is a plain block;
    the streams and summaries match JAX's, and speculation resumes after."""
    jobs = [(REPEAT, dict(max_tokens=14)), ([4, 8, 15, 16], dict(max_tokens=5,
                                                                want_logprobs=True))]
    runs = {}
    for name, batcher in (("jax", _jax(models, draft="ngram")),
                          ("port", _port(models, draft="ngram", async_sched="off"))):
        tick = batcher._tick if name == "jax" else None
        runs[name] = serve_on_this_thread(batcher, jobs, tick=tick)[0]
        runs[name + "_stats"] = batcher.spec_stats()
    assert [[t for t, _ in s] for s in runs["port"]] == [[t for t, _ in s] for s in runs["jax"]]
    for (_, g), (_, w) in zip(runs["port"][1][1:], runs["jax"][1][1:]):
        assert abs(g.chosen - w.chosen) < 1e-4
        np.testing.assert_array_equal(g.top_indices, w.top_indices)
    assert runs["port_stats"] == runs["jax_stats"]
    assert runs["port_stats"]["rounds"] > 0


def test_sampled_ngram_streams_repeat(models):
    """Seeded sampled requests under speculation: the same streams in two
    runs of the same geometry and ticks (the draws equal JAX's in
    distribution only)."""
    jobs = [([9, 1, 9, 1, 9], dict(max_tokens=12, temperature=0.9, top_p=0.85, seed=321)),
            (REPEAT, dict(max_tokens=10))]
    runs = [_drive(_port(models, draft="ngram", async_sched=s), jobs)
            for s in ("off", "off", "on", "on")]
    assert runs[0] == runs[1] and runs[2] == runs[3]
    assert [len(s) for s in runs[0]] == [12, 10]


def test_spec_k_without_a_draft_engine_does_nothing(models):
    port = _port(models, spec_k=2)
    assert port.spec_stats() is None and port._spec_mode == "off"
    assert _drive(port, SPEC_JOBS[:2]) == _drive(_port(models), SPEC_JOBS[:2])
    assert port.verify_ticks == 0


def _error(exc, fn):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [
    dict(draft="lookahead"),
    dict(draft="engine"),
    dict(draft="ngram", spec_window_max=1),
    dict(draft="ngram", spec_window_max=True),
    dict(draft="ngram", spec_window_max=2.5),
    dict(spec_window_max=4),
    dict(draft="off", draft_engine=object()),
    dict(draft="ngram", draft_engine=object()),
])
def test_validation_matches_jax(models, kw):
    """JAX's ``test_scheduler_ngram_validation`` rows (the pp=2 row aside:
    the port's engine is pp=1 only) and the draft-engine conflicts: the
    same ValueError messages."""
    jeng = _jax_engine(models)
    want = _error(ValueError, lambda: jscheduler.ContinuousBatcher(jeng, **kw))
    assert _error(ValueError, lambda: ContinuousBatcher(_engine(models), **kw)) == want


def test_ngram_always_runs_the_tracker(models):
    b = _port(models, draft="ngram")
    assert b.spec_tracker is not None and b._w_max == 8 and b.spec_tracker.rungs == (2, 4, 8)
    assert b.spec_stats()["mode"] == "ngram" and b.spec_stats()["window_max"] == 8


def test_async_reasons(models):
    """``auto`` resolves as JAX's does, with its reasons: plain decode and
    n-gram speculation are async; ``on`` and ``off`` are taken as asked; a
    draft engine resolves ``auto`` to sync and refuses ``on``, as JAX's."""
    jeng = _jax_engine(models)
    for kw in (dict(), dict(draft="ngram"), dict(draft="ngram", async_sched="off"),
               dict(draft="ngram", async_sched="on")):
        jb = jscheduler.ContinuousBatcher(jeng, **kw)
        port = ContinuousBatcher(_engine(models), **kw)
        assert (port._async, port.async_reason) == (jb._async, jb.async_reason), kw
        jb.close()
    ngram = _port(models, draft="ngram", async_sched="auto")
    assert ngram._async and ngram._grow_ahead == 16
    jm, params, tm = models
    dense = dict(microbatches=3, max_seq=64, prefill_chunk=8)
    jdraft = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, **dense)
    tdraft = PipelineEngine(tm, device="cpu", **dense)
    jb = jscheduler.ContinuousBatcher(jeng, draft_engine=jdraft)
    port = ContinuousBatcher(_engine(models), draft_engine=tdraft)
    assert (port._async, port.async_reason) == (jb._async, jb.async_reason) and not port._async
    want = _error(ValueError, lambda: jscheduler.ContinuousBatcher(jeng, draft_engine=jdraft,
                                                                   async_sched="on"))
    assert _error(ValueError, lambda: ContinuousBatcher(_engine(models), draft_engine=tdraft,
                                                        async_sched="on")) == want


def _host_plan(eng, offsets, table, active, steps):
    """Every slot's write page, row, length, position and table row for
    ``steps`` steps, built on the host in numpy."""
    m, page, spg = eng.microbatches, eng.page_size, eng.slot_pages
    act = np.asarray(active, bool)
    pos = np.asarray(offsets, np.int64)[None, :] + np.arange(steps)[:, None]
    pos = np.where(act[None, :], pos, 0)  # (K, M)
    rows = np.where(act[:, None], table[:m], table[m][None, :])  # (M, SPG)
    pidx = pos // page
    page_ids = rows[np.arange(m)[None, :], np.minimum(pidx, spg - 1)]
    page_ids = np.where(pidx < spg, page_ids, eng.pool_pages)
    lengths = np.where(act[None, :], pos + 1, 0)
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
            for a in (page_ids, pos % page, lengths, pos, rows)]


def test_device_plan_equals_the_host_plan(models):
    """The plan a step makes on the device from the slot offsets equals one
    built on the host: offsets inside, at and past page edges, an inactive
    slot, a position past the mapped pages (the scratch page)."""
    eng = _engine(models)
    cache, table = eng.init_cache_paged()
    table[0, :3] = [4, 1, 7]
    table[1, :2] = [2, 9]
    table[2, :8] = np.arange(8)
    for offsets, active in (([3, 7, 0], [True, True, False]), ([15, 8, 60], [True, True, True]),
                            ([22, 14, 5], [True, False, True])):
        for steps in (1, 4, 8):
            want = _host_plan(eng, offsets, table, active, steps)
            inputs = eng.device_inputs(("t", steps), table, active, offsets, True)
            got = eng.device_plan(inputs.offsets.long(), inputs, steps)
            for w, g in zip(want, (got.page_ids, got.row_pos, got.lengths, got.positions,
                                   got.tables)):
                assert g.dtype == torch.int32 and torch.equal(g, w)
