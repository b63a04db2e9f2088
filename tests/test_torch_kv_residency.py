"""The port's spill tier in the batcher (preemption that spills instead of
discarding, cold-slot spill and wake, prefetch) against the JAX package's
``ContinuousBatcher`` (``tests/test_kv_transfer.py``'s spill harness and
``tests/test_kv_residency.py``'s single-host cases), over the tiny f32
Llama of ``tests/test_torch_scheduler.py`` on a ``pipeline_mesh(1)``
ragged engine: 2 slots, capacity 64, chunk 8, page 8, a pool of 8 pages
that two requests needing 6 and 5 pages cannot share, so overcommit
preempts.

Both batchers are driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), every request submitted first, and
both tiers flush synchronously (``_flush_async = False``), so the two
packages preempt, spill, prefetch and import at the same ticks: greedy
streams must be token-identical and every ``spill_stats()`` counter equal
(JAX's batcher is reused across cases, so the counters compared are each
run's increments). A seeded stream, which the two packages draw
differently, must equal the same request served without preemption. Left
out: the drain and crash re-placement cases (``migrate_out``, replicas,
slice 8)."""

import jax.numpy as jnp
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults
from tests.test_torch_scheduler import models  # noqa: F401

ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=8, page_size=8)
GREEDY = [([7, 7, 2, 1], dict(max_tokens=40)), ([9, 4, 4, 6], dict(max_tokens=36))]
SEEDED = ([9, 4, 4, 6], dict(temperature=0.9, top_p=0.85, seed=321, repetition_penalty=1.3,
                             repetition_context_size=8, max_tokens=36))
COUNTERS = ("spills", "spill_hits", "spill_fallbacks", "reprefill_tokens", "preemptions",
            "cold_spills", "cold_wakes", "prefetches", "prefetch_hits", "demand_imports",
            "prefetch_faults", "evictions", "rejects", "rejects_oversize", "tier_hits",
            "tier_misses")


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
    faults.disarm()
    jfaults.disarm()


_JAX: dict = {}


def _jax(models, key, **kw):
    """One JAX batcher per configuration for the module (its compiled
    block programs are most of the file's time), its tier flushing
    synchronously."""
    if key not in _JAX:
        jm, params, _ = models
        eng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                              paged_attention="ragged", **ENGINE)
        _JAX[key] = jscheduler.ContinuousBatcher(eng, decode_block=3, **kw)
        if _JAX[key].spill is not None:
            _JAX[key].spill._flush_async = False
    return _JAX[key]


@pytest.fixture(scope="module", autouse=True)
def _close_jax():
    yield
    for b in _JAX.values():
        b.close()
    _JAX.clear()


def _port(models, pool=ENGINE["pool_pages"], **kw):
    b = ContinuousBatcher(PipelineEngine(models[2], device="cpu", **{**ENGINE,
                                                                      "pool_pages": pool}),
                          decode_block=3, **kw)
    if b.spill is not None:
        b.spill._flush_async = False
    return b


def _serve(batcher, jobs, **kw):
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        kw["tick"] = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, **kw)
    return [[t for t, _ in s] for s in items]


def _run(batcher, jobs, **kw):
    """The streams and the run's increments of the ``spill_stats``
    counters."""
    before = batcher.spill_stats()
    streams = _serve(batcher, jobs, **kw)
    after = batcher.spill_stats()
    return streams, {k: after[k] - before[k] for k in COUNTERS}


def _assert_pool_home(batcher):
    total, in_use, _ = batcher.page_stats()
    assert in_use == 0 and len(batcher._free_pages) == total
    assert batcher.spill_stats()["bytes_in_use"] == 0 and not batcher._parked


@pytest.mark.parametrize("async_sched", ["on", "off"])
def test_spilled_preemption_equals_jax(models, async_sched):
    """The spill tier on: the newcomer is preempted, its pages exported,
    staged and imported instead of re-prefilled, in both packages at the
    same ticks; streams and counters equal JAX's, no re-prefilled token."""
    kw = dict(overcommit=True, spill_bytes=64 << 20, async_sched=async_sched)
    want, jstats = _run(_jax(models, ("spill", async_sched), **kw), GREEDY)
    port = _port(models, **kw)
    got, stats = _run(port, GREEDY)
    assert got == want and stats == jstats
    assert stats["preemptions"] >= 1 and stats["spill_hits"] == stats["spills"] >= 1
    assert stats["prefetch_hits"] >= 1 and stats["reprefill_tokens"] == 0
    assert port.resilience_stats()["spills"] == stats["spills"]
    _assert_pool_home(port)


@pytest.mark.parametrize("site", ["cache.export", "cache.import", "cache.prefetch"])
def test_each_fault_site_degrades_as_jax(models, site):
    """A fault at each site: an export fault takes the discard path, an
    import fault re-prefills the folded history, a prefetch fault the
    demand import; the streams stay JAX's, the counters equal JAX's."""
    kw = dict(overcommit=True, spill_bytes=64 << 20, async_sched="on")
    jb = _jax(models, ("spill", "on"), **kw)
    jfaults.arm(site, exc=jfaults.FaultError, times=1)
    want, jstats = _run(jb, GREEDY)
    port = _port(models, **kw)
    faults.arm(site, exc=faults.FaultError, times=1)
    got, stats = _run(port, GREEDY)
    assert got == want and stats == jstats
    if site == "cache.prefetch":
        # the next tick's pass stages the block again
        assert stats["prefetch_faults"] == 1 and stats["spill_hits"] >= 1
    else:
        assert stats["spill_fallbacks"] >= 1 and stats["reprefill_tokens"] > 0
    _assert_pool_home(port)


@pytest.mark.parametrize("prefetch", ["off", "auto"])
def test_prefetch_modes_count_staged_and_demand_imports(models, prefetch):
    """``kv_prefetch`` off: every resume copies its own payload (a counted
    demand import); auto (on with a tier): the resume takes the stage.
    Streams equal the sync JAX batcher's."""
    want, jstats = _run(_jax(models, ("spill", "off"), overcommit=True, spill_bytes=64 << 20,
                             async_sched="off"), GREEDY)
    port = _port(models, overcommit=True, spill_bytes=64 << 20, async_sched="off",
                 kv_prefetch=prefetch)
    got, stats = _run(port, GREEDY)
    assert got == want
    assert port.spill_stats()["prefetch_enabled"] is (prefetch == "auto")
    if prefetch == "auto":
        assert stats == jstats
    else:
        assert (stats["prefetches"], stats["prefetch_hits"]) == (0, 0)
        assert stats["demand_imports"] == stats["spill_hits"] >= 1


def test_seeded_stream_through_a_spill_equals_it_alone(models):
    """A seeded top-p request with a repetition penalty preempted behind a
    greedy hog resumes from its block with its generator's state and its
    window: both streams equal the same requests served without
    preemption, and nothing is re-prefilled."""
    jobs = [GREEDY[0], SEEDED]
    alone = _serve(_port(models, pool=16), jobs)
    port = _port(models, overcommit=True, spill_bytes=64 << 20)
    got, stats = _run(port, jobs)
    assert got == alone
    assert stats["spill_hits"] >= 1 and stats["reprefill_tokens"] == 0


def test_budget_too_small_for_any_block_falls_back_exactly(models):
    """A tier smaller than any block rejects every spill: preemption takes
    the discard path, counted, and the streams stay JAX's."""
    want = _run(_jax(models, ("spill", "on"), overcommit=True, spill_bytes=64 << 20,
                     async_sched="on"), GREEDY)[0]
    port = _port(models, overcommit=True, spill_bytes=64)
    got, stats = _run(port, GREEDY)
    assert got == want
    assert stats["spills"] == 0 and stats["rejects_oversize"] == stats["spill_fallbacks"] >= 1
    _assert_pool_home(port)


COLD_JOBS = [([7, 7, 2, 1], dict(max_tokens=30)), ([9, 4, 4, 6, 1, 3], dict(max_tokens=24))]
COLD = dict(spill_bytes=64 << 20, spill_cold_after=2, kv_prefetch="on")


@pytest.fixture(scope="module")
def cold_jax(models):
    """JAX's async batcher's run of ``COLD_JOBS`` with reader 0 stopping
    after 3 tokens for 12 ticks."""
    return _run(_jax(models, "cold", async_sched="on", **COLD), COLD_JOBS, hold=(0, 3, 12))


@pytest.mark.parametrize("async_sched", ["on", "off"])
def test_cold_spill_and_wake_equal_jax(models, cold_jax, async_sched):
    """One reader stops after 3 tokens for 12 ticks: after 2 stagnant scans
    its slot is spilled and parked, its pages freed; when it reads again
    the request wakes at the head of the line, its block staged, and the
    resumed stream equals JAX's and the never-spilled run; with async
    ticks every counter equals JAX's async batcher's too."""
    want, jstats = cold_jax
    port = _port(models, async_sched=async_sched, **COLD)
    got, stats = _run(port, COLD_JOBS, hold=(0, 3, 12))
    assert got == want == _serve(_port(models, pool=16), COLD_JOBS)
    if async_sched == "on":
        assert stats == jstats
    assert stats["cold_spills"] >= 1 and stats["cold_wakes"] == stats["cold_spills"]
    assert stats["spill_hits"] == stats["cold_spills"] and stats["reprefill_tokens"] == 0
    assert stats["prefetch_hits"] == stats["spill_hits"]
    _assert_pool_home(port)


def test_cancel_while_parked_reaps_cleanly(models):
    """A parked request whose client walks away is reaped at the next wake
    pass: its stream ends, its block leaves the tier, no page leaks."""
    port = _port(models, spill_bytes=64 << 20, spill_cold_after=2)
    port._ensure_running = lambda: None
    stream = port.generate_step([7, 7, 2, 1], max_tokens=30)
    req = port._submit.queue[-1]
    with torch.no_grad():
        while req.out.empty():
            port.run_tick()
        next(stream)  # one token read, then the client stops reading
        for _ in range(200):
            if port._parked:
                break
            port.run_tick()
    assert port._parked == [req] and port.spill_stats()["blocks"] == 1
    stream.close()  # the client leaves without reading
    with torch.no_grad():
        port.run_tick()
    assert not port._parked and port.spill_stats()["blocks"] == 0
    _assert_pool_home(port)


def _refusal(make) -> str:
    with pytest.raises(ValueError) as info:
        make()
    return str(info.value)


@pytest.mark.parametrize("kw", [
    dict(spill_bytes=0), dict(spill_bytes=True), dict(spill_cold_after=2),
    dict(spill_bytes=1 << 20, spill_cold_after=0), dict(kv_prefetch="on"),
    dict(kv_prefetch="sometimes"),
], ids=["zero_budget", "bool_budget", "cold_without_tier", "cold_zero", "prefetch_without_tier",
        "prefetch_value"])
def test_spill_arguments_refused_with_jax_messages(models, kw):
    jb = _jax(models, ("spill", "on"), overcommit=True, spill_bytes=64 << 20,
              async_sched="on")
    want = _refusal(lambda: jscheduler.ContinuousBatcher(jb.engine, **kw))
    assert _refusal(lambda: _port(models, **kw)) == want


def test_spill_refused_on_dense_slots_and_with_a_draft_engine(models):
    """The paged-engine and draft-engine refusals (JAX's messages)."""
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher as TB

    dense = PipelineEngine(models[2], device="cpu", microbatches=2, max_seq=64, prefill_chunk=8)
    assert _refusal(lambda: TB(dense, spill_bytes=1 << 20)) == (
        "KV spill (--spill-bytes) requires a paged engine (pool_pages): spilling moves pool "
        "pages")
    draft = PipelineEngine(models[2], device="cpu", microbatches=2, max_seq=64, prefill_chunk=8)
    paged = PipelineEngine(models[2], device="cpu", **ENGINE)
    assert _refusal(lambda: TB(paged, draft_engine=draft, spill_bytes=1 << 20)) == (
        "KV spill is incompatible with a draft engine — speculative slots re-prefill on "
        "preemption")
