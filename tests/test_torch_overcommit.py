"""The port's async ticks and overcommit admission with preemption, against
the JAX package's ``ContinuousBatcher`` on a ``pipeline_mesh(1)`` ragged
engine with the same weights (the tiny config and the ``JOBS`` mix of
``tests/test_torch_scheduler.py``: 2 layers, hidden 32, 3 slots, chunk 8,
page 8, f32).

Both batchers are driven tick by tick on the test's thread, every request
submitted before the first tick, so the two packages see the same tick
sequence and preempt the same requests at the same ticks. Greedy f32
streams must be token-identical (f32 and int8 pools); the port's async and
sync streams bit-identical, a seeded top-p request with logprobs among
them; a preempted seeded stream equal to the same request served alone."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_scheduler import ENGINE, JOBS, _engine, _jobs, models  # noqa: F401

# the JOBS mix's largest request needs 6 pages of 8; over a pool of 6 the
# overcommit batchers admit on current need and must preempt
OC_POOL = 6
SEEDED = dict(max_tokens=16, temperature=0.9, top_p=0.8, seed=11, repetition_penalty=1.2,
              repetition_context_size=6)


def _drive(batcher, jobs, **kw):
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        kw["tick"] = batcher._tick_async if batcher._async else batcher._tick
    return serve_on_this_thread(batcher, jobs, **kw)[0]


def _tokens(streams):
    return [[t for t, _ in s] for s in streams]


def _port(models, kv_dtype=None, pool=OC_POOL, **kw):
    return ContinuousBatcher(_engine(models, kv_dtype, pool_pages=pool), decode_block=3, **kw)


def _jax(models, kv_dtype=None, pool=OC_POOL, **kw):
    jm, params, _ = models
    eng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                          paged_attention="ragged", kv_dtype=kv_dtype,
                          **{**ENGINE, "pool_pages": pool})
    return jscheduler.ContinuousBatcher(eng, decode_block=3, **kw)


def _assert_pool_home(batcher):
    total, in_use, _ = batcher.page_stats()
    assert in_use == 0 and len(batcher._free_pages) == total
    assert all(r is None for r in batcher._slots) and not batcher._waiting


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_overcommit_streams_token_identical_to_jax(models, kv_dtype):
    """The JOBS mix over 6 pages: both batchers (async ticks, overcommit)
    preempt the same requests as often and re-prefill the same tokens, and
    every greedy stream is token-identical."""
    jb = _jax(models, kv_dtype, overcommit=True)
    try:
        want = _tokens(_drive(jb, _jobs()))
    finally:
        jb.close()
    port = _port(models, kv_dtype, overcommit=True)
    got = _tokens(_drive(port, _jobs()))
    assert jb._async and port._async
    assert jb.preemptions >= 1
    assert (port.preemptions, port.reprefill_tokens) == (jb.preemptions, jb.reprefill_tokens)
    assert got == want
    assert [len(s) for s in got] == [kw["max_tokens"] for _, kw in JOBS]
    assert port.pages_high_water <= OC_POOL
    _assert_pool_home(port)


@pytest.mark.parametrize("overcommit", [False, True], ids=["reserve", "overcommit"])
def test_async_streams_bit_identical_to_sync(models, overcommit):
    """The JOBS mix plus a seeded top-p request with logprobs: the same
    tokens and the same logprob summaries through async and sync ticks
    (the sync run harvests every block before the next; the async run
    dispatches a block ahead, drops lookahead tokens and quiesces)."""
    jobs = _jobs() + [([int(t) for t in np.random.default_rng(1).integers(1, 300, size=19)],
                       dict(SEEDED, want_logprobs=True))]
    runs = {}
    for mode in ("off", "on"):
        batcher = _port(models, pool=OC_POOL if overcommit else ENGINE["pool_pages"],
                        overcommit=overcommit, async_sched=mode)
        runs[mode] = _drive(batcher, jobs)
        stats = batcher.tick_timing_stats()
        assert stats["path"] == ("async" if mode == "on" else "sync") and stats["ticks"] > 0
        assert stats["device_blocked_ms_avg"] >= 0 and stats["host_ms_avg"] >= 0
        _assert_pool_home(batcher)
    assert _tokens(runs["on"]) == _tokens(runs["off"])
    for (_, a), (_, b) in zip(runs["on"][-1], runs["off"][-1]):
        assert a.chosen == b.chosen
        np.testing.assert_array_equal(a.top_indices, b.top_indices)
        np.testing.assert_array_equal(a.top_values, b.top_values)
    assert [len(s) for s in runs["on"]] == [kw["max_tokens"] for _, kw in jobs]


@pytest.mark.parametrize("async_sched", ["on", "off"])
def test_preempted_seeded_stream_equals_it_alone(models, async_sched):
    """A greedy hog admitted first and a seeded top-p request with a
    repetition penalty, each needing 6 of the 8 pages in the end: the
    newcomer is preempted, and resumes with its generator's state and its
    window restored, so both streams equal the same requests served
    alone."""
    jobs = [([7, 7, 2, 1], dict(max_tokens=40)),
            ([9, 4, 4, 6], dict(SEEDED, max_tokens=36))]
    alone = [_tokens(_drive(_port(models, pool=8, async_sched=async_sched), [job]))[0]
             for job in jobs]
    batcher = _port(models, pool=8, overcommit=True, async_sched=async_sched)
    got = _tokens(_drive(batcher, jobs))
    assert batcher.preemptions >= 1 and batcher.reprefill_tokens > 0
    assert got == alone
    _assert_pool_home(batcher)


def test_pool_exhaustion_with_one_request_left_errors_not_wedges(models):
    """The lone request cannot grow (the free list vanishes under it, as
    accounting drift would make it): its stream ends with the error, and
    the batcher does not wedge against the scratch page."""
    batcher = _port(models, pool=4, overcommit=True)
    batcher._ensure_running = lambda: None
    stream = batcher.generate_step([5, 9], max_tokens=24)  # 4 pages in the end
    req = batcher._submit.queue[0]
    with torch.no_grad():
        while req.out.empty():
            batcher.run_tick()
        assert isinstance(next(stream)[0], int)
        batcher._free_pages = []
        for _ in range(50):
            if req.slot < 0:
                break
            batcher.run_tick()
    with pytest.raises(RuntimeError, match="KV page pool exhausted"):
        list(stream)
    assert req.slot < 0 and req.produced < 24


def _error(exc_type, fn):
    with pytest.raises(exc_type) as info:
        fn()
    return str(info.value)


def test_async_sched_and_overcommit_validation(models):
    """``auto`` and ``on`` run async ticks, ``off`` sync ones, anything
    else is refused; overcommit without a pool is refused with the JAX
    batcher's message, and each mode doubles or keeps the growth reach."""
    jm, params, _ = models
    dense = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                            microbatches=3, max_seq=64, prefill_chunk=8)
    want = _error(ValueError, lambda: jscheduler.ContinuousBatcher(dense, overcommit=True))
    no_pool = types.SimpleNamespace(microbatches=3, pool_pages=None)
    assert _error(ValueError, lambda: ContinuousBatcher(no_pool, overcommit=True)) == want
    assert "async_sched" in _error(ValueError, lambda: _port(models, async_sched="sometimes"))
    for mode, is_async in (("auto", True), ("on", True), ("off", False)):
        batcher = _port(models, overcommit=True, async_sched=mode)
        assert batcher._async is is_async and batcher.overcommit
        assert batcher._grow_ahead == (6 if is_async else 3)
        assert batcher.tick_timing_stats()["path"] == ("async" if is_async else "sync")


@pytest.mark.parametrize("how", ["max_tokens", "cancelled"])
def test_lookahead_block_over_a_finished_slot(models, how):
    """A slot that finishes (its last token, or its client walking away
    after three) while the next block is already in flight: that block's
    tokens for it are dropped, its pages come home, its host offset is
    rolled back to where a sync run leaves it, and the survivor's stream
    equals the same request served alone."""
    survivor = ([9, 4, 4, 6, 1, 3], dict(max_tokens=16))
    short = ([7, 7, 2, 1], dict(max_tokens=5 if how == "max_tokens" else 30))
    cancel = (1, 3) if how == "cancelled" else None
    want = _tokens(_drive(_port(models, pool=8), [survivor]))[0]
    offsets = {}
    for mode in ("off", "on"):
        batcher = _port(models, pool=8, async_sched=mode)
        items, reqs = serve_on_this_thread(batcher, [survivor, short], cancel_after=cancel)
        got = _tokens(items)
        assert got[0] == want
        assert len(got[1]) == (5 if how == "max_tokens" else 3)
        if how == "max_tokens":  # nothing emitted past the end, not even unread
            assert reqs[1].produced == len(reqs[1].history) == 5
        offsets[mode] = list(batcher.cache.offsets)
        _assert_pool_home(batcher)
    assert offsets["on"][:2] == offsets["off"][:2]
