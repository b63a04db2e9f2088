"""The continuous batcher over the port's pipeline engine at pp = 2 against
the JAX package's batcher over its pp = 2 engine, on the CPU in f32: three
mixed-length requests over dense slots and over an f32 and an int8 page
pool (which decode on the ``gather`` path at pp > 1, as JAX resolves
``auto``), both batchers driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), every request submitted first;
overcommit admission at pp = 2 against JAX's and against reserve
admission; and each cache's own per-stage programs. Greedy streams must be
token-identical. The tiny Llama (4 layers, hidden 32) is
``tests/test_torch_pipeline_archs.py``'s."""

import jax.numpy as jnp
import pytest

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_pipeline_archs import _llama, _Replay, one_torch_thread  # noqa: F401

JOBS = [([5, 9, 2, 7, 11], dict(max_tokens=9)), ([3, 17, 42], dict(max_tokens=12)),
        ([8, 1, 6, 6, 2, 9, 4, 4, 7, 30, 31, 12, 5], dict(max_tokens=7))]
GEOMETRY = dict(microbatches=3, max_seq=64, prefill_chunk=8)
POOL = dict(pool_pages=12, page_size=8)


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


def _drive(batcher, jobs=JOBS):
    tick = None
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        tick = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, tick=tick)
    batcher.close()
    return [[t for t, _ in s] for s in items]


@pytest.mark.parametrize("kind", ["dense", "pool", "int8_pool"])
def test_batcher_at_pp2_matches_jax(llama4, kind):
    """Three mixed-length requests through the batcher over an engine of
    two stages, dense slots or a pool (which decodes on ``gather`` at
    pp = 2, as JAX resolves ``auto``), f32 or int8: token-identical to
    JAX's batcher over its pp = 2 engine, driven tick by tick."""
    jm, params, tm = llama4
    kw = dict(GEOMETRY, **(POOL if kind != "dense" else {}),
              **({"kv_dtype": "int8"} if kind == "int8_pool" else {}))
    jeng = jpipeline.PipelineEngine(jm, params, pipeline_mesh(2), cache_dtype=jnp.float32, **kw)
    want = _drive(jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off"))
    eng = PipelineEngine(tm, stages=2, device="cpu", **kw)
    assert eng.paged_attention == jeng.paged_attention
    assert eng.decode_path == ("dense" if kind == "dense" else "gather")
    got = _drive(ContinuousBatcher(eng, decode_block=3))
    assert got == want


def test_batcher_overcommit_at_pp2_matches_reserve(llama4):
    """Overcommit admission over a pool too small for every request's
    reserve preempts and resumes at pp = 2 as JAX's batcher over its pp = 2
    engine does on the same 6-page pool, both on synchronous ticks: the
    same preemptions, the same
    re-prefilled tokens, token-identical streams; and those streams equal
    reserve admission's over a pool large enough."""
    jm, params, tm = llama4
    jobs = [([3, 1, 4, 1, 5, 9, 2, 6], dict(max_tokens=24)) for _ in range(3)]
    small = dict(GEOMETRY, pool_pages=6, page_size=8)
    jeng = jpipeline.PipelineEngine(jm, params, pipeline_mesh(2), cache_dtype=jnp.float32,
                                    **small)
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, overcommit=True, async_sched="off")
    want = _drive(jb, jobs)
    port = ContinuousBatcher(PipelineEngine(tm, stages=2, device="cpu", **small),
                             decode_block=3, overcommit=True, async_sched="off")
    assert _drive(port, jobs) == want
    assert jb.preemptions >= 1
    assert (port.preemptions, port.reprefill_tokens) == (jb.preemptions, jb.reprefill_tokens)
    reserve = _drive(ContinuousBatcher(PipelineEngine(tm, stages=2, device="cpu",
                                                      **GEOMETRY, **POOL), decode_block=3), jobs)
    assert want == reserve


def test_stage_programs_are_kept_per_cache(llama4):
    """With each stage's share of a step as a program of its own, each
    cache the engine steps has programs of its own (a captured program
    writes the rows of the cache it was captured over): every program run
    again as its first call brought it (``_Replay``), a batcher beside the
    engine's single stream serves over its own rows, and the stream before
    and after it equals the pp = 1 Generator's."""
    _, _, tm = llama4
    prompt = list(range(3, 20))
    jobs = [(prompt, dict(max_tokens=8)), (prompt[:9], dict(max_tokens=5))]
    ref = [[t for t, _ in Generator(tm, max_seq=64, prefill_chunk=8).generate_step(
        p, **kw)] for p, kw in jobs]
    eng = PipelineEngine(tm, stages=2, device="cpu", decode_block=4, stage_graphs=True,
                         **dict(GEOMETRY, microbatches=2))
    stream = eng.stream().model.graphs
    stream.graphs = [_Replay(), _Replay()]
    assert [t for t, _ in eng.generate_step(prompt, max_tokens=8)] == ref[0]
    batcher = ContinuousBatcher(eng, decode_block=4)
    own = eng._graphs_for(batcher.cache)
    assert own is not stream and own.graphs is None  # no card here
    own.graphs = [_Replay(), _Replay()]
    items, _ = serve_on_this_thread(batcher, jobs)
    assert [[t for t, _ in s] for s in items] == ref
    assert [t for t, _ in eng.generate_step(prompt, max_tokens=8)] == ref[0]
    for graphs in (stream, own):
        assert all(("decode",) in g.programs for g in graphs.graphs)
    batcher.close()


