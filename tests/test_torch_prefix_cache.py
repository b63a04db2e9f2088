"""The port's prefix sharing over the paged pool (``ContinuousBatcher(
prefix_cache=True)``) against the JAX package's batcher on a
``pipeline_mesh(1)`` ragged engine with the same weights (the tiny config of
``tests/test_torch_scheduler.py``: 2 layers, hidden 32, 3 slots, chunk 8,
page 8, f32 and int8 pools).

Both batchers are driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), in rounds: every request of a round
is submitted before its first tick, and a round starts when the last one
has ended, so that a later round finds the pages an earlier one
registered. The ``prefix_stats()`` tuples (queries, hits, tokens reused,
evictions, cached pages) must be equal, and every greedy stream
token-identical to JAX's and to the port's own run with the cache off."""

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch.sample import make_sampler_params
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher, _Request
from tests.test_torch_scheduler import ENGINE, _engine, models  # noqa: F401
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(11)
SYSTEM = [int(t) for t in RNG.integers(1, 300, size=24)]  # three pages of 8


def _prompt(n_shared, n_own, seed):
    own = np.random.default_rng(seed).integers(1, 300, size=n_own)
    return SYSTEM[:n_shared] + [int(t) for t in own]


# rounds of (prompt, kwargs): a request that registers the system prompt's
# pages, then requests that share two or three of them (one exactly a page
# edge past them, one shorter than a page past them), then one that shares
# none, then the first prompt again (its last page is capped: the last
# token always goes through prefill)
ROUNDS = [
    [(_prompt(24, 5, 1), dict(max_tokens=6))],
    [(_prompt(24, 3, 2), dict(max_tokens=5)), (_prompt(16, 8, 3), dict(max_tokens=7)),
     (_prompt(16, 1, 4), dict(max_tokens=4))],
    [(_prompt(0, 12, 5), dict(max_tokens=5)), (_prompt(24, 5, 1), dict(max_tokens=6))],
]


def _port(models, kv_dtype=None, pool=ENGINE["pool_pages"], **kw):
    return ContinuousBatcher(_engine(models, kv_dtype, pool_pages=pool), decode_block=3, **kw)


def _jax(models, kv_dtype=None, pool=ENGINE["pool_pages"], **kw):
    jm, params, _ = models
    eng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                          paged_attention="ragged", kv_dtype=kv_dtype,
                          **{**ENGINE, "pool_pages": pool})
    return jscheduler.ContinuousBatcher(eng, decode_block=3, **kw)


def _serve(batcher, rounds):
    """Each round's greedy streams, and the batcher's prefix_stats() after
    every round."""
    tick = None
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        tick = batcher._tick_async if batcher._async else batcher._tick
    streams, stats = [], []
    try:
        for jobs in rounds:
            got, _ = serve_on_this_thread(batcher, jobs, tick=tick)
            streams.append([[t for t, _ in s] for s in got])
            stats.append(batcher.prefix_stats())
    finally:
        batcher.close()
    return streams, stats


def _pool_home(batcher):
    """Every page is free or held by the index alone, once at a time."""
    held = sorted(batcher._free_pages + list(batcher._prefix_index.values()))
    assert held == list(range(batcher.engine.pool_pages))
    assert all(batcher._page_ref.get(p) == 1 for p in batcher._prefix_index.values())


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_prefix_stats_and_streams_match_jax(models, kv_dtype):
    """The rounds over a 10-page pool: the same hits, reused tokens and
    cached pages after every round, the same streams as JAX, and the same
    streams as the port with the cache off."""
    want_streams, want_stats = _serve(_jax(models, kv_dtype, prefix_cache=True), ROUNDS)
    port = _port(models, kv_dtype, prefix_cache=True)
    got_streams, got_stats = _serve(port, ROUNDS)
    off_streams, off_stats = _serve(_port(models, kv_dtype), ROUNDS)
    assert got_stats == want_stats
    # six queries; hits of three, two, two and three pages
    assert got_stats[-1][:3] == (6, 4, 8 * (3 + 2 + 2 + 3))
    assert got_streams == want_streams == off_streams
    assert off_stats == [None] * len(ROUNDS)
    _pool_home(port)


def test_eviction_in_a_small_pool_matches_jax(models):
    """Over 6 pages every round needs pages that only the index holds: the
    least recently used are evicted, as many as JAX evicts, and the streams
    stay those of the cache off."""
    pool = 6
    want_streams, want_stats = _serve(_jax(models, pool=pool, prefix_cache=True), ROUNDS)
    port = _port(models, pool=pool, prefix_cache=True)
    got_streams, got_stats = _serve(port, ROUNDS)
    off_streams, _ = _serve(_port(models, pool=pool), ROUNDS)
    assert got_stats == want_stats
    assert got_stats[-1][3] >= 1  # evictions
    assert got_streams == want_streams == off_streams
    _pool_home(port)


def test_overcommit_preemption_with_sharing_matches_jax(models):
    """Overcommit admission over 6 pages with the cache on: the preempted
    request drops its pages (shared ones keep the index's reference) and
    looks its folded prompt up again; the preemptions, re-prefilled tokens,
    prefix_stats() and greedy streams equal JAX's."""
    rounds = [[(_prompt(24, 5, 1), dict(max_tokens=4))],
              [(_prompt(16, 4, 7), dict(max_tokens=20)), (_prompt(16, 9, 8), dict(max_tokens=18)),
               (_prompt(24, 2, 9), dict(max_tokens=16))]]
    jb = _jax(models, pool=6, prefix_cache=True, overcommit=True)
    want_streams, want_stats = _serve(jb, rounds)
    port = _port(models, pool=6, prefix_cache=True, overcommit=True)
    got_streams, got_stats = _serve(port, rounds)
    assert jb.preemptions >= 1
    assert (port.preemptions, port.reprefill_tokens) == (jb.preemptions, jb.reprefill_tokens)
    assert got_stats == want_stats
    assert got_streams == want_streams
    _pool_home(port)


def test_prefix_cache_needs_a_paged_engine(models):
    """The JAX batcher's check: sharing is page-granular."""
    class Dense:
        microbatches = 1

    with pytest.raises(ValueError, match="prefix_cache requires a paged engine"):
        ContinuousBatcher(Dense(), prefix_cache=True)


def test_lookup_stops_one_token_short_of_the_prompt(models):
    """A prompt of exactly three registered pages maps two of them: its last
    token goes through prefill for the first sample's logits."""
    port = _port(models, prefix_cache=True)
    serve_on_this_thread(port, [(SYSTEM + [5], dict(max_tokens=2))])
    assert port.prefix_stats()[4] == 3

    def request(prompt):
        return _Request(prompt=np.asarray(prompt, np.int64),
                        sp=make_sampler_params(device="cpu"), seed=0, max_tokens=1,
                        rep_context=20)

    assert len(port._prefix_lookup(request(SYSTEM))) == 2
    assert len(port._prefix_lookup(request(SYSTEM + [9]))) == 3
    port.close()
