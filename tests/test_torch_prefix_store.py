"""The port's prefix store (``prefix_store.py``) and the batcher's side of it
against the JAX package's (``tests/test_prefix_store.py``'s single-host
cases).

- The store alone: the same calls on both packages' stores give the same
  answers and the same ``stats()`` (longest-prefix match, the COW lease,
  the insertion policy, the host tier, ``drop_owner``, the lookup fault).
- Digests: the port's prompts are int64 and JAX's int32; the digests hash
  decimal text, so they are byte-equal.
- The batcher: the tiny f32 Llama of ``tests/test_torch_scheduler.py`` on
  a ``pipeline_mesh(1)`` ragged engine (2 slots, capacity 64, chunk 8,
  page 8, pool 8), driven tick by tick on the test's thread
  (``chip_smoke.serve_on_this_thread``), both host tiers flushing
  synchronously. Each case uses its own 2-page prefix; one JAX batcher and
  store serve the module, so the store counters compared are each run's
  increments. Greedy streams must equal JAX's, and so must the counters
  (device and host hits, demotions, imports, faults). Left out: the disagg
  full-hit skip and the pod federation (slices 8 and 9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu import prefix_store as jps
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.cache import KVCache
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu.utils.digests import chunk_digests as jchunk_digests
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch import prefix_store as tps
from mlx_sharding_tpu_torch.cache import PagedKV
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults
from mlx_sharding_tpu_torch.utils.digests import chunk_digests
from tests.test_torch_scheduler import models  # noqa: F401

PAGE = 8
ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=8, page_size=PAGE)
BASE = [7, 7, 2, 1, 9, 4, 4, 6, 3, 17, 42, 5, 11, 2, 2, 8]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()
    jfaults.disarm()


def test_digests_equal_jax_for_int64_and_int32_prompts():
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128_000, size=61)
    want = jchunk_digests(prompt.astype(np.int32), PAGE)
    assert chunk_digests(prompt.astype(np.int64), PAGE) == want
    assert chunk_digests(list(prompt), PAGE, max_chunks=3) == want[:3]
    for pkg in (tps, jps):
        store = pkg.PrefixStore(host_bytes=1 << 20)
        assert store.digests_for(prompt) == []  # no geometry bound yet
        store.bind_page_size(PAGE)
        assert store.digests_for(prompt.astype(np.int64)) == want[:7]  # one token short
        assert store.digests_for(list(range(16))) == jchunk_digests(list(range(8)), PAGE)
        store.close()


def _block(pkg):
    """A pure-prefix block of 2 pages from a hand-built pool."""
    shape = (1, 2, 4, 1, PAGE, 2, 4)
    vals = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    kw = dict(page_size=PAGE, n_tokens=2 * PAGE, prompt=BASE, history=[], produced=0,
              resume_recent=None)
    if pkg is jps:
        cache = KVCache(k=jnp.asarray(vals), v=jnp.asarray(vals + 1000.0),
                        offset=jnp.zeros((), jnp.int32))
        return jkv.export_block(cache, [0, 1], resume_keys=None, **kw)
    leaf = torch.from_numpy(vals[0, :, :, 0].copy())
    return tkv.export_block(PagedKV(k=leaf, v=leaf + 1000.0, offsets=[0]), [0, 1],
                            resume_gen=None, **kw)


def _store_script(pkg, fault_mod) -> list:
    """One store driven through lookups, leases, the insertion policy, the
    host tier, a pool reset and the lookup fault; every answer and the
    stats along the way."""
    out = []
    store = pkg.PrefixStore(host_bytes=1 << 20, insert_min_hits=2, insert_burst=1)
    store.bind_page_size(PAGE)
    with pytest.raises(ValueError, match="chained at page_size=8") as info:
        store.bind_page_size(16)
    out.append(str(info.value))
    owner, other = object(), object()
    digests = store.digests_for(BASE + [5])
    store.count_lookup("miss", digests)
    out.append(store.register(owner, digests, [0, 1], BASE, 64) is None)  # 1 miss < 2
    store.count_lookup("miss", digests)
    lease = store.register(owner, digests, [0, 1], BASE, 64)
    probe = store.digests_for(BASE + [9] * 9)
    out += [lease.cover, store.lookup(owner, probe), store.lookup(other, probe)]
    fork = store.acquire(owner, probe, 2)
    out += [fork.pages, fork.release() is None]
    second = store.digests_for(list(range(100, 117)))
    store.count_lookup("miss", second)
    store.count_lookup("miss", second)
    out.append(store.register(owner, second, [2, 3], list(range(100, 116)), 64) is None)
    store.note_admission()  # one admission, one insert credit
    lease2 = store.register(owner, second, [2, 3], list(range(100, 116)), 64)
    store.pause_inserts(True)
    out += [store.inserts_paused, store.stats()]
    store.pause_inserts(False)
    entry = lease.release()
    out += [entry is not None, store.lookup(owner, probe)]
    with pytest.raises(RuntimeError, match="released twice"):
        lease.release()
    out.append(store.host_put(digests[-1], _block(pkg)))
    out += [store.lookup(other, digests), store.covers_full(BASE + [5]),
            store.covers_full(BASE + [9] * 9), store.owner_hint(list(range(100, 117))) is owner,
            store.host_block(digests[-1]) is not None, len(store.host_inventory())]
    store.drop_owner(owner)
    out += [lease2.release() is None, store.lookup(owner, second)]
    fault_mod.arm("cache.prefix_lookup", exc=fault_mod.FaultError)
    for probe_fn in (lambda: store.lookup(owner, digests), lambda: store.covers_full(BASE)):
        with pytest.raises(fault_mod.FaultError):
            probe_fn()
    fault_mod.disarm()
    out.append(store.stats())
    store.close()
    for bad in (dict(host_bytes=0), dict(insert_min_hits=0), dict(insert_burst=0)):
        with pytest.raises(ValueError) as info:
            pkg.PrefixStore(**bad)
        out.append(str(info.value))
    return out


def test_store_answers_and_stats_equal_jax():
    assert _store_script(tps, faults) == _store_script(jps, jfaults)


# ------------------------------------------------------------- batchers
_JAX: dict = {}


def _jax(models):
    """The module's JAX batcher and store (its compiles are most of the
    file's time)."""
    if not _JAX:
        jm, params, _ = models
        eng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                              paged_attention="ragged", **ENGINE)
        store = jps.PrefixStore(host_bytes=64 << 20)
        store._host._flush_async = False
        _JAX["b"] = jscheduler.ContinuousBatcher(eng, decode_block=3, prefix_store=store)
    return _JAX["b"]


@pytest.fixture(scope="module", autouse=True)
def _close_jax():
    yield
    if _JAX:
        _JAX["b"].close()
        _JAX["b"].prefix_store.close()
        _JAX.clear()


def _port(models, store=True, kv_dtype=None, **kw):
    ps = None
    if store:
        ps = tps.PrefixStore(host_bytes=64 << 20)
        ps._host._flush_async = False
    return ContinuousBatcher(PipelineEngine(models[2], device="cpu", kv_dtype=kv_dtype, **ENGINE),
                             decode_block=3, prefix_store=ps, **kw)


def _serve(batcher, jobs, **kw):
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        kw["tick"] = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, **kw)
    return [[t for t, _ in s] for s in items]


STORE_COUNTERS = ("queries", "hits_device", "hits_host", "misses", "tokens_reused", "inserts",
                  "inserts_damped", "cow_forks", "demotions", "demote_drops", "imports_staged",
                  "imports_demand", "lookup_faults", "import_faults")


def _run(batcher, jobs, **kw):
    before = batcher.prefix_store.stats()
    streams = _serve(batcher, jobs, **kw)
    after = batcher.prefix_store.stats()
    return streams, {k: after[k] - before[k] for k in STORE_COUNTERS}


def _jobs(prefix, tails=((5, 40), (9, 12), (3, 12))):
    return [(prefix + [t], dict(max_tokens=n)) for t, n in tails]


# each job after the one before it has ended: A prefills and registers the
# prefix, its finish demotes it, B and C import it from the host tier
SEQUENTIAL = {1: (0, 10 ** 9), 2: (1, 10 ** 9)}


def _assert_home(batcher):
    total, in_use, _ = batcher.page_stats()
    assert in_use == 0 and batcher.prefix_store.stats()["device_blocks"] == 0


def test_sequential_hot_prefix_through_the_host_tier_equals_jax(models):
    jobs = _jobs(BASE)
    want, jstats = _run(_jax(models), jobs, start_after=SEQUENTIAL)
    port = _port(models)
    got, stats = _run(port, jobs, start_after=SEQUENTIAL)
    assert got == want and stats == jstats
    assert got == _serve(_port(models, store=False), jobs, start_after=SEQUENTIAL)
    assert stats["inserts"] >= 1 and stats["demotions"] >= 1 and stats["hits_host"] == 2
    assert stats["imports_staged"] + stats["imports_demand"] == 2
    assert stats["tokens_reused"] == 2 * len(BASE)
    _assert_home(port)


def test_concurrent_same_prefix_forks_the_device_pages_as_jax(models):
    """B arrives while A still decodes on the same prefix: it leases A's
    pages copy-on-write (no import), and both streams equal JAX's."""
    prefix = [int(t) for t in np.random.default_rng(5).integers(1, 300, 16)]
    jobs = _jobs(prefix, ((5, 16), (9, 12)))
    want, jstats = _run(_jax(models), jobs, start_after={1: (0, 2)})
    port = _port(models)
    got, stats = _run(port, jobs, start_after={1: (0, 2)})
    assert got == want and stats == jstats
    assert stats["cow_forks"] == stats["hits_device"] == 1
    assert stats["imports_staged"] + stats["imports_demand"] == 0
    _assert_home(port)


@pytest.mark.parametrize("site", ["cache.prefix_lookup", "cache.import", "cache.export"])
def test_each_fault_degrades_to_plain_prefill_as_jax(models, site):
    """A lookup fault is a counted miss, an import fault re-prefills into
    the pages it took, an export fault drops the prefix (counted): never a
    wrong or dropped stream, and the counters equal JAX's."""
    seed = {"cache.prefix_lookup": 11, "cache.import": 12, "cache.export": 13}[site]
    prefix = [int(t) for t in np.random.default_rng(seed).integers(1, 300, 16)]
    jobs = _jobs(prefix, ((5, 12), (9, 8)))
    jfaults.arm(site, exc=jfaults.FaultError)
    want, jstats = _run(_jax(models), jobs, start_after={1: (0, 10 ** 9)})
    jfaults.disarm()
    port = _port(models)
    faults.arm(site, exc=faults.FaultError)
    got, stats = _run(port, jobs, start_after={1: (0, 10 ** 9)})
    faults.disarm()
    assert got == want and stats == jstats
    key = {"cache.prefix_lookup": "lookup_faults", "cache.import": "import_faults",
           "cache.export": "demote_drops"}[site]
    assert stats[key] >= 1


def test_int8_pool_store_streams_equal_the_store_off(models):
    """An int8 pool's prefix pages move with their scales: the streams
    through the store equal the same engine's without it."""
    jobs = _jobs(BASE)
    plain = _serve(_port(models, store=False, kv_dtype="int8"), jobs, start_after=SEQUENTIAL)
    port = _port(models, kv_dtype="int8")
    got, stats = _run(port, jobs, start_after=SEQUENTIAL)
    assert got == plain and stats["hits_host"] == 2


def test_store_refusals_match_jax(models):
    """Paged engine only, not with the prefix cache, not with a draft
    engine: JAX's messages."""
    jb = _jax(models)

    def refusal(make):
        with pytest.raises(ValueError) as info:
            make()
        return str(info.value)

    store = tps.PrefixStore(host_bytes=1 << 20)
    want = refusal(lambda: jscheduler.ContinuousBatcher(jb.engine, prefix_cache=True,
                                                        prefix_store=jps.PrefixStore()))
    assert refusal(lambda: _port(models, prefix_cache=True)) == want
    dense = PipelineEngine(models[2], device="cpu", microbatches=2, max_seq=64, prefill_chunk=8)
    assert refusal(lambda: ContinuousBatcher(dense, prefix_store=store)) == (
        "the prefix store requires a paged engine (pool_pages): prefix reuse is page-granular")
    paged = PipelineEngine(models[2], device="cpu", **ENGINE)
    assert refusal(lambda: ContinuousBatcher(paged, draft_engine=dense, prefix_store=store)) == (
        "the prefix store is incompatible with a draft engine: the draft's dense KV has no "
        "shareable pages, so a store hit would leave it attending to unprefilled state")
    store.close()
