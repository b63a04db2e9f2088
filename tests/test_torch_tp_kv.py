"""Page blocks of a cache split over tp or ep shards (``cache.ShardedKV``)
against the JAX package, on the CPU: JAX's engines on ``make_mesh(tp=,
ep=)`` over the 8 host devices, the port's shards all on ``device="cpu"``.

JAX's pool at tp > 1 is one global array sharded on the KV heads, so its
block carries every head. The port keeps a pool a shard and exports whole
heads too: a block of a tp = 2 pool has the tp = 1 pool's leaf shapes and
JAX's values (f32 within ``F32_TOL``; an int8 pool's codes within one step
and its scales within ``F32_TOL``, since the two packages' K/V rows differ
in their last bits and may round to the neighbouring code), and imports
into a pool of tp = 1, tp = 2 or pp = 2 x tp = 2. The import writes every
ep copy in place; a replicated cache (DeepSeek-V2's compressed latent)
moves shard 0's pages with its exact codec; a low-rank compress map and a
share map at tp = 2 give JAX's streams. Greedy f32 streams must be
token-identical (no tolerance): a stream handed off through ``to_bytes`` /
``from_bytes`` and resumed on another pool equals the uninterrupted
stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu_torch import kv_compress as tkc
from mlx_sharding_tpu_torch import kv_share as tks
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch.cache import ShardedKV, shard_caches, stage_caches
from mlx_sharding_tpu_torch.kv_compress import tree_leaves
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.resilience import HandoffReadyError
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_families import jax_pair, port
from tests.test_torch_pipeline_archs import _llama, one_torch_thread  # noqa: F401
from tests.test_torch_pipeline_batcher import _drive

# f32 K/V rows of the two packages: summation order only
F32_TOL = 1e-5
POOL = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
PROMPT, TOKENS = [3, 17, 42, 5, 9, 11, 2, 8, 13, 21, 1], 14


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


def _tb(tm, kv_dtype=None, **kw):
    return ContinuousBatcher(PipelineEngine(tm, device="cpu", kv_dtype=kv_dtype, **POOL, **kw),
                             decode_block=3, async_sched="off")


def _jb(jm, params, kv_dtype=None, **kw):
    mesh = make_mesh(tp=kw.pop("tp", 1), ep=kw.pop("ep", 1))
    eng = jpipeline.PipelineEngine(jm, params, mesh, cache_dtype=jnp.float32,
                                   kv_dtype=kv_dtype, **POOL, **kw)
    return jscheduler.ContinuousBatcher(eng, decode_block=3, async_sched="off")


def _stream(batcher, prompt=PROMPT, n=TOKENS):
    return _drive(batcher, [(prompt, dict(max_tokens=n))])[0]


def _handoff(src, prompt=PROMPT, n=TOKENS):
    """A prefill-only stream on ``src``: its first token and the state its
    ``HandoffReadyError`` carries, the block flushed to the host."""
    toks = []
    with pytest.raises(HandoffReadyError) as info:
        for t, _ in src.generate_step(prompt, max_tokens=n, _prefill_only=True):
            toks.append(t)
    state = info.value.state
    state.block.to_host()
    return toks, state


def _resume(dst, state, prompt=PROMPT, n=TOKENS):
    return [t for t, _ in dst.generate_step(prompt, max_tokens=n, _resume=state)]


def _port_leaf(a) -> np.ndarray:
    """JAX's ``(S, L, n, B, page, H, D)`` page leaf as the port's ``(L, n,
    page, H, D)``."""
    return np.asarray(a)[0, :, :, 0]


def _export_all(cache, pkg):
    pages = list(range(POOL["pool_pages"]))
    kw = dict(page_size=POOL["page_size"], n_tokens=len(pages) * POOL["page_size"],
              prompt=[1, 2], history=[3], produced=1, resume_recent=None)
    if pkg == "jax":
        return jkv.export_block(cache, pages, resume_keys=None, **kw).to_host()
    return tkv.export_block(cache, pages, resume_gen=None, **kw).to_host()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_tp2_block_has_whole_heads_and_jax_values(llama4, kv_dtype):
    """The same request served through JAX's and the port's batchers over a
    tp = 2 pool: every page of the port's tp = 2 pool exported as one
    block has the tp = 1 pool's leaf shapes and JAX's bytes, and its values
    equal JAX's global block's (f32 within ``F32_TOL``; int8 codes within
    one step, scales within ``F32_TOL``); in f32 the port's tp = 1 block
    of the same request is within ``F32_TOL`` of it (an int8 pool's tp = 1
    and tp = 2 rows part by a code where a row rounds otherwise, in JAX as
    here, and later layers carry that step)."""
    jm, params, tm = llama4
    jb, tb = _jb(jm, params, kv_dtype, tp=2), _tb(tm, kv_dtype, tp=2)
    assert isinstance(tb.cache, ShardedKV) and tb.cache.tp == 2
    want = _stream(jb)
    assert _stream(tb) == want
    one = _tb(tm, kv_dtype)
    assert _stream(one) == want
    jblk, tblk, oblk = _export_all(jb.cache, "jax"), _export_all(tb.cache, "port"), \
        _export_all(one.cache, "port")
    assert tblk.nbytes == jblk.nbytes == oblk.nbytes
    assert tkv.pages_compatible(tblk.k_pages, tblk.v_pages, one.cache) is None
    for t, j, o in zip(tree_leaves((tblk.k_pages, tblk.v_pages)),
                       tree_leaves((jblk.k_pages, jblk.v_pages)),
                       tree_leaves((oblk.k_pages, oblk.v_pages))):
        assert t.shape == o.shape == _port_leaf(j).shape and t.dtype == o.dtype
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - _port_leaf(j).astype(np.int32)).max() <= 1
            continue
        np.testing.assert_allclose(t.numpy(), _port_leaf(j), rtol=F32_TOL, atol=F32_TOL)
        if kv_dtype is None:
            np.testing.assert_allclose(t.numpy(), o.numpy(), rtol=F32_TOL, atol=F32_TOL)


# (source, destination): each engine's keywords
ROUTES = {"tp2_to_tp2": (dict(tp=2), dict(tp=2)), "tp2_to_tp1": (dict(tp=2), dict()),
          "tp1_to_tp2": (dict(), dict(tp=2)),
          "pp2_tp2_to_pp2_tp2": (dict(tp=2, stages=2), dict(tp=2, stages=2)),
          "pp2_tp2_to_pp2_tp1": (dict(tp=2, stages=2), dict(stages=2))}


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_block_through_the_wire_resumes_on_another_tp(llama4, route):
    """A stream's block after its first token, through ``to_bytes`` /
    ``from_bytes``, imported into a pool of another tp: tp = 2 into tp = 2
    and tp = 1 and back, and at pp = 2 (one whole-head payload a stage)
    into pp = 2 x tp = 2 and pp = 2 x tp = 1. The block carries every KV
    head; the resumed stream is token-identical to the uninterrupted tp = 1
    stream, imported (a demand import) and not re-prefilled."""
    jm, params, tm = llama4
    src_kw, dst_kw = ROUTES[route]
    want = _stream(_tb(tm))
    src = _tb(tm, **src_kw)
    first, state = _handoff(src)
    src.close()
    assert {leaf.shape[3] for leaf in tree_leaves(state.block.k_pages)} == {2}
    state.block = tkv.KVPageBlock.from_bytes(state.block.to_bytes())
    dst = _tb(tm, **dst_kw)
    try:
        got = first + _resume(dst, state)
        stats = dst.spill_stats()
    finally:
        dst.close()
    assert got == want
    assert stats["demand_imports"] == 1 and stats["spill_fallbacks"] == 0
    assert stats["reprefill_tokens"] == 0


def _fill(cache, seed):
    """Distinct values in every cell of a whole-head pool (int8 codes and
    scales too), written in place."""
    g = torch.Generator().manual_seed(seed)
    for t in tree_leaves((cache.k, cache.v)):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, dtype=t.dtype) + 0.5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", [dict(ep=2), dict(tp=2, ep=2)], ids=["ep2", "tp2_ep2"])
def test_import_writes_every_ep_copy_in_place(mesh, kv_dtype):
    """A tp = 1 block of tiny Mixtral imported into a pool at ep = 2 (and
    tp2 x ep2): every shard of every ep index holds its heads of the block
    (both copies written, not shard 0's alone), the shards' tensors are
    not rebound, and the block exported back from the sharded pool is the
    one imported, bit for bit."""
    cfg, jm, params = jax_pair("mixtral")
    tm = port(cfg, params)
    one = PipelineEngine(tm, device="cpu", kv_dtype=kv_dtype, **POOL).init_cache_paged()[0]
    _fill(one, seed=3)
    eng = PipelineEngine(tm, device="cpu", kv_dtype=kv_dtype, **POOL, **mesh)
    cache = eng.init_cache_paged()[0]
    assert isinstance(cache, ShardedKV) and len(cache.shards) == 2 * mesh.get("tp", 1)
    before = [t.data_ptr() for c in cache.shards for t in tree_leaves((c.k, c.v))]
    blk = tkv.export_block(one, [0, 3, 5], page_size=8, n_tokens=20, prompt=[1, 2], history=[3],
                           produced=1, resume_gen=None, resume_recent=None).to_host()
    tkv.import_block(cache, blk, [7, 1, 2])
    assert [t.data_ptr() for c in cache.shards for t in tree_leaves((c.k, c.v))] == before
    tp, h = cache.tp, eng.cache_heads()
    for r, shard in enumerate(cache.shards):
        t = r % tp
        for got, src in zip(tree_leaves((shard.k, shard.v)), tree_leaves((one.k, one.v))):
            assert torch.equal(got[:, [7, 1, 2]], src[:, [0, 3, 5], :, t * h:(t + 1) * h])
    back = tkv.export_block(cache, [7, 1, 2], page_size=8, n_tokens=20, prompt=[1, 2],
                            history=[3], produced=1, resume_gen=None,
                            resume_recent=None).to_host()
    assert back.checksum == blk.checksum


def test_deepseek_latent_moves_with_its_codec_at_tp2():
    """DeepSeek-V2's compressed latent at tp = 2 is replicated over the
    shards: the engine gets the exact latent codec, the block carries shard
    0's pages (one latent head) compressed by it, and a stream handed off
    from a tp = 2 pool resumes on tp = 2 and on tp = 1 pools as JAX's tp = 2
    batcher streams it."""
    cfg, jm, params = jax_pair("deepseek_v2", mla_cache_mode="compressed")
    tm = port(cfg, params)
    prompt = PROMPT[:9]
    want = _stream(_jb(jm, params, tp=2), prompt, 10)
    got = []
    for dst_kw in (dict(tp=2), dict()):
        src = _tb(tm, tp=2)
        assert src.engine.kv_codec.mode == "latent" and src.cache.replicated
        first, state = _handoff(src, prompt, 10)
        assert state.block.compress_kind == "latent"
        assert state.block.compress_hash == src.engine.kv_compress_hash
        src.close()
        dst = _tb(tm, **dst_kw)
        try:
            got.append(first + _resume(dst, state, prompt, 10))
            cs = dst.engine.kv_compress_stats()
        finally:
            dst.close()
        assert cs["blocks_reconstructed"] == 1
    assert got == [want, want]


def test_lowrank_map_and_share_map_at_tp2_match_jax(llama4, tmp_path):
    """A calibrated low-rank compress map and a layer-sharing map at tp =
    2: each batcher serves JAX's streams over its tp = 2 engine with the
    same map (the share map's ``kv_share_stats`` JAX's), and a preempted
    request resumes from a low-rank compressed spill block as JAX's does."""
    from mlx_sharding_tpu import kv_compress as jkc
    from mlx_sharding_tpu import kv_share as jks

    jm, params, tm = llama4
    rng = np.random.default_rng(1)
    buf = lambda: rng.normal(size=(4, 1, 16, 2, 8)).astype(np.float32)  # noqa: E731
    cmap = tkc.calibrate_compress_map(buf(), buf(), rank=6)
    cmap.save(str(tmp_path / "map.npz"))
    jmap = jkc.KVCompressMap.load(str(tmp_path / "map.npz"))
    jobs = [([7, 7, 2, 1, 5, 9], dict(max_tokens=30)), ([9, 4, 4, 6], dict(max_tokens=26))]
    spill = dict(overcommit=True, spill_bytes=64 << 20)
    small = dict(POOL, pool_pages=6)
    jeng = jpipeline.PipelineEngine(jm, params, make_mesh(tp=2), cache_dtype=jnp.float32,
                                    kv_compress_map=jmap, **small)
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off", **spill)
    jb.spill._flush_async = False
    want = _drive(jb, jobs)
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", tp=2, kv_compress_map=cmap, **small),
                           decode_block=3, async_sched="off", **spill)
    tb.spill._flush_async = False
    assert tb.engine.kv_codec.mode == "lowrank"
    assert _drive(tb, jobs) == want
    s, cs = tb.spill_stats(), tb.engine.kv_compress_stats()
    assert s["preemptions"] >= 1 and s["spill_hits"] >= 1 and s["spill_fallbacks"] == 0
    assert cs["blocks_compressed"] >= 1 and cs["blocks_reconstructed"] >= 1
    assert (s["preemptions"], s["spill_hits"]) == (jb.preemptions, jb.spill_stats()["spill_hits"])

    groups = (0, 1, 0, 1)
    jeng = jpipeline.PipelineEngine(jm, params, make_mesh(tp=2), cache_dtype=jnp.float32,
                                    kv_share_map=jks.KVShareMap(4, groups), **POOL)
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off")
    want = _drive(jb, jobs)
    tb = _tb(tm, tp=2, kv_share_map=tks.KVShareMap(4, groups))
    assert _drive(tb, jobs) == want
    assert tb.engine.kv_share_stats() == jeng.kv_share_stats()
    assert tb.engine.kv_share_bytes_saved == jeng.kv_share_bytes_saved > 0
    for c in shard_caches(stage_caches(tb.cache)[0]):
        assert c.k.shape[0] == 2  # every shard's pool holds the two groups
