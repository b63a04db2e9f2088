"""Layer-wise KV sharing in the port (``kv_share.py``, the engine under a
share map, both calibrate CLIs) against the JAX package
(``tests/test_kv_share.py``'s cases), on the CPU.

The maps: canonical groups, owners, JSON round trips and refusals with
JAX's messages, ``share_hash`` byte-equal to JAX's, and calibration giving
JAX's map for the same K/V. The engine: the identity map bit-identical to
an unshared engine; under a non-identity map (4 layers in 2 groups, so
layers 2 and 3 read their owners' buffers) in f32 the greedy streams of
the paged batcher are token-identical to JAX's ragged engine under the
same map, on the ragged and the gather path, with an f32 and an int8
pool, with JAX's pool bytes and
``kv_share_stats()``; a block exported under the map is refused by an
unshared pool. Both CLIs run end to end on a checkpoint of the tiny model,
and JAX's loaders take their artifacts.

Left out: the stage-split refusal at pp > 1 (the port's engine is pp = 1;
it raises earlier, naming the roadmap item)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import kv_share as jks
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch import kv_share as tks
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.kv_transfer import BlockIntegrityError, export_block, import_block
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
GROUPS = (0, 1, 0, 1)  # layers 2 and 3 read and write their owners' buffers
JOBS_SHAPE = ((13, 20), (9, 25), (17, 10))  # (prompt tokens, max tokens)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _jobs():
    rng = np.random.default_rng(7)
    return [([int(t) for t in rng.integers(1, 300, size=n)], dict(max_tokens=k))
            for n, k in JOBS_SHAPE]


def _serve(batcher, jobs):
    kw = {}
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        kw["tick"] = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, **kw)
    return [[t for t, _ in s] for s in items]


# ------------------------------------------------------------- map algebra
@pytest.mark.parametrize("groups", [(2, 0, 2, 0), (0, 0, 1, 2), (0, 1, 2, 3), (3, 3, 3, 3)])
def test_maps_equal_jax(groups):
    """Canonical groups, owners, the mask, the saved fraction and the hash
    (byte-equal to JAX's; None for the identity map)."""
    j, t = jks.KVShareMap(4, groups), tks.KVShareMap(4, groups)
    for attr in ("group_of", "num_groups", "is_identity", "owner_layers", "owner_mask",
                 "share_hash"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.bytes_saved_fraction() == j.bytes_saved_fraction()
    assert t.to_json() == j.to_json()
    assert tks.KVShareMap.identity(4).share_hash is None


def test_from_pairs_and_refusals_match_jax():
    pairs = [(0, 3), (3, 5), (1, 4)]
    assert tks.KVShareMap.from_pairs(6, pairs).group_of == \
        jks.KVShareMap.from_pairs(6, pairs).group_of
    for make in (lambda m: m.KVShareMap.from_pairs(4, [(0, 9)]),
                 lambda m: m.KVShareMap(4, (0, 0, 1, 2)).validate_for(2),
                 lambda m: m.KVShareMap(3, (0, 1))):
        with pytest.raises(jks.ShareMapError) as je:
            make(jks)
        with pytest.raises(tks.ShareMapError) as te:
            make(tks)
        assert str(te.value) == str(je.value)


def test_json_round_trip_across_packages(tmp_path):
    """A map saved by either package loads in the other; a hand-edited
    hash, bad JSON and another format are refused with JAX's messages."""
    m = tks.KVShareMap(4, (0, 0, 1, 2), meta={"note": "t"})
    p = tmp_path / "share.json"
    m.save(str(p))
    jks.KVShareMap(4, (0, 0, 1, 2), meta={"note": "t"}).save(str(tmp_path / "j.json"))
    assert p.read_text() == (tmp_path / "j.json").read_text()  # the same bytes
    assert jks.load_share_map(str(p), num_layers=4).group_of == m.group_of
    assert tks.load_share_map(str(tmp_path / "j.json"), num_layers=4) == m
    assert tks.load_share_map(None) is None
    for text in ('{"format": "mst-kv-share-map-v1", "num_layers": 4, "group_of": [0, 1, 1, 2], '
                 f'"share_hash": "{m.share_hash}"}}', "{not json", '{"format": "x"}'):
        p.write_text(text)
        with pytest.raises(jks.ShareMapError) as je:
            jks.KVShareMap.load(str(p))
        with pytest.raises(tks.ShareMapError) as te:
            tks.KVShareMap.load(str(p))
        assert str(te.value) == str(je.value)


def test_calibration_equals_jax_on_the_same_kv():
    """``rank_layer_pairs`` and ``calibrate_share_map`` over the same dense
    (L, B, S, H, D) buffers: JAX's ranking and map, meta included."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((6, 1, 12, 2, 4)).astype(np.float32)
    v = rng.standard_normal((6, 1, 12, 2, 4)).astype(np.float32)
    assert tks.rank_layer_pairs(k, v, valid_tokens=10) == \
        jks.rank_layer_pairs(k, v, valid_tokens=10)
    for num_share, max_group in ((1, 2), (3, 2), (4, 3)):
        t = tks.calibrate_share_map(k, v, num_share=num_share, max_group=max_group)
        j = jks.calibrate_share_map(k, v, num_share=num_share, max_group=max_group)
        assert t.to_json() == j.to_json()  # groups, hash and meta
    for kw in (dict(num_share=6), dict(num_share=1, max_group=1)):
        with pytest.raises(tks.ShareMapError):
            tks.calibrate_share_map(k, v, **kw)


# ------------------------------------------------------------ the engine
def test_engine_checks_match_jax(models):
    """A share map needs a paged engine and the engine's layer count, with
    JAX's messages."""
    jm, params, tm = models
    dense = {k: v for k, v in ENGINE.items() if k not in ("pool_pages", "page_size")}
    with pytest.raises(ValueError) as je:
        JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                        kv_share_map=jks.KVShareMap(4, GROUPS), **dense)
    with pytest.raises(ValueError) as te:
        PipelineEngine(tm, device="cpu", kv_share_map=tks.KVShareMap(4, GROUPS), **dense)
    assert str(te.value) == str(je.value)
    with pytest.raises(jks.ShareMapError) as je:
        JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                        kv_share_map=jks.KVShareMap(2, (0, 0)), **ENGINE)
    with pytest.raises(tks.ShareMapError) as te:
        PipelineEngine(tm, device="cpu", kv_share_map=tks.KVShareMap(2, (0, 0)), **ENGINE)
    assert str(te.value) == str(je.value)


def test_identity_map_is_bit_identical_to_unshared(models):
    """The identity map keeps the unshared layout and code path: the same
    pool bytes and stats as no map, and the same tokens and final pool
    contents, bit for bit."""
    tm = models[2]
    out = []
    for m in (None, tks.KVShareMap.identity(4)):
        b = ContinuousBatcher(PipelineEngine(tm, device="cpu", kv_share_map=m, **ENGINE),
                              decode_block=3, async_sched="off")
        out.append((_serve(b, _jobs()), b.cache.k.clone(), b.cache.v.clone(),
                    b.engine.kv_share_stats(), b.cache.nbytes))
        b.close()
    (s0, k0, v0, st0, n0), (s1, k1, v1, st1, n1) = out
    assert s1 == s0 and torch.equal(k1, k0) and torch.equal(v1, v0)
    assert st1 == st0 == {"enabled": False, "groups": 4, "layers": 4, "bytes_saved": 0,
                          "share_hash": None}
    assert n1 == n0


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_shared_streams_equal_jax(models, kv_dtype):
    """Under the map, greedy streams token-identical to JAX's ragged engine
    under the same map (different from the unshared engine's), with JAX's
    pool bytes and ``kv_share_stats()``; the port's gather path under the
    map gives the same streams (in f32 and with the int8 pool); a block
    exported under the map carries its hash and an unshared pool refuses
    it."""
    jm, params, tm = models
    path = "ragged"
    jeng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                           paged_attention=path, kv_dtype=kv_dtype,
                           kv_share_map=jks.KVShareMap(4, GROUPS), **ENGINE)
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off")
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", paged_attention=path,
                                          kv_dtype=kv_dtype,
                                          kv_share_map=tks.KVShareMap(4, GROUPS), **ENGINE),
                           decode_block=3, async_sched="off")
    try:
        want, got = _serve(jb, _jobs()), _serve(tb, _jobs())
        assert got == want
        assert tb.engine.kv_share_stats() == jeng.kv_share_stats()
        jbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves((jb.cache.k, jb.cache.v)))
        assert tb.cache.nbytes == jbytes
        assert tb.engine.kv_share_bytes_saved == jeng.kv_share_bytes_saved > 0
        gb = ContinuousBatcher(PipelineEngine(tm, device="cpu", paged_attention="gather",
                                              kv_dtype=kv_dtype,
                                              kv_share_map=tks.KVShareMap(4, GROUPS), **ENGINE),
                               decode_block=3, async_sched="off")
        assert _serve(gb, _jobs()) == want
        gb.close()
        if kv_dtype is None:
            ub = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3,
                                   async_sched="off")
            assert _serve(ub, _jobs()) != got  # the map changes what layers 2, 3 attend
            block = export_block(tb.cache, [0, 1], page_size=8, n_tokens=16, prompt=[1] * 15,
                                 history=[2, 3], produced=2, resume_gen=None,
                                 resume_recent=None, share_hash=tb.engine.kv_share_hash,
                                 codec=tb.engine.kv_codec)
            assert block.share_hash == jks.KVShareMap(4, GROUPS).share_hash
            with pytest.raises(BlockIntegrityError, match="--kv-share-map"):
                import_block(ub.cache, block, [0, 1], share_hash=None, codec=ub.engine.kv_codec)
            import_block(tb.cache, block, [2, 3], share_hash=tb.engine.kv_share_hash,
                         codec=tb.engine.kv_codec)
            assert torch.equal(tb.cache.k[:, 2:4], tb.cache.k[:, 0:2])
            ub.close()
    finally:
        jb.close()
        tb.close()


# ------------------------------------------------------------- the CLIs
def test_calibrate_clis_end_to_end(models, tmp_path, capsys, monkeypatch):
    """Both CLIs on a checkpoint of the tiny model written to disk, on the
    CPU: the share map, then a compress map calibrated under it (its hash
    stamped), each loadable by JAX's loaders; the engine takes both. The
    tokenizer is the tests' byte tokenizer (loading ``transformers`` would
    cost the file most of its time)."""
    from chip_smoke import write_llama_checkpoint
    from mlx_sharding_tpu import kv_compress as jkc
    from mlx_sharding_tpu_torch import loading
    from mlx_sharding_tpu_torch.cli import kv_compress_calibrate, kv_share_calibrate
    from mlx_sharding_tpu_torch.kv_compress import load_compress_map
    from tests.test_tokenizer_utils import ByteTokenizer

    ckpt = tmp_path / "ckpt"
    write_llama_checkpoint(models[2], {"model_type": "llama", **TINY}, str(ckpt))
    monkeypatch.setattr(loading, "load_tokenizer", lambda path: ByteTokenizer())
    share_path, comp_path = tmp_path / "share.json", tmp_path / "comp.npz"
    assert kv_share_calibrate.main(["--model", str(ckpt), "--num-share", "1", "--output",
                                    str(share_path), "--device", "cpu"]) == 0
    assert kv_compress_calibrate.main(["--model", str(ckpt), "--rank", "4", "--kv-share-map",
                                       str(share_path), "--output", str(comp_path),
                                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 layers -> 3 groups" in out and "rank 4" in out
    jmap = jks.load_share_map(str(share_path), num_layers=4)
    tmap = tks.load_share_map(str(share_path), num_layers=4)
    assert jmap.share_hash == tmap.share_hash is not None and not tmap.is_identity
    assert tmap.meta["calibration_prompts"] == 3 and tmap.meta["model"] == str(ckpt)
    # calibrate_model is the numpy calibration over the prompts' prefill K/V
    from mlx_sharding_tpu_torch.cli.kv_share_calibrate import prefill_kv
    ids = [ByteTokenizer().encode(p) for p in kv_share_calibrate.DEFAULT_PROMPTS]
    k, v, _ = prefill_kv(models[2], ids, tks.ShareMapError)
    assert jks.calibrate_share_map(k, v, num_share=1).group_of == tmap.group_of
    jcomp = jkc.KVCompressMap.load(str(comp_path))
    tcomp = load_compress_map(str(comp_path))
    assert jcomp.compress_hash == tcomp.compress_hash
    assert jcomp.share_hash == tcomp.share_hash == tmap.share_hash
    assert tcomp.num_layers == tmap.num_groups == 3
    model, _ = loading.load_model(str(ckpt), device="cpu", dtype=torch.float32)
    eng = PipelineEngine(model, device="cpu", kv_share_map=tmap, kv_compress_map=tcomp,
                         **ENGINE)
    assert eng.kv_share_hash == tmap.share_hash and eng.kv_codec is not None
