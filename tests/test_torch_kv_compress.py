"""The port's compressed-latent KV codec (``kv_compress.py``) against the
JAX package's (``tests/test_kv_compress.py``): the map artifact (saved by
one package, loaded by the other, with the same ``compress_hash``),
truncation and its refusals; the exact ``latent`` codec on an MLA-shaped
pool (one latent head of 24, the dummy V of width 1); the calibrated
``lowrank`` codec on pool pages drawn from an exactly rank-4 row process;
fault degradation, the spill tier's re-accounting, the prefix store's
compress binding; and ``build_codec``'s choices and refusals on tiny
models (JAX's messages).

Tolerances: the latent rebuild is bit-exact, as is every page moved raw.
The low-rank wire coefficients are float16 from float32 products whose
summation order differs between numpy and torch: the port's and JAX's
coefficients agree within 1e-3 relative (a float16 ulp is 2^-11 ~ 4.9e-4
relative), and their rebuilt pages within 2e-3 of each other, relative in
L2; both are within 5e-3 of the raw pages (JAX's bound)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import kv_compress as jkc
from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu.cache import KVCache
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch import kv_compress as tkc
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch.cache import PagedKV
from mlx_sharding_tpu_torch.kv_compress import ZeroLeaf, tree_leaves
from mlx_sharding_tpu_torch.prefix_store import PrefixStore
from mlx_sharding_tpu_torch.testing import faults

PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny tensors run on one torch thread: under the test run's several
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


def _both(k: np.ndarray, v: np.ndarray):
    """One numpy pool (JAX leaves) as (JAX KVCache, port PagedKV)."""
    return (KVCache(k=jnp.asarray(k), v=jnp.asarray(v), offset=jnp.zeros((), jnp.int32)),
            PagedKV(k=torch.from_numpy(np.ascontiguousarray(k[0, :, :, 0])),
                    v=torch.from_numpy(np.ascontiguousarray(v[0, :, :, 0])), offsets=[0]))


def mla_pools(pool_pages=6, d_lat=24):
    """An MLA-shaped pool: one latent head of ``d_lat`` in K, the all-zero
    (…, 1, 1) V of the compressed cache mode."""
    kshape = (1, 2, pool_pages + 1, 1, PAGE, 1, d_lat)
    k = np.arange(np.prod(kshape), dtype=np.float32).reshape(kshape)
    return _both(k, np.zeros(kshape[:-2] + (1, 1), np.float32))


def lowrank_fixture(rank=4, L=2, H=2, D=4, pool_pages=6, seed=0):
    """Pages drawn from an exactly rank-``rank`` row process, the map
    calibrated on the same process (JAX's fixture), and each package's
    codec over that map."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(H * D, H * D)))[0][:, :rank]

    def draw(rows):
        return (rng.normal(size=rows + (rank,)).astype(np.float32) @ basis.T).astype(np.float32)

    cal_k = draw((L, 1, 64)).reshape(L, 1, 64, H, D)
    cal_v = draw((L, 1, 64)).reshape(L, 1, 64, H, D)
    m = tkc.calibrate_compress_map(cal_k, cal_v, rank=rank)
    kshape = (1, L, pool_pages + 1, 1, PAGE, H, D)
    caches = _both(draw((1, L, pool_pages + 1, 1, PAGE)).reshape(kshape),
                   draw((1, L, pool_pages + 1, 1, PAGE)).reshape(kshape))
    geo = dict(num_heads=H, head_dim_k=D, head_dim_v=D)
    return caches, m, (jkc.KVCompressCodec("lowrank", compress_map=jax_map(m), **geo),
                       tkc.KVCompressCodec("lowrank", compress_map=m, **geo))


def jax_map(m: "tkc.KVCompressMap") -> "jkc.KVCompressMap":
    """The same map as the JAX package's class."""
    return jkc.KVCompressMap(**{f: getattr(m, f) for f in (
        "num_layers", "rank", "num_heads", "head_dim_k", "head_dim_v", "k_down", "k_up",
        "v_down", "v_up", "share_hash")})


def _latent(pkg, d_lat=24):
    return pkg.KVCompressCodec("latent", num_heads=1, head_dim_k=d_lat, head_dim_v=1)


def _jexport(cache, codec=None, pages=(2, 4)):
    return jkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=6, prompt=[1, 2, 3],
                            history=[5, 6, 7], produced=3, resume_keys=None,
                            resume_recent=None, codec=codec)


def _texport(cache, codec=None, pages=(2, 4)):
    return tkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=6, prompt=[1, 2, 3],
                            history=[5, 6, 7], produced=3, resume_gen=None,
                            resume_recent=None, codec=codec)


def _zeroed(cache: PagedKV) -> PagedKV:
    return PagedKV(k=torch.zeros_like(cache.k), v=torch.zeros_like(cache.v), offsets=[0])


def _assert_pools_equal(a: PagedKV, b: PagedKV):
    for x, y in zip(tree_leaves((a.k, a.v)), tree_leaves((b.k, b.v))):
        assert torch.equal(x, y)


# -------------------------------------------------------------- artifact
def test_map_artifacts_cross_load_with_the_same_hash(tmp_path):
    """A map saved by either package loads in the other and names the same
    layout; truncation is the same slice; an edited or foreign artifact
    and a rank without a map are refused as JAX refuses them."""
    _, m, _ = lowrank_fixture()
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    m.save(ours)
    jax_loaded = jkc.KVCompressMap.load(ours)
    assert jax_loaded.compress_hash == m.compress_hash
    jax_loaded.save(theirs)
    assert tkc.KVCompressMap.load(theirs).compress_hash == m.compress_hash
    assert m.meta["calibration"]["max_rel_err"] < 1e-4
    t2 = m.truncate(2)
    assert t2.compress_hash == jax_loaded.truncate(2).compress_hash != m.compress_hash
    np.testing.assert_array_equal(t2.k_down, m.k_down[:, :, :2])
    assert tkc.load_compress_map(ours, rank=2).compress_hash == t2.compress_hash
    assert tkc.load_compress_map(None) is None
    for call in (lambda pkg: pkg.load_compress_map(None, rank=2),
                 lambda pkg: pkg.KVCompressMap.load(ours).truncate(99)):
        with pytest.raises(jkc.CompressError) as want:
            call(jkc)
        with pytest.raises(tkc.CompressError) as got:
            call(tkc)
        assert str(got.value) == str(want.value)
    with np.load(ours) as z:
        doc = {n: np.asarray(z[n]) for n in z.files}
    edited = dict(doc, k_down=doc["k_down"] * 1.5)
    header = json.loads(bytes(doc["header"]).decode())
    foreign = dict(doc, header=np.frombuffer(json.dumps(dict(header, format="nope")).encode(),
                                             np.uint8).copy())
    for name, content, match in (("edited", edited, "recalibrate"),
                                 ("foreign", foreign, "mst-kv-compress-map-v1")):
        path = str(tmp_path / f"{name}.npz")
        with open(path, "wb") as f:
            np.savez(f, **content)
        with pytest.raises(jkc.CompressError) as want:
            jkc.KVCompressMap.load(path)
        with pytest.raises(tkc.CompressError, match=match) as got:
            tkc.KVCompressMap.load(path)
        assert str(got.value) == str(want.value)


def test_map_validation_hints_equal_jax():
    _, m, _ = lowrank_fixture()
    for args, kw in (((3, 2, 4, 4), {}), ((2, 2, 4, 4), dict(share_hash="aa55"))):
        with pytest.raises(tkc.CompressError) as got:
            m.validate_for(*args, **kw)
        with pytest.raises(jkc.CompressError) as want:
            jax_map(m).validate_for(*args, **kw)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------- MLA-native latent
def test_latent_roundtrip_bitexact_smaller_and_as_jax():
    (jsrc, tsrc), (jc, tc) = mla_pools(), (_latent(jkc), _latent(tkc))
    assert tc.compress_hash == jc.compress_hash
    raw = _texport(tsrc).to_host()
    blk = _texport(tsrc, codec=tc).to_host()
    jblk = _jexport(jsrc, codec=jc).to_host()
    assert blk.compress_kind == jblk.compress_kind == "latent"
    assert blk.nbytes == jblk.nbytes < raw.nbytes
    assert all(isinstance(leaf, ZeroLeaf) for leaf in tree_leaves(blk.v_pages))
    wire = tkv.KVPageBlock.from_bytes(blk.to_bytes())
    got = tkv.import_block(_zeroed(tsrc), wire, [1, 3], codec=tc)
    _assert_pools_equal(got, tkv.import_block(_zeroed(tsrc), raw, [1, 3]))
    jkv.import_block(jsrc, jblk, [1, 3], codec=jc)
    keys = ("mode", "blocks_compressed", "blocks_reconstructed", "bytes_raw_total",
            "bytes_wire_total", "bytes_saved_total", "compress_hash")
    assert {k: tc.stats()[k] for k in keys} == {k: jc.stats()[k] for k in keys}
    assert tc.stats()["bytes_saved_total"] > 0


def test_latent_layout_mismatch_and_tamper_fail_closed():
    _, src = mla_pools()
    blk = _texport(src, codec=_latent(tkc)).to_host()
    for codec in (None, _latent(tkc, d_lat=25)):
        with pytest.raises(tkv.BlockIntegrityError, match="compress layout"):
            tkv.import_block(_zeroed(src), blk, [1, 3], codec=codec)
    data = bytearray(blk.to_bytes())
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(tkv.BlockIntegrityError):
        tkv.KVPageBlock.from_bytes(bytes(data))


def test_latent_prefetch_stages_the_rebuilt_pages():
    _, src = mla_pools()
    codec = _latent(tkc)
    blk = _texport(src, codec=codec).to_host()
    blk.prefetch(device="cpu", codec=codec)
    assert blk.is_prefetched and not isinstance(blk.payload()[1], ZeroLeaf)
    got = tkv.import_block(_zeroed(src), blk, [1, 3], codec=codec)
    _assert_pools_equal(got, tkv.import_block(_zeroed(src), _texport(src).to_host(), [1, 3]))


# --------------------------------------------------- calibrated low-rank
def test_lowrank_wire_and_rebuild_agree_with_jax():
    ((jsrc, tsrc), _, (jc, tc)) = lowrank_fixture()
    blk, jblk = _texport(tsrc, codec=tc).to_host(), _jexport(jsrc, codec=jc).to_host()
    assert blk.compress_kind == "lowrank" and blk.k_pages.dtype == torch.float16
    assert blk.nbytes == jblk.nbytes and blk.nbytes * 2 <= _texport(tsrc).to_host().nbytes
    for ours, theirs in ((blk.k_pages, jblk.k_pages), (blk.v_pages, jblk.v_pages)):
        a, b = ours.float().numpy(), np.asarray(theirs, np.float32)[0, :, :, 0]
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
    got = tkv.import_block(_zeroed(tsrc), blk, [2, 4], codec=tc)
    jgot = jkv.import_block(jsrc, jblk, [2, 4], codec=jc)
    raw = tkv.import_block(_zeroed(tsrc), _texport(tsrc).to_host(), [2, 4])
    for ours, theirs, ref in zip((got.k, got.v), (jgot.k, jgot.v), (raw.k, raw.v)):
        a, r = ours[:, [2, 4]].numpy(), ref[:, [2, 4]].numpy()
        b = np.asarray(theirs)[0][:, [2, 4]][:, :, 0]
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-3
        assert np.linalg.norm(a - r) / np.linalg.norm(r) < 5e-3


def test_lowrank_block_refused_under_another_calibration():
    (_, src), _, (_, codec) = lowrank_fixture(seed=0)
    _, _, (_, other) = lowrank_fixture(seed=7)
    blk = _texport(src, codec=codec).to_host()
    assert codec.compress_hash != other.compress_hash
    with pytest.raises(tkv.BlockIntegrityError, match="compress layout"):
        tkv.import_block(_zeroed(src), blk, [2, 4], codec=other)


# ------------------------------------------------------ fault degradation
def test_encode_fault_ships_raw_and_decode_fault_is_counted():
    _, src = mla_pools()
    codec = _latent(tkc)
    faults.arm("cache.compress", exc=faults.FaultError, times=1)
    raw = _texport(src, codec=codec).to_host()
    assert raw.compress_kind is None and raw.is_host
    assert codec.stats()["compress_faults"] == 1
    ref = tkv.import_block(_zeroed(src), _texport(src).to_host(), [1, 3])
    _assert_pools_equal(tkv.import_block(_zeroed(src), raw, [1, 3], codec=codec), ref)
    blk = _texport(src, codec=codec).to_host()
    faults.arm("cache.compress", exc=faults.FaultError, times=1)
    with pytest.raises(tkv.BlockIntegrityError, match="reconstruction"):
        tkv.import_block(_zeroed(src), blk, [1, 3], codec=codec)
    assert codec.stats()["reconstruct_faults"] == 1
    _assert_pools_equal(tkv.import_block(_zeroed(src), blk, [1, 3], codec=codec), ref)


def test_spill_tier_charges_the_wire_bytes_as_jax():
    (jsrc, tsrc), (jc, tc) = mla_pools(), (_latent(jkc), _latent(tkc))
    out = []
    for pkg, src, codec, export in ((tkv, tsrc, tc, _texport), (jkv, jsrc, jc, _jexport)):
        tier = pkg.KVSpillTier(1 << 20, flush_async=False)
        blk = export(src, codec=codec)
        assert tier.put("a", blk) and blk.compress_kind == "latent"
        out.append(tier.stats())
        tier.close()
    assert out[0] == out[1] and out[0]["bytes_compress_saved"] > 0


def test_prefix_store_compress_binding():
    (_, src) = mla_pools()
    codec = _latent(tkc)
    store = PrefixStore(host_bytes=1 << 20)
    store.bind_page_size(PAGE)
    store.bind_compress_hash(codec.compress_hash)
    store.bind_compress_hash(codec.compress_hash)  # idempotent
    with pytest.raises(ValueError, match="kv-compress-map"):
        store.bind_compress_hash("bb66")
    digests = store.digests_for(list(range(4 * PAGE)))
    assert store.host_put(digests[0], _texport(src, codec=codec).to_host())
    assert store.host_put(digests[1], _texport(src).to_host())  # raw always binds
    assert not store.host_put(digests[2], _texport(src, codec=_latent(tkc, 25)).to_host())
    assert store.stats()["demote_drops"] == 1
    store.close()


# ------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def llama_pair():
    from mlx_sharding_tpu.config import LlamaConfig
    from mlx_sharding_tpu.models.llama import LlamaModel
    from mlx_sharding_tpu_torch.convert import params_from_numpy

    cfg = LlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2)
    jm = LlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    return jm, params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _llama_map(rank=4, layers=2, seed=1):
    rng = np.random.default_rng(seed)
    buf = lambda: rng.normal(size=(layers, 1, 16, 2, 8)).astype(np.float32)  # noqa: E731
    return tkc.calibrate_compress_map(buf(), buf(), rank=rank)


def _engine(model, **kw):
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    return PipelineEngine(model, microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10,
                          page_size=8, device="cpu", **kw)


def _refusal(jmodel, **kw) -> str:
    with pytest.raises(jkc.CompressError) as info:
        jkc.build_codec(jmodel, paged=True, num_stages=1, pool_layers=2, **kw)
    return str(info.value)


def test_engine_codec_gates_as_jax(llama_pair):
    jm, tm = llama_pair
    assert _engine(tm).kv_codec is None and _engine(tm).kv_compress_stats() is None
    eng = _engine(tm, kv_compress_map=_llama_map())
    assert eng.kv_codec.mode == "lowrank" and eng.kv_compress_stats()["rank"] == 4
    assert eng.kv_compress_hash == _llama_map().compress_hash
    with pytest.raises(tkc.CompressError) as got:
        _engine(tm, kv_compress_map=_llama_map(), kv_dtype="int8")
    assert str(got.value) == _refusal(jm, kv_quant=True, compress_map=jax_map(_llama_map()))
    bad = _llama_map(layers=3)
    with pytest.raises(tkc.CompressError) as got:
        _engine(tm, kv_compress_map=bad)
    assert str(got.value) == _refusal(jm, kv_quant=False, compress_map=jax_map(bad))
    with pytest.raises(tkc.CompressError) as got:
        tkc.build_codec(tm, paged=False, kv_quant=False, num_stages=1, pool_layers=2,
                        compress_map=_llama_map())
    with pytest.raises(jkc.CompressError) as want:
        jkc.build_codec(jm, paged=False, kv_quant=False, num_stages=1, pool_layers=2,
                        compress_map=jax_map(_llama_map()))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def deepseek_pair():
    """The tiny DeepSeek-V2 pair of ``tests/test_torch_deepseek_v2.py``
    with the compressed MLA cache."""
    from tests.test_torch_deepseek_v2 import port
    from tests.test_torch_families import FAMILIES, j_build_model

    jm, cfg = j_build_model({**FAMILIES["deepseek_v2"], "mla_cache_mode": "compressed"})
    params = jax.jit(lambda key: jm.init_params(key, jnp.float32))(jax.random.PRNGKey(2))
    return jm, port(cfg, params)


def test_mla_engine_gets_jax_latent_codec_and_resumes_exactly(deepseek_pair):
    """A compressed MLA pool gets the exact latent codec with JAX's layout
    hash (a map on it is refused as redundant), and a preempted f32 stream
    resumed from a latent-compressed spill block equals its uninterrupted
    run through the same engine with reserve admission."""
    from chip_smoke import serve_on_this_thread
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    jm, tm = deepseek_pair
    want = jkc.build_codec(jm, paged=True, kv_quant=False, num_stages=1,
                           pool_layers=tm.config.num_local_layers)
    eng = _engine(tm)
    assert eng.kv_codec.mode == "latent" and eng.kv_compress_hash == want.compress_hash
    with pytest.raises(tkc.CompressError, match="redundant"):
        _engine(tm, kv_compress_map=_llama_map())
    jobs = [([7, 7, 2, 1], dict(max_tokens=40)),
            ([9, 4, 4, 6], dict(temperature=0.9, top_p=0.85, seed=321, max_tokens=36))]
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    def run(pool, **kw):
        engine = PipelineEngine(tm, microbatches=2, max_seq=64, prefill_chunk=8,
                                pool_pages=pool, page_size=8, device="cpu")
        b = ContinuousBatcher(engine, decode_block=3, **kw)
        items, _ = serve_on_this_thread(b, jobs)
        return [[t for t, _ in s] for s in items], b

    ref, _ = run(16)
    got, b = run(8, overcommit=True, spill_bytes=64 << 20)
    assert got == ref
    s, cs = b.spill_stats(), b.engine.kv_compress_stats()
    assert s["preemptions"] > 0 and s["spill_hits"] > 0 and s["spill_fallbacks"] == 0
    assert cs["blocks_compressed"] > 0 and cs["blocks_reconstructed"] > 0
    assert cs["bytes_wire_total"] < cs["bytes_raw_total"]
