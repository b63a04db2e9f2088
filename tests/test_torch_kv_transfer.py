"""The port's page-block export and import and its spill tier against the
JAX package's (``tests/test_kv_transfer.py`` and the unit cases of
``tests/test_kv_residency.py``), on hand-built pools of 6 pages + scratch,
page 4, 2 layers, 2 KV heads, D 4, with a distinct value in every cell.

The same numpy pool is JAX's leaf ``(S, L, P+1, B, page, H, D)`` with S =
B = 1 and the port's ``(L, P+1, page, H, D)``: every exported page must
equal JAX's after that mapping, bit for bit (f32, bf16 and an int8 pool's
codes and scales), and an import must land where JAX's lands. The tier's
counters must equal JAX's tier's for the same operations. The wire format
is the port's own: a round trip is exact, a flipped byte or a cut payload
raises ``BlockIntegrityError``."""

import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu.cache import KVCache
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch.cache import PagedKV
from mlx_sharding_tpu_torch.kv_compress import tree_leaves
from mlx_sharding_tpu_torch.testing import faults

POOL, PAGE = 6, 4
LEAF = (1, 2, POOL + 1, 1, PAGE, 2, 4)  # JAX's pool leaf
KINDS = ("f32", "bf16", "int8")


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


def _numpy_pool(kind: str, seed: int = 0):
    """(k, v) as JAX leaves in numpy: distinct values per cell; int8 as
    ``{"d", "s"}`` with per-row scales."""
    rng = np.random.default_rng(seed)
    vals = np.arange(np.prod(LEAF), dtype=np.float32).reshape(LEAF)
    if kind == "int8":
        def q(offset):
            return {"d": ((vals + offset) % 127).astype(np.int8),
                    "s": rng.uniform(0.5, 2.0, LEAF[:-1] + (1,)).astype(np.float32)}
        return q(0), q(3)
    dt = ml_dtypes.bfloat16 if kind == "bf16" else np.float32
    return (vals % 251).astype(dt), ((vals + 1000.0) % 509).astype(dt)


def _to_port_leaf(a):
    """JAX leaf (numpy) -> the port's (L, P+1, page, H, D) tensor."""
    a = np.asarray(a)[0, :, :, 0]
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _tmap(fn, tree):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def pools(kind: str, seed: int = 0):
    """The same pool in both packages: (JAX KVCache, port PagedKV)."""
    k, v = _numpy_pool(kind, seed)
    jcache = KVCache(k=_tmap(jnp.asarray, k), v=_tmap(jnp.asarray, v),
                     offset=jnp.zeros((), jnp.int32))
    return jcache, PagedKV(k=_tmap(_to_port_leaf, k), v=_tmap(_to_port_leaf, v), offsets=[0])


def _as_np(leaf) -> np.ndarray:
    """A port leaf as numpy, in JAX's dtype."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return leaf.float().numpy().astype(ml_dtypes.bfloat16)
    return leaf.numpy()


def assert_pages_equal(jax_tree, port_tree):
    """JAX page leaves ``(1, L, n, 1, page, H, D)`` equal the port's ``(L,
    n, page, H, D)``, bit for bit."""
    jl = [np.asarray(x) for x in tree_leaves(jax_tree)]
    tl = tree_leaves(port_tree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        got = _as_np(t)
        assert got.dtype == j.dtype
        np.testing.assert_array_equal(got.view(np.uint8), j[0, :, :, 0].view(np.uint8))


def _jexport(cache, pages=(2, 4), n_tokens=6, history=(5, 6, 7)):
    return jkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=n_tokens,
                            prompt=[1, 2, 3], history=list(history), produced=len(history),
                            resume_keys=None, resume_recent=None)


def _texport(cache, pages=(2, 4), n_tokens=6, history=(5, 6, 7)):
    return tkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=n_tokens,
                            prompt=[1, 2, 3], history=list(history), produced=len(history),
                            resume_gen=torch.Generator().manual_seed(3).get_state(),
                            resume_recent=torch.arange(6))


@pytest.mark.parametrize("kind", KINDS)
def test_exported_pages_equal_jax(kind):
    jcache, tcache = pools(kind)
    jb, tb = _jexport(jcache, pages=(5, 0, 3)), _texport(tcache, pages=(5, 0, 3))
    assert tb.n_pages == jb.n_pages == 3 and tb.nbytes == jb.nbytes
    assert_pages_equal((jb.k_pages, jb.v_pages), (tb.k_pages, tb.v_pages))
    jb.to_host()
    tb.to_host()
    assert tb.is_host and tb.checksum is not None
    assert_pages_equal((jb.k_pages, jb.v_pages), (tb.k_pages, tb.v_pages))


@pytest.mark.parametrize("kind", KINDS)
def test_block_roundtrip_lands_where_jax_lands(kind):
    """export → to_host → verify → import into other pages: the port's pool
    afterwards equals JAX's, and the moved pages equal the source's."""
    jsrc, tsrc = pools(kind)
    jdst, tdst = pools(kind, seed=1)
    jb, tb = _jexport(jsrc).to_host(), _texport(tsrc).to_host()
    tb.verify()
    jout = jkv.import_block(jdst, jb, [1, 3])
    tout = tkv.import_block(tdst, tb, [1, 3])
    assert tout is tdst  # written in place, never rebound
    assert_pages_equal((jout.k, jout.v), (tout.k, tout.v))
    for src, dst in zip(tree_leaves((tsrc.k, tsrc.v)), tree_leaves((tout.k, tout.v))):
        assert torch.equal(src[:, [2, 4]], dst[:, [1, 3]])


def test_import_writes_the_pool_in_place():
    """The captured steps hold the pool's addresses: an import keeps every
    leaf's storage."""
    _, src = pools("int8")
    _, dst = pools("int8", seed=2)
    before = [t.data_ptr() for t in tree_leaves((dst.k, dst.v))]
    tkv.import_block(dst, _texport(src).to_host(), [0, 5])
    assert [t.data_ptr() for t in tree_leaves((dst.k, dst.v))] == before


def test_tamper_and_degenerate_blocks_rejected():
    _, tcache = pools("f32")
    blk = _texport(tcache).to_host()
    tree_leaves(blk.k_pages)[0].view(-1)[0] += 1  # one corrupt element
    with pytest.raises(tkv.BlockIntegrityError, match="checksum"):
        blk.verify()
    with pytest.raises(tkv.BlockIntegrityError, match="pages"):
        _texport(tcache, n_tokens=99).verify()
    hollow = _texport(tcache)
    hollow.history = []
    with pytest.raises(tkv.BlockIntegrityError, match="history"):
        hollow.verify()
    # a host block whose checksum this process never stamped or checked is
    # hashed at the import too
    stranger = _texport(tcache).to_host()
    stranger.checksum, stranger._verified = "0" * 32, False
    with pytest.raises(tkv.BlockIntegrityError, match="checksum"):
        tkv.import_block(tcache, stranger, [1, 3])


@pytest.mark.parametrize("kind", KINDS)
def test_wire_roundtrip_exact_and_corruption_raises(kind):
    _, tcache = pools(kind)
    with pytest.raises(tkv.BlockIntegrityError, match="to_host"):
        _texport(tcache).to_bytes()  # not on the host yet
    blk = _texport(tcache).to_host()
    wire = blk.to_bytes()
    back = tkv.KVPageBlock.from_bytes(wire)
    assert back.checksum == blk.checksum and back.is_host
    assert (back.n_tokens, back.page_size, back.history, back.produced, back.last_tok) == \
        (blk.n_tokens, blk.page_size, blk.history, blk.produced, blk.last_tok)
    np.testing.assert_array_equal(back.prompt, blk.prompt)
    for a, b in zip(tree_leaves((blk.k_pages, blk.v_pages, blk.resume_gen, blk.resume_recent)),
                    tree_leaves((back.k_pages, back.v_pages, back.resume_gen,
                                 back.resume_recent))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flipped = bytearray(wire)
    flipped[len(wire) - 40] ^= 0x01  # a byte of the sampler rows
    with pytest.raises(tkv.BlockIntegrityError, match="checksum"):
        tkv.KVPageBlock.from_bytes(bytes(flipped))
    for cut in (wire[:-1], wire[: len(wire) // 2], wire[:12], b"junk" * 4, wire + b"\0"):
        with pytest.raises(tkv.BlockIntegrityError):
            tkv.KVPageBlock.from_bytes(cut)


def test_cross_mode_and_geometry_imports_rejected_as_jax():
    """An int8 block never scatters into a float pool, a block whose page
    shape differs is refused, and a page-count mismatch is caught before
    any write, in both packages."""
    (jq, tq), (jf, tf) = pools("int8"), pools("f32")
    jb, tb = _jexport(jq).to_host(), _texport(tq).to_host()
    assert "mismatch" in jb.compatible_with(jf) and "mismatch" in tb.compatible_with(tf)
    with pytest.raises(jkv.BlockIntegrityError, match="mismatch"):
        jkv.import_block(jf, jb, [1, 3])
    with pytest.raises(tkv.BlockIntegrityError, match="mismatch"):
        tkv.import_block(tf, tb, [1, 3])
    wide = PagedKV(k=torch.zeros(2, POOL + 1, PAGE, 2, 8), v=torch.zeros(2, POOL + 1, PAGE, 2, 8),
                   offsets=[0])
    assert "geometry" in _texport(tf).to_host().compatible_with(wide)
    bf = pools("bf16")[1]
    assert "dtype" in _texport(tf).to_host().compatible_with(bf)
    with pytest.raises(jkv.BlockIntegrityError, match="pages"):
        jkv.import_block(jf, _jexport(jf).to_host(), [1])
    with pytest.raises(tkv.BlockIntegrityError, match="pages"):
        tkv.import_block(tf, _texport(tf).to_host(), [1])


def test_export_import_fault_sites_fire():
    _, cache = pools("f32")
    faults.arm("cache.export", exc=faults.FaultError, times=1)
    with pytest.raises(faults.FaultError):
        _texport(cache)
    blk = _texport(cache).to_host()  # spent: the export works again
    faults.arm("cache.import", exc=faults.FaultError, times=1)
    with pytest.raises(faults.FaultError):
        tkv.import_block(cache, blk, [1, 3])
    tkv.import_block(cache, blk, [1, 3])


# ------------------------------------------------------------- spill tier
def _fake(pkg, nbytes):
    """A block of ``nbytes`` payload bytes in package ``pkg``."""
    if pkg is jkv:
        payload = np.zeros(nbytes // 2, np.uint8)
        return jkv.KVPageBlock(k_pages=payload, v_pages=payload.copy(), n_tokens=1, page_size=4,
                               prompt=np.array([1], np.int32), history=[7], produced=1,
                               last_tok=7, resume_keys=None, resume_recent=None)
    payload = torch.zeros(1, nbytes // 2, dtype=torch.uint8)
    return tkv.KVPageBlock(k_pages=payload, v_pages=payload.clone(), n_tokens=1, page_size=4,
                           prompt=np.array([1], np.int64), history=[7], produced=1, last_tok=7,
                           resume_gen=None, resume_recent=None)


def _lru_script(pkg) -> dict:
    tier = pkg.KVSpillTier(100, flush_async=False)
    a, b, c = "a", "b", "c"
    assert tier.put(a, _fake(pkg, 40)) and tier.put(b, _fake(pkg, 40))
    tier.put(a, tier.take(a))  # refresh: a becomes MRU
    assert tier.put(c, _fake(pkg, 40))  # evicts b, not a
    assert tier.take(b) is None and tier.contains(a) and tier.peek(c) is not None
    assert not tier.put("d", _fake(pkg, 200))  # alone over budget
    tier.touch(a)
    tier.touch("zzz")  # absent: a no-op
    assert tier.keys() == [a, c]
    tier.put("e", _fake(pkg, 40))  # evicts c: a was touched
    tier.drop("e")  # neither hit nor miss
    stats = tier.stats()
    tier.close()
    assert not tier.put("f", _fake(pkg, 10))  # closed
    return {"open": stats, "closed": tier.stats()}


def test_spill_tier_lru_and_counters_equal_jax():
    got, want = _lru_script(tkv), _lru_script(jkv)
    assert got == want
    assert want["open"]["evictions"] == 2 and want["closed"]["rejects_closed"] == 1
    with pytest.raises(ValueError, match="positive"):
        tkv.KVSpillTier(0)


def test_tier_flusher_moves_block_to_host():
    _, cache = pools("bf16")
    tier = tkv.KVSpillTier(1 << 20)
    blk = _texport(cache)
    assert not blk.is_host
    assert tier.put("req", blk)
    deadline = time.monotonic() + 30
    while tier.stats()["blocks_host"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert blk.is_host and tier.take("req") is blk
    blk.verify()
    tier.close()


def test_block_prefetch_stage_and_payload():
    """prefetch() stages a flushed block once, payload() prefers the stage,
    drop_prefetch() releases it; a block not yet flushed never stages."""
    _, cache = pools("f32")
    dev = _texport(cache)
    dev.prefetch()
    assert not dev.is_prefetched
    host = _texport(cache).to_host()
    host.prefetch(device="cpu")
    assert host.is_prefetched
    staged = host.payload()
    host.prefetch(device="cpu")  # idempotent
    assert host.payload()[0] is staged[0]
    host.drop_prefetch()
    assert not host.is_prefetched and host.payload()[2] is None
    faults.arm("cache.prefetch", exc=faults.FaultError)
    with pytest.raises(faults.FaultError):
        host.prefetch()
    assert not host.is_prefetched
