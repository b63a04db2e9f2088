"""Page blocks of a pipeline of two stages: the port's staged export and
import (``cache.StagedKV``, ``kv_transfer.export_block`` / ``import_block``)
against the JAX package's pp = 2 pool, on hand-built pools of 6 pages +
scratch, page 4, 2 KV heads, D 4, a distinct value in every cell.

JAX stacks the stages on axis 0 of one leaf ``(S, L, P+1, B, page, H, D)``
and pads an uneven split to its largest stage. The port keeps one pool a
stage over its own layers, ``(L_s, P+1, page, H, D)``: stage s of a port
block must equal ``leaf[s, :L_s, :, 0]`` of JAX's, bit for bit (bf16, f32,
an int8 pool's codes and scales), at an even split (2 / 2) and an uneven
one (3 / 1, JAX's pad layer dropped). An import must land where JAX's
lands; the wire round trip is exact, and a flipped or cut payload raises.
A block is refused by a pool of another stage count or split where JAX's
refuses, with JAX's reason."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu.cache import KVCache
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch.cache import PagedKV, staged
from mlx_sharding_tpu_torch.kv_compress import tree_leaves
from tests.test_torch_kv_transfer import one_torch_thread  # noqa: F401

POOL, PAGE, HEADS, DIM = 6, 4, 2, 4
SPLITS = {"even_2_2": (2, 2), "uneven_3_1": (3, 1)}
KINDS = ("bf16", "int8")


def _numpy_pool(split, kind, seed=0):
    """(k, v) as JAX pp = S leaves in numpy, L padded to the largest stage
    (the pad layers hold values too, which the port never sees)."""
    leaf = (len(split), max(split), POOL + 1, 1, PAGE, HEADS, DIM)
    rng = np.random.default_rng(seed)
    vals = np.arange(np.prod(leaf), dtype=np.float32).reshape(leaf) + 7.0 * seed
    if kind == "int8":
        def q(offset):
            return {"d": ((vals + offset) % 127).astype(np.int8),
                    "s": rng.uniform(0.5, 2.0, leaf[:-1] + (1,)).astype(np.float32)}
        return q(0), q(3)
    dt = ml_dtypes.bfloat16 if kind == "bf16" else np.float32
    return (vals % 251).astype(dt), ((vals + 1000.0) % 509).astype(dt)


def _tmap(fn, tree):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _stage_leaf(a, s, layers):
    """Stage s of a JAX leaf as the port's ``(L_s, P+1, page, H, D)``."""
    a = np.ascontiguousarray(np.asarray(a)[s, :layers, :, 0])
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def pools(split, kind, seed=0):
    """The same pool in both packages: (JAX KVCache, port StagedKV)."""
    k, v = _numpy_pool(split, kind, seed)
    jcache = KVCache(k=_tmap(jnp.asarray, k), v=_tmap(jnp.asarray, v),
                     offset=jnp.zeros((), jnp.int32))
    stages = [PagedKV(k=_tmap(lambda a, s=s, n=n: _stage_leaf(a, s, n), k),
                      v=_tmap(lambda a, s=s, n=n: _stage_leaf(a, s, n), v), offsets=[0])
              for s, n in enumerate(split)]
    return jcache, staged(stages)


def _as_np(leaf) -> np.ndarray:
    if leaf.dtype == torch.bfloat16:
        return leaf.float().numpy().astype(ml_dtypes.bfloat16)
    return leaf.numpy()


def assert_stages_equal(jax_tree, port_stages, split):
    """Each stage of the port's payload equals JAX's ``[s, :L_s, :, 0]``,
    bit for bit."""
    jl = [np.asarray(x) for x in tree_leaves(jax_tree)]
    for s, n in enumerate(split):
        tl = tree_leaves(tuple(part[s] for part in port_stages))
        assert len(tl) == len(jl)
        for j, t in zip(jl, tl):
            got = _as_np(t)
            assert got.dtype == j.dtype and got.shape[0] == n
            np.testing.assert_array_equal(got.view(np.uint8), j[s, :n, :, 0].view(np.uint8))


def _jexport(cache, pages=(5, 0, 3), n_tokens=10):
    return jkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=n_tokens,
                            prompt=[1, 2, 3], history=[5, 6, 7], produced=3,
                            resume_keys=None, resume_recent=None)


def _texport(cache, pages=(5, 0, 3), n_tokens=10):
    return tkv.export_block(cache, list(pages), page_size=PAGE, n_tokens=n_tokens,
                            prompt=[1, 2, 3], history=[5, 6, 7], produced=3,
                            resume_gen=torch.Generator().manual_seed(3).get_state(),
                            resume_recent=torch.arange(6))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split", list(SPLITS))
def test_staged_export_equals_jax_stage_by_stage(split, kind):
    """A staged export holds one payload per stage, in stage order, equal
    to JAX's pp = 2 block stage by stage (its pad layers dropped); the
    block records the stage layout, and its bytes equal JAX's at an even
    split and are smaller at an uneven one (no pad layers)."""
    layers = SPLITS[split]
    jcache, tcache = pools(layers, kind)
    jb, tb = _jexport(jcache), _texport(tcache)
    assert tb.stage_layers == layers and tb.n_pages == jb.n_pages == 3
    assert isinstance(tb.k_pages, list) and len(tb.k_pages) == 2
    assert_stages_equal((jb.k_pages, jb.v_pages), (tb.k_pages, tb.v_pages), layers)
    if layers[0] == layers[1]:
        assert tb.nbytes == jb.nbytes
    else:
        assert tb.nbytes < jb.nbytes
    jb.to_host()
    tb.to_host()
    assert tb.is_host and tb.checksum is not None
    assert_stages_equal((jb.k_pages, jb.v_pages), (tb.k_pages, tb.v_pages), layers)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split", list(SPLITS))
def test_staged_import_round_trips_and_lands_where_jax_lands(split, kind):
    """export → to_host → import into other pages of another pool of the
    same split: every stage's pool afterwards equals JAX's, written in
    place, and the moved pages equal the source's exactly; a prefetched
    block imports the same."""
    layers = SPLITS[split]
    jsrc, tsrc = pools(layers, kind)
    jdst, tdst = pools(layers, kind, seed=1)
    before = [t.data_ptr() for c in tdst.stages for t in tree_leaves((c.k, c.v))]
    jb, tb = _jexport(jsrc).to_host(), _texport(tsrc).to_host()
    tb.verify()
    jout = jkv.import_block(jdst, jb, [1, 2, 4])
    assert tkv.import_block(tdst, tb, [1, 2, 4]) is tdst
    assert [t.data_ptr() for c in tdst.stages for t in tree_leaves((c.k, c.v))] == before
    assert_stages_equal((jout.k, jout.v), ([c.k for c in tdst.stages],
                                           [c.v for c in tdst.stages]), layers)
    for src, dst in zip(tsrc.stages, tdst.stages):
        for a, b in zip(tree_leaves((src.k, src.v)), tree_leaves((dst.k, dst.v))):
            assert torch.equal(a[:, [5, 0, 3]], b[:, [1, 2, 4]])
    _, again = pools(layers, kind, seed=1)
    staged_blk = _texport(tsrc).to_host().prefetch(device=["cpu", "cpu"])
    assert staged_blk.is_prefetched
    tkv.import_block(again, staged_blk, [1, 2, 4])
    for a, b in zip(tdst.stages, again.stages):
        for x, y in zip(tree_leaves((a.k, a.v)), tree_leaves((b.k, b.v))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_staged_wire_round_trip_is_exact_and_corruption_raises(kind):
    """``to_bytes`` / ``from_bytes`` carry the stage layout and every
    stage's leaves bit for bit; the checksum covers the layout, and a
    flipped byte anywhere or a cut payload raises ``BlockIntegrityError``."""
    _, tcache = pools((3, 1), kind)
    blk = _texport(tcache).to_host()
    wire = blk.to_bytes()
    back = tkv.KVPageBlock.from_bytes(wire)
    assert back.stage_layers == (3, 1) and back.checksum == blk.checksum
    assert isinstance(back.k_pages, list)
    for a, b in zip(tree_leaves((blk.k_pages, blk.v_pages)),
                    tree_leaves((back.k_pages, back.v_pages))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    relaid = tkv.KVPageBlock.from_bytes(wire)
    relaid.stage_layers = (2, 2)  # the layout is part of the checksum
    with pytest.raises(tkv.BlockIntegrityError, match="checksum"):
        relaid.verify()
    for at in (40, len(wire) // 2, len(wire) - 20):
        flipped = bytearray(wire)
        flipped[at] ^= 0x01
        with pytest.raises(tkv.BlockIntegrityError):
            tkv.KVPageBlock.from_bytes(bytes(flipped))
    for cut in (wire[:-1], wire[: len(wire) // 2], wire + b"\0"):
        with pytest.raises(tkv.BlockIntegrityError):
            tkv.KVPageBlock.from_bytes(cut)


def _pp1_pool(kind, layers=4, seed=2):
    """A pp = 1 pool of ``layers`` in both packages."""
    jk, jv = _numpy_pool((layers,), kind, seed)
    jcache = KVCache(k=_tmap(jnp.asarray, jk), v=_tmap(jnp.asarray, jv),
                     offset=jnp.zeros((), jnp.int32))
    tcache = PagedKV(k=_tmap(lambda a: _stage_leaf(a, 0, layers), jk),
                     v=_tmap(lambda a: _stage_leaf(a, 0, layers), jv), offsets=[0])
    return jcache, tcache


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("target", ["pp1", "split_3_1", "pp2_into_pp1_reverse"])
def test_blocks_of_another_split_are_refused_where_jax_refuses(kind, target):
    """A pp = 2 block into a pp = 1 pool, a 0-2 / 2-4 block into a 0-3 /
    3-4 pool, and a pp = 1 block into a pp = 2 pool: JAX's
    ``compatible_with`` refuses each with a page geometry mismatch, and so
    does the port's, before any write; ``import_block`` raises."""
    if target == "pp2_into_pp1_reverse":
        (jsrc, tsrc), (jdst, tdst) = _pp1_pool(kind), pools((2, 2), kind, seed=1)
    else:
        (jsrc, tsrc) = pools((2, 2), kind)
        jdst, tdst = _pp1_pool(kind) if target == "pp1" else pools((3, 1), kind, seed=1)
    jb, tb = _jexport(jsrc).to_host(), _texport(tsrc).to_host()
    jwhy, twhy = jb.compatible_with(jdst), tb.compatible_with(tdst)
    assert jwhy is not None and jwhy.startswith("page geometry mismatch")
    assert twhy is not None and twhy.startswith("page geometry mismatch")
    with pytest.raises(tkv.BlockIntegrityError, match="page geometry mismatch"):
        tkv.import_block(tdst, tb, [1, 2, 4])
    with pytest.raises(jkv.BlockIntegrityError, match="page geometry mismatch"):
        jkv.import_block(jdst, jb, [1, 2, 4])


def test_a_split_jax_pads_alike_is_refused_by_the_port():
    """JAX compares leaves padded to the largest stage, so a 0-3 / 3-4
    block fits its 0-1 / 1-4 pool (both (2, 3, ...)) and would land stage
    0's layers 1-2 on the pool's pad rows; the port compares each stage's
    own layers and refuses it."""
    jsrc, tsrc = pools((3, 1), "bf16")
    jdst, tdst = pools((1, 3), "bf16", seed=1)
    assert _jexport(jsrc).to_host().compatible_with(jdst) is None
    why = _texport(tsrc).to_host().compatible_with(tdst)
    assert why is not None and why.startswith("page geometry mismatch")
