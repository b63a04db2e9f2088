"""The port's ragged paged decode attention and paged-pool helpers against
the JAX package's on the same numpy inputs: the plain version against the
Pallas kernel (interpret mode) and the XLA path over uneven lengths,
page-boundary lengths, an empty slot and MHA/GQA/MQA layouts (groups 1-7), for f32,
bf16 and int8 pools; ``quantize_kv_rows`` bit for bit; the card kernel's
split walk (``plan_paged_split``'s picks, and the walk and its merge in
plain PyTorch) against the plain version and the Pallas kernel. In f32 the
tolerance is 2e-5, as the JAX package's own parity matrix states; bf16
outputs may differ by the rounding of the fp32 sums to bf16 (two ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import cache as jcache
from mlx_sharding_tpu.ops.paged_attention import paged_attention as j_paged_attention
from mlx_sharding_tpu_torch import cache
from mlx_sharding_tpu_torch.convert import to_torch
from mlx_sharding_tpu_torch.ops import paged_attention as pa

PAGE = 8
SPG = 4  # pages per slot: 32 positions
# mid-page, one page exactly, two pages exactly, an empty slot, uneven
# multi-page, a full slot
LENGTHS = [5, PAGE, 2 * PAGE, 0, 27, SPG * PAGE]
F32_TOL = 2e-5
BF16_TOL = 2.0**-7
# MHA, GQA at G = 2, MQA, and the groups the card's kernel pads (3, 6 = the
# Qwen2-1.5B group, 7 = the Qwen2-7B group)
HEADS = pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1), (6, 2), (12, 2), (7, 1)],
                                ids=["mha", "gqa", "mqa", "g3", "g6", "g7"])
PATHS = pytest.mark.parametrize("interpret", [False, True], ids=["xla", "kernel"])


def _case(rng, lengths, hq, hkv, dk, dv):
    """A pool laid out as ``init_cache_paged`` does: each slot owns distinct
    pages for its live prefix, the scratch page (last id) past it."""
    m = len(lengths)
    n_pages = m * SPG
    k_pool = rng.standard_normal((n_pages + 1, PAGE, hkv, dk), np.float32)
    v_pool = rng.standard_normal((n_pages + 1, PAGE, hkv, dv), np.float32)
    tables = np.full((m, SPG), n_pages, np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // PAGE)
        tables[i, :used] = np.arange(i * SPG, i * SPG + used)
    q = rng.standard_normal((m, hq, dk), np.float32)
    return q, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


def _jax(q, k, v, tables, lengths, scale, interpret=False, **kw):
    kw = {name: jnp.asarray(x) if isinstance(x, np.ndarray) else x for name, x in kw.items()}
    out = j_paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(tables), jnp.asarray(lengths), scale,
                            interpret=interpret, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, tables, lengths, scale, **kw):
    kw = {name: to_torch(x) if isinstance(x, np.ndarray) else x for name, x in kw.items()}
    out = pa.paged_attention(to_torch(q), to_torch(k), to_torch(v), to_torch(tables),
                             to_torch(lengths), scale, **kw)
    return out.float().numpy()


@HEADS
@PATHS
def test_plain_version_matches_jax_f32(hq, hkv, interpret):
    rng = np.random.default_rng(0)
    q, k, v, tables, lengths = _case(rng, LENGTHS, hq, hkv, 16, 16)
    want = _jax(q, k, v, tables, lengths, 0.25, interpret)
    got = _port(q, k, v, tables, lengths, 0.25)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert not got[LENGTHS.index(0)].any()  # the empty slot is zeros


@HEADS
def test_plain_version_matches_jax_bf16_pool(hq, hkv):
    """bf16 q and pools through the XLA path, whose probs are rounded to
    bf16 as the plain version's are."""
    import ml_dtypes

    rng = np.random.default_rng(1)
    q, k, v, tables, lengths = (x.astype(ml_dtypes.bfloat16) if x.dtype == np.float32 else x
                                for x in _case(rng, LENGTHS, hq, hkv, 16, 16))
    want = _jax(q, k, v, tables, lengths, 0.25)
    got = _port(q, k, v, tables, lengths, 0.25)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def _int8_case(rng, hq, hkv):
    q, k, v, tables, lengths = _case(rng, LENGTHS, hq, hkv, 16, 16)
    kq, vq = (jcache.quantize_kv_rows(jnp.asarray(x)) for x in (k, v))
    return q, tables, lengths, {name: np.asarray(x) for name, x in (
        ("k", kq["d"]), ("v", vq["d"]), ("k_scale", kq["s"]), ("v_scale", vq["s"]))}


@HEADS
@PATHS
def test_plain_version_matches_jax_int8_pool(hq, hkv, interpret):
    """Int8 codes times their per-row-per-head scale as the pages are read."""
    q, tables, lengths, p = _int8_case(np.random.default_rng(2), hq, hkv)
    want = _jax(q, p["k"], p["v"], tables, lengths, 0.25, interpret,
                k_scale=p["k_scale"], v_scale=p["v_scale"])
    got = _port(q, p["k"], p["v"], tables, lengths, 0.25,
                k_scale=p["k_scale"], v_scale=p["v_scale"])
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("option", [{"logit_softcap": 3.0}, {"sliding_window": 4}],
                         ids=["softcap", "window"])
def test_softcap_and_window_match_jax(option):
    """The plain version carries the XLA path's softcap and window (the
    kernel does not take them)."""
    rng = np.random.default_rng(3)
    q, k, v, tables, lengths = _case(rng, LENGTHS, 4, 2, 16, 16)
    want = _jax(q, k, v, tables, lengths, 0.5, **option)
    got = _port(q, k, v, tables, lengths, 0.5, **option)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_values_from_k_is_not_yet_ported():
    q, k, v, tables, lengths = _case(np.random.default_rng(4), [3], 2, 2, 16, 16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _port(q, k, v, tables, lengths, 0.25, values_from_k=8)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v, tables, lengths = (to_torch(x) for x in _case(np.random.default_rng(5), LENGTHS,
                                                           4, 2, 64, 64))
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, lengths, 0.125)
    assert pa.paged_attention.launches == before
    assert torch.equal(got, pa.paged_attention_reference(q, k, v, tables, lengths, 0.125))


@pytest.mark.parametrize("dk,dv,option,eligible", [
    (64, 64, {}, True),
    (128, 128, {}, True),
    (256, 128, {}, True),
    (96, 96, {}, False),
    (320, 320, {}, False),
    (128, 128, {"logit_softcap": 30.0}, False),
    (128, 128, {"sliding_window": 4}, False),
    (128, 128, {"values_from_k": 64}, False),
])
def test_kernel_eligible(dk, dv, option, eligible):
    """JAX ``kernel_eligible`` on the TPU, with the head-dim cap the CUDA
    kernel's shared memory sets."""
    assert pa.kernel_eligible(dk, dv, **option) is eligible


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(2, 4, 16)[:, :, None]), "q must be"),
    (dict(tables=torch.zeros(3, SPG, dtype=torch.int32)), "tables must be"),
    (dict(k_scale=torch.ones(9, PAGE, 2, 1)), "passed together"),
    (dict(v=torch.zeros(9, PAGE, 1, 16)), "mismatched"),
])
def test_wrapper_rejects_malformed_operands(bad, match):
    args = dict(q=torch.zeros(2, 4, 16), k=torch.zeros(9, PAGE, 2, 16),
                v=torch.zeros(9, PAGE, 2, 16), tables=torch.zeros(2, SPG, dtype=torch.int32),
                lengths=torch.zeros(2, dtype=torch.int32))
    bad = dict(bad)
    extra = {name: bad.pop(name) for name in ("k_scale",) if name in bad}
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        pa.paged_attention(args["q"], args["k"], args["v"], args["tables"], args["lengths"],
                           0.25, **extra)


# ------------------------------------------------------------ pool helpers
def test_quantize_kv_rows_bit_equal_to_jax():
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    rows[0, 0, 0] = 0.0  # the 1e-12 floor
    # x / s exactly half-way between codes: round half to even in both
    rows[0, 1, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    rows[0, 1, 0, 5:] = 0.0
    want = jcache.quantize_kv_rows(jnp.asarray(rows))
    got = cache.quantize_kv_rows(torch.from_numpy(rows))
    assert got["d"].dtype == torch.int8 and got["s"].shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(got["d"].numpy(), np.asarray(want["d"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        cache.dequantize_kv(got).numpy(), np.asarray(jcache.dequantize_kv(want)))
    np.testing.assert_array_equal(got["d"][0, 1, 0, :5].numpy(), [127, 0, 2, 2, 0])


def test_pool_layout_matches_the_jax_leaf():
    """``(L, P+1, page, Hkv, D)``: the JAX leaf ``(S, L, P+1, B, page, H,
    D)`` with S = B = 1 dropped; an int8 pool is a ``{d, s}`` pair; the page
    table is (M+1, slot_pages) with every entry at the scratch page."""
    for quantized in (False, True):
        kv = cache.init_cache_paged(2, 10, 8, 2, 16, 3, torch.float32, "cpu", quantized=quantized)
        assert cache.is_quantized_kv(kv.k) is quantized
        assert tuple(cache.kv_data(kv.k).shape) == (2, 11, 8, 2, 16)
        assert kv.offsets == [0, 0, 0]
        if quantized:
            assert kv.k["s"].shape == (2, 11, 8, 2, 1) and kv.k["s"].dtype == torch.float32
            assert kv.nbytes == 2 * (2 * 11 * 8 * 2 * (16 + 4))
        else:
            assert kv.nbytes == 2 * (2 * 11 * 8 * 2 * 16 * 4)
    table = cache.init_page_table(3, 8, 10)
    assert table.shape == (4, 8) and table.dtype == np.int32 and (table == 10).all()


def test_pool_writes():
    """A decode step's rows land at (page id, row); a prefill chunk's at a
    span of one page; int8 pools get the quantized rows."""
    for quantized in (False, True):
        kv = cache.init_cache_paged(1, 4, 8, 2, 16, 2, torch.float32, "cpu", quantized=quantized)
        pool = cache.layer_pool(kv.k, 0)
        rows = torch.randn(2, 2, 16)
        cache.write_pool_rows(pool, torch.tensor([3, 1]), torch.tensor([7, 0]), rows)
        span = torch.randn(5, 2, 16)
        cache.write_pool_span(pool, torch.tensor([2]), 3, span)
        got = cache.dequantize_kv(kv.k)[0]
        want = [(got[3, 7], rows[0]), (got[1, 0], rows[1]), (got[2, 3:8], span)]
        for g, w in want:
            if quantized:
                w = cache.dequantize_kv(cache.quantize_kv_rows(w))
            assert torch.equal(g, w)


# ------------------------------------------------ the split walk of the card's kernel
SMS = 132  # the H100's SMs, for the planner


@pytest.mark.parametrize("m,hq,hkv,page,spg,want", [
    (8, 32, 8, 256, 16, 512),  # the smoke's mix, and every slot at max_seq
    (32, 32, 8, 256, 16, 512),  # 32 slots of 1024
    (1, 32, 8, 256, 16, 192),  # one long stream: 8 rows need 17 splits each
    (8, 28, 4, 256, 8, 448),  # Qwen2-7B's G = 7 in one chunk of 16 heads
    (4, 24, 1, 64, 6, 64),  # G = 24: two chunks of 16 heads per KV head
    (6, 4, 2, 8, 4, 0),  # tiny pages: the whole reach is under one split
    (3, 4, 1, 16, 20, 64),  # a short walk the planner still splits
])
def test_planner_picks_the_longest_walk_that_gives_every_sm_an_item(m, hq, hkv, page, spg, want):
    """``plan_paged_split`` reads shapes only: the longest multiple of 64 up to
    ``MAX_SPLIT`` whose full-length walk gives each SM an item (0 when the
    reach fits one split), at the smoke's and the sweep's shapes, padded and
    chunked groups and tiny pages."""
    chunks = hkv * pa.head_chunks(hq, hkv)
    split = pa.plan_paged_split(m, chunks, page, spg, SMS)
    assert split == want
    reach = page * spg
    assert split % pa.SPLIT_ALIGN == 0 and split <= pa.MAX_SPLIT
    if split:
        assert split < reach
        blocks = m * chunks * pa.num_splits(page, spg, split)
        # every SM gets an item, unless the walk is already at its shortest
        # or longest
        assert blocks >= SMS or split in (pa.SPLIT_ALIGN, pa.MAX_SPLIT)
        # one step longer would leave SMs without an item
        longer = split + pa.SPLIT_ALIGN
        assert longer > pa.MAX_SPLIT or m * chunks * pa.num_splits(page, spg, longer) < SMS


def test_head_chunks_and_split_counts():
    """Groups of up to 16 heads run in one chunk; the forced values of
    ``SPLIT_POSITIONS`` (N positions a block, 0 the whole walk) give the
    blocks along the walk the kernel launches."""
    assert [pa.head_chunks(hq, hkv) for hq, hkv in ((32, 8), (28, 4), (16, 1), (24, 1), (64, 2))] == [
        1, 1, 1, 2, 2]
    assert pa.num_splits(256, 16, 0) == 1
    assert pa.num_splits(256, 16, 64) == 64
    assert pa.num_splits(256, 16, 512) == 8
    assert pa.num_splits(16, 20, 192) == 2  # 320 positions: a short last split
    assert pa.SPLIT_POSITIONS is None  # planned unless a check forces it


SPLIT_PAGE = 16
SPLIT_SPG = 12  # 192 positions a slot
# empty, one position, page edges, split edges (64, 128) and the full reach
SPLIT_LENGTHS = [0, 1, 16, 64, 65, 127, 128, 192]


def _split_case(rng, hq, hkv, d):
    m = len(SPLIT_LENGTHS)
    n_pages = m * SPLIT_SPG
    k = rng.standard_normal((n_pages + 1, SPLIT_PAGE, hkv, d), np.float32)
    v = rng.standard_normal((n_pages + 1, SPLIT_PAGE, hkv, d), np.float32)
    k[n_pages] = v[n_pages] = 30.0  # the scratch page shows if it is read
    # each slot's pages in a shuffled order, the scratch page past its length
    order = rng.permutation(n_pages)
    tables = np.full((m, SPLIT_SPG), n_pages, np.int32)
    for i, n in enumerate(SPLIT_LENGTHS):
        used = -(-n // SPLIT_PAGE)
        tables[i, :used] = order[i * SPLIT_SPG: i * SPLIT_SPG + used]
    q = rng.standard_normal((m, hq, d), np.float32)
    return q, k, v, tables, np.asarray(SPLIT_LENGTHS, np.int32)


SPLIT_HEADS = pytest.mark.parametrize("hq,hkv", [(8, 2), (6, 2), (4, 4)], ids=["g4", "g3", "mha"])
SPLITS = (0, 64, 128)


@SPLIT_HEADS
def test_split_walk_matches_plain_version_and_jax_kernel_f32(hq, hkv):
    """The kernel's walk in plain PyTorch (blocks of 64 and 128 positions and
    whole, merged in split order) equals the plain version within 1e-5 in f32
    (the sums run in another order) and the JAX Pallas kernel in interpret
    mode within 2e-5 (the JAX package's own tolerance); the empty slot is
    zeros."""
    q, k, v, tables, lengths = _split_case(np.random.default_rng(hq + hkv), hq, hkv, 32)
    want_jax = _jax(q, k, v, tables, lengths, 0.2, interpret=True)
    tq, tk, tv, tt, tl = (to_torch(x) for x in (q, k, v, tables, lengths))
    ref = pa.paged_attention_reference(tq, tk, tv, tt, tl, 0.2)
    for split in SPLITS:
        got = pa.paged_attention_split_reference(tq, tk, tv, tt, tl, 0.2, split)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_jax, atol=F32_TOL, rtol=F32_TOL)
        assert not got[SPLIT_LENGTHS.index(0)].any()


@SPLIT_HEADS
def test_split_walk_matches_plain_version_and_jax_kernel_int8_pool(hq, hkv):
    """Int8 codes times their row scales: the split walk against the plain
    version (1e-5) and the JAX Pallas kernel in interpret mode (2e-5)."""
    q, k, v, tables, lengths = _split_case(np.random.default_rng(7 + hq), hq, hkv, 32)
    kq, vq = (jcache.quantize_kv_rows(jnp.asarray(x)) for x in (k, v))
    kd, ks, vd, vs = (np.asarray(x) for x in (kq["d"], kq["s"], vq["d"], vq["s"]))
    want_jax = _jax(q, kd, vd, tables, lengths, 0.2, interpret=True, k_scale=ks, v_scale=vs)
    tq, tk, tv, tt, tl, tks, tvs = (to_torch(x) for x in (q, kd, vd, tables, lengths, ks, vs))
    ref = pa.paged_attention_reference(tq, tk, tv, tt, tl, 0.2, k_scale=tks, v_scale=tvs)
    for split in SPLITS:
        got = pa.paged_attention_split_reference(tq, tk, tv, tt, tl, 0.2, split, k_scale=tks,
                                                 v_scale=tvs)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_jax, atol=F32_TOL, rtol=F32_TOL)
        assert not got[SPLIT_LENGTHS.index(0)].any()


@SPLIT_HEADS
def test_split_walk_matches_plain_version_and_jax_bf16_pool(hq, hkv):
    """bf16 q and pools: probs are rounded to bf16 before P V in the split
    walk and the plain version alike, but each split rounds its own probs
    (relative to its own max), so the outputs agree with the plain version
    and the JAX Pallas kernel in interpret mode to the bf16 tolerance of
    this file (2^-7, about two ulps)."""
    import ml_dtypes

    q, k, v, tables, lengths = (x.astype(ml_dtypes.bfloat16) if x.dtype == np.float32 else x
                                for x in _split_case(np.random.default_rng(11 + hq), hq, hkv, 32))
    want_jax = _jax(q, k, v, tables, lengths, 0.2, interpret=True)
    tq, tk, tv, tt, tl = (to_torch(x) for x in (q, k, v, tables, lengths))
    ref = pa.paged_attention_reference(tq, tk, tv, tt, tl, 0.2).float().numpy()
    for split in SPLITS:
        got = pa.paged_attention_split_reference(tq, tk, tv, tt, tl, 0.2, split)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        np.testing.assert_allclose(got, ref, atol=BF16_TOL, rtol=BF16_TOL)
        np.testing.assert_allclose(got, want_jax, atol=BF16_TOL, rtol=BF16_TOL)
        assert not got[SPLIT_LENGTHS.index(0)].any()


def test_split_walk_clips_lengths_to_the_reach():
    """A length past the table's reach reads no further than the reach, in
    the split walk as in the plain version."""
    q, k, v, tables, lengths = _split_case(np.random.default_rng(3), 4, 2, 32)
    lengths = lengths.copy()
    lengths[-1] = SPLIT_PAGE * SPLIT_SPG + 50
    tq, tk, tv, tt, tl = (to_torch(x) for x in (q, k, v, tables, lengths))
    ref = pa.paged_attention_reference(tq, tk, tv, tt, tl.clamp_max(SPLIT_PAGE * SPLIT_SPG), 0.2)
    got = pa.paged_attention_split_reference(tq, tk, tv, tt, tl, 0.2, 64)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
