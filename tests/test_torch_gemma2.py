"""The port's Gemma-2 (``models/gemma2.py``) and the two kernels' softcap and
sliding window against the JAX package.

The plain versions of kernel 1 (``flash_attention_reference``, and its split
walk as the card runs it), of its T=1 route (``flash_decode_reference``) and
of kernel 2 (``paged_attention_reference`` and the card's walk) with a
logit softcap and a window, against JAX's ``causal_attention`` and
``_paged_attention_xla``, at head dims 64, 128 and 256, windows that cut,
lengths below, at and past the window and 0; the split planner with a
window. Then the model on a tiny config (3 layers, window 24, caps 3 and 5):
one layer's halves, every position of a 150-token forward in f32 and bf16,
prefill against decode, greedy streams through both Generators and both
batchers, both loaders on a tiny HF checkpoint, and the CLI and the server
on the CPU. f32 tolerance 2e-4 for attention (the JAX kernel tests'), the
harness's elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import causal_attention as j_causal_attention
from mlx_sharding_tpu.ops.paged_attention import _paged_attention_xla
from mlx_sharding_tpu_torch import cache
from mlx_sharding_tpu_torch.ops import flash_attention as fa
from mlx_sharding_tpu_torch.ops import paged_attention as pa
from tests.test_torch_families import (
    BF16_REL_L2,
    F32_TOL,
    batcher_streams,
    f32,
    generator_streams,
    jax_pair,
    loads_match,
    logits_both,
    port,
    prefill_then_decode,
    prompt,
    rel_l2,
    serve_cli_and_server,
    tokenizer_checkpoint,
)

FAMILY = "gemma2"
ATTN_TOL = 2e-4
# (Hq, Hkv, D): Gemma-2-9B's group and head dim, and narrower ones
HEADS = [(4, 2, 64), (4, 4, 128), (16, 8, 256)]
CAP = 2.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps run on one torch thread in this module: under
    the test run's several workers, a thread pool per small op contends for
    the cores and multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(rng, b, t, s, hq, hkv, d):
    return (rng.standard_normal((b, t, hq, d)).astype(np.float32) * 2,
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _jax_attn(q, k, v, offset, scale, cap, window):
    return np.asarray(j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(offset), scale, logit_softcap=cap,
                                         sliding_window=window))


@pytest.mark.parametrize("hq,hkv,d", HEADS)
@pytest.mark.parametrize("offset,window", [(0, 40), (96, 40), (200, 100), (64, 1), (64, None)])
def test_flash_plain_version_with_softcap_and_window(hq, hkv, d, offset, window):
    """A 128-row chunk through the wrapper's CPU branch (the plain version)
    with a softcap and a window that cuts inside the chunk and before it;
    a window of 1 (each row sees only itself) is exact."""
    rng = np.random.default_rng(d + offset)
    q, k, v = _qkv(rng, 1, 128, 384, hq, hkv, d)
    want = _jax_attn(q, k, v, offset, d ** -0.5, CAP, window)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), offset, d ** -0.5,
                             logit_softcap=CAP, sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    if window == 1:
        np.testing.assert_allclose(got, np.repeat(v[:, offset:offset + 128], hq // hkv, axis=2),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv,d", HEADS)
@pytest.mark.parametrize("offset,window,split", [(0, 100, 64), (256, 100, 64), (256, 300, 128),
                                                 (512, 1000, 256), (96, 40, 0)])
def test_split_walk_with_window_matches_jax(hq, hkv, d, offset, window, split):
    """The card's walk in plain PyTorch (row tiles from their first row's
    window, chunks cut from there, the merge) against JAX; every planned
    chunk holds keys, the chunks tile each row tile's range, and the grid's
    chunk count is the longest tile's."""
    rng = np.random.default_rng(3 * d + offset)
    t, s = 128, 1024
    q, k, v = _qkv(rng, 1, t, s, hq, hkv, d)
    want = _jax_attn(q, k, v, offset, d ** -0.5, CAP, window)
    got = fa.flash_attention_split_reference(*(torch.from_numpy(x) for x in (q, k, v)), offset,
                                             d ** -0.5, split, logit_softcap=CAP,
                                             sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    g = hq // hkv
    plan = fa.split_chunks(t, g, s, offset, split, window)
    n = fa.num_splits(t, s, offset, split, g, window)
    assert max(len(c) for c in plan) == n
    for tile, chunks in enumerate(plan):
        first, end = fa.tile_kv_range(t, g, s, offset, tile, window)
        assert chunks[0][0] == first and chunks[-1][1] == end
        assert all(a < b for a, b in chunks)
        assert all(b == a2 for (_, b), (a2, _) in zip(chunks, chunks[1:]))
        # the first row of the tile sees its window's first key
        assert first == max(0, offset + tile * fa.BLOCK_ROWS // g - window + 1)


def test_split_plan_learns_the_window():
    """Gemma-2-9B's shapes at a chunk deep in an 8192-row cache: the window
    shortens every tile's walk, so the planner's chunks shrink with it and
    no chunk is empty."""
    off, s = 7936, 8192
    whole = fa.plan_split(1, 256, s, 16, 8, off, 132)
    windowed = fa.plan_split(1, 256, s, 16, 8, off, 132, window=4096)
    assert fa.longest_walk(256, 2, s, off) == s
    assert fa.longest_walk(256, 2, s, off, 4096) == 4096 + 31
    assert windowed < whole
    plan = fa.split_chunks(256, 2, s, off, windowed, 4096)
    assert all(chunks and all(a < b for a, b in chunks) for chunks in plan)
    assert fa.num_splits(256, s, off, 0, 2, 4096) == 1


@pytest.mark.parametrize("d", [64, 256])
def test_flash_decode_plain_version_with_softcap_and_window(d):
    """The T=1 route's plain version (the paged plain version over the
    dense cache's paged view) at positions below, at and past the window,
    against JAX's causal attention of one query."""
    rng = np.random.default_rng(d)
    _, k, v = _qkv(rng, 1, 1, 256, 4, 2, d)
    for pos in (5, 39, 40, 41, 200):
        q = rng.standard_normal((1, 1, 4, d)).astype(np.float32)
        want = _jax_attn(q, k, v, pos, d ** -0.5, CAP, 40)
        got = fa.flash_decode(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.tensor([pos]), d ** -0.5, logit_softcap=CAP,
                              sliding_window=40).numpy()
        np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def _paged_case(rng, lengths, hq, hkv, d, page, spg):
    m = len(lengths)
    pages = m * spg
    kp = rng.standard_normal((pages + 1, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pages + 1, page, hkv, d)).astype(np.float32)
    tables = np.full((m, spg), pages, np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = np.arange(i * spg, i * spg + used)
    q = rng.standard_normal((m, hq, d)).astype(np.float32) * 2
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


# lengths below, at and past the window (100), on page edges, and 0
PAGED_LENGTHS = [0, 1, 64, 99, 100, 101, 128, 200, 255, 256]


@pytest.mark.parametrize("hq,hkv,d", HEADS)
@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_paged_plain_version_with_softcap_and_window(hq, hkv, d, pool):
    """The paged plain version against ``_paged_attention_xla`` with cap 2
    and window 100; the card's walk (from the window's first tile, the
    keys below it masked, split in 64s and whole) against it too."""
    rng = np.random.default_rng(d + hq)
    q, kp, vp, tables, lengths = _paged_case(rng, PAGED_LENGTHS, hq, hkv, d, 16, 16)
    kw = {}
    if pool == "int8":
        kq, vq = (cache.quantize_kv_rows(torch.from_numpy(x)) for x in (kp, vp))
        kp, vp = kq["d"].numpy(), vq["d"].numpy()
        kw = dict(k_scale=kq["s"].numpy(), v_scale=vq["s"].numpy())
    scale = d ** -0.5
    want = np.asarray(_paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), scale, CAP, 100, None,
        **{n: jnp.asarray(x) for n, x in kw.items()}))
    tkw = {n: torch.from_numpy(x) for n, x in kw.items()}
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, lengths)]
    got = pa.paged_attention(*args, scale, logit_softcap=CAP, sliding_window=100, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert not got[0].any()  # length 0: zeros
    for split in (64, 0):
        walk = pa.paged_attention_split_reference(*args, scale, split, logit_softcap=CAP,
                                                  sliding_window=100, **tkw).numpy()
        np.testing.assert_allclose(walk, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_paged_walk_starts_at_the_windows_tile():
    assert pa.walk_start(0, 100) == (0, 0)
    assert pa.walk_start(99, 100) == (0, 0)
    assert pa.walk_start(230, 100) == (130, 128)
    assert pa.walk_start(5000, None) == (0, 0)
    # the plan cuts the walk a window leaves: 4 slots at Gemma-2-9B's shapes
    assert pa.plan_paged_split(4, 8, 256, 32, 132, window=4096) <= pa.MAX_SPLIT
    assert pa.plan_paged_split(1, 1, 256, 32, 132, window=256) == 64


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    cfg, jm, params = jax_pair(FAMILY)
    return cfg, jm, params, port(cfg, params)


def test_layer_halves_match_jax(pair):
    """Layer 0's (1 + w) norm, QKV and RoPE, and its sandwich-normed finish
    with the GeGLU, within ``F32_TOL``; each layer carries its global index
    and its window (even layers) and softcap."""
    cfg, jm, params, tm = pair
    h = np.random.default_rng(1).standard_normal((1, 5, 128)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    for want, got in zip(jm.layer_attn_inputs(p0, jnp.asarray(h), 3),
                         tm.layer_attn_inputs(tm.layers[0], torch.from_numpy(h), 3)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL, atol=F32_TOL)
    attn = np.random.default_rng(2).standard_normal((1, 5, 4, 64)).astype(np.float32)
    want = jm.layer_finish(p0, jnp.asarray(h), jnp.asarray(attn))
    got = tm.layer_finish(tm.layers[0], torch.from_numpy(h), torch.from_numpy(attn))
    np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL, atol=F32_TOL)
    assert [layer.layer_idx for layer in tm.layers] == [0, 1, 2]
    assert [tm.attn_options(layer)["sliding_window"] for layer in tm.layers] == [24, None, 24]
    assert all(tm.attn_options(layer)["logit_softcap"] == 3.0 for layer in tm.layers)
    assert tm.scale == 64 ** -0.5


def test_logits_match_jax_f32_and_prefill_equals_decode(pair):
    """A 150-token forward (positions far past the window of 24) at every
    position within ``F32_TOL``, and again as a 128-token prefill (the flash
    route, softcap and window) then T=1 steps (the T=1 route)."""
    _, jm, params, tm = pair
    tokens = prompt(150)
    want, got = logits_both(jm, params, tm, tokens)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(prefill_then_decode(tm, tokens, 128), got, rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.abs(got).max() <= 5.0  # the final softcap


def test_embedding_scale_rounds_like_jax():
    """The sqrt(hidden) factor is rounded to the activations' dtype, as JAX
    rounds it: bf16 logits within ``BF16_REL_L2`` at every position."""
    cfg, jm, params = jax_pair(FAMILY, dtype=jnp.bfloat16, hidden_size=128)
    tm = port(cfg, params)
    h = torch.ones(1, 1, 128, dtype=torch.bfloat16)
    jh = jm.embed_transform(jnp.ones((1, 1, 128), jnp.bfloat16))
    assert torch.equal(tm.embed_transform(h).float(), torch.from_numpy(f32(jh)))
    want, got = logits_both(jm, params, tm, prompt(40))
    assert rel_l2(got, want) <= BF16_REL_L2


def test_generator_streams_match_jax(pair):
    """32 greedy tokens after a 30-token prompt (past the window), through
    both Generators."""
    _, jm, params, tm = pair
    want, got = generator_streams(jm, params, tm)
    assert got == want


def test_batcher_streams_match_jax(pair):
    _, jm, params, tm = pair
    want, got = batcher_streams(jm, params, tm)
    assert got == want


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tokenizer_checkpoint(tmp_path_factory.mktemp("gemma2") / "hf", FAMILY)


def test_both_loaders_agree(ckpt):
    """The tied head and the four norms a layer map in both loaders."""
    tm = loads_match(ckpt, keep_quantized=False)
    assert not hasattr(tm, "lm_head") and tm.head_is_tied()
    assert hasattr(tm.layers[0], "pre_ffw_norm")


def test_cli_and_server_on_cpu(ckpt, monkeypatch, capsys):
    serve_cli_and_server(ckpt, monkeypatch, capsys)
