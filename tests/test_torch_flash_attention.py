"""The port's flash-attention module against the JAX Pallas kernel (run in
interpret mode) and the JAX XLA path, on the grid of
tests/test_flash_attention.py; its dispatch rule; its wrapper checks. The
CUDA kernel itself is tested on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import REL_L2_TOL, kernel_disagreement
from mlx_sharding_tpu.ops import causal_attention as j_causal_attention
from mlx_sharding_tpu.ops.flash_attention import flash_attention as j_flash_attention
from mlx_sharding_tpu_torch.ops import attention as attention_mod
from mlx_sharding_tpu_torch.ops import causal_attention
from mlx_sharding_tpu_torch.ops import flash_attention as fa
from mlx_sharding_tpu_torch.ops.attention import flash_eligible

GRID = [
    # b, t, s, hq, hkv, dk, dv, offset — prefill
    (1, 128, 256, 4, 4, 64, 64, 0),
    (1, 128, 256, 8, 2, 64, 64, 64),
    (2, 256, 256, 4, 2, 32, 32, 0),
    # DeepSeek MLA: full mode 192/128, compressed mode 576/512
    (1, 128, 256, 8, 8, 192, 128, 0),
    (1, 128, 128, 16, 1, 576, 512, 0),
    (1, 128, 256, 8, 8, 192, 128, 96),
    # T=1 decode steps, offset mid-buffer
    (1, 1, 256, 8, 2, 64, 64, 17),
    (1, 1, 256, 16, 1, 576, 512, 40),
    (1, 1, 128, 4, 4, 192, 192, 127),
]


def _kernel_takes(dk, dv):
    return all(d % fa.HEAD_DIM_ALIGN == 0 and d <= fa.MAX_HEAD_DIM for d in (dk, dv))


@pytest.mark.parametrize("b,t,s,hq,hkv,dk,dv,offset", GRID)
def test_flash_matches_jax_kernel_and_xla(b, t, s, hq, hkv, dk, dv, offset):
    """atol/rtol 2e-4 in f32, the tolerance of the JAX kernel's own tests.
    Head dims the CUDA kernel does not take (32, 576) make the wrapper
    raise; its plain version is still held against JAX there."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, t, hq, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    scale = dk**-0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    blocks = dict(block_q=64) if t > 1 else {}
    want_kernel = np.asarray(j_flash_attention(
        jq, jk, jv, jnp.asarray(offset), scale, block_k=64, interpret=True, **blocks))
    want_xla = np.asarray(j_causal_attention(jq, jk, jv, jnp.asarray(offset), scale))
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    if _kernel_takes(dk, dv):
        got = fa.flash_attention(tq, tk, tv, offset, scale).numpy()
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            fa.flash_attention(tq, tk, tv, offset, scale)
        got = fa.flash_attention_reference(tq, tk, tv, offset, scale).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_xla, rtol=2e-4, atol=2e-4)


def test_dispatch_rule():
    """_flash_eligible without the env switches, the TPU backend test and
    the reserved sinks argument."""
    def shapes(t, s, dk, dv):
        return torch.zeros(1, t, 8, dk), torch.zeros(1, s, 8, dk), torch.zeros(1, s, 8, dv)

    assert flash_eligible(*shapes(128, 256, 192, 128))
    assert flash_eligible(*shapes(256, 4096, 128, 128))
    assert not flash_eligible(*shapes(128, 256, 128, 128), logit_softcap=30.0)
    assert not flash_eligible(*shapes(128, 256, 128, 128), sliding_window=4096)
    assert not flash_eligible(*shapes(1, 256, 128, 128))  # T=1 decode
    assert not flash_eligible(*shapes(100, 256, 128, 128))  # ragged T
    assert not flash_eligible(*shapes(128, 200, 128, 128))  # ragged S
    assert not flash_eligible(*shapes(128, 256, 32, 32))  # head dim not 64-aligned
    assert not flash_eligible(*shapes(128, 256, 576, 512))  # MLA compressed


@pytest.mark.parametrize("t,want_calls", [(128, 1), (256, 1), (1, 0), (64, 0)])
def test_causal_attention_routes_through_flash(monkeypatch, t, want_calls):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fa.flash_attention(*args)

    monkeypatch.setattr(attention_mod, "flash_attention", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, t, 4, 64, generator=g)
    k = torch.randn(1, 256, 2, 64, generator=g)
    v = torch.randn(1, 256, 2, 64, generator=g)
    out = causal_attention(q, k, v, 0, 0.125)
    assert len(calls) == want_calls and out.shape == (1, t, 4, 64)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = fa.flash_attention.launches
    q, k, v = torch.ones(1, 128, 2, 64), torch.ones(1, 128, 2, 64), torch.ones(1, 128, 2, 64)
    torch.testing.assert_close(fa.flash_attention(q, k, v, 0, 0.125),
                               fa.flash_attention_reference(q, k, v, 0, 0.125))
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("case", ["dtype_mix", "f16", "grouping", "dk_mismatch", "batch",
                                  "rank", "offset", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = torch.zeros(1, 128, 4, 64), torch.zeros(1, 256, 2, 64), torch.zeros(1, 256, 2, 64)
    offset = 0
    if case == "dtype_mix":
        k = k.bfloat16()
    elif case == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "grouping":
        q = torch.zeros(1, 128, 3, 64)
    elif case == "dk_mismatch":
        k = torch.zeros(1, 256, 2, 128)
    elif case == "batch":
        k = torch.zeros(2, 256, 2, 64)
    elif case == "rank":
        q = q[0]
    elif case == "offset":
        offset = -1
    elif case == "meta_device":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, offset, 0.125)


def test_mla_compressed_head_dim_waits_for_deepseek_slice():
    q, k, v = torch.zeros(1, 128, 16, 576), torch.zeros(1, 128, 1, 576), torch.zeros(1, 128, 1, 512)
    with pytest.raises(ValueError, match="576.*DeepSeek"):
        fa.flash_attention(q, k, v, 0, 0.1)


@pytest.mark.parametrize("offset", [0, 256, 3840])
def test_smoke_bf16_limit_follows_the_output_scale(offset):
    """The limit that holds the kernel against its plain version on the card
    (chip_smoke.py) at the main path's bf16 shapes, with fewer heads: it
    takes probs rounded to bf16, as the kernel rounds P, and rejects a
    causal mask shifted by one position either way at every offset."""
    g = torch.Generator().manual_seed(offset)
    q = torch.randn(1, 256, 8, 128, generator=g).bfloat16()
    k = torch.randn(1, 4096, 2, 128, generator=g).bfloat16()
    v = torch.randn(1, 4096, 2, 128, generator=g).bfloat16()
    ref = fa.flash_attention_reference(q, k, v, offset, 128**-0.5)
    rounded = fa.flash_attention_reference(q, k, v, offset, 128**-0.5, probs_dtype=torch.bfloat16)
    _, worst, rel_l2 = kernel_disagreement(rounded, ref)
    assert worst <= 0.5 and rel_l2 <= REL_L2_TOL / 2
    for shifted in [s for s in (offset - 1, offset + 1) if s >= 0]:
        _, worst, _ = kernel_disagreement(
            fa.flash_attention_reference(q, k, v, shifted, 128**-0.5), ref)
        assert worst > 3


# ------------------------------------------------ the split walk of the bf16 kernel
SPLIT_T = (1, 100, 128, 256)
SPLIT_OFFSETS = (0, 17, 256, 3840)
SPLIT_S = (256, 4096)
SPLIT_GRID = [(t, off, s) for t in SPLIT_T for off in SPLIT_OFFSETS for s in SPLIT_S]


@pytest.mark.parametrize("t,offset,s", SPLIT_GRID)
def test_split_plan_covers_each_row_tile_once(t, offset, s):
    """At the main path's heads (Hq 32, Hkv 8) and the card's 132 SMs, for
    the planner's split and forced ones: every row tile's chunks tile
    [0, kv_end) exactly once, in order, none longer than the split; kv_end
    is one past the tile's last position (clipped to S); and every chunk the
    grid launches past a tile's causal end is one that returns at once."""
    groups = 4
    planned = fa.plan_split(1, t, s, 32, 8, offset, 132)
    assert planned % fa.SPLIT_ALIGN == 0 and (planned == 0 or planned >= fa.MIN_SPLIT)
    for split in sorted({planned, 0, 64, 256, 1024}):
        launched = fa.num_splits(t, s, offset, split)
        plan = fa.split_chunks(t, groups, s, offset, split)
        assert len(plan) == fa.row_tiles(t, groups) == -(-t * groups // fa.BLOCK_ROWS)
        for tile, chunks in enumerate(plan):
            last_pos = (min((tile + 1) * fa.BLOCK_ROWS, t * groups) - 1) // groups
            kv_end = min(s, offset + last_pos + 1)
            assert fa.tile_kv_end(t, groups, s, offset, tile) == kv_end
            assert chunks[0][0] == 0 and chunks[-1][1] == kv_end
            for (a, b), (c, _) in zip(chunks, chunks[1:]):
                assert b == c  # contiguous, no overlap, no gap
            assert all(0 < b - a <= (split or s) for a, b in chunks)
            # chunk c of the grid starts at c * split: the first len(chunks)
            # start below kv_end, every later one at or past it
            assert len(chunks) <= launched
            step = split or s
            assert all((c * step < kv_end) == (c < len(chunks)) for c in range(launched))


def test_planner_splits_only_long_walks_on_an_unfilled_card():
    """The main path's chunks (128 blocks on 132 SMs): the walk is split in
    two at offset 3840 only; a grid that fills two blocks per SM, or a walk
    whose chunks would fall under MIN_SPLIT, is never split."""
    assert [fa.plan_split(1, 256, 4096, 32, 8, off, 132) for off in (0, 256, 512, 1280, 3840)] == [
        0, 0, 0, 0, 2048]
    assert fa.plan_split(2, 256, 4096, 32, 8, 3840, 132) == 0  # 256 blocks fill the card
    assert fa.plan_split(1, 256, 4096, 16, 4, 3840, 132) == 1024  # 64 blocks: four chunks
    assert fa.plan_split(1, 256, 4096, 4, 1, 3840, 132) == 0  # 16 chunks would be too short
    assert fa.num_splits(256, 4096, 3840, 2048) == 2 and fa.num_splits(256, 4096, 3840, 0) == 1


@pytest.mark.parametrize("t,offset,s", SPLIT_GRID)
def test_split_and_merge_matches_reference_and_jax(t, offset, s):
    """The kernel's walk in plain PyTorch (packed GQA rows, chunks of 64 and
    1024 keys and the whole walk, log2 softmax, the merge) equals the plain
    version within 1e-5 in f32, and the JAX Pallas kernel in interpret mode
    within 2e-4 (the tolerance of the JAX kernel's own tests)."""
    rng = np.random.default_rng(t + offset + s)
    b, hq, hkv, d = 1, 4, 2, 64
    q = rng.normal(size=(b, t, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    scale = d**-0.5
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    ref = fa.flash_attention_reference(tq, tk, tv, offset, scale)
    want_jax = np.asarray(j_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offset), scale,
        block_k=64, interpret=True))
    for split in (0, 64, 1024):
        got = fa.flash_attention_split_reference(tq, tk, tv, offset, scale, split)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_jax, rtol=2e-4, atol=2e-4)
