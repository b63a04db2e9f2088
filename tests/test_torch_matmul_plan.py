"""The bf16 prefill matmul's plan and split walk over IN, on the CPU: the
planner's token tiles and splits at the Llama-3.1-8B layer shapes (every
split on group boundaries, none empty), and the walk written in plain
PyTorch (each split's fp32 partial, the partials added in split order)
against the plain version (1e-5 in f32: only the order of summation
differs) and against the JAX package's Pallas matmul in interpret mode,
whose sequential grid over IN blocks is the same partition (2e-4, as
tests/test_torch_quant.py holds that kernel; bit-equal on integer
operands)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import quant as jq
from mlx_sharding_tpu.ops.quant_matmul import quant_matmul_pallas
from mlx_sharding_tpu_torch.ops import quant as tq
from mlx_sharding_tpu_torch.ops import quant_matmul as tqm
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

# the four projections of a Llama-3.1-8B layer as the packed path runs them
# (QKV and gate+up fused): (OUT, IN)
LAYER_8B = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)]
H100_SMS = 132


@pytest.mark.parametrize("m", [9, 88, 256])
@pytest.mark.parametrize("out_dim,in_dim", LAYER_8B)
def test_planned_walk_covers_in_once_on_group_boundaries(m, out_dim, in_dim):
    tile, split = tqm.plan_matmul(m, out_dim, in_dim, H100_SMS)
    assert tile in tqm.TOKEN_TILES and m <= tile < m + tqm.TOKEN_TILES[0]
    assert split == 0 or (split % tqm.SPLIT_ALIGN == 0 and split < in_dim)
    ranges = tqm.split_ranges(in_dim, split)
    assert ranges[0][0] == 0 and ranges[-1][1] == in_dim
    assert all(k1 > k0 for k0, k1 in ranges)  # no empty split
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start
    for gs in tqm.GROUP_SIZES:
        assert all(k0 % gs == 0 and k1 % gs == 0 for k0, k1 in ranges)
    assert len(ranges) <= tqm.MAX_SPLITS


def test_planner_splits_the_layers_whose_tiles_leave_sms_idle():
    """On 132 SMs: QKV's 48 OUT tiles walk IN in two splits and o_proj's
    and down_proj's 32 in four, at every M (the token tile does not change
    the number of blocks); gate+up's 224 tiles fill the card and walk
    whole."""
    for m in (9, 88, 256):
        assert [tqm.plan_matmul(m, *shape, H100_SMS)[1] for shape in LAYER_8B] == [
            2048, 1024, 0, 3584]


@pytest.mark.parametrize("m,tile", [(9, 32), (32, 32), (33, 64), (88, 96), (200, 224),
                                    (256, 256), (257, 160), (300, 160), (600, 224),
                                    (1000, 256)])
def test_token_tiles_hold_the_tokens_in_as_few_tiles_as_fit(m, tile):
    assert tqm.plan_matmul(m, 4096, 4096, H100_SMS)[0] == tile
    tiles = -(-m // tile)
    assert tiles == -(-m // tqm.TOKEN_TILES[-1])


def _operands(rng, m, in_dim, out_dim, gs, bits, integer):
    """Random f32 operands, or integer-valued ones (random codes, scale 1,
    bias -2^(bits-1), x in [-4, 4)) whose every product and sum is exact."""
    if integer:
        q = rng.integers(0, 2**32, size=(out_dim, in_dim * bits // 32), dtype=np.uint32)
        s = np.ones((out_dim, in_dim // gs), np.float32)
        b = np.full((out_dim, in_dim // gs), -float(2 ** (bits - 1)), np.float32)
        x = rng.integers(-4, 4, size=(m, in_dim)).astype(np.float32)
    else:
        w = rng.normal(size=(out_dim, in_dim)) / np.sqrt(in_dim)
        q, s, b = jq.quantize(w.astype(np.float32), gs, bits)
        s, b = s.astype(np.float32), b.astype(np.float32)
        x = rng.normal(size=(m, in_dim)).astype(np.float32)
    return x, q, s, b


def _torch(x, q, s, b):
    return (torch.from_numpy(x), tq.words_to_torch(np.asarray(q)), torch.from_numpy(s),
            torch.from_numpy(b))


@pytest.mark.parametrize("split", [0, 128, 384, 1024])
@pytest.mark.parametrize("bits,gs", [(b, g) for b in (2, 4, 8) for g in (32, 64, 128)])
def test_split_walk_matches_the_plain_version(bits, gs, split):
    """Ragged M and OUT, IN 1152: random f32 within 1e-5 of the plain
    version; integer-valued operands bit-equal."""
    rng = np.random.default_rng(bits * gs + split)
    for integer in (False, True):
        args = _torch(*_operands(rng, 37, 1152, 77, gs, bits, integer))
        got = tqm.quant_matmul_split_reference(*args, gs, bits, split)
        want = tqm.quant_matmul_reference(*args, gs, bits)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_split_walk_of_a_group_of_32_may_end_inside_a_stage():
    """Splits of 96 (a multiple of the group size 32 but not of the
    kernel's 64-wide stage) cover IN 1152 in twelve."""
    rng = np.random.default_rng(96)
    args = _torch(*_operands(rng, 9, 1152, 130, 32, 4, integer=True))
    assert len(tqm.split_ranges(1152, 96)) == 12
    assert torch.equal(tqm.quant_matmul_split_reference(*args, 32, 4, 96),
                       tqm.quant_matmul_reference(*args, 32, 4))


def test_split_walk_rounds_the_weight_to_x_dtype():
    """bf16 x: the weight rounded to bf16 before the products, as the
    kernel's A fragments hold it; the result rounded once to bf16."""
    rng = np.random.default_rng(7)
    x, q, s, b = _torch(*_operands(rng, 20, 512, 64, 64, 4, integer=False))
    xb = x.bfloat16()
    got = tqm.quant_matmul_split_reference(xb, q, s.half(), b.half(), 64, 4, 256)
    w = tq.dequantize(q, s.half(), b.half(), 64, 4, torch.bfloat16).float()
    want = (xb.float()[:, :256] @ w[:, :256].T + xb.float()[:, 256:] @ w[:, 256:].T).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("m,out_dim,bits,gs,split", [
    (37, 77, 4, 64, 256), (9, 130, 2, 32, 512), (100, 64, 8, 128, 256), (20, 96, 4, 32, 1024),
    (88, 48, 2, 128, 128), (65, 40, 8, 32, 512),
])
def test_split_walk_matches_the_pallas_matmul(m, out_dim, bits, gs, split, integer):
    """The Pallas matmul with ``block_in`` = the split walks IN 1024 in the
    same blocks, adding each block's sum into its fp32 accumulator."""
    rng = np.random.default_rng(m + out_dim + bits + gs)
    x, q, s, b = _operands(rng, m, 1024, out_dim, gs, bits, integer)
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b),
                               group_size=gs, bits=bits, block_in=split, interpret=True)
    got = tqm.quant_matmul_split_reference(*_torch(x, q, s, b), gs, bits, split).numpy()
    if integer:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)

