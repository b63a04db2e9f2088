"""The bf16 decode GEMV's split walk over IN, on the CPU: the planner's
splits cover IN exactly once on group boundaries, and the walk written in
plain PyTorch (per-group sums with the bias folded, fp32 partials added in
split order) agrees with the plain version (1e-5, f32) and with the JAX
package's Pallas GEMV in interpret mode (2e-4, as tests/test_quant_matmul.py
holds that kernel against dense)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import quant as jq
from mlx_sharding_tpu.ops.quant_matmul import quant_gemv_pipelined
from mlx_sharding_tpu_torch.ops import quant as tq
from mlx_sharding_tpu_torch.ops import quant_matmul as tqm

# the packed path's Llama-3.1-8B shapes (OUT, IN), and ragged ones
LLAMA_8B = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336), (128256, 4096)]
RAGGED = [(77, 96), (130, 8320), (200, 512), (64, 1152), (1, 128), (4096, 1024), (896, 4864)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("out_dim,in_dim", LLAMA_8B + RAGGED)
def test_planned_splits_cover_in_once_on_group_boundaries(out_dim, in_dim, sms):
    split = tqm.plan_gemv(out_dim, in_dim, sms)
    assert split == 0 or (split % tqm.SPLIT_ALIGN == 0 and tqm.MIN_SPLIT <= split < in_dim)
    ranges = tqm.split_ranges(in_dim, split)
    assert ranges[0][0] == 0 and ranges[-1][1] == in_dim
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start
    for gs in tqm.GROUP_SIZES:
        if in_dim % gs == 0:
            assert all(k0 % gs == 0 and k1 % gs == 0 for k0, k1 in ranges)
    blocks = -(-out_dim // tqm.GEMV_ROWS) * len(ranges)
    if split:  # a split walk gives each SM at most one block
        assert blocks <= sms


def test_planner_splits_only_the_layers_whose_rows_leave_sms_idle():
    """On 132 SMs every Llama-3.1-8B shape has a row block for each SM and
    walks whole; the down_proj of Llama-3.2-1B and Qwen2-1.5B (2048 and 1536
    rows) splits IN in two, their o_proj (IN 2048, 1536) is too short to, and
    on 16 SMs nothing splits."""
    assert all(tqm.plan_gemv(*shape, 132) == 0 for shape in LLAMA_8B)
    assert tqm.plan_gemv(2048, 8192, 132) == 4096
    assert tqm.plan_gemv(1536, 8960, 132) == 4480
    assert tqm.plan_gemv(2048, 2048, 132) == 0
    assert tqm.plan_gemv(1536, 1536, 132) == 0
    assert all(tqm.plan_gemv(*shape, 16) == 0 for shape in LLAMA_8B)


def _operands(rng, m, in_dim, out_dim, gs, bits, integer):
    if integer:
        q = rng.integers(0, 2**32, size=(out_dim, in_dim * bits // 32), dtype=np.uint32)
        s = np.ones((out_dim, in_dim // gs), np.float32)
        b = np.full((out_dim, in_dim // gs), -float(2 ** (bits - 1)), np.float32)
        x = rng.integers(-4, 4, size=(m, in_dim)).astype(np.float32)
    else:
        # weights of N(0, 1/IN), so that outputs are of order one
        w = rng.normal(size=(out_dim, in_dim)) / np.sqrt(in_dim)
        q, s, b = jq.quantize(w.astype(np.float32), gs, bits)
        s, b = s.astype(np.float32), b.astype(np.float32)
        x = rng.normal(size=(m, in_dim)).astype(np.float32)
    return x, q, s, b


@pytest.mark.parametrize("split", [0, 128, 384, 1024])
@pytest.mark.parametrize("bits,gs", [(b, g) for b in (2, 4, 8) for g in (32, 64, 128)])
def test_split_walk_matches_the_plain_version(bits, gs, split):
    """Random f32 within 1e-5 of the plain version; integer-valued operands
    (every sum exact) bit-equal."""
    rng = np.random.default_rng(bits * gs + split)
    for integer in (False, True):
        x, q, s, b = (torch.from_numpy(np.asarray(a)) if i != 1 else tq.words_to_torch(a)
                      for i, a in enumerate(_operands(rng, 5, 1152, 70, gs, bits, integer)))
        got = tqm.quant_gemv_split_reference(x, q, s, b, gs, bits, split)
        want = tqm.quant_matmul_reference(x, q, s, b, gs, bits)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,bits,gs,split", [
    (1, 4, 64, 1024), (8, 4, 64, 256), (3, 2, 32, 128), (8, 2, 128, 384), (4, 8, 32, 512),
    (2, 8, 128, 0),
])
def test_split_walk_matches_the_pallas_gemv(m, bits, gs, split):
    rng = np.random.default_rng(m + bits + gs)
    x, q, s, b = _operands(rng, m, 2048, 256, gs, bits, integer=False)
    want = quant_gemv_pipelined(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b),
                                group_size=gs, bits=bits, interpret=True)
    got = tqm.quant_gemv_split_reference(torch.from_numpy(x), tq.words_to_torch(q),
                                         torch.from_numpy(s), torch.from_numpy(b), gs, bits, split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
