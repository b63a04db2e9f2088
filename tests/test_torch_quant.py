"""The port's quant ops against the JAX package's on the same numpy inputs:
``dequantize`` and both packers bit for bit, the kernels' plain version
against the Pallas TPU kernels (run in interpret mode), fusion, the packed
``linear`` dispatch and the wrappers' refusals. CPU tensors only: the
wrappers compute their plain version here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import quant as jq
from mlx_sharding_tpu.ops.quant_matmul import quant_gemv_pipelined, quant_matmul_pallas
from mlx_sharding_tpu_torch.ops import quant as tq
from mlx_sharding_tpu_torch.ops import quant_matmul as tqm
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

CONFIGS = [(bits, gs) for bits in (2, 4, 8) for gs in (32, 64, 128)]


def _words(q):
    return tq.words_to_torch(np.asarray(q))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,gs", CONFIGS)
def test_dequantize_matches_jax_bit_for_bit(bits, gs, dtype):
    """Leading layer dims (3, 2), fp16 scales and biases, every word value."""
    rng = np.random.default_rng(bits * gs)
    out_dim, in_dim = 48, 256
    q = rng.integers(0, 2**32, size=(3, 2, out_dim, in_dim * bits // 32), dtype=np.uint32)
    s = rng.normal(size=(3, 2, out_dim, in_dim // gs)).astype(np.float16)
    b = rng.normal(size=(3, 2, out_dim, in_dim // gs)).astype(np.float16)
    want = np.asarray(jq.dequantize(q, s, b, gs, bits, getattr(jnp, dtype)).astype(jnp.float32))
    got = tq.dequantize(_words(q), torch.from_numpy(s), torch.from_numpy(b), gs, bits,
                        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 2, out_dim, in_dim)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("bits,gs", CONFIGS)
def test_numpy_packer_matches_jax(bits, gs):
    w = np.random.default_rng(1).normal(size=(64, 256)).astype(np.float32)
    for got, want in zip(tq.quantize(w, gs, bits), jq.quantize(w, gs, bits)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,gs", CONFIGS)
def test_device_packer_matches_quantize_jax(bits, gs):
    """Words bit for bit (as the int32 view), the same f32 scales and
    biases, with a leading layer dim; and the words round-trip."""
    w = np.random.default_rng(2).normal(size=(2, 64, 256)).astype(np.float32)
    jw, js, jb = jq.quantize_jax(jnp.asarray(w), gs, bits)
    tw, ts, tb = tq.quantize_torch(torch.from_numpy(w), gs, bits)
    assert tw.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    deq = tq.dequantize(tw, ts, tb, gs, bits, torch.float32).numpy()
    assert np.abs(deq - w).max() <= ts.numpy().max() / 2 + 1e-6


def _operands(rng, m, in_dim, out_dim, gs, bits, integer):
    """Random f32 operands, or the bit-exact recipe of the JAX tests
    (tests/test_quant_memory_hierarchy.py): random codes, scale 1, bias
    -2^(bits-1), integer activations in [-4, 4), so every product and
    partial sum is exact in fp32 whatever the order of summation."""
    if integer:
        q = rng.integers(0, 2**32, size=(out_dim, in_dim * bits // 32), dtype=np.uint32)
        s = np.ones((out_dim, in_dim // gs), np.float32)
        b = np.full((out_dim, in_dim // gs), -float(2 ** (bits - 1)), np.float32)
        x = rng.integers(-4, 4, size=(m, in_dim)).astype(np.float32)
    else:
        q, s, b = jq.quantize(rng.normal(size=(out_dim, in_dim)).astype(np.float32), gs, bits)
        s, b = s.astype(np.float32), b.astype(np.float32)
        x = rng.normal(size=(m, in_dim)).astype(np.float32)
    return x, q, s, b


PALLAS_CASES = [
    # (TPU kernel, M, group size, bits); IN=512, OUT=256
    ("matmul", 16, 64, 4),
    ("matmul", 32, 32, 8),
    ("gemv", 1, 64, 4),
    ("gemv", 8, 128, 4),
    ("gemv", 4, 32, 8),
    # 2 bits: one 16-byte load of words holds two groups of 32
    ("matmul", 16, 32, 2),
    ("matmul", 12, 128, 2),
    ("gemv", 1, 32, 2),
    ("gemv", 8, 64, 2),
    ("gemv", 3, 128, 2),
]


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("kernel,m,gs,bits", PALLAS_CASES)
def test_plain_version_matches_the_pallas_kernels(kernel, m, gs, bits, integer):
    """rtol = atol = 2e-4 on random f32 (as tests/test_quant_matmul.py
    holds the Pallas kernel against dense); bit-equal on integer values."""
    rng = np.random.default_rng(m * gs + bits)
    x, q, s, b = _operands(rng, m, 512, 256, gs, bits, integer)
    args = (jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b))
    if kernel == "matmul":
        want = quant_matmul_pallas(*args, group_size=gs, bits=bits, interpret=True)
    else:
        want = quant_gemv_pipelined(*args, group_size=gs, bits=bits, interpret=True)
    wrapper = tqm.quant_matmul if kernel == "matmul" else tqm.quant_gemv
    got = wrapper(torch.from_numpy(x), _words(q), torch.from_numpy(s), torch.from_numpy(b),
                  gs, bits).numpy()
    if integer:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_plain_version_rounds_once_to_bf16():
    """bf16 x: the f32 product rounded once, equal to the f32 path's output
    rounded to bf16."""
    rng = np.random.default_rng(5)
    x, q, s, b = _operands(rng, 3, 256, 64, 64, 4, integer=False)
    args = (_words(q), torch.from_numpy(s).half(), torch.from_numpy(b).half())
    xb = torch.from_numpy(x).bfloat16()
    got = tqm.quant_gemv(xb, *args)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tqm.quant_gemv(xb.float(), *args).bfloat16())


def _packed(rng, out_dim, in_dim, gs=64, bits=4):
    q, s, b = jq.quantize(rng.normal(size=(out_dim, in_dim)).astype(np.float32), gs, bits)
    return q, s, b, {"q": _words(q), "scales": torch.from_numpy(s), "biases": torch.from_numpy(b)}


def test_fuse_packed_is_bit_exact_and_matches_jax():
    rng = np.random.default_rng(6)
    parts = [_packed(rng, out_dim, 128) for out_dim in (64, 32, 32)]
    fused = tq.fuse_packed([p[3] for p in parts])
    jfused = jq.fuse_packed([{"q": q, "scales": s, "biases": b} for q, s, b, _ in parts])
    for leaf in tq.PACKED_LEAVES:
        got = fused[leaf].numpy()
        np.testing.assert_array_equal(got.view(np.uint32) if leaf == "q" else got,
                                      np.asarray(jfused[leaf]))
    for m in (2, 12):  # the GEMV and the matmul dispatch
        x = torch.from_numpy(rng.normal(size=(m, 128)).astype(np.float32))
        separate = torch.cat([tq.linear(x, p[3]) for p in parts], dim=-1)
        assert torch.equal(tq.linear(x, fused), separate)
    with pytest.raises(ValueError, match="packed"):
        tq.fuse_packed([parts[0][3], torch.zeros(4, 4)])


@pytest.mark.parametrize("lead", [(2, 5), (1, 1), (3, 7)])
def test_linear_packed_matches_dense_and_jax(lead, monkeypatch):
    """Packed and dense weights give the same product (1e-5, f32), as JAX's
    ``linear`` does; M = prod(lead) <= 8 dispatches to the GEMV, else to
    the matmul."""
    rng = np.random.default_rng(7)
    q, s, b, packed = _packed(rng, 96, 128)
    dense = tq.dequantize(packed["q"], packed["scales"], packed["biases"], 64, 4, torch.float32)
    x = rng.normal(size=(*lead, 128)).astype(np.float32)
    calls = []
    for name in ("quant_gemv", "quant_matmul"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    got = tq.linear(torch.from_numpy(x), packed, 64, 4)
    assert calls == ["quant_gemv" if int(np.prod(lead)) <= tqm.GEMV_MAX_M else "quant_matmul"]
    assert got.shape == (*lead, 96)
    torch.testing.assert_close(got, torch.nn.functional.linear(torch.from_numpy(x), dense),
                               rtol=1e-5, atol=1e-5)
    jpacked = {"q": jnp.asarray(q), "scales": jnp.asarray(s, jnp.float32),
               "biases": jnp.asarray(b, jnp.float32)}
    want = np.asarray(jq.linear(jnp.asarray(x), jpacked, 64, 4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tq.is_quantized(packed) and not tq.is_quantized(dense)
    assert torch.equal(tq.linear(torch.from_numpy(x), dense), torch.nn.functional.linear(
        torch.from_numpy(x), dense))


def _args(m=2, in_dim=128, out_dim=32, gs=64, bits=4, device="cpu"):
    rng = np.random.default_rng(8)
    x, q, s, b = _operands(rng, m, in_dim, out_dim, gs, bits, integer=False)
    return [torch.from_numpy(x).to(device), _words(q).to(device),
            torch.from_numpy(s).to(device), torch.from_numpy(b).to(device)], gs, bits


@pytest.mark.parametrize("wrapper", ["quant_gemv", "quant_matmul"])
@pytest.mark.parametrize("fault", [
    "in_not_multiple_of_group", "bits", "group_size", "words", "scales", "x_dtype",
    "param_dtypes", "device",
])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper, fault):
    args, gs, bits = _args()
    fn = getattr(tqm, wrapper)
    if fault == "in_not_multiple_of_group":
        # IN = 96: a multiple of 32/bits but not of the group size
        args[0] = args[0][:, :96]
        args[1] = args[1][:, :12]
        args[2] = args[2][:, :1]
        args[3] = args[3][:, :1]
        match = "multiple of group_size"
    elif fault == "bits":
        bits, match = 3, "bits"
    elif fault == "group_size":
        gs, match = 16, "group sizes"
    elif fault == "words":
        args[1], match = args[1][:, :8], "does not pack"
    elif fault == "scales":
        args[2], match = args[2][:, :1], "scales and biases must be"
    elif fault == "x_dtype":
        args[0], match = args[0].double(), "x must be"
    elif fault == "param_dtypes":
        args[3], match = args[3].half(), "share one dtype"
    else:  # a device that is neither cpu nor cuda
        args, gs, bits = _args(device="meta")
        match = "runs on cuda or cpu"
    with pytest.raises(ValueError, match=match):
        fn(*args, gs, bits)


def test_gemv_refuses_more_than_eight_rows():
    args, gs, bits = _args(m=9)
    with pytest.raises(ValueError, match="M <= 8"):
        tqm.quant_gemv(*args, gs, bits)
    assert tqm.quant_matmul(*args, gs, bits).shape == (9, 32)


def test_cpu_calls_do_not_count_as_launches():
    args, gs, bits = _args()
    before = (tqm.quant_gemv.launches, tqm.quant_matmul.launches)
    tqm.quant_gemv(*args, gs, bits)
    tqm.quant_matmul(*args, gs, bits)
    assert (tqm.quant_gemv.launches, tqm.quant_matmul.launches) == before
