"""The port's ``ops/moe.py`` and the routed-expert GEMV's plain version
against the JAX package's ``ops/moe.py`` on the same numpy inputs:
``mixtral_routing`` (exact router ties broken toward the lower expert, as
``jax.lax.top_k`` breaks them), ``apply_experts`` at N = 1, 16 and 17
tokens (both sides of the gather/scan switch) with dense and packed 4-bit
stacks, and ``quant_gemv_experts`` (its CPU branch, the plain version)
against JAX's gather-then-dequantize einsum for one projection. f32
tolerance 1e-5 (summation order); packed stacks dequantize exactly in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import moe as jmoe
from mlx_sharding_tpu.ops.quant import dequantize as j_dequantize
from mlx_sharding_tpu.ops.quant import quantize as j_quantize
from mlx_sharding_tpu_torch.ops import moe
from mlx_sharding_tpu_torch.ops import quant_matmul as qm
from mlx_sharding_tpu_torch.ops.quant import words_to_torch
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

H, I, E, K = 128, 192, 6, 2
TOL = 1e-5


def _router(rng, tie=False):
    w = rng.standard_normal((H, E)).astype(np.float32) * 0.3  # JAX (in, out)
    if tie:  # experts 1 and 4 get the same logit for every token
        w[:, 4] = w[:, 1]
    return w


def _stacks(rng, packed):
    """JAX's stacks, and the port's: dense (E, in, out) vs (E, out, in), or
    the same packed (E, out, ...) triples in both."""
    dims = {"gate": (H, I), "up": (H, I), "down": (I, H)}
    j, t = {}, {}
    for name, (n_in, n_out) in dims.items():
        w = rng.standard_normal((E, n_in, n_out)).astype(np.float32) * n_in ** -0.5
        if not packed:
            j[name], t[name] = jnp.asarray(w), torch.from_numpy(np.swapaxes(w, 1, 2).copy())
            continue
        trip = [j_quantize(w[e].T, 64, 4) for e in range(E)]
        q, s, b = (np.stack([x[i] for x in trip]) for i in range(3))
        j[name] = {"q": jnp.asarray(q), "scales": jnp.asarray(s), "biases": jnp.asarray(b)}
        t[name] = {"q": words_to_torch(q), "scales": torch.from_numpy(s),
                   "biases": torch.from_numpy(b)}
    return j, t


@pytest.mark.parametrize("n", [1, 16, 17])
@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
def test_routing_matches_jax(n, tie):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, H)).astype(np.float32)
    router = _router(rng, tie)
    jw, ji = jmoe.mixtral_routing(jnp.asarray(x), jnp.asarray(router), K)
    tw, ti = moe.mixtral_routing(torch.from_numpy(x), torch.from_numpy(router.T.copy()), K)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)


def test_exact_ties_go_to_the_lower_expert():
    """Equal probabilities keep their order: expert 1 before expert 4, as
    ``jax.lax.top_k`` orders them."""
    probs = torch.tensor([[0.1, 0.3, 0.05, 0.05, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25, 0, 0]])
    _, ids = moe.top_k_lower_first(probs, 2)
    _, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert ids.tolist() == np.asarray(jids).tolist() == [[1, 4], [0, 1]]


@pytest.mark.parametrize("n", [1, 16, 17])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_apply_experts_matches_jax(n, packed):
    """N <= 16 takes the gather path (packed: the routed GEMV's plain
    version), N = 17 the scan over experts (packed: the matmul's)."""
    rng = np.random.default_rng(10 + n)
    x = rng.standard_normal((n, H)).astype(np.float32)
    jw, ji = jmoe.mixtral_routing(jnp.asarray(x), jnp.asarray(_router(rng)), K)
    js, ts = _stacks(rng, packed)
    want = jmoe.apply_experts(jnp.asarray(x), jw, ji, js["gate"], js["up"], js["down"],
                              group_size=64, bits=4)
    got = moe.apply_experts(torch.from_numpy(x), torch.from_numpy(np.array(jw)),
                            torch.from_numpy(np.array(ji, np.int32)), ts["gate"], ts["up"],
                            ts["down"], 64, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("per_pair", [False, True], ids=["token-rows", "pair-rows"])
def test_quant_gemv_experts_plain_version_matches_jax(per_pair):
    """One projection of ``_apply_gather_packed``: the routed experts'
    packed leaves gathered, dequantized, contracted over IN; x rows per
    token (gate, up) or per (token, k) pair (down); every pair on one expert
    too. The CPU branch launches nothing."""
    rng = np.random.default_rng(3)
    _, ts = _stacks(rng, packed=True)
    w = ts["gate"]
    n = 5
    x = rng.standard_normal((n, K, H) if per_pair else (n, H)).astype(np.float32)
    for idx in (rng.integers(0, E, size=(n, K)), np.full((n, K), 3)):
        idx = idx.astype(np.int32)
        dense = j_dequantize(jnp.asarray(w["q"].numpy().view(np.uint32)[idx]),
                             jnp.asarray(w["scales"].numpy()[idx]),
                             jnp.asarray(w["biases"].numpy()[idx]), 64, 4, jnp.float32)
        spec = "nkh,nkih->nki" if per_pair else "nh,nkih->nki"
        want = np.asarray(jnp.einsum(spec, jnp.asarray(x), dense))
        before = qm.quant_gemv_experts.launches
        got = qm.quant_gemv_experts(torch.from_numpy(x), torch.from_numpy(idx), w["q"],
                                    w["scales"], w["biases"], 64, 4)
        assert qm.quant_gemv_experts.launches == before
        assert got.shape == (n, K, I)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad,match", [
    (dict(idx=torch.zeros(3, 2, dtype=torch.int64)), "int32"),
    (dict(idx=torch.zeros(4, 2, dtype=torch.int32)), "does not match"),
    (dict(x=torch.zeros(3, 2, 64)), "group_size|does not pack"),
])
def test_quant_gemv_experts_rejects_malformed_operands(bad, match):
    rng = np.random.default_rng(4)
    _, ts = _stacks(rng, packed=True)
    args = dict(x=torch.zeros(3, H), idx=torch.zeros(3, 2, dtype=torch.int32))
    args.update(bad)
    w = ts["up"]
    with pytest.raises(ValueError, match=match):
        qm.quant_gemv_experts(args["x"], args["idx"], w["q"], w["scales"], w["biases"], 64, 4)
