"""The port's norms, RoPE and plain causal attention against the JAX ops,
on the same numpy inputs (JAX on the CPU, highest matmul precision)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import apply_rope as j_apply_rope
from mlx_sharding_tpu.ops import causal_attention as j_causal_attention
from mlx_sharding_tpu.ops import rms_norm as j_rms_norm
from mlx_sharding_tpu.ops import rope_frequencies as j_rope_frequencies
from mlx_sharding_tpu_torch.convert import to_torch
from mlx_sharding_tpu_torch.ops import apply_rope, causal_attention, rms_norm, rope_frequencies

LLAMA3 = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}
SCALINGS = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    "linear_legacy_key": {"type": "linear", "factor": 2.0},
    "llama3": LLAMA3,
}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_f32(offset):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset=offset)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset=offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rms_norm_bf16():
    """bf16 in, fp32 inside, bf16 out: the two may round the same fp32 value
    one bf16 step apart (2**-8 relative)."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 7, 128)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(128,)), jnp.bfloat16)
    want = np.asarray(j_rms_norm(x, w, 1e-5).astype(jnp.float32))
    got = rms_norm(to_torch(np.asarray(x)), to_torch(np.asarray(w)), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("scaling", SCALINGS, ids=list(SCALINGS))
@pytest.mark.parametrize("head_dim,theta", [(64, 10000.0), (128, 500000.0)])
def test_rope_frequencies_equal_jax(scaling, head_dim, theta):
    want = j_rope_frequencies(head_dim, theta, SCALINGS[scaling])
    got = rope_frequencies(head_dim, theta, SCALINGS[scaling])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rope_rejects_unknown_type():
    with pytest.raises(ValueError, match="Unsupported rope_scaling"):
        rope_frequencies(64, 10000.0, {"rope_type": "yarn", "factor": 4.0})


@pytest.mark.parametrize("scaling", ["default", "linear", "llama3"])
@pytest.mark.parametrize("offset", [0, 5, 3000])
def test_apply_rope_matches_jax(scaling, offset):
    """fp32 trig on both sides; positions offset + arange(T)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    inv = rope_frequencies(64, 500000.0, SCALINGS[scaling])
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(inv), jnp.asarray(offset))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(inv), offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_apply_rope_keeps_bf16():
    x = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = apply_rope(x, torch.from_numpy(rope_frequencies(64)), 9)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape


ATTN_CASES = [
    # b, t, s, hq, hkv, dk, dv, offset
    (1, 1, 64, 4, 2, 32, 32, 10),  # T=1 decode mid-buffer
    (2, 5, 32, 4, 4, 16, 16, 3),  # MHA continuation
    (1, 8, 64, 8, 2, 64, 32, 20),  # GQA, dk != dv
    (1, 12, 16, 2, 1, 16, 16, 4),  # offset + T exactly at capacity
]


@pytest.mark.parametrize("b,t,s,hq,hkv,dk,dv,offset", ATTN_CASES)
def test_plain_causal_attention_matches_jax(b, t, s, hq, hkv, dk, dv, offset):
    """The grouped-GQA path (none of these shapes is flash-eligible)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, t, hq, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    scale = dk**-0.5
    want = j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(offset), scale)
    got = causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           offset, scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softcap,window", [(50.0, None), (None, 6), (30.0, 4)])
def test_plain_attention_softcap_and_window_match_jax(softcap, window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 8, 4, 32)).astype(np.float32) * 4
    k = rng.normal(size=(1, 32, 2, 32)).astype(np.float32) * 4
    v = rng.normal(size=(1, 32, 2, 32)).astype(np.float32)
    want = j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(9),
                              0.2, logit_softcap=softcap, sliding_window=window)
    got = causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 9,
                           0.2, logit_softcap=softcap, sliding_window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_attention_bf16_matches_jax():
    """bf16 operands, fp32 scores and softmax, probs cast to bf16, fp32
    accumulation, bf16 out on both sides: one bf16 step (2**-8) apart."""
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.normal(size=(1, 4, 8, 64)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(1, 64, 2, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(1, 64, 2, 64)), jnp.bfloat16)
    want = np.asarray(j_causal_attention(q, k, v, jnp.asarray(30), 0.125).astype(jnp.float32))
    got = causal_attention(*(to_torch(np.asarray(a)) for a in (q, k, v)), 30, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=2**-7, atol=2**-7)
