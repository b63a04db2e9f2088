"""The port's sampler against ``mlx_sharding_tpu/sample.py``: the logit
bias, repetition-penalty window and top-p masks equal JAX's exactly, greedy
picks are equal, and seeded draws are reproducible within the port (the two
packages' random streams differ, so draws match JAX only in distribution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import sample as jsample
from mlx_sharding_tpu_torch import sample as tsample

BIAS = {3: 2.5, 7: -1.0, 41: 100.0}


def _logits(b=3, v=64, seed=0, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(b, v)) * scale).astype(np.float32)


def _params(**kw):
    return (jsample.make_sampler_params(**kw),
            tsample.make_sampler_params(**kw, device="cpu"))


def _recent(prompt, window=6):
    prompt = np.asarray(prompt)
    return (jsample.init_recent_tokens(prompt.shape[0], window, prompt),
            tsample.init_recent_tokens(prompt.shape[0], window, prompt, device="cpu"))


def test_logit_bias_equal():
    lo = _logits()
    jp, tp = _params(logit_bias=BIAS)
    want = jsample.apply_logit_bias(jnp.asarray(lo), jp.bias_indices, jp.bias_values)
    got = tsample.apply_logit_bias(torch.from_numpy(lo), tp.bias_indices, tp.bias_values)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_no_bias_is_identity():
    lo = torch.from_numpy(_logits())
    tp = tsample.make_sampler_params(device="cpu")
    assert tp.bias_indices is None
    assert tsample.apply_logit_bias(lo, tp.bias_indices, tp.bias_values) is lo


@pytest.mark.parametrize("prompt", [[[5, 9, 9, 1]], [[1, 2, 3, 4, 5, 6, 7, 8, 9]],
                                    [[0, 63, 2], [4, 4, 4]]])
def test_recent_window_equal(prompt):
    jr, tr = _recent(prompt)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    tok = np.arange(len(prompt), dtype=np.int32) + 11
    jr = jsample.update_recent_tokens(jr, jnp.asarray(tok))
    tr = tsample.update_recent_tokens(tr, torch.from_numpy(tok.astype(np.int64)))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("penalty", [1.3, 0.7])
def test_repetition_penalty_equal(penalty):
    """Empty (-1) slots and repeated tokens included."""
    lo = _logits(b=2)
    jr, tr = _recent([[5, 9, 9, 1], [2, 2, 60, 0]], window=6)
    want = jsample.apply_repetition_penalty(jnp.asarray(lo), jr, jnp.float32(penalty))
    got = tsample.apply_repetition_penalty(torch.from_numpy(lo), tr, penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_p", [0.05, 0.3, 0.6, 0.9, 0.99, 1.0])
def test_top_p_mask_equal(top_p):
    lo = _logits(b=4, v=256, seed=1)
    want = np.asarray(jsample.top_p_filter(jnp.asarray(lo), jnp.float32(top_p)))
    got = tsample.top_p_filter(torch.from_numpy(lo), top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.8), (1.3, 0.5), (1.0, 1.0)])
def test_transform_and_nucleus_equal(temperature, top_p):
    """bias -> penalty -> temperature -> top-p, the sampled branch's full
    distribution."""
    lo = _logits(b=2, v=128, seed=2)
    kw = dict(temperature=temperature, top_p=top_p, repetition_penalty=1.2, logit_bias=BIAS)
    jp, tp = _params(**kw)
    jr, tr = _recent([[5, 9, 9, 1], [2, 2, 60, 0]])
    want = jsample.nucleus_logits(jsample.transform_logits(jnp.asarray(lo), jr, jp), jp)
    got = tsample.nucleus_logits(tsample.transform_logits(torch.from_numpy(lo), tr, tp), tp)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_greedy_equal():
    lo = _logits(b=5, v=300, seed=3)
    jp, tp = _params(repetition_penalty=1.5, logit_bias={7: 0.5})
    jr, tr = _recent([[1, 2, 3]] * 5)
    jt, jlp = jsample.sample_token(jax.random.PRNGKey(0), jnp.asarray(lo), jp, jr)
    tt, tlp = tsample.sample_token(torch.Generator().manual_seed(0), torch.from_numpy(lo), tp, tr)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)


def test_seeded_draws_reproducible_and_inside_the_nucleus():
    lo = torch.from_numpy(_logits(b=8, v=300, seed=4))
    tp = tsample.make_sampler_params(temperature=0.9, top_p=0.5, device="cpu")

    def draw(seed):
        return tsample.sample_token(torch.Generator().manual_seed(seed), lo, tp)[0]

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    allowed = torch.isfinite(tsample.nucleus_logits(lo, tp))
    assert bool(allowed.gather(1, a[:, None]).all())


def test_draws_follow_the_jax_distribution():
    """8000 draws from one row: empirical frequencies against the softmax of
    the JAX nucleus logits (binomial sd <= 0.006; tolerance 0.03)."""
    row = _logits(b=1, v=12, seed=5, scale=1.0)
    jp, tp = _params(temperature=0.8, top_p=0.9, logit_bias={2: 1.0})
    want = np.asarray(jax.nn.softmax(jsample.nucleus_logits(
        jsample.transform_logits(jnp.asarray(row), None, jp), jp), axis=-1))[0]
    lo = torch.from_numpy(np.repeat(row, 8000, axis=0))
    tok, _ = tsample.sample_token(torch.Generator().manual_seed(0), lo, tp)
    freq = np.bincount(tok.numpy(), minlength=12) / 8000
    np.testing.assert_allclose(freq, want, atol=0.03)
    assert freq[want == 0].sum() == 0
