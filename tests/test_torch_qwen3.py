"""The port's Qwen3 (``models/qwen3.py``) against the JAX model on a tiny
config (2 layers, hidden 128, Hq 4 / Hkv 2, head_dim 64), the JAX weights
carried across by ``convert.params_from_numpy``: one layer's halves, the
whole forward at every position in f32 and bf16, prefill against decode,
greedy streams through both Generators and both paged batchers, both
loaders on tiny HF and MLX 4-bit checkpoints, and the CLI and the server on
the CPU. Tolerances are the harness's (``tests/test_torch_families.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

FAMILY = "qwen3"


@pytest.fixture(scope="module")
def pair():
    cfg, jm, params = jax_pair(FAMILY)
    return cfg, jm, params, port(cfg, params)


def test_layer_halves_match_jax(pair):
    """Layer 0's attention inputs (per-head q/k norms before RoPE) and its
    finish, on the same hidden states, within ``F32_TOL``."""
    _, jm, params, tm = pair
    h = np.random.default_rng(1).standard_normal((1, 5, 128)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    jq, jk, jv = jm.layer_attn_inputs(p0, jnp.asarray(h), 3)
    tq, tk, tv = tm.layer_attn_inputs(tm.layers[0], torch.from_numpy(h), 3)
    for want, got in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL, atol=F32_TOL)
    attn = np.random.default_rng(2).standard_normal((1, 5, 4, 64)).astype(np.float32)
    want = jm.layer_finish(p0, jnp.asarray(h), jnp.asarray(attn))
    got = tm.layer_finish(tm.layers[0], torch.from_numpy(h), torch.from_numpy(attn))
    np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL, atol=F32_TOL)


def test_logits_match_jax_f32_and_prefill_equals_decode(pair):
    """Every position of a 150-token forward within ``F32_TOL`` of JAX's,
    and the same positions as a 128-token prefill (the flash route) then
    T=1 steps (the T=1 route)."""
    _, jm, params, tm = pair
    tokens = prompt(150)
    want, got = logits_both(jm, params, tm, tokens)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(prefill_then_decode(tm, tokens, 128), got, rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_logits_within_tolerance():
    cfg, jm, params = jax_pair(FAMILY, dtype=jnp.bfloat16)
    want, got = logits_both(jm, params, port(cfg, params), prompt(40))
    assert rel_l2(got, want) <= BF16_REL_L2


def test_generator_streams_match_jax(pair):
    """32 greedy tokens, token-identical, through both Generators (f32)."""
    _, jm, params, tm = pair
    want, got = generator_streams(jm, params, tm)
    assert got == want


def test_batcher_streams_match_jax(pair):
    _, jm, params, tm = pair
    want, got = batcher_streams(jm, params, tm)
    assert got == want


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("qwen3")
    return {q: tokenizer_checkpoint(root / ("mlx4" if q else "hf"), FAMILY, quantized=q)
            for q in (False, True)}


@pytest.mark.parametrize("quantized,keep", [(False, False), (True, False), (True, True)],
                         ids=["hf", "mlx4-dequantized", "mlx4-packed"])
def test_both_loaders_agree(ckpts, quantized, keep):
    tm = loads_match(ckpts[quantized], keep)
    assert hasattr(tm.layers[0], "q_norm")
    assert isinstance(tm.layers[0].q_proj, torch.nn.Linear) != keep


@pytest.mark.parametrize("quantized", [False, True], ids=["hf", "mlx4-packed"])
def test_cli_and_server_on_cpu(ckpts, quantized, monkeypatch, capsys):
    serve_cli_and_server(ckpts[quantized], monkeypatch, capsys,
                         ["--keep-quantized"] if quantized else [])
