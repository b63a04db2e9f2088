"""The port's Mixtral (``models/mixtral.py``) against the JAX model on a tiny
config (2 layers, hidden 128, 4 experts, top 2), dense and with its
projections and expert stacks packed to MLX 4-bit (the router dense): the
whole forward at every position in f32 (a 150-token prefill takes the scan
over experts, T=1 steps the gather path) and bf16, prefill against decode,
greedy streams through both Generators and both paged batchers, both
loaders on tiny HF and MLX 4-bit checkpoints (per-expert tensors stacked),
and the CLI and the server on the CPU. Tolerances are the harness's
(``tests/test_torch_families.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from tests.test_torch_families import (
    BF16_REL_L2,
    F32_TOL,
    batcher_streams,
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

FAMILY = "mixtral"
PACKINGS = pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "packed"])
def pair(request):
    cfg, jm, params = jax_pair(FAMILY, packed=request.param, seed=2)
    return cfg, jm, params, port(cfg, params)


def test_logits_match_jax_f32_and_prefill_equals_decode(pair):
    """A 150-token forward (the scan over experts) at every position within
    ``F32_TOL`` of JAX's, and the same positions as a 128-token prefill then
    T=1 steps (one token each: the gather path)."""
    _, jm, params, tm = pair
    tokens = prompt(150, seed=1)
    want, got = logits_both(jm, params, tm, tokens)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(prefill_then_decode(tm, tokens, 128), got, rtol=F32_TOL,
                               atol=F32_TOL)


def test_generator_streams_match_jax(pair):
    _, jm, params, tm = pair
    want, got = generator_streams(jm, params, tm)
    assert got == want


def test_batcher_streams_match_jax(pair):
    """Three slots a step: the gather path at N = 3."""
    _, jm, params, tm = pair
    want, got = batcher_streams(jm, params, tm)
    assert got == want


@PACKINGS
def test_bf16_logits_within_tolerance(packed):
    cfg, jm, params = jax_pair(FAMILY, dtype=jnp.bfloat16, packed=packed, seed=3)
    want, got = logits_both(jm, params, port(cfg, params), prompt(20, seed=4))
    assert rel_l2(got, want) <= BF16_REL_L2


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixtral")
    return {q: tokenizer_checkpoint(root / ("mlx4" if q else "hf"), FAMILY, quantized=q)
            for q in (False, True)}


@pytest.mark.parametrize("quantized,keep", [(False, False), (True, False), (True, True)],
                         ids=["hf", "mlx4-dequantized", "mlx4-packed"])
def test_both_loaders_agree(ckpts, quantized, keep):
    """Per-expert w1/w3/w2 stacked to (E, ...) by both loaders; a packed
    load keeps the stacks packed and the router dense."""
    tm = loads_match(ckpts[quantized], keep)
    layer = tm.layers[0]
    assert isinstance(layer.w_gate, QuantizedLinear) == keep
    assert not isinstance(layer.router, QuantizedLinear)
    stack = layer.w_down.q if keep else layer.w_down.weight
    assert stack.shape[0] == 4


@pytest.mark.parametrize("quantized", [False, True], ids=["hf", "mlx4-packed"])
def test_cli_and_server_on_cpu(ckpts, quantized, monkeypatch, capsys):
    serve_cli_and_server(ckpts[quantized], monkeypatch, capsys,
                         ["--keep-quantized"] if quantized else [])


def test_packed_decode_reads_only_the_routed_experts(monkeypatch):
    """A T=1 step of the packed model sends its experts to the routed GEMV
    (three calls a layer, on the ids the router chose), a 128-token prefill
    to the scan (no routed call)."""
    from mlx_sharding_tpu_torch.ops import moe

    cfg, _, params = jax_pair(FAMILY, packed=True, seed=2)
    tm = port(cfg, params)

    calls = []
    real = moe.quant_gemv_experts
    monkeypatch.setattr(moe, "quant_gemv_experts",
                        lambda x, idx, *a: calls.append(tuple(idx.shape)) or real(x, idx, *a))
    cache = tm.make_cache(1, 256)
    _, cache = tm(torch.from_numpy(prompt(128)), cache)
    assert calls == []
    tm(torch.tensor([[5]]), cache)
    assert calls == [(1, 2)] * 3 * len(tm.layers)
