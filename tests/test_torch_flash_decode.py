"""The T=1 route of the flash kernel (``ops/flash_attention.py::flash_decode``:
the paged kernel over the dense cache seen as pages) against the JAX
package, on the CPU:

- the dispatch rule ``flash_eligible`` against JAX's ``_flash_eligible``
  with the backend patched to "tpu" (as ``tests/test_flash_attention.py``
  does), over T, S, head dims and both switches, ``MST_FLASH`` and
  ``MST_FLASH_DECODE``;
- the route's plain version against the JAX Pallas kernel at T = 1 in
  interpret mode, at positions 0, 63, 64, 255 and S - 1 with B = 2: f32
  within 1e-5, bf16 within ``chip_smoke.kernel_disagreement``'s limits;
- ``causal_attention`` sends a T=1 step with a device position to the
  route only when it is switched on, and both routes agree;
- the dense Generator's greedy stream is the same on both routes;
- the wrapper's refusals, and no launch counted on the CPU.

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` (phase 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import REL_L2_TOL, kernel_disagreement
from mlx_sharding_tpu.ops.attention import _flash_eligible as j_flash_eligible
from mlx_sharding_tpu.ops.flash_attention import flash_attention as j_flash_attention
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops import attention as attention_mod
from mlx_sharding_tpu_torch.ops import causal_attention
from mlx_sharding_tpu_torch.ops import flash_attention as fa
from mlx_sharding_tpu_torch.ops.attention import FLASH_DECODE_DEFAULT, flash_eligible
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

S = 512
POSITIONS = [0, 63, 64, 255, S - 1]


def _pos(p):
    return torch.tensor([p], dtype=torch.int64)


@pytest.mark.parametrize("flash", [None, "0", "1"], ids=["flash_unset", "flash0", "flash1"])
@pytest.mark.parametrize("decode", ["0", "1"])
def test_dispatch_rule_matches_jax(monkeypatch, flash, decode):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if flash is None:
        monkeypatch.delenv("MST_FLASH", raising=False)
    else:
        monkeypatch.setenv("MST_FLASH", flash)
    monkeypatch.setenv("MST_FLASH_DECODE", decode)
    cases = [(t, s, dk, dv) for t in (1, 2, 64, 128, 256) for s in (128, 200, 256, 4096)
             for dk, dv in ((64, 64), (128, 128), (192, 128), (256, 256), (32, 32), (96, 64))]
    for t, s, dk, dv in cases:
        q, k, v = np.zeros((1, t, 4, dk)), np.zeros((1, s, 2, dk)), np.zeros((1, s, 2, dv))
        want = j_flash_eligible(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None)
        got = flash_eligible(*(torch.from_numpy(x) for x in (q, k, v)))
        assert got == want, (t, s, dk, dv)
        # the options do not enter the rule: the kernels compute them
        for extra in (dict(logit_softcap=30.0), dict(sliding_window=64)):
            assert flash_eligible(*(torch.from_numpy(x) for x in (q, k, v)), **extra) == want


def test_default_switch_is_the_measured_one(monkeypatch):
    """Unset, ``MST_FLASH_DECODE`` takes the port's default (JAX's is off);
    ``MST_FLASH=0`` turns the route off with the prefill kernel."""
    monkeypatch.delenv("MST_FLASH_DECODE", raising=False)
    monkeypatch.delenv("MST_FLASH", raising=False)
    q, k = torch.zeros(1, 1, 4, 64), torch.zeros(1, 256, 2, 64)
    assert flash_eligible(q, k, k) == (FLASH_DECODE_DEFAULT == "1")
    monkeypatch.setenv("MST_FLASH", "0")
    assert not flash_eligible(q, k, k)
    assert not attention_mod.flash_decode_on()


def _case(b, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, S, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("position", POSITIONS)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 64), (4, 4, 128), (16, 1, 64)])
def test_plain_version_matches_the_jax_kernel(position, hq, hkv, d):
    """f32, B = 2: within 1e-5 of the Pallas kernel in interpret mode."""
    q, k, v = _case(2, hq, hkv, d, position + hq)
    scale = d ** -0.5
    want = np.asarray(j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(position), scale, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lengths = fa.decode_lengths(_pos(position), 2, S)
    assert lengths.tolist() == [position + 1] * 2 and lengths.dtype == torch.int32
    got = fa.flash_decode_reference(tq, tk, tv, lengths, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    torch.testing.assert_close(fa.flash_decode(tq, tk, tv, _pos(position), scale), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("position", POSITIONS)
def test_bf16_plain_version_within_the_smoke_limits(position):
    """bf16 operands, B = 2: the plain version (probs rounded to bf16) and
    the JAX kernel in interpret mode (fp32 probs) within the limits the
    smoke holds the CUDA kernel to."""
    q, k, v = _case(2, 8, 2, 128, 7 + position)
    scale = 128 ** -0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_flash_attention(jq, jk, jv, jnp.asarray(position), scale,
                                        interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_decode(tq, tk, tv, _pos(position), scale)
    assert got.dtype == torch.bfloat16
    _, worst, rel_l2 = kernel_disagreement(got, torch.tensor(want).to(torch.bfloat16))
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("route", ["1", "0"])
def test_causal_attention_takes_the_route_only_when_on(monkeypatch, route):
    monkeypatch.setenv("MST_FLASH_DECODE", route)
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("lengths"))
        return fa.flash_decode(*args, **kw)

    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    q, k, v = (torch.from_numpy(x) for x in _case(1, 8, 2, 64, 3))
    lengths = fa.decode_lengths(_pos(100), 1, S)
    got = causal_attention(q, k, v, 100, 0.125, position=_pos(100), lengths=lengths)
    plain = attention_mod.masked_attention(q, k, v, _pos(100), 0.125)
    assert len(calls) == (1 if route == "1" else 0)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    # a host offset alone takes the route too, at that position
    host = causal_attention(q, k, v, 100, 0.125)
    assert len(calls) == (2 if route == "1" else 0)
    torch.testing.assert_close(host, plain, rtol=1e-5, atol=1e-5)


def test_dense_stream_is_the_same_on_both_routes(monkeypatch):
    """A tiny f32 Llama's greedy stream through ``Generator`` on the CPU,
    with the route on and off."""
    cfg = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=64)
    model, _ = build_model(cfg, dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(2), "cpu")
    prompt = np.random.default_rng(8).integers(0, 320, size=40).tolist()
    streams = {}
    for route in ("1", "0"):
        monkeypatch.setenv("MST_FLASH_DECODE", route)
        gen = Generator(model, max_seq=S, prefill_chunk=128)
        streams[route] = [t for t, _ in gen.generate_step(prompt, max_tokens=20)]
    assert streams["1"] == streams["0"] and len(streams["1"]) == 20


@pytest.mark.parametrize("case", ["t2", "capacity", "strided", "meta"])
def test_wrapper_refusals(case):
    q, k, v = torch.zeros(1, 1, 4, 64), torch.zeros(1, 256, 2, 64), torch.zeros(1, 256, 2, 64)
    pos = _pos(3)
    if case == "t2":
        q = torch.zeros(1, 2, 4, 64)
        match = "one query position"
    elif case == "capacity":
        k, v = torch.zeros(1, 192, 2, 64), torch.zeros(1, 192, 2, 64)
        match = "pages of 128"
    elif case == "strided":
        k = torch.zeros(1, 256, 4, 64)[:, :, ::2]
        match = "must be contiguous"
    else:
        q, k, v, pos = (x.to("meta") for x in (q, k, v, pos))
        match = "cuda or cpu"
    with pytest.raises(ValueError, match=match):
        fa.flash_decode(q, k, v, pos, 0.125)


def test_cpu_calls_count_no_launch():
    before = fa.flash_decode.launches
    q, k, v = (torch.from_numpy(x) for x in _case(1, 8, 2, 64, 1))
    fa.flash_decode(q, k, v, _pos(9), 0.125)
    assert fa.flash_decode.launches == before
