"""Sequence parallelism in the port against the JAX package, on the CPU in
f32 (the cases of ``tests/test_sp_prefill.py``, ``test_sp_prefill_archs.py``
and ``test_sp_decode.py``): ``SpPrefill``'s logits and gathered cache
against the JAX model's dense prefill and JAX's ``SpPrefill``; the
Generator over ``sp_mesh`` (the prompt's prefill over the shards, decode
as usual) and with ``sp_decode`` (the cache split over the shards for the
whole request) token-identical to JAX's Generator on ``make_mesh(sp=...)``
with logprobs within ``LOGPROB_TOL``: long, unaligned and one-chunk
prompts, seeded sampling, decode past the prefill's padded rows; Gemma-2
(softcap and window), DeepSeek-V2 in both cache modes, Mixtral; and the
sharded cache's layout. The shards all sit on the CPU
(``device_grid(sp=N, device="cpu")``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.sp_prefill import SpPrefill as JSpPrefill
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel.mesh import device_grid
from mlx_sharding_tpu_torch.parallel.sp_prefill import SpPrefill, supports_sp_prefill
from tests.test_torch_families import jax_pair, port
from tests.test_torch_pipeline_archs import _pair, one_torch_thread  # noqa: F401
from tests.test_torch_tp import assert_streams_match

TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module")
def llama():
    return _pair(LlamaModel(LlamaConfig(**TINY)), 0)


# both packages' generators, built once per module for each (model, mesh,
# geometry): a generator serves request after request, and JAX compiles
# its programs once per generator
_GENERATORS: dict = {}


def _streams(jm, params, tm, prompt, sp=4, sp_decode=False, max_seq=64, chunk=8, **kw):
    key = (id(tm), sp, sp_decode, max_seq, chunk)
    if key not in _GENERATORS:
        _GENERATORS[key] = (
            JGenerator(jm, params, max_seq=max_seq, cache_dtype=jnp.float32,
                       prefill_chunk=chunk, sp_mesh=make_mesh(sp=sp), sp_decode=sp_decode),
            Generator(tm, max_seq=max_seq, prefill_chunk=chunk, decode_block=4,
                      sp_mesh=device_grid(sp=sp, device="cpu"), sp_decode=sp_decode))
    jg, g = _GENERATORS[key]
    want = list(jg.generate_step(prompt, want_logprobs=True, **kw))
    return list(g.generate_step(prompt, want_logprobs=True, **kw)), want, g


def test_sp_prefill_logits_and_cache_match_jax(llama):
    """A 32-token prompt over 4 shards: the logits and the gathered cache
    rows equal JAX's ``SpPrefill``'s on ``make_mesh(sp=4)``."""
    jm, params, tm = llama
    prompt = np.arange(1, 33, dtype=np.int32).reshape(1, 32)
    jsp = JSpPrefill(jm, params, make_mesh(sp=4), prefill_chunk=8)
    want_logits, jcache = jsp(prompt, jm.make_cache(1, 64, jnp.float32))
    cache = tm.make_cache(1, 64)
    logits = SpPrefill(tm, device_grid(sp=4, device="cpu"), prefill_chunk=8)(
        prompt.astype(np.int64), cache.k, cache.v)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=2e-5, atol=2e-5)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(got[:, :, :32].numpy(), np.asarray(want[:, :, :32]),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["long", "unaligned", "one_chunk", "sampled"])
@pytest.mark.parametrize("sp_decode", [False, True], ids=["gathered", "sp_decode"])
def test_llama_sp_streams_match_jax(llama, case, sp_decode):
    """Over 4 shards, gathered or sp-decoded: a 32-token prompt, a 29-token
    one (padded to 32), one within a chunk (the chunked path, or under
    sp_decode the shards all the same), and a seeded sampled stream."""
    jm, params, tm = llama
    prompt, kw = {"long": (list(range(1, 33)), {}), "unaligned": (list(range(1, 30)), {}),
                  "one_chunk": ([5, 9, 2], {}),
                  "sampled": (list(range(3, 30)), dict(temperature=0.8, top_p=0.9, seed=42))
                  }[case]
    got, want, _ = _streams(jm, params, tm, prompt, sp_decode=sp_decode, max_tokens=8, **kw)
    if case == "sampled":
        # the two packages draw from different generators: a seeded stream
        # over the shards equals the port's own stream without them (JAX's
        # test holds its sp stream to its Generator)
        plain = Generator(tm, max_seq=64, prefill_chunk=8)
        assert [t for t, _ in got] == [t for t, _ in plain.generate_step(prompt, max_tokens=8,
                                                                         **kw)]
    else:
        assert_streams_match(got, want)


def test_sp_decode_past_the_prefill_rows_and_cache_layout(llama):
    """sp_decode over 2 shards of 32 rows: a 20-token prompt decodes 30
    tokens, across the first shard's end into the second's rows; the
    cache stays split (each shard max_seq / sp rows) and the stream equals
    JAX's."""
    jm, params, tm = llama
    got, want, g = _streams(jm, params, tm, list(range(1, 21)), sp=2, sp_decode=True,
                            max_tokens=30)
    assert_streams_match(got, want)
    spd = g._sp_decode
    assert [tuple(k.shape) for k in spd.k] == [(4, 1, 32, 2, 8)] * 2
    assert spd.k[1][:, :, : 50 - 32 - 1].abs().sum() > 0  # rows written on the second shard


def test_sp_quantum_overflow_falls_back_to_chunked(llama):
    """A prompt whose padded length would pass the capacity prefills in
    chunks (JAX's fallback), still JAX's stream."""
    jm, params, tm = llama
    got, want, _ = _streams(jm, params, tm, list(range(1, 41)), sp=4, max_seq=48, chunk=16,
                            max_tokens=4)
    assert_streams_match(got, want)


@pytest.mark.parametrize("family,sp_decode", [
    ("gemma2", False), ("gemma2", True), ("deepseek_v2", True), ("deepseek_v2_full", False),
    ("mixtral", False)],
    ids=["gemma2", "gemma2_sp_decode", "deepseek_v2_sp_decode", "deepseek_v2_full",
         "mixtral"])
def test_family_sp_streams_match_jax(family, sp_decode):
    """Gemma-2 (the ring and the merge take its softcap and per-layer
    window), DeepSeek-V2 compressed (values from the latent keys: only the
    keys rotate) and full, and Mixtral, over 2 shards against JAX's."""
    overrides = {"mla_cache_mode": "full"} if family.endswith("_full") else {}
    cfg, jm, params = jax_pair(family.removesuffix("_full"), **overrides)
    tm = port(cfg, params)
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, 300, 40)]
    got, want, _ = _streams(jm, params, tm, prompt, sp=2, sp_decode=sp_decode, max_seq=128,
                            chunk=16, max_tokens=6)
    assert_streams_match(got, want)


def test_unsupported_arch_raises(llama):
    """A model without the sp hooks is refused up front, with JAX's
    message; sp_decode without a mesh too."""
    _, _, tm = llama
    assert supports_sp_prefill(tm)
    tm.supports_sp = False
    try:
        with pytest.raises(ValueError, match="does not support sequence-parallel prefill"):
            Generator(tm, max_seq=64, prefill_chunk=8, sp_mesh=device_grid(sp=2, device="cpu"))
    finally:
        del tm.supports_sp
    with pytest.raises(ValueError, match="sp_decode requires sp_mesh"):
        Generator(tm, max_seq=64, prefill_chunk=8, sp_decode=True)
