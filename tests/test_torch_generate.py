"""The port's Generator and stream_generate against the JAX ones on a tiny
Llama (2 layers, head_dim 64, 128-token prefill chunks) with the same
weights: greedy streams token-identical over a prompt that spans two chunks
with a padded tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.generate import stream_generate as j_stream_generate
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator, stream_generate
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

TINY = dict(
    vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, head_dim=64,
)
CHUNK = 128


@pytest.fixture(scope="module")
def pair():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    jg = JGenerator(jm, params, max_seq=512, cache_dtype=jnp.float32, prefill_chunk=CHUNK)
    tg = Generator(tm, max_seq=512, prefill_chunk=CHUNK)
    return jg, tg


def _prompt(n=200, seed=0):
    # 200 tokens = a full 128-token chunk + a 72-token tail padded to 128
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


def _tokens(gen, prompt, **kw):
    return [t for t, _ in gen.generate_step(prompt, **kw)]


def test_greedy_streams_identical(pair):
    jg, tg = pair
    want = _tokens(jg, _prompt(), max_tokens=48)
    got = _tokens(tg, _prompt(), max_tokens=48)
    assert len(got) == 48 and got == want


def test_greedy_with_penalty_and_bias_identical(pair):
    jg, tg = pair
    kw = dict(max_tokens=40, repetition_penalty=1.4, repetition_context_size=12,
              logit_bias={65: 3.0, 66: -2.0})
    assert _tokens(tg, _prompt(seed=1), **kw) == _tokens(jg, _prompt(seed=1), **kw)


def test_logprobs_match(pair):
    """Chosen and top-10 summaries, computed on the device in both."""
    jg, tg = pair
    want = [lp for _, lp in jg.generate_step(_prompt(), max_tokens=20, want_logprobs=True)]
    got = [lp for _, lp in tg.generate_step(_prompt(), max_tokens=20, want_logprobs=True)]
    assert len(got) == 20
    for w, g in zip(want, got):
        assert abs(w.chosen - g.chosen) < 1e-4
        np.testing.assert_array_equal(g.top_indices, w.top_indices)
        np.testing.assert_allclose(g.top_values, w.top_values, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("decode_block", [1, 5, 16])
def test_decode_block_size_does_not_change_the_stream(pair, decode_block, monkeypatch):
    jg, tg = pair
    monkeypatch.setattr(tg, "decode_block", decode_block)
    assert _tokens(tg, _prompt(), max_tokens=23) == _tokens(jg, _prompt(), max_tokens=23)


def test_prompt_of_exactly_one_chunk_and_a_single_token(pair):
    jg, tg = pair
    for prompt in (_prompt(CHUNK), [7]):
        assert _tokens(tg, prompt, max_tokens=9) == _tokens(jg, prompt, max_tokens=9)
    assert len(_tokens(tg, [7], max_tokens=1)) == 1


def test_seeded_sampling_reproducible(pair):
    _, tg = pair
    kw = dict(max_tokens=24, temperature=0.9, top_p=0.8)
    a = _tokens(tg, _prompt(), seed=11, **kw)
    assert a == _tokens(tg, _prompt(), seed=11, **kw)
    assert a != _tokens(tg, _prompt(), seed=12, **kw)


def test_capacity(pair):
    _, tg = pair
    assert Generator(tg.model, max_seq=300, prefill_chunk=CHUNK).max_seq == 384
    with pytest.raises(ValueError, match="exceeds KV"):
        _tokens(tg, _prompt(500), max_tokens=13)
    with pytest.raises(ValueError, match="empty prompt"):
        _tokens(tg, [], max_tokens=3)
    # a request that fills the cache exactly runs to its end
    assert len(_tokens(tg, _prompt(460), max_tokens=52)) == 52


@pytest.mark.parametrize("stop", [None, "e", "xyz"])
def test_stream_generate_matches_jax(pair, stop):
    """Detokenized text, finish reason and token count; stop sequences are
    trimmed and partial ones held back."""
    jg, tg = pair
    tok = ByteTokenizer()
    prompt = _prompt()
    stops = [tok.encode(stop)] if stop else None

    def run(fn, gen):
        chunks = list(fn(gen, tok, prompt, max_tokens=40, stop_id_sequences=stops))
        return "".join(c.text for c in chunks), chunks[-1]

    want_text, want_last = run(j_stream_generate, jg)
    got_text, got_last = run(stream_generate, tg)
    assert got_text == want_text
    assert got_last.finish_reason == want_last.finish_reason
    assert got_last.generation_tokens == want_last.generation_tokens
    assert got_last.prompt_tokens == 200 and got_last.ttft > 0
