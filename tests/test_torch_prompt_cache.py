"""The port's single-stream prompt cache (``Generator(prompt_cache=True)``)
against the JAX package's, the eight cases of ``tests/test_prompt_cache.py``
run through both with the same f32 weights (its tiny config: 2 layers,
hidden 32, Hq 4 / Hkv 2, chunk 8, decode blocks of 4, capacity 128).

Tolerances: ``last_prefix_hit`` and greedy tokens equal to JAX's; the
logprob summaries within 1e-5; sampled draws are equal in distribution
only (``torch.Generator`` does not re-derive ``jax.random``'s stream), so a
sampled request is held to the port's uncached generator with the same
seed, token for token, and its hit to JAX's. The port prefills from the
chunk boundary at or below the hit (its chunk graphs are keyed by offset):
every chunk it runs starts at a chunk multiple."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
CHUNK, BLOCK = 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    return cfg, jm, params


def _pair(weights, max_seq, prompt_cache):
    """(JAX generator, port generator) over the same weights."""
    cfg, jm, params = weights
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    jg = JGenerator(jm, params, max_seq=max_seq, cache_dtype=jnp.float32, prefill_chunk=CHUNK,
                    decode_block=BLOCK, prompt_cache=prompt_cache)
    tg = Generator(tm, max_seq=max_seq, prefill_chunk=CHUNK, decode_block=BLOCK,
                   prompt_cache=prompt_cache)
    return jg, tg


@pytest.fixture(scope="module")
def gens(weights):
    """The cached and the plain generators of both packages, built once:
    every case runs the same request sequence through both, so the caches'
    contents follow each other."""
    (jc, tc), (jp, tp) = _pair(weights, 128, True), _pair(weights, 128, False)
    return {"jax": jc, "port": tc, "jax_plain": jp, "port_plain": tp}


def run(gen, prompt, **kw):
    return [t for t, _ in gen.generate_step(prompt, **kw)]


def _both(gens, prompt, **kw):
    """The request through both cached generators: the port's tokens and
    hit must be JAX's."""
    want = run(gens["jax"], prompt, **kw)
    got = run(gens["port"], prompt, **kw)
    assert got == want
    assert gens["port"].last_prefix_hit == gens["jax"].last_prefix_hit
    return got


def test_chat_turn_pattern(gens):
    p1 = [5, 9, 2, 44, 17, 80, 3, 14, 9, 9, 31]
    reply = _both(gens, p1, max_tokens=9)
    assert gens["port"].last_prefix_hit == 0
    p2 = p1 + reply + [77, 12, 5]
    got = _both(gens, p2, max_tokens=8)
    assert got == run(gens["port_plain"], p2, max_tokens=8)
    assert gens["port"].last_prefix_hit >= len(p1)


def test_exact_repeat(gens):
    p = [8, 1, 99, 42, 6, 13, 27]
    _both(gens, p, max_tokens=5)
    got = _both(gens, p, max_tokens=5)
    assert got == run(gens["port_plain"], p, max_tokens=5)
    assert gens["port"].last_prefix_hit == len(p) - 1


def test_mismatched_prompt_is_safe(gens):
    _both(gens, [5, 9, 2, 44, 17], max_tokens=6)
    p = [200, 201, 202, 203]
    got = _both(gens, p, max_tokens=6)
    assert got == run(gens["port_plain"], p, max_tokens=6)
    assert gens["port"].last_prefix_hit == 0


def test_partial_prefix(gens):
    p1 = [5, 9, 2, 44, 17, 80, 3, 14]
    _both(gens, p1, max_tokens=4)
    p2 = p1[:5] + [150, 151, 152]
    got = _both(gens, p2, max_tokens=6)
    assert got == run(gens["port_plain"], p2, max_tokens=6)
    assert gens["port"].last_prefix_hit == 5


def test_sampled_with_cache(gens):
    """Sampled over a reused prefix: the hit is JAX's, and the stream is
    the port's uncached generator's with the same seed."""
    p1 = [5, 9, 2, 44, 17, 80]
    _both(gens, p1, max_tokens=5)
    p2 = p1 + [60, 61]
    kw = dict(max_tokens=7, temperature=0.8, top_p=0.9, seed=3, repetition_penalty=1.2)
    run(gens["jax"], p2, **kw)
    got = run(gens["port"], p2, **kw)
    assert gens["port"].last_prefix_hit == gens["jax"].last_prefix_hit >= len(p1) - 1
    assert got == run(gens["port_plain"], p2, **kw)


def test_early_close_then_reuse(gens):
    """A stream closed after 3 tokens leaves exactly the rows it can name:
    the lookahead block's rows are past them."""
    p1 = [5, 9, 2, 44, 17, 80, 3]
    taken = []
    for key in ("jax", "port"):
        g = gens[key].generate_step(p1, max_tokens=12)
        taken.append([next(g)[0] for _ in range(3)])
        g.close()
    assert taken[0] == taken[1]
    p2 = p1 + taken[1] + [90]
    got = _both(gens, p2, max_tokens=6)
    assert got == run(gens["port_plain"], p2, max_tokens=6)
    assert gens["port"].last_prefix_hit >= len(p1)


def test_logprobs_with_cache(gens):
    p1 = [5, 9, 2, 44]
    _both(gens, p1, max_tokens=4)
    p2 = p1 + [10, 11]
    want = list(gens["jax"].generate_step(p2, max_tokens=5, want_logprobs=True))
    got = list(gens["port"].generate_step(p2, max_tokens=5, want_logprobs=True))
    assert gens["port"].last_prefix_hit == gens["jax"].last_prefix_hit
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.chosen == pytest.approx(b.chosen, abs=1e-5)
        assert list(a.top_indices) == list(b.top_indices)


def test_capacity_edge_unaligned_hit(weights):
    """prefill_chunk 8, max_seq 16: a 5-token hit on a 15-token prompt
    would carry the padded suffix past the capacity, so JAX aligns it to 0,
    and the port reports the same."""
    jc, tc = _pair(weights, 16, True)
    _, tp = _pair(weights, 16, False)
    p1 = [5, 9, 2, 44, 17]
    for g in (jc, tc):
        run(g, p1, max_tokens=2)
    p2 = p1 + [30, 31, 32, 33, 34, 35, 36, 37, 38, 39]
    want = run(jc, p2, max_tokens=1)
    assert run(tc, p2, max_tokens=1) == want == run(tp, p2, max_tokens=1)
    assert tc.last_prefix_hit == jc.last_prefix_hit == 0


def test_prefill_starts_on_chunk_boundaries(gens, monkeypatch):
    """A hit inside a chunk (11 here) prefills from the boundary below it
    (8), so every chunk offset is one ``warm_up`` captures on a card; the
    rows between are recomputed from the same tokens."""
    tc = gens["port"]
    offsets = []
    real = tc.run_chunk
    monkeypatch.setattr(tc, "run_chunk", lambda off: offsets.append(off) or real(off))
    p1 = [7, 3, 19, 44, 2, 8, 91, 5, 66, 12, 40, 28, 3]
    run(tc, p1, max_tokens=3)
    p2 = p1[:11] + [1, 2, 3, 4, 5, 6, 7]
    got = run(tc, p2, max_tokens=5)
    assert tc.last_prefix_hit == 11 and offsets == [0, 8, 8, 16]
    assert got == run(gens["port_plain"], p2, max_tokens=5)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tc.run_prefill(np.asarray([p2]), 3)
