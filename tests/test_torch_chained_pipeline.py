"""The port's chained pipeline (one model per stage, the hidden state
handed on) against the JAX package's ``ChainedPipeline``, on the CPU in
f32: the uneven three-stage chain of ``tests/test_chained_pipeline.py``,
DeepSeek-V2 in two stages loaded from a checkpoint (its dense first layer
alone on stage 0), and the bounds validation with JAX's errors. Greedy
streams must be token-identical to JAX's chain and to the port's pp = 1
``Generator``; a seeded sampled stream equals the ``Generator``'s draw for
draw (the chain is a ``Generator`` over its stages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel
from mlx_sharding_tpu.parallel import chained as jchained
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.loading import load_model
from mlx_sharding_tpu_torch.parallel import chained
from tests.test_torch_families import tokenizer_checkpoint
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=2)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]


def _j_stage(params_full, start, end):
    """JAX's per-stage model and params (``tests/test_chained_pipeline.py``)."""
    cfg = LlamaConfig(**{**TINY, "start_layer": start, "end_layer": end})
    p = {"layers": {k: v[start:end] for k, v in params_full["layers"].items()}}
    if cfg.needs_embed:
        p["embed"] = params_full["embed"]
    if cfg.needs_head:
        p["final_norm"] = params_full["final_norm"]
        p["lm_head"] = params_full["lm_head"]
    return LlamaModel(cfg), p


@pytest.fixture(scope="module")
def llama():
    jm = LlamaModel(LlamaConfig(**TINY))
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    return params, params_from_numpy(jm.config, jax.tree.map(np.asarray, params), device="cpu")


def test_uneven_three_stage_chain_matches_jax_and_pp1(llama):
    """Stages of 1, 2 and 3 layers: the port's chain over the loaded
    model's own tensors is token-identical to JAX's chain of per-stage
    params and to the port's pp = 1 Generator, and its stages hold no copy
    of any tensor."""
    params, tm = llama
    bounds = [(0, 1), (1, 3), (3, 6)]
    stages = [_j_stage(params, a, b) for a, b in bounds]
    jchain = jchained.ChainedPipeline([m for m, _ in stages], [p for _, p in stages],
                                      max_seq=64, cache_dtype=jnp.float32, prefill_chunk=8)
    want = [t for t, _ in jchain.generate_step(PROMPT, max_tokens=10)]
    chain = chained.chained_from_model(tm, bounds, max_seq=64, prefill_chunk=8, decode_block=4)
    assert chain.num_stages == 3 and chain.stage_bounds == bounds
    assert [t for t, _ in chain.generate_step(PROMPT, max_tokens=10)] == want
    gen = Generator(tm, max_seq=64, prefill_chunk=8)
    assert [t for t, _ in gen.generate_step(PROMPT, max_tokens=10)] == want
    ptrs = {t.data_ptr() for t in tm.state_dict().values()}
    for st, (a, b) in zip(chain.models, bounds):
        assert st.config.start_layer == a and st.config.end_layer == b
        assert len(st.layers) == b - a
        assert {t.data_ptr() for t in st.state_dict().values()} <= ptrs
    assert not hasattr(chain.models[1], "embed_tokens") and not hasattr(chain.models[0],
                                                                        "lm_head")
    # sampled: the same seed draws the same tokens as the pp = 1 Generator
    kw = dict(max_tokens=12, temperature=0.9, top_p=0.9, repetition_penalty=1.2, seed=5)
    assert ([t for t, _ in chain.generate_step(PROMPT, **kw)]
            == [t for t, _ in gen.generate_step(PROMPT, **kw)])


def test_chained_deepseek_two_stages_from_a_checkpoint(tmp_path):
    """DeepSeek-V2 loaded per stage from one checkpoint with bounds 0-1 /
    1-3 (stage 0 holds the dense layer, stage 1 the MoE layers), by both
    packages' ``load_chained_pipeline``: token-identical greedy streams,
    equal to the port's pp = 1 stream of the whole checkpoint."""
    path = tokenizer_checkpoint(tmp_path, "deepseek_v2")
    bounds = [(0, 1), (1, 3)]
    jchain = jchained.load_chained_pipeline(str(path), bounds, dtype=jnp.float32, max_seq=32,
                                            cache_dtype=jnp.float32, prefill_chunk=8)
    prompt = [2, 45, 99, 3]
    want = [t for t, _ in jchain.generate_step(prompt, max_tokens=6)]
    chain = chained.load_chained_pipeline(str(path), bounds, dtype=torch.float32, device="cpu",
                                          max_seq=32, prefill_chunk=8)
    assert [m.layers[0].moe for m in chain.models] == [False, True]
    assert [t for t, _ in chain.generate_step(prompt, max_tokens=6)] == want
    full, _ = load_model(str(path), dtype=torch.float32, device="cpu")
    gen = Generator(full, max_seq=32, prefill_chunk=8)
    assert [t for t, _ in gen.generate_step(prompt, max_tokens=6)] == want


@pytest.mark.parametrize("bounds,match", [
    ([(1, 6)], "start at layer 0"),
    ([(0, 4)], "end at num_hidden_layers"),
])
def test_chained_validates_bounds_as_jax(llama, bounds, match):
    """A chain that does not start at layer 0, or does not end at the last
    layer, raises JAX's error in both packages."""
    params, tm = llama
    stages = [_j_stage(params, a, b) for a, b in bounds]
    with pytest.raises(ValueError, match=match):
        jchained.ChainedPipeline([m for m, _ in stages], [p for _, p in stages])
    with pytest.raises(ValueError, match=match):
        chained.ChainedPipeline([chained.stage_model(tm, a, b) for a, b in bounds])


def test_chain_needs_a_device_per_stage_and_in_range_bounds(llama):
    """JAX's device count error; bounds past the model's layers fail as the
    config's check fails in JAX; ``chained_from_model`` takes the engine's
    bound checks (a gap between stages would drop layers)."""
    params, tm = llama
    stages = [chained.stage_model(tm, 0, 3), chained.stage_model(tm, 3, 6)]
    with pytest.raises(ValueError, match="2 stages need 2 devices, have 1"):
        chained.ChainedPipeline(stages, devices=["cpu"])
    with pytest.raises(ValueError, match="Invalid stage bounds"):
        _j_stage(params, 3, 9)
    with pytest.raises(ValueError, match="Invalid stage bounds"):
        chained.stage_model(tm, 3, 9)
    with pytest.raises(ValueError, match="must be contiguous"):
        chained.chained_from_model(tm, [(0, 2), (3, 6)])
