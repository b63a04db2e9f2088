"""The port's Llama model against the JAX model on a tiny config (3 layers,
head_dim 64, 128-token prefill chunks, so prefill runs through the flash
module's plain version), with the JAX weights carried across by
``convert.params_from_numpy``; and the port's loader on the tiny on-disk
checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import LlamaConfig as JLlamaConfig
from mlx_sharding_tpu.config import config_from_dict as j_config_from_dict
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.loading import load_model, read_safetensors
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops import attention as attention_mod
from mlx_sharding_tpu_torch.ops import flash_attention as fa

TINY = dict(
    vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=3,
    num_attention_heads=2, num_key_value_heads=1, head_dim=64,
    rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
)


def _pair(dtype=jnp.float32, seed=0, **overrides):
    cfg = j_config_from_dict({**TINY, **overrides})
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(seed), dtype)
    return cfg, jm, params


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(1, n))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.fixture(scope="module")
def f32_pair():
    cfg, jm, params = _pair()
    return cfg, jm, params, _port(cfg, params)


def test_prefill_and_decode_logits_match_jax_f32(f32_pair, monkeypatch):
    """Every position of a 128-token chunk, then 6 T=1 decode steps, within
    1e-4 in f32. The chunk goes through the flash module (once per layer)."""
    cfg, jm, params, tm = f32_pair
    calls = []
    monkeypatch.setattr(attention_mod, "flash_attention",
                        lambda *a: calls.append(1) or fa.flash_attention(*a))
    prompt = _prompt(128)
    jc = jm.make_cache(1, 256, jnp.float32)
    tc = tm.make_cache(1, 256)
    jl, jc = jm(params, jnp.asarray(prompt, jnp.int32), jc)
    tl, tc = tm(torch.from_numpy(prompt), tc)
    assert len(calls) == cfg.num_hidden_layers
    assert tc.offset == int(jc.offset) == 128
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    tok = int(np.argmax(_f32(jl)[0, -1]))
    for _ in range(6):
        jl, jc = jm(params, jnp.asarray([[tok]], jnp.int32), jc)
        tl, tc = tm(torch.tensor([[tok]]), tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
        tok = int(np.argmax(_f32(jl)[0, -1]))
    assert len(calls) == cfg.num_hidden_layers  # decode stays on the plain path


def test_padded_chunk_advances_by_n_valid(f32_pair):
    """A right-padded chunk: the offset advances by n_valid and the logits
    at n_valid - 1 are those of the unpadded prompt."""
    cfg, jm, params, tm = f32_pair
    prompt = _prompt(128)
    prompt[0, 90:] = 0
    jl, jc = jm(params, jnp.asarray(prompt, jnp.int32), jm.make_cache(1, 256, jnp.float32),
                n_valid=jnp.asarray(90))
    tl, tc = tm(torch.from_numpy(prompt), tm.make_cache(1, 256), n_valid=90, logits_at=89)
    assert tc.offset == int(jc.offset) == 90
    assert tl.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(_f32(tl)[0, 0], _f32(jl)[0, 89], rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax():
    """bf16 weights and activations: the two frameworks round at different
    points (XLA may fuse and keep fp32 where PyTorch rounds each op's output
    to bf16), so over 3 layers the logits (magnitude ~5) differ by up to a
    few bf16 steps. Tolerance: relative L2 error 2e-2, and the greedy pick
    equal at >= 90% of positions."""
    cfg, jm, params = _pair(jnp.bfloat16)
    tm = _port(cfg, params)
    assert tm.dtype == torch.bfloat16
    prompt = _prompt(128, seed=1)
    jl, _ = jm(params, jnp.asarray(prompt, jnp.int32), jm.make_cache(1, 256, jnp.bfloat16))
    tl, _ = tm(torch.from_numpy(prompt), tm.make_cache(1, 256))
    j, t = _f32(jl), _f32(tl)
    assert np.linalg.norm(t - j) / np.linalg.norm(j) < 2e-2
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("variant", ["qwen2_biases", "tied_embeddings", "mistral"])
def test_llama_family_variants_match_jax(variant):
    overrides = {
        "qwen2_biases": {"model_type": "qwen2"},
        "tied_embeddings": {"tie_word_embeddings": True},
        "mistral": {"model_type": "mistral", "rope_scaling": None},
    }[variant]
    cfg, jm, params = _pair(seed=2, **overrides)
    if cfg.attention_bias:  # init_params zeroes the biases: give them values
        rng = np.random.default_rng(3)
        for name in ("q_bias", "k_bias", "v_bias"):
            b = params["layers"][name]
            params["layers"][name] = jnp.asarray(rng.normal(size=b.shape), jnp.float32)
    tm = _port(cfg, params)
    assert hasattr(tm, "lm_head") != cfg.tie_word_embeddings
    prompt = _prompt(128, seed=4)
    jl, _ = jm(params, jnp.asarray(prompt, jnp.int32), jm.make_cache(1, 256, jnp.float32))
    tl, _ = tm(torch.from_numpy(prompt), tm.make_cache(1, 256))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)


def test_stage_bounds_compose_to_the_full_model(f32_pair):
    """[0, 1) then [1, 3): embed on the first stage only, head on the last."""
    cfg, jm, params, tm = f32_pair
    tree = jax.tree.map(np.asarray, params)

    def stage(lo, hi):
        sub = dict(tree, layers={k: v[lo:hi] for k, v in tree["layers"].items()})
        return params_from_numpy({**cfg.to_dict(), "start_layer": lo, "end_layer": hi}, sub,
                                 device="cpu")

    first, last = stage(0, 1), stage(1, 3)
    assert not hasattr(first, "lm_head") and not hasattr(last, "embed_tokens")
    prompt = torch.from_numpy(_prompt(128))
    h, _ = first(prompt, first.make_cache(1, 256))
    got, _ = last(h, last.make_cache(1, 256))
    want, _ = tm(prompt, tm.make_cache(1, 256))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_init_params_is_seeded_and_materialized():
    def make(seed):
        model, _ = build_model(TINY, dtype=torch.float32)
        return model.init_params(torch.Generator().manual_seed(seed), "cpu")

    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert pa.device.type == "cpu" and torch.equal(pa, pb), name
    assert not torch.equal(a.layers[0].q_proj.weight, c.layers[0].q_proj.weight)
    assert torch.equal(a.final_norm, torch.ones(128))


@pytest.mark.parametrize("model_type", ["qwen3", "gemma2", "deepseek_v2", "mixtral"])
def test_unported_model_types_name_the_roadmap_item(model_type):
    with pytest.raises(NotImplementedError, match="not yet ported.*ROADMAP.md"):
        build_model({**TINY, "model_type": model_type})


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("torch_ckpt"))


def test_safetensors_reader_matches_the_library(tiny_checkpoint, tmp_path):
    """The HF checkpoint's tensors, and packed U32 words (read as an int32
    view of the same bits) beside fp16 scales."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    save_file({"w.weight": rng.integers(0, 2**32, size=(4, 8), dtype=np.uint32),
               "w.scales": rng.normal(size=(4, 1)).astype(np.float16)},
              str(tmp_path / "packed.safetensors"))
    for path in [*tiny_checkpoint.glob("*.safetensors"), tmp_path / "packed.safetensors"]:
        want = load_file(str(path))
        got = read_safetensors(path)
        assert set(got) == set(want)
        for name, arr in want.items():
            if arr.dtype == np.uint32:
                assert got[name].dtype == torch.int32
                np.testing.assert_array_equal(got[name].numpy().view(np.uint32), arr)
            else:
                np.testing.assert_array_equal(got[name].numpy(), arr)


def test_loaded_checkpoint_matches_jax_loader(tiny_checkpoint):
    """Both loaders on the same HF checkpoint: equal prefill logits in f32,
    and a stage-bounded load holds only its layers."""
    from mlx_sharding_tpu.loading import load_model as j_load_model

    jm, params = j_load_model(str(tiny_checkpoint), dtype=jnp.float32)
    tm, cfg = load_model(str(tiny_checkpoint), dtype=torch.float32, device="cpu")
    prompt = _prompt(128, seed=5) % cfg.vocab_size
    jl, _ = jm(params, jnp.asarray(prompt, jnp.int32), jm.make_cache(1, 256, jnp.float32))
    tl, _ = tm(torch.from_numpy(prompt), tm.make_cache(1, 256))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    stage, scfg = load_model(str(tiny_checkpoint), start_layer=1, end_layer=3,
                             dtype=torch.float32, device="cpu")
    assert len(stage.layers) == 2 and not hasattr(stage, "embed_tokens")
    torch.testing.assert_close(stage.layers[0].q_proj.weight, tm.layers[1].q_proj.weight)


def test_missing_checkpoint_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "absent"), device="cpu")


def test_jax_and_port_configs_agree():
    """The port's config.py is a copy: the same dict gives the same fields."""
    from mlx_sharding_tpu_torch.config import config_from_dict

    for d in (TINY, {**TINY, "model_type": "qwen2"}, {**TINY, "model_type": "mistral"}):
        assert config_from_dict(d).to_dict() == j_config_from_dict(d).to_dict()
    assert JLlamaConfig().to_dict() == config_from_dict({"model_type": "llama"}).to_dict()
