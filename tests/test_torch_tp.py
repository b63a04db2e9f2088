"""Tensor parallelism in the port's fused engine against the JAX package's,
on the CPU in f32 (the cases of ``tests/test_tp_inference.py``): the specs
and the models' shard hooks, every shard of the placed weights bit-equal to
JAX's addressable shard (dense and packed), the KV cache split on its heads,
and greedy streams of Llama at pp1/tp2, pp2/tp2 and an uneven split with
microbatches, Qwen3, Gemma-2 and DeepSeek-V2 (both cache modes) at tp = 2,
token-identical to JAX's engine on ``make_mesh(pp, tp)`` over the 8 host
devices, with their logprobs within ``LOGPROB_TOL``. The port's shards all
sit on ``device="cpu"``. Expert parallelism is
``tests/test_torch_expert_parallel.py``; the batcher, the CLI and the server
``tests/test_torch_tp_serve.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import DeepseekV2Config, LlamaConfig
from mlx_sharding_tpu.models.deepseek_v2 import DeepseekV2Model
from mlx_sharding_tpu.models.llama import LlamaModel
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel import tp as jtp
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu_torch.cache import ShardedKV, shard_caches
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.parallel import mesh as tmesh
from mlx_sharding_tpu_torch.parallel import pipeline as tpipeline
from mlx_sharding_tpu_torch.parallel import tp as ttp
from mlx_sharding_tpu.models import build_model as j_build_model
from mlx_sharding_tpu_torch.models import build_model
from tests.test_torch_families import FAMILIES, jax_pair, port
from tests.test_torch_pipeline_archs import _pair, one_torch_thread  # noqa: F401

TOKENS = 8
# f32 logprobs of the two packages: summation order only
LOGPROB_TOL = 1e-4
TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2)
DEEPSEEK_TINY = dict(
    vocab_size=128, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=16,
    qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=12, n_routed_experts=4,
    n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1)


@pytest.fixture(scope="module")
def llama():
    return _pair(LlamaModel(LlamaConfig(**TINY)), 0)


def _deepseek(mode, q_lora_rank=None):
    return _pair(DeepseekV2Model(DeepseekV2Config(**{**DEEPSEEK_TINY, "q_lora_rank": q_lora_rank},
                                                  mla_cache_mode=mode)), 1)


def _jax_stream(jm, params, prompt, *, pp=1, tp=1, ep=1, max_tokens=TOKENS, **kw):
    eng = jpipeline.PipelineEngine(jm, params, make_mesh(pp=pp, tp=tp, ep=ep), max_seq=64,
                                   cache_dtype=jnp.float32, prefill_chunk=8, **kw)
    return list(eng.generate_step(prompt, max_tokens=max_tokens, want_logprobs=True))


def _port_stream(tm, prompt, *, pp=1, tp=1, ep=1, max_tokens=TOKENS, **kw):
    eng = PipelineEngine(tm, stages=pp, tp=tp, ep=ep, max_seq=64, prefill_chunk=8,
                         device="cpu", decode_block=4, **kw)
    return list(eng.generate_step(prompt, max_tokens=max_tokens, want_logprobs=True))


def assert_streams_match(got, want):
    """Token-identical greedy streams, the chosen logprobs within tolerance."""
    assert [t for t, _ in got] == [t for t, _ in want]
    err = max(abs(g.chosen - w.chosen) for (_, g), (_, w) in zip(got, want))
    assert err < LOGPROB_TOL, err


# ------------------------------------------------------- specs and hooks
def test_specs_match_jax():
    """``llama_param_specs`` and ``prune_specs`` are JAX's, spec for spec."""
    for kw in (dict(), dict(tp=None, layers="pp")):
        want, got = jtp.llama_param_specs(**kw), ttp.llama_param_specs(**kw)
        flat = lambda d: {k: (tuple(v) if not isinstance(v, dict) else flat(v))  # noqa: E731
                          for k, v in d.items()}
        assert flat(got) == flat(want)
    params = {"layers": {"q_proj": 0, "input_norm": 0}, "final_norm": {"weight": 0}}
    assert (ttp.prune_specs(ttp.llama_param_specs(), params)["layers"].keys()
            == jtp.prune_specs(jtp.llama_param_specs(), params)["layers"].keys())


@pytest.mark.parametrize("family", ["qwen3", "gemma2", "mixtral", "deepseek_v2", "deepseek_lora"])
def test_shard_hooks_match_jax(family):
    """``tp_layer_axes``, ``ep_layer_axes`` and ``cache_tp_replicated`` of
    every family are the JAX model's (JAX's orientation)."""
    overrides = {"q_lora_rank": 24} if family == "deepseek_lora" else {}
    config = {**FAMILIES["deepseek_v2" if family == "deepseek_lora" else family], **overrides}
    jm, _ = j_build_model(config)
    tm, _ = build_model(config)  # the hooks read the config only: no weights
    assert tm.tp_layer_axes() == jm.tp_layer_axes()
    assert tm.ep_layer_axes() == jm.ep_layer_axes()
    assert tm.cache_tp_replicated() == jm.cache_tp_replicated()


def test_device_grid_and_its_fingerprint(monkeypatch):
    """The grid over (pp, sp, ep, tp) in JAX's axis order: the first cards
    (fewer raise with ``make_mesh``'s message), or every shard on one
    device; a tp = 2 placement's fingerprint (the weight store's key) is not
    a tp = 1 one's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    grid = tmesh.device_grid(pp=2, ep=2, tp=2)
    assert grid.shape == (2, 1, 2, 2)
    assert [d.index for d in grid.flat] == list(range(8))
    with pytest.raises(ValueError, match="mesh dp=1 pp=2 sp=1 ep=2 tp=4 needs 16 devices, "
                                         "have 8"):
        tmesh.device_grid(pp=2, ep=2, tp=4)
    one, two = tmesh.device_grid(device="cpu"), tmesh.device_grid(tp=2, device="cpu")
    assert tmesh.mesh_fingerprint(one) == "pp=1|cpu"
    assert tmesh.mesh_fingerprint(two) == "pp=1,sp=1,ep=1,tp=2|cpu,cpu"
    assert not tmesh.same_mesh_devices(one, two)
    assert tmesh.same_mesh_devices(two, tmesh.device_grid(tp=2, device="cpu"))


# ------------------------------------------------------------ the shards
def _port_tensor(layer, name, leaf):
    """A port layer's tensor under JAX's name, in JAX's (in, out)
    orientation for a dense weight, MLX's for a packed leaf."""
    mod = getattr(layer, name)
    if isinstance(mod, torch.nn.Parameter):
        return mod.detach()
    if leaf is not None:
        return getattr(mod, leaf)
    return mod.weight.detach().transpose(-1, -2)


def _check_shards(jeng, engine, names):
    """Every JAX addressable shard of ``names`` in ``jeng`` (JAX's placed
    tree, ``place_weights``; stage and tp rank from the shard's index)
    equals the port's shard, bit for bit."""
    tp, checked = engine.tp, 0
    for name in names:
        arr = jeng.layer_params[name]
        leaves = arr.items() if isinstance(arr, dict) else [(None, arr)]
        for leaf, a in leaves:
            # the split dim past the (S, L) stack axes, if any
            split = [d for d, n in enumerate(a.sharding.shard_shape(a.shape))
                     if d > 1 and n != a.shape[d]]
            for shard in a.addressable_shards:
                s = shard.index[0].start or 0
                r = ((shard.index[split[0]].start or 0) // shard.data.shape[split[0]]
                     if split else 0)
                lo = engine.stage_bounds[s][0]
                for j in range(shard.data.shape[1]):
                    layer = engine.shard_views[s][r % tp].layers[j]
                    want = np.asarray(shard.data[0, j])
                    got = _port_tensor(layer, name, leaf).numpy()
                    if got.dtype != want.dtype:  # packed words: int32 here, uint32 in JAX
                        got = got.view(want.dtype)
                    np.testing.assert_array_equal(got, want, err_msg=f"{name}.{leaf} s{s} r{r} "
                                                  f"layer {lo + j}")
                    checked += 1
    assert checked


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_shards_bit_equal_jax(packed):
    """Placed at pp = 2, tp = 2: each port shard of every column- and
    row-parallel projection, and of the replicated norms, is JAX's
    addressable shard, dense and packed (a packed row split cuts the words
    and the group scales); a packed slice that is not contiguous is a copy,
    and the model's whole tensor is dropped, so the bytes are held once."""
    cfg, jm, params = jax_pair("qwen3", packed=packed)
    tm = port(cfg, params)
    jeng = jpipeline.place_weights(jm, params, make_mesh(pp=2, tp=2))
    whole = tpipeline.model_weight_bytes(tm)
    eng = PipelineEngine(tm, stages=2, tp=2, max_seq=64, prefill_chunk=8, device="cpu")
    _check_shards(jeng, eng, ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                              "down_proj", "input_norm", "q_norm"])
    assert eng.weight_stream_bytes == whole
    if packed:
        o = eng.shard_views[0][1].layers[0].o_proj
        assert o.q.is_contiguous() and o.scales.is_contiguous()
        assert tm.layers[0].o_proj.q.device.type == "meta"  # the whole is dropped


def test_shard_divisibility_raises_jax_message():
    """A split that does not divide raises JAX's message: the KV heads
    first, then a packed row split whose group scales do not divide (the
    guard that a split lands on a group boundary)."""
    cfg, jm, params = jax_pair("qwen3", packed=True, intermediate_size=192)
    with pytest.raises(ValueError) as want:
        jpipeline.PipelineEngine(jm, params, make_mesh(tp=2), max_seq=64,
                                 cache_dtype=jnp.float32, prefill_chunk=8)
    with pytest.raises(ValueError) as got:
        PipelineEngine(port(cfg, params), tp=2, max_seq=64, prefill_chunk=8, device="cpu")
    assert str(got.value) == str(want.value)
    _, _, tm = _pair(LlamaModel(LlamaConfig(**TINY)), 0)
    with pytest.raises(ValueError, match="tp=4 must divide the 2 KV heads"):
        PipelineEngine(tm, tp=4, max_seq=64, prefill_chunk=8, device="cpu")


def test_tp_cache_is_head_sharded(llama):
    """Each (stage, tp shard) keeps its own cache over its own KV heads, the
    shape JAX's sharding gives each device; after a prefill its rows equal
    JAX's shard's (f32, within the matmuls' summation order)."""
    jm, params, tm = llama
    jeng = jpipeline.PipelineEngine(jm, params, make_mesh(pp=2, tp=2), max_seq=64,
                                    cache_dtype=jnp.float32, prefill_chunk=8)
    jcache = jeng.init_cache()
    prompt = np.asarray([[[3, 17, 42, 9, 5, 6, 7, 8]]], np.int32)
    _, jcache = jeng._prefill(jeng.layer_params, jeng.layer_masks, jeng.vocab_parts,
                              jeng.shared_params, jnp.asarray(prompt), jcache,
                              jnp.asarray(8, jnp.int32))
    eng = PipelineEngine(tm, stages=2, tp=2, max_seq=64, prefill_chunk=8, device="cpu")
    eng.generate_step(prompt[0, 0].tolist(), max_tokens=1).__next__()
    cache = eng.stream().model.cache
    want_shape = jcache.k.sharding.shard_shape(jcache.k.shape)
    for s, stage in enumerate(cache.stages):
        assert isinstance(stage, ShardedKV)
        for r, c in enumerate(shard_caches(stage)):
            # JAX (S, L, M+1, B, S, H, D) per device; the port (L, M+1, S, H, D)
            assert c.k.shape == (want_shape[1], want_shape[2], want_shape[4],
                                 want_shape[5], want_shape[6])
            heads = slice(r * want_shape[5], (r + 1) * want_shape[5])
            want = np.asarray(jcache.k[s, :, 0, 0, :8, heads])
            np.testing.assert_allclose(c.k[:, 0, :8].numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the streams
@pytest.mark.parametrize("mesh", ["pp1_tp2", "pp2_tp2", "uneven_pp2_tp2_microbatches"])
def test_llama_tp_streams_match_jax(llama, mesh):
    """The engine's single stream at tp = 2 (pp = 1, pp = 2, and bounds 0-3 /
    3-4 with 2 microbatches) is token-identical to JAX's on the same mesh."""
    jm, params, tm = llama
    kw = {"pp1_tp2": dict(pp=1, tp=2), "pp2_tp2": dict(pp=2, tp=2),
          "uneven_pp2_tp2_microbatches": dict(pp=2, tp=2, stage_bounds=[(0, 3), (3, 4)],
                                              microbatches=2)}[mesh]
    prompt = list(range(1, 14))
    assert_streams_match(_port_stream(tm, prompt, **kw), _jax_stream(jm, params, prompt, **kw))


def test_tp2_seeded_sampling_matches_tp1(llama):
    """A seeded sampled stream at tp = 2 equals the port's tp = 1 Generator's
    (JAX's test: the engine at tp = 2 against its Generator)."""
    _, _, tm = llama
    kw = dict(temperature=0.9, top_p=0.85, seed=31, max_tokens=8)
    prompt = [5, 9, 2, 7]
    want = [t for t, _ in Generator(tm, max_seq=64, prefill_chunk=8).generate_step(prompt, **kw)]
    eng = PipelineEngine(tm, tp=2, max_seq=64, prefill_chunk=8, device="cpu")
    assert [t for t, _ in eng.generate_step(prompt, **kw)] == want


def test_two_reductions_a_layer(llama):
    """Under tp a layer's row-parallel O and down products are summed in
    process: two reductions a layer, every layer; none at tp = 1."""
    _, _, tm = llama
    for tp, want in ((1, 0), (2, 2 * TINY["num_hidden_layers"])):
        eng = PipelineEngine(tm, tp=tp, max_seq=64, prefill_chunk=8, device="cpu")
        stream = eng.stream()
        before = tmesh.reductions()
        stream.model(torch.zeros((1, 1), dtype=torch.int64), stream.cache)
        assert tmesh.reductions() - before == want


@pytest.mark.parametrize("family", ["qwen3", "gemma2_pp2"])
def test_family_tp_streams_match_jax(family):
    """Qwen3 (per-head norms replicated) and Gemma-2 at pp = 2 (its norms
    are nonlinear: the partial products are summed before them; the
    window alternates) at tp = 2 against JAX's engine."""
    cfg, jm, params = jax_pair(family.split("_")[0])
    tm = port(cfg, params)
    pp = 2 if family.endswith("pp2") else 1
    prompt = list(range(2, 30))
    assert_streams_match(_port_stream(tm, prompt, pp=pp, tp=2),
                         _jax_stream(jm, params, prompt, pp=pp, tp=2))


@pytest.mark.parametrize("mode", ["full", "compressed"])
def test_deepseek_tp2_streams_match_jax(mode):
    """MLA at tp = 2 (q-LoRA, a dense layer and a MoE one): per-head
    projections split around the replicated latent; in compressed mode
    every tp shard keeps a whole copy of the latent cache."""
    jm, params, tm = _deepseek(mode, q_lora_rank=24)
    prompt = [7, 3, 99, 12]
    got = _port_stream(tm, prompt, tp=2)
    assert_streams_match(got, _jax_stream(jm, params, prompt, tp=2))


def test_packed_tp2_stream_matches_jax():
    """A packed Llama-family model (Qwen3's tiny config, MLX 4-bit) at tp =
    2: the shards' packed products (the kernels' plain versions here)
    token-identical to JAX's engine; fusion stays off at tp > 1."""
    cfg, jm, params = jax_pair("qwen3", packed=True)
    tm = port(cfg, params)
    prompt = list(range(2, 20))
    got = _port_stream(tm, prompt, tp=2)
    assert not any(hasattr(layer, "qkv_proj") for layer in tm.layers)
    assert_streams_match(got, _jax_stream(jm, params, prompt, tp=2))


def test_what_tp_does_not_take():
    """JAX's wiring check, its ragged rule (a tp batcher decodes on
    ``gather``), and what this slice defers at tp or ep > 1: share and
    compression maps, speculation, page-block moves (slice 9b.3b)."""
    from mlx_sharding_tpu_torch.kv_share import KVShareMap
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    _, _, tm = _pair(LlamaModel(LlamaConfig(**TINY)), 0)
    tm.tp_layer_axes = lambda: {}
    with pytest.raises(ValueError, match="tensor parallelism is not wired for LlamaModel"):
        PipelineEngine(tm, tp=2, max_seq=64, prefill_chunk=8, device="cpu")
    del tm.tp_layer_axes
    pool = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8,
                device="cpu")
    with pytest.raises(ValueError, match="tp=ep=1"):
        PipelineEngine(tm, tp=2, paged_attention="ragged", **pool)
    eng = PipelineEngine(tm, tp=2, **pool)
    assert eng.decode_path == "gather"
    with pytest.raises(NotImplementedError, match="slice 9b.3b"):
        PipelineEngine(tm, tp=2, kv_share_map=KVShareMap.identity(4), **pool)
    for kw in (dict(spill_bytes=1 << 20), dict(draft="ngram")):
        with pytest.raises(NotImplementedError, match="slice 9b.3b"):
            ContinuousBatcher(eng, **kw)
