"""The port's fused pipeline engine at pp > 1 against the JAX package's, on
the CPU in f32: the cases of ``tests/test_pipeline_archs.py`` (Llama split
3/3/2 by default and skewed 5/2/1, Gemma-2 with one layer a stage, Mixtral,
DeepSeek-V2 in two stages and split 0-3 / 3-4, its dense prefix and MoE
suffix), the stage split of the weights, the balanced bounds, and what JAX
allows only at pp = 1. The batcher at pp = 2 is
``tests/test_torch_pipeline_batcher.py``.

Both packages run the same numbers: the JAX model's parameters drawn from a
seed and carried across by ``convert.params_from_numpy``. JAX's engines run
on ``pipeline_mesh(S)`` over the 8 host devices ``tests/conftest.py``
forces; the port's on ``device="cpu"``, every stage on it. Greedy streams
must be token-identical to JAX's engine at the same S and to the port's
pp = 1 ``Generator`` (no tolerance: f32 on both sides, the same argmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import (
    DeepseekV2Config,
    Gemma2Config,
    LlamaConfig,
    MixtralConfig,
)
from mlx_sharding_tpu.models.deepseek_v2 import DeepseekV2Model
from mlx_sharding_tpu.models.gemma2 import Gemma2Model
from mlx_sharding_tpu.models.llama import LlamaModel
from mlx_sharding_tpu.models.mixtral import MixtralModel
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu_torch.cache import StagedKV
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.parallel import pipeline as tpipeline
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

TOKENS = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps on one torch thread: under the test run's
    workers a thread pool per small op contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jmodel, seed: int):
    params = jmodel.init_params(jax.random.PRNGKey(seed), jnp.float32)
    return jmodel, params, params_from_numpy(jmodel.config, jax.tree.map(np.asarray, params),
                                             device="cpu")


def _llama(layers=8, seed=2):
    return _pair(LlamaModel(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=2)), seed)


def _deepseek(seed):
    return _pair(DeepseekV2Model(DeepseekV2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=16,
        q_lora_rank=None, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=12,
        n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
        first_k_dense_replace=1)), seed)


# (name, pair builder, S, bounds, prompt, max_seq, chunk)
CASES = {
    "llama_balanced_3_3_2": (_llama, 3, None, [3, 17, 42], 32, 8),
    "llama_skewed_5_2_1": (_llama, 3, [(0, 5), (5, 7), (7, 8)], [3, 17, 42], 32, 8),
    "gemma2_one_layer_a_stage": (lambda: _pair(Gemma2Model(Gemma2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, sliding_window=4,
        query_pre_attn_scalar=8)), 0), 4, None, list(range(2, 12)), 32, 16),
    "mixtral_two_stages": (lambda: _pair(MixtralModel(MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2)), 1), 2, None, [5, 9, 2], 32, 8),
    "deepseek_two_stages": (lambda: _deepseek(3), 2, None, [7, 3, 99, 12], 32, 8),
    "deepseek_dense_prefix_0_3_3_4": (lambda: _deepseek(5), 2, [(0, 3), (3, 4)], [4, 88, 23],
                                      32, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_stream_matches_jax_engine_and_pp1(case):
    """The engine's single stream at S stages is token-identical to JAX's
    engine on ``pipeline_mesh(S)`` with the same bounds, and to the port's
    pp = 1 ``Generator``; the stages hold their own layers' caches."""
    build, stages, bounds, prompt, max_seq, chunk = CASES[case]
    jm, params, tm = build()
    jeng = jpipeline.PipelineEngine(jm, params, pipeline_mesh(stages), stage_bounds=bounds,
                                    max_seq=max_seq, cache_dtype=jnp.float32,
                                    prefill_chunk=chunk)
    want = [t for t, _ in jeng.generate_step(prompt, max_tokens=TOKENS)]
    eng = PipelineEngine(tm, stages=stages, stage_bounds=bounds, max_seq=max_seq,
                         prefill_chunk=chunk, device="cpu", decode_block=4)
    assert eng.stage_bounds == jeng.stage_bounds
    assert [t for t, _ in eng.generate_step(prompt, max_tokens=TOKENS)] == want
    pp1 = Generator(tm, max_seq=max_seq, prefill_chunk=chunk)
    assert [t for t, _ in pp1.generate_step(prompt, max_tokens=TOKENS)] == want
    cache = eng.stream().model.cache
    assert isinstance(cache, StagedKV)
    assert [c.k.shape[0] for c in cache.stages] == [b - a for a, b in eng.stage_bounds]


def test_microbatches_and_logprobs_follow_slot_zero():
    """``microbatches=3`` at pp = 2 (every slot runs the prompt, as in
    JAX): slot 0's greedy stream and its logprob summaries equal the
    single-slot engine's; a sampled stream is reproducible from its seed."""
    _, _, tm = _llama(layers=4)
    prompt = [9, 4, 4, 6, 1, 3, 8, 8, 2, 11]
    one = PipelineEngine(tm, stages=2, max_seq=64, prefill_chunk=8, device="cpu",
                         decode_block=3)
    three = PipelineEngine(tm, stages=2, microbatches=3, max_seq=64, prefill_chunk=8,
                           device="cpu", decode_block=3)
    a = list(one.generate_step(prompt, max_tokens=10, want_logprobs=True))
    b = list(three.generate_step(prompt, max_tokens=10, want_logprobs=True))
    assert [t for t, _ in a] == [t for t, _ in b]
    for (_, la), (_, lb) in zip(a, b):
        np.testing.assert_allclose(lb.chosen, la.chosen, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(lb.top_indices, la.top_indices)
    draws = [[t for t, _ in three.generate_step(prompt, max_tokens=10, temperature=0.8,
                                                seed=11)] for _ in range(2)]
    assert draws[0] == draws[1]


class _Replay:
    """A stage's ``StepGraphs`` as a CPU stand-in with a graph's semantics:
    the program of a key is the one its first call brought (its closure
    over the stage's static inputs), and every later call runs that one."""

    def __init__(self):
        self.programs = {}

    def run(self, key, step, **_):
        return self.programs.setdefault(key, step)()


def test_per_stage_programs_read_only_their_static_inputs():
    """With each stage's share of a step as a program of its own (stages on
    distinct devices, here forced): every program, run again as captured,
    reads its inputs from the static copies ``StageGraphs.run`` makes, so
    the engine's stream and the chain's equal the pp = 1 Generator's; the
    engine keys its programs by chunk offset and one decode step."""
    from mlx_sharding_tpu_torch.parallel.chained import chained_from_model

    _, _, tm = _llama(layers=4)
    prompt = list(range(3, 40))
    ref = [t for t, _ in Generator(tm, max_seq=64, prefill_chunk=8).generate_step(
        prompt, max_tokens=12)]
    eng = PipelineEngine(tm, stages=2, max_seq=64, prefill_chunk=8, device="cpu",
                         decode_block=4, stage_graphs=True)
    stages = eng.stream().model.graphs
    assert eng.per_stage_graphs and stages.graphs is None  # no card here
    stages.graphs = [_Replay(), _Replay()]
    assert [t for t, _ in eng.generate_step(prompt, max_tokens=12)] == ref
    assert [t for t, _ in eng.generate_step(prompt[5:], max_tokens=9)] == \
        [t for t, _ in Generator(tm, max_seq=64, prefill_chunk=8).generate_step(prompt[5:],
                                                                                max_tokens=9)]
    for g in stages.graphs:
        assert set(g.programs) == {("prefill", off) for off in range(0, 40, 8)} | {("decode",)}
    chain = chained_from_model(tm, [(0, 1), (1, 4)], max_seq=64, prefill_chunk=8,
                               stage_graphs=True)
    assert chain.graphs is None
    chain.model.graphs.graphs = [_Replay(), _Replay()]
    assert [t for t, _ in chain.generate_step(prompt, max_tokens=12)] == ref


def test_each_stage_runs_through_a_view_with_its_own_constants(monkeypatch):
    """At pp = 2 each stage runs its layers through a view of the model
    (``pipeline.stage_model``) whose RoPE table is its own, on the stage's
    device, so no stage replaces the table another stage's captured
    program reads (stages on distinct cards would otherwise move one
    shared table back and forth). The single stream's prefill and decode
    and a batcher's steps all go through the views, and no view's table is
    replaced."""
    from chip_smoke import serve_on_this_thread

    _, _, tm = _llama(layers=4)
    prompt = list(range(3, 20))
    ref = [t for t, _ in Generator(tm, max_seq=64, prefill_chunk=8).generate_step(
        prompt, max_tokens=6)]
    eng = PipelineEngine(tm, stages=2, microbatches=2, max_seq=64, prefill_chunk=8,
                         device="cpu", decode_block=4, stage_graphs=True)
    views = eng.stage_models
    assert len({id(v) for v in views}) == 2 and all(v is not tm for v in views)
    assert [v.inv_freq.device for v in views] == eng.stage_devices
    tables = [v.inv_freq for v in views]
    stage_of = {id(tm.layers[i]): s for s, (a, b) in enumerate(eng.stage_bounds)
                for i in range(a, b)}
    reads, inner = [], type(tm).layer_attn_inputs

    def spy(self, p, h, offset):
        reads.append((self, stage_of[id(p)], self.inv_freq))
        return inner(self, p, h, offset)

    monkeypatch.setattr(type(tm), "layer_attn_inputs", spy)
    assert [t for t, _ in eng.generate_step(prompt, max_tokens=6)] == ref
    items, _ = serve_on_this_thread(ContinuousBatcher(eng, decode_block=4),
                                    [(prompt, dict(max_tokens=6))])
    assert [t for t, _ in items[0]] == ref
    assert {s for _, s, _ in reads} == {0, 1}
    assert all(view is views[s] and table is tables[s] for view, s, table in reads)


# ------------------------------------------------------------- the split
def test_stage_split_carries_jax_per_stage_tensors():
    """The weights each stage runs are JAX's split of the same tree
    (``split_stage_stacks``: DeepSeek's dense and MoE groups, the padded
    rows masked off), carried across by ``convert.py``: every real row of
    JAX's stage s equals the port's layer of that stage, which is the
    model's own module (the stages are slices of one layer list), and the
    split adds no weight bytes."""
    from mlx_sharding_tpu_torch.convert import _LAYER_NAMES

    jm, params, tm = _deepseek(7)
    bounds = [(0, 3), (3, 4)]
    split, masks, _ = jpipeline.split_stage_stacks(jm, params["layers"], bounds)
    eng = PipelineEngine(tm, stage_bounds=bounds, device="cpu")
    cache = eng.init_cache()
    checked = 0
    for s, (lo, hi) in enumerate(bounds):
        layers = [(i, layer) for i, layer, _, _ in eng._stage_layers(cache, s)]
        assert [i for i, _ in layers] == list(range(lo, hi))
        assert all(layer is tm.layers[i] for i, layer in layers)
        for group, (g0, g1) in jm.layer_group_ranges().items():
            first = max(lo, g0)
            for r in np.flatnonzero(np.asarray(masks[group][s])):
                for name, stack in split[group].items():
                    ours, transpose = _LAYER_NAMES[name]
                    want = np.asarray(stack[s][r])
                    got = tm.layers[first + r].get_parameter(ours).numpy()
                    np.testing.assert_array_equal(got, np.swapaxes(want, -1, -2) if transpose
                                                  else want)
                    checked += 1
    assert checked > 4 * 10
    assert (tpipeline.place_weights(tm, stage_bounds=bounds, device="cpu").weight_bytes
            == tpipeline.place_weights(tm, device="cpu").weight_bytes)


def test_resident_weights_carry_the_split():
    """``place_weights`` at S > 1 (JAX's): a ``ResidentWeights`` with the
    split and each stage's device, which an engine adopts with its own
    caches; bounds that disagree raise JAX's error."""
    _, _, tm = _llama(layers=4)
    w = tpipeline.place_weights(tm, stages=2, device="cpu")
    assert w.stage_bounds == ((0, 2), (2, 4)) and [str(d) for d in w.devices] == ["cpu"] * 2
    eng = PipelineEngine(tm, weights=w, device="cpu", max_seq=32, prefill_chunk=8)
    assert eng.stage_bounds == [(0, 2), (2, 4)] and eng.weights_shared
    with pytest.raises(ValueError, match="disagree with the resident tree's split"):
        PipelineEngine(tm, weights=w, stage_bounds=[(0, 1), (1, 4)], device="cpu")
    with pytest.raises(ValueError, match="2 stage bounds for a 3-stage pp mesh"):
        PipelineEngine(tm, stage_bounds=[(0, 1), (1, 4)], stages=3, device="cpu")


@pytest.mark.parametrize("stages", range(1, 9))
def test_balanced_bounds_equal_jax(stages):
    """``balanced_stage_bounds`` equals JAX's for every layer count up to
    40 at this stage count, and the engine takes them by default."""
    for layers in range(stages, 41):
        assert (tpipeline.balanced_stage_bounds(layers, stages)
                == jpipeline.balanced_stage_bounds(layers, stages))


@pytest.mark.parametrize("bounds,match", [
    ([(0, 3), (4, 8)], "must be contiguous"),
    ([(0, 3), (3, 7)], "must cover all layers"),
    ([(0, 4), (4, 4), (4, 8)], "contain an empty stage"),
])
def test_bad_bounds_raise_jax_errors(bounds, match):
    jm, params, tm = _llama()
    with pytest.raises(ValueError, match=match):
        jpipeline.split_stage_stacks(jm, params["layers"], bounds)
    with pytest.raises(ValueError, match=match):
        PipelineEngine(tm, stage_bounds=bounds, device="cpu")


# ----------------------------------------------------- pp = 1 only in JAX
GEOMETRY = dict(microbatches=3, max_seq=64, prefill_chunk=8)
POOL = dict(pool_pages=12, page_size=8)


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


def test_what_jax_allows_only_at_pp1_raises(llama4):
    """Ragged decode, a KV share map, speculation in the batcher (n-gram or
    a draft engine) raise JAX's errors at pp = 2; tensor parallelism runs
    at pp = 2 (on ``gather``), and expert parallelism over a model without
    experts raises JAX's error (tp and ep: ``tests/test_torch_tp.py``,
    ``tests/test_torch_expert_parallel.py``). The spill tier,
    the prefix store and page-block moves run at pp = 2
    (``tests/test_torch_pipeline_kv.py``, ``tests/test_torch_pipeline_fleet.py``)."""
    from mlx_sharding_tpu_torch.kv_share import KVShareMap

    _, _, tm = llama4
    with pytest.raises(ValueError, match="needs a paged \\(pool_pages\\) pp=1 engine"):
        PipelineEngine(tm, stages=2, device="cpu", paged_attention="ragged", **GEOMETRY, **POOL)
    identity = KVShareMap.identity(4)
    with pytest.raises(ValueError, match="kv_share_map requires a pp=1 engine"):
        PipelineEngine(tm, stages=2, device="cpu", kv_share_map=identity, **GEOMETRY, **POOL)
    eng = PipelineEngine(tm, stages=2, device="cpu", **GEOMETRY, **POOL)
    with pytest.raises(ValueError, match="needs a pp=1 engine"):
        ContinuousBatcher(eng, draft="ngram")
    with pytest.raises(ValueError, match="needs pp=1 engines"):
        ContinuousBatcher(PipelineEngine(tm, stages=2, device="cpu", **GEOMETRY),
                          draft_engine=PipelineEngine(tm, device="cpu", **GEOMETRY))
    tp2 = PipelineEngine(tm, stages=2, tp=2, device="cpu", **GEOMETRY, **POOL)
    assert (tp2.shards, tp2.paged_attention) == (2, "gather")
    with pytest.raises(ValueError, match="expert parallelism is not wired for LlamaModel"):
        PipelineEngine(tm, stages=2, ep=2, device="cpu", **GEOMETRY)
