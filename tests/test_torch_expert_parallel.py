"""Expert parallelism in the port against the JAX package, on the CPU in
f32 (the cases of ``tests/test_expert_parallel.py``): the top-level
``expert_parallel_apply`` at ep = 2 and 4 and its uneven refusal, the
experts' ep branch inside a shard program (``apply_experts(...,
ep_axis=...)`` run over the shards by ``parallel.mesh.run_shards``), the
expert stacks' shards bit-equal to JAX's, and the engine's greedy streams
of Mixtral at ep = 2, tp2 x ep2 and tp = 2 and DeepSeek-V2 at tp2 x ep2, token-identical to JAX's engine on the same mesh; the
continuous batcher at ep = 2 against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops.moe import apply_experts as japply
from mlx_sharding_tpu.ops.moe import mixtral_routing as jrouting
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel.expert_parallel import expert_parallel_apply as jep_apply
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu_torch.ops.moe import apply_experts
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.parallel.expert_parallel import expert_parallel_apply
from mlx_sharding_tpu_torch.parallel.mesh import ShardAxis, run_shards
from tests.test_torch_families import jax_pair, port
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401
from tests.test_torch_tp import _check_shards, _deepseek, _jax_stream, _port_stream, \
    assert_streams_match

N, H, I, E, K = 32, 16, 24, 8, 2


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, H)).astype(np.float32)
    router = rng.normal(size=(H, E)).astype(np.float32)
    wg, wu = (rng.normal(size=(E, H, I)).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.normal(size=(E, I, H)).astype(np.float32) * 0.1
    weights, idx = jrouting(jnp.asarray(x), jnp.asarray(router), K)
    ref = np.asarray(japply(jnp.asarray(x), weights, idx, jnp.asarray(wg), jnp.asarray(wu),
                            jnp.asarray(wd)))
    # the port's stacks are (E, OUT, IN)
    port_stacks = [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))
                   for w in (wg, wu, wd)]
    return (x, router, (wg, wu, wd), weights, idx, ref,
            torch.from_numpy(x), torch.from_numpy(np.array(weights)),
            torch.from_numpy(np.array(idx)), port_stacks)


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_matches_jax(ep):
    """``expert_parallel_apply`` over ep shards equals JAX's over
    ``make_mesh(ep=ep)`` and the one-device experts."""
    x, _, (wg, wu, wd), weights, idx, ref, tx, tw, ti, stacks = _inputs()
    want = np.asarray(jep_apply(jnp.asarray(x), weights, idx, jnp.asarray(wg), jnp.asarray(wu),
                                jnp.asarray(wd), make_mesh(ep=ep)))
    got = expert_parallel_apply(tx, tw, ti, *stacks, ep=ep, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_expert_parallel_rejects_uneven():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="6 experts not divisible over ep=4"):
        expert_parallel_apply(x, torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.int32),
                              torch.zeros(6, 8, 8), torch.zeros(6, 8, 8), torch.zeros(6, 8, 8),
                              ep=4, device="cpu")


def test_apply_experts_ep_branch_over_shards():
    """The ep branch of ``apply_experts`` inside a shard program: each of
    two shards scans its own experts (``idx - base``) over every token and
    one psum over ep combines, equal to the one-device experts."""
    *_, ref, tx, tw, ti, stacks = _inputs()
    programs = [apply_experts(tx, tw, ti, *(w[r * E // 2 : (r + 1) * E // 2] for w in stacks),
                              ep_axis=ShardAxis("ep", r, 2)) for r in range(2)]
    outs = run_shards(programs, {"ep": [[0, 1]]})
    for out in outs:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_expert_stack_shards_bit_equal_jax():
    """Mixtral placed at tp2 x ep2: the expert stacks split their E dim over
    ep (ep overrides tp for them), the attention over tp; every port shard
    is JAX's addressable shard."""
    cfg, jm, params = jax_pair("mixtral")
    jeng = jpipeline.place_weights(jm, params, make_mesh(tp=2, ep=2))
    eng = PipelineEngine(port(cfg, params), tp=2, ep=2, max_seq=64, prefill_chunk=8,
                         device="cpu")
    assert eng.shard_views[0][2].layers[0].w_gate.weight.shape[0] == 2  # shard (ep 1, tp 0)
    _check_shards(jeng, eng, ["q_proj", "o_proj"])
    for r, view in enumerate(eng.shard_views[0]):
        e = r // 2
        want = np.asarray(params["layers"]["w_gate"][:, 2 * e : 2 * e + 2])  # (L, E/2, in, out)
        for j, layer in enumerate(view.layers):
            np.testing.assert_array_equal(layer.w_gate.weight.transpose(-1, -2).numpy(), want[j])


@pytest.mark.parametrize("mesh", ["ep2", "tp2_ep2", "tp2"])
def test_mixtral_streams_match_jax(mesh):
    """Mixtral's greedy stream at ep = 2, tp2 x ep2 and tp = 2 (the
    experts' intermediate split over tp) against JAX's engine."""
    cfg, jm, params = jax_pair("mixtral")
    kw = {"ep2": dict(ep=2), "tp2_ep2": dict(tp=2, ep=2), "tp2": dict(tp=2)}[mesh]
    prompt = [9, 4, 120, 33, 5, 17]
    assert_streams_match(_port_stream(port(cfg, params), prompt, **kw),
                         _jax_stream(jm, params, prompt, **kw))


def test_deepseek_tp2_ep2_matches_jax():
    """DeepSeek-V2 at tp2 x ep2: the routed stacks over ep (made whole
    inside the experts), only the shared experts' partials summed over
    tp."""
    jm, params, tm = _deepseek("full")
    prompt = [5, 88, 2, 61]
    assert_streams_match(_port_stream(tm, prompt, tp=2, ep=2),
                         _jax_stream(jm, params, prompt, tp=2, ep=2))


def test_ep_unsupported_arch_raises():
    cfg, _, params = jax_pair("qwen3")
    with pytest.raises(ValueError, match="expert parallelism is not wired for Qwen3Model"):
        PipelineEngine(port(cfg, params), ep=2, max_seq=64, prefill_chunk=8, device="cpu")


def test_ep2_continuous_batching_matches_jax():
    """The batcher over Mixtral at ep = 2 on a page pool (the gather path)
    against JAX's batcher over its ep = 2 engine, driven tick by tick."""
    from mlx_sharding_tpu import scheduler as jscheduler
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from tests.test_torch_pipeline_batcher import _drive

    cfg, jm, params = jax_pair("mixtral")
    kw = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
    jobs = [([5, 9, 2, 7, 11], dict(max_tokens=7)), ([3, 17, 42], dict(max_tokens=9))]
    jeng = jpipeline.PipelineEngine(jm, params, make_mesh(ep=2), cache_dtype=jnp.float32, **kw)
    want = _drive(jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off"), jobs)
    eng = PipelineEngine(port(cfg, params), ep=2, device="cpu", **kw)
    assert eng.paged_attention == jeng.paged_attention == "gather"
    assert _drive(ContinuousBatcher(eng, decode_block=3), jobs) == want
