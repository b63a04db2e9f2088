"""The port's continuous batcher over the paged pool against the JAX
package's ``ContinuousBatcher`` on a ``pipeline_mesh(1)`` ragged engine,
with the same weights (the tiny config of ``tests/test_paged_attention.py``:
2 layers, hidden 32, Hq 4 / Hkv 2, chunk 8, page 8, pool 10, f32): greedy
streams token-identical for the f32 and the int8 pool on a mixed-length
run whose prompts straddle page boundaries; the batched sampler's
transforms exactly equal; admission, capacity errors, ``close()`` and the
refusals of what is not yet ported."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import generate as jgenerate
from mlx_sharding_tpu import sample as jsample
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.ops.rope import apply_rope as j_apply_rope
from mlx_sharding_tpu.parallel.mesh import make_mesh, pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch import generate, sample, scheduler
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.ops.rope import apply_rope
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(microbatches=3, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
# prompts mid-page, on a page edge, and over two and three pages; with 3
# slots and 10 pages some requests wait for pages
JOBS = [
    (3, dict(max_tokens=6)),
    (8, dict(max_tokens=9)),
    (13, dict(max_tokens=12, repetition_penalty=1.3, repetition_context_size=6)),
    (17, dict(max_tokens=15)),
    (9, dict(max_tokens=18, logit_bias={5: 2.0, 17: -1.0})),
    (24, dict(max_tokens=21)),
]


def _jobs():
    rng = np.random.default_rng(7)
    return [([int(t) for t in rng.integers(1, 300, size=n)], kw) for n, kw in JOBS]


@pytest.fixture(scope="module")
def models():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _jax_engine(models, kv_dtype=None):
    jm, params, _ = models
    return JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                           paged_attention="ragged", kv_dtype=kv_dtype, **ENGINE)


def _engine(models, kv_dtype=None, **kw):
    return PipelineEngine(models[2], kv_dtype=kv_dtype, device="cpu", **{**ENGINE, **kw})


def _concurrent(batcher, jobs, logprobs=False):
    results = [None] * len(jobs)

    def work(i, prompt, kw):
        out = batcher.generate_step(prompt, want_logprobs=logprobs, **kw)
        results[i] = [item if logprobs else item[0] for item in out]

    threads = [threading.Thread(target=work, args=(i, p, kw)) for i, (p, kw) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    return results


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX batcher's greedy streams of ``JOBS`` for each pool, and one
    JAX batcher (f32 pool) kept open for the error-message tests."""
    streams = {}
    for kv in (None, "int8"):
        jb = jscheduler.ContinuousBatcher(_jax_engine(models, kv), decode_block=3)
        try:
            streams[kv] = _concurrent(jb, _jobs())
        finally:
            jb.close()
    return streams


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_greedy_streams_token_identical_to_jax(models, jax_streams, kv_dtype):
    batcher = ContinuousBatcher(_engine(models, kv_dtype), decode_block=3)
    try:
        got = _concurrent(batcher, _jobs())
    finally:
        batcher.close()
    assert got == jax_streams[kv_dtype]
    assert [len(s) for s in got] == [kw["max_tokens"] for _, kw in JOBS]
    assert batcher.page_waits >= 1  # the pool held some requests back
    assert batcher.pages_high_water <= ENGINE["pool_pages"]


def test_logprobs_match_jax(models):
    """Chosen and top-10 summaries of every token, the first (from the
    prefill logits) included."""
    prompt, kw = _jobs()[3]
    want = []
    jb = jscheduler.ContinuousBatcher(_jax_engine(models), decode_block=3)
    try:
        for tok, lp in jb.generate_step(prompt, want_logprobs=True, **kw):
            if not isinstance(lp, jgenerate.TokenLogprobs):  # the first token's (1, V) row
                row = np.asarray(lp)[0]
                top = np.argsort(-row, kind="stable")[:10]
                lp = jgenerate.TokenLogprobs(float(row[tok]), top, row[top])
            want.append((tok, lp))
    finally:
        jb.close()
    batcher = ContinuousBatcher(_engine(models), decode_block=3)
    try:
        got = list(batcher.generate_step(prompt, want_logprobs=True, **kw))
    finally:
        batcher.close()
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g.chosen - w.chosen) < 1e-4
        np.testing.assert_array_equal(g.top_indices, w.top_indices)
        np.testing.assert_allclose(g.top_values, w.top_values, rtol=1e-4, atol=1e-4)


def test_seeded_sample_same_alone_and_interleaved(models):
    """A sampled row draws from its slot's own generator, seeded when its
    prefill completes: the same tokens alone and among other requests."""
    seeded = ([int(t) for t in np.random.default_rng(1).integers(1, 300, size=19)],
              dict(max_tokens=14, temperature=0.9, top_p=0.8, seed=5))
    batcher = ContinuousBatcher(_engine(models), decode_block=3)
    try:
        alone = _concurrent(batcher, [seeded])[0]
        mixed = _concurrent(batcher, _jobs()[:3] + [seeded])[-1]
    finally:
        batcher.close()
    assert len(alone) == 14 and mixed == alone


def _request(mod, n_prompt, max_tokens):
    sp = (mod.make_sampler_params(device="cpu") if mod is scheduler
          else jsample.make_sampler_params())
    return mod._Request(prompt=np.arange(1, n_prompt + 1), sp=sp, seed=0,
                        max_tokens=max_tokens, rep_context=20)


@pytest.mark.parametrize("policy,want_slots", [("fifo", [0, -1, -1]), ("first_fit", [0, -1, 1])])
def test_admission_policy_under_a_small_pool(models, policy, want_slots):
    """7 pages, then 5 that do not fit the 3 left, then 2 that do: fifo
    holds the line behind the 5, first_fit lets the 2 pass (the 5 keeps its
    place). When the first finishes, its pages admit the rest. The JAX
    batcher does the same."""
    port = ContinuousBatcher(_engine(models), policy=policy)
    jax_b = jscheduler.ContinuousBatcher(_jax_engine(models), policy=policy)
    for mod, b in ((scheduler, port), (jscheduler, jax_b)):
        reqs = [_request(mod, 40, 10), _request(mod, 30, 8), _request(mod, 5, 5)]
        b._waiting.extend(reqs)
        b._admit_waiting()
        assert [r.slot for r in reqs] == want_slots, mod.__name__
        b._finish(reqs[0])
        b._admit_waiting()
        assert sorted(r.slot for r in reqs[1:]) == [0, 1] and not b._waiting, mod.__name__
    assert port.page_waits == 1


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [
    dict(prompt=60, max_tokens=10),  # past max_seq
    dict(prompt=20, max_tokens=40, pool_pages=6),  # more pages than the pool
    dict(prompt=4, max_tokens=4, logit_bias={i: 1.0 for i in range(513)}),
    dict(prompt=4, max_tokens=4, repetition_penalty=1.1, repetition_context_size=65),
], ids=["capacity", "pool", "bias_width", "window"])
def test_rejections_match_jax(models, kw):
    """Rejected on the calling thread, before any request state exists,
    with the JAX batcher's message."""
    kw = dict(kw)
    pool = kw.pop("pool_pages", ENGINE["pool_pages"])
    prompt = list(range(1, kw.pop("prompt") + 1))
    jm, params, _ = models
    jax_b = jscheduler.ContinuousBatcher(JPipelineEngine(
        jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, paged_attention="ragged",
        **{**ENGINE, "pool_pages": pool}))
    port = ContinuousBatcher(_engine(models, pool_pages=pool))
    want = _error(lambda: jax_b.generate_step(prompt, **kw))
    assert _error(lambda: port.generate_step(prompt, **kw)) == want
    assert port._thread is None and port._submit.empty()


def test_close_ends_every_stream(models):
    """A request decoding and one waiting for pages both end when the
    batcher closes; no consumer blocks."""
    batcher = ContinuousBatcher(_engine(models, microbatches=1), decode_block=2)
    running = batcher.generate_step(list(range(1, 10)), max_tokens=50)
    assert isinstance(next(running)[0], int)
    waiting = batcher.generate_step(list(range(1, 5)), max_tokens=4)
    out = {}
    threads = [threading.Thread(target=lambda k=k, it=it: out.__setitem__(k, list(it)))
               for k, it in (("running", running), ("waiting", waiting))]
    for t in threads:
        t.start()
    batcher.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(out["running"]) < 49 and out["waiting"] == []


@pytest.mark.parametrize("kw", [
    # every option this test once saw refused as not yet ported is ported:
    # the spill tier, cold-slot spill and prefetch, and the prefix store
    # (tests/test_torch_kv_residency.py, tests/test_torch_prefix_store.py);
    # async ticks, overcommit, a draft engine, prefix sharing, the queue
    # bound and n-gram speculation before them
    dict(spill_cold_after=4),
    dict(spill_bytes=1 << 20), dict(kv_prefetch="on"),
    dict(prefix_store="store"),
])
def test_unported_batcher_options_raise(models, kw):
    """Each option is taken, or refused with the JAX batcher's message where
    what it needs is missing (a cold threshold or prefetch without a spill
    tier)."""
    if "spill_cold_after" in kw or "kv_prefetch" in kw:
        with pytest.raises(ValueError) as want:
            jscheduler.ContinuousBatcher(_jax_engine(models), **kw)
        with pytest.raises(ValueError, match="spill tier") as got:
            ContinuousBatcher(_engine(models), **kw)
        assert str(got.value) == str(want.value)
        return
    if "prefix_store" in kw:
        from mlx_sharding_tpu_torch.prefix_store import PrefixStore

        batcher = ContinuousBatcher(_engine(models), prefix_store=PrefixStore())
        assert batcher.prefix_store.page_size == ENGINE["page_size"]
    else:
        batcher = ContinuousBatcher(_engine(models), **kw)
        assert batcher.spill.budget_bytes == kw["spill_bytes"]
    batcher.close()


def test_a_dense_draft_engine_is_taken(models):
    """A draft engine (a dense engine of the same slots and chunk) is taken
    beside the paged target: engine-mode speculation, fixed ``spec_k``
    rounds, sync ticks, its own slot caches."""
    draft = PipelineEngine(models[2], microbatches=3, max_seq=64, prefill_chunk=8, device="cpu")
    batcher = ContinuousBatcher(_engine(models), draft_engine=draft, spec_k=3)
    assert batcher.draft is draft and batcher._spec_mode == "engine" and not batcher._async
    assert batcher.spec_stats()["window_max"] == 3 and batcher.spec_tracker is None
    assert batcher.dcache.k.shape[1] == 4  # three slots and the scratch slot


def test_auto_async_resolves_to_sync_and_says_why(models):
    """``auto`` resolves as the JAX rule does: with no draft engine and one
    host it is async; ``off`` is sync. Each says why."""
    batcher = ContinuousBatcher(_engine(models))
    assert batcher.async_sched == "auto" and batcher._async
    assert batcher.async_reason.startswith("async ticks: auto resolved to async")
    off = ContinuousBatcher(_engine(models), async_sched="off")
    assert not off._async and off.async_reason == "sync ticks: async_sched='off'"
    assert off.tick_timing_stats()["path"] == "sync"


@pytest.mark.parametrize("kw,match", [
    (dict(ep=2), "expert parallelism is not wired for LlamaModel"),
    (dict(tp=2), None),
])
def test_unported_engines_raise(models, kw, match):
    """Tensor and expert parallelism are ported (``tests/test_torch_tp.py``,
    ``tests/test_torch_expert_parallel.py``): ep over a model without
    experts raises JAX's error, and a tp = 2 engine builds as JAX's does,
    on the ``gather`` path (ragged needs tp = ep = 1)."""
    jm, params, _ = models
    mesh = make_mesh(**kw)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            JPipelineEngine(jm, params, mesh, cache_dtype=jnp.float32, **ENGINE)
        with pytest.raises(ValueError, match=match):
            _engine(models, **kw)
        return
    jeng = JPipelineEngine(jm, params, mesh, cache_dtype=jnp.float32, **ENGINE)
    eng = _engine(models, **kw)
    assert (eng.shards, eng.paged_attention, eng.decode_path) == (2, jeng.paged_attention,
                                                                  "gather")


@pytest.mark.parametrize("kw,path", [(dict(pool_pages=None), "dense"),
                                     (dict(paged_attention="gather"), "gather")])
def test_dense_and_gather_engines_build_as_jax_resolves_them(models, kw, path):
    """No pool gives the dense slot engine, ``gather`` the contiguous-view
    path of the paged one: both build, with JAX's ``paged`` and
    ``paged_attention``."""
    jm, params, _ = models
    jeng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                           **{**ENGINE, **kw})
    eng = _engine(models, **kw)
    assert (eng.paged, eng.paged_attention) == (jeng.paged, jeng.paged_attention)
    assert eng.decode_path == path


@pytest.mark.parametrize("kw", [dict(page_size=12), dict(page_size=16, max_seq=40),
                                dict(kv_dtype="fp8"), dict(paged_attention="fast")])
def test_engine_checks_match_jax(models, kw):
    jm, params, _ = models
    kv = kw.pop("kv_dtype", None)
    want = _error(lambda: JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                                          kv_dtype=kv, **{**ENGINE, **kw}))
    assert _error(lambda: _engine(models, kv, **kw)) == want


# -------------------------------------------------- the batched step's parts
def _sampler_rows():
    return [dict(), dict(repetition_penalty=1.3, logit_bias={3: 2.5, 7: -1.0}),
            dict(repetition_penalty=0.7, logit_bias={3: 1.0}, temperature=0.6, top_p=0.5)]


def test_batched_transforms_equal_jax():
    """Per-row bias, repetition penalty over a window masked to each row's
    size, temperature and top-p: bit for bit."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    recent = rng.integers(0, 40, size=(3, 8))
    recent[0, :3] = -1
    sizes = [8, 5, 2]
    rows = _sampler_rows()
    jsp = jsample.stack_sampler_params([jsample.make_sampler_params(**r) for r in rows])
    tsp = sample.stack_sampler_params([sample.make_sampler_params(device="cpu", **r)
                                       for r in rows], device="cpu")
    valid = np.arange(8)[None, :] >= (8 - np.asarray(sizes))[:, None]
    mask = sample.window_mask(8, sizes, "cpu")
    np.testing.assert_array_equal(mask.numpy(), valid)
    want = jsample.transform_logits_batched(jnp.asarray(logits),
                                            jnp.asarray(np.where(valid, recent, -1)), jsp)
    got = sample.transform_logits_batched(torch.from_numpy(logits),
                                          torch.where(mask, torch.from_numpy(recent), -1), tsp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sample.nucleus_logits_batched(got, tsp).numpy(),
                                  np.asarray(jsample.nucleus_logits_batched(want, jsp)))


def test_set_sampler_slot_matches_jax():
    rows = _sampler_rows()
    tsp = sample.stack_sampler_params([sample.make_sampler_params(device="cpu")] * 3,
                                      device="cpu")
    jsp = jsample.stack_sampler_params([jsample.make_sampler_params(min_bias_slots=512)] * 3)
    sample.set_sampler_slot(tsp, 1, sample.make_sampler_params(device="cpu", **rows[2]))
    jsp = jsample.set_sampler_slot(jsp, 1, jsample.make_sampler_params(**rows[2]))
    assert tsp.temperature == pytest.approx(np.asarray(jsp.temperature).tolist())
    assert tsp.top_p == pytest.approx(np.asarray(jsp.top_p).tolist())
    np.testing.assert_array_equal(tsp.repetition_penalty[:, 0].numpy(),
                                  np.asarray(jsp.repetition_penalty))
    np.testing.assert_array_equal(tsp.bias_indices.numpy(), np.asarray(jsp.bias_indices))
    np.testing.assert_array_equal(tsp.bias_values.numpy(), np.asarray(jsp.bias_values))
    # JAX counts its power-of-two buffer (1024), the port the entries (513)
    with pytest.raises(ValueError, match="exceeds the scheduler's per-slot bias width 512"):
        sample.set_sampler_slot(tsp, 0, sample.make_sampler_params(
            device="cpu", logit_bias={i: 1.0 for i in range(513)}))


def test_rope_at_per_row_offsets_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1, 2, 16)).astype(np.float32)
    inv = (1.0 / 10000 ** (np.arange(0, 16, 2) / 16)).astype(np.float32)
    offsets = np.asarray([0, 7, 8, 63], np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(inv), jnp.asarray(offsets))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(inv), torch.from_numpy(offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # an int offset and a tensor of equal offsets agree
    same = apply_rope(torch.from_numpy(x), torch.from_numpy(inv), torch.full((4,), 7))
    torch.testing.assert_close(same, apply_rope(torch.from_numpy(x), torch.from_numpy(inv), 7))


def test_block_token_logprobs_reads_the_slot_row():
    rng = np.random.default_rng(4)
    outs = (rng.integers(0, 9, (2, 3)), rng.standard_normal((2, 3)),
            rng.standard_normal((2, 3, 10)), rng.integers(0, 9, (2, 3, 10)))
    got, want = generate.block_token_logprobs(outs, 1, 2), jgenerate.block_token_logprobs(outs, 1, 2)
    assert got.chosen == want.chosen
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_array_equal(got.top_values, want.top_values)
