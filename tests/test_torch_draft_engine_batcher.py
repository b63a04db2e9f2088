"""The port's batched draft engine (``ContinuousBatcher(draft_engine=...)``,
a dense ``PipelineEngine`` of a small model beside the target's slots)
against the JAX package's batcher with ``draft_engine``, with the same
weights, both driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), every request submitted first.

The target is the tiny Llama of ``tests/test_torch_scheduler.py`` (2 layers,
hidden 32, 3 slots, capacity 64, chunk 8, decode blocks of 3, f32) over
dense slot caches; the draft is its first layer (with its embedding and
head: some proposals are accepted and most rejected, so rounds emit from 1
to K tokens), a dense engine of the same slots. The pair checks build a
one-layer draft of another seed too. Each JAX program serves short runs
(its compiles are most of the file's time). Tolerances: greedy
streams token-identical and ``spec_stats()`` equal; the sampled proposals'
log-distributions within 1e-5 of JAX's at the same logits (their draws
equal JAX's in distribution only, so a seeded sampled stream is held to
itself across runs); the pair checks' messages equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import sample as jsample
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch import cache
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.sample import make_sampler_params, set_sampler_slot
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_scheduler import ENGINE, TINY, models  # noqa: F401

DENSE = {k: v for k, v in ENGINE.items() if k not in ("pool_pages", "page_size")}
QLP_TOL = 1e-5
REPEAT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps run on one torch thread in this module: under
    the test run's several workers, a thread pool per small op contends for
    the cores and multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JAX: dict = {}


def _jax_engine(key, jm, params, **kw):
    """One JAX engine per (model, geometry) for the module."""
    if key not in _JAX:
        _JAX[key] = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, **kw)
    return _JAX[key]


@pytest.fixture(scope="module")
def drafts(models):
    """``{name: (JAX model, JAX params, port model)}`` of the drafts: the
    target's first layer, and (for the pair checks) a one-layer model of
    another seed."""
    jm, params, _ = models
    cfg = LlamaConfig(**dict(TINY, num_hidden_layers=1))
    djm = JLlamaModel(cfg)
    out = {}
    for name, dparams in (
            ("first_layer", dict(params, layers=jax.tree.map(lambda x: x[:1], params["layers"]))),
            ("other_seed", djm.init_params(jax.random.PRNGKey(5), jnp.float32))):
        out[name] = (djm, dparams, params_from_numpy(cfg, jax.tree.map(np.asarray, dparams),
                                                     device="cpu"))
    return out


def _clock():
    """A fake speculation clock, a quarter second a read."""
    n = iter(range(10**6))
    return lambda: 0.25 * next(n)


def _pair(models, drafts, draft, pool, **kw):
    """The JAX and the port batchers of one (draft, target geometry), each
    with its own fake speculation clock."""
    jm, params, tm = models
    djm, dparams, dtm = drafts[draft]
    geometry = dict(ENGINE) if pool else DENSE
    jb = jscheduler.ContinuousBatcher(
        _jax_engine(("target", pool), jm, params, **geometry), decode_block=3,
        draft_engine=_jax_engine(draft, djm, dparams, **DENSE), spec_clock=_clock(), **kw)
    port = ContinuousBatcher(PipelineEngine(tm, device="cpu", **geometry), decode_block=3,
                             draft_engine=PipelineEngine(dtm, device="cpu", **DENSE),
                             spec_clock=_clock(), **kw)
    return jb, port


def _drive(batcher, jobs):
    tick = batcher._tick if isinstance(batcher, jscheduler.ContinuousBatcher) else None
    items, _ = serve_on_this_thread(batcher, jobs, tick=tick)
    return items


def _tokens(items):
    return [[t for t, _ in s] for s in items]


def test_greedy_streams_and_stats_match_jax(models, drafts):
    """Three greedy requests (prompts of 3-11 tokens, one of them
    repetitive) with 3-token rounds: token-identical streams, equal to
    plain greedy decode, and equal ``spec_stats()`` (rounds, accepted
    tokens, the accept rate); some proposals accepted, most rejected."""
    jobs = [(REPEAT, dict(max_tokens=12)), ([3, 17, 42], dict(max_tokens=8)),
            ([9, 1, 9, 1, 9, 1, 9], dict(max_tokens=10))]
    jb, port = _pair(models, drafts, "first_layer", False, spec_k=3)
    want = _tokens(_drive(jb, jobs))
    got = _tokens(_drive(port, jobs))
    assert got == want
    plain = ContinuousBatcher(PipelineEngine(models[2], device="cpu", **DENSE), decode_block=3)
    assert got == _tokens(_drive(plain, jobs))
    st = port.spec_stats()
    assert st == jb.spec_stats()
    assert st["mode"] == "engine" and st["window_max"] == 3 and st["rounds"] > 0
    # some proposals accepted (a round emits more than its correction), most not
    assert st["rounds"] < st["accepted_tokens"] < st["draft_tokens"]
    assert port.verify_ticks > 0 and not port._async and port.fallback_ticks == 0


def test_fallback_tick_replays_the_block_into_the_draft(models, drafts):
    """A logprobs request pauses speculation: those ticks run plain blocks
    and feed the chain they consumed through the draft's caches, counted in
    ``fallback_ticks`` and ``replayed_tokens`` as JAX counts them. The
    streams, the summaries and the acceptance after the pause equal JAX's
    (a wrong replay would leave the draft attending stale rows)."""
    jobs = [(REPEAT, dict(max_tokens=16)), ([4, 8, 15, 16], dict(max_tokens=5,
                                                                want_logprobs=True))]
    jb, port = _pair(models, drafts, "first_layer", False, spec_k=3)
    want, got = _drive(jb, jobs), _drive(port, jobs)
    assert _tokens(got) == _tokens(want)
    for (_, g), (_, w) in zip(got[1][1:], want[1][1:]):
        assert abs(g.chosen - w.chosen) < 1e-4
        np.testing.assert_array_equal(g.top_indices, w.top_indices)
    st = port.spec_stats()
    assert st == jb.spec_stats()
    assert st["fallback_ticks"] >= 1 and st["replayed_tokens"] >= 3 * st["fallback_ticks"]


def test_sampled_proposals_match_jax_in_distribution(models, drafts):
    """Sampled slots: the draft's first proposal step yields the same
    transformed log-distribution q as JAX's ``spec_propose_cb`` (bias,
    penalty over the slot's window, temperature, top-p), on the same
    prefilled draft cache (the later steps draw, differently in each
    package); a seeded sampled stream repeats across runs."""
    djm, dparams, dtm = drafts["first_layer"]
    jeng = _jax_engine("first_layer", djm, dparams, **DENSE)
    peng = PipelineEngine(dtm, device="cpu", **DENSE)
    jc, pc, table = jeng.init_cache(), peng.init_cache(), cache.slot_table(3)
    prompts = {0: [5, 9, 2, 7, 11], 1: [3, 17, 42, 3]}
    for slot, prompt in prompts.items():
        chunk = np.pad(prompt, (0, 8 - len(prompt)))
        _, jc = jeng.prefill_slot()(
            jeng.layer_params, jeng.layer_masks, jeng.vocab_parts, jeng.shared_params,
            jnp.asarray(chunk[None], jnp.int32), jnp.asarray(slot, jnp.int32), jc,
            jnp.asarray(len(prompt), jnp.int32))
        peng.prefill_slot(chunk, slot, pc, len(prompt), table)
    rows = [dict(temperature=0.8, top_p=0.9, repetition_penalty=1.3, logit_bias={7: 2.0}),
            dict(temperature=0.6), dict()]
    active = [True, True, False]
    recent = np.full((3, 8), -1, np.int64)
    recent[0, -3:] = [5, 9, 2]
    recent[1, -2:] = [17, 42]
    tok = np.asarray([[7], [3], [0]])
    jsp = jsample.stack_sampler_params([jsample.make_sampler_params(**r) for r in rows])
    _, jq, _ = jeng.spec_propose_cb(3)(
        jeng.layer_params, jeng.layer_masks, jeng.vocab_parts, jeng.shared_params,
        jnp.asarray(tok, jnp.int32), jc, jnp.asarray(active), jnp.asarray(recent, jnp.int32),
        jnp.stack([jax.random.PRNGKey(1)] * 3), jsp, jnp.full((3,), 8, jnp.int32))
    batcher = ContinuousBatcher(PipelineEngine(models[2], device="cpu", **DENSE),
                                repetition_window=8)
    for slot, r in enumerate(rows):
        set_sampler_slot(batcher.sp, slot, make_sampler_params(device="cpu", **r))
    inputs = peng.device_inputs("p", table, active, pc.offsets, True)
    drafts_t, q = peng.spec_propose_cb(3)(
        torch.from_numpy(tok), pc, peng.device_plan(inputs.offsets.long(), inputs, 3),
        recent=torch.from_numpy(recent), generators=batcher.generators, sp=batcher.sp,
        rep_mask=batcher.rep_mask, sampled=True)
    assert drafts_t.shape == (3, 3) and q.shape == (3, 3, TINY["vocab_size"])
    for m in (0, 1):
        want = np.asarray(jq)[0, m]
        kept = want > -1e8  # the nucleus both keep
        np.testing.assert_array_equal(q[0, m].numpy() > -1e8, kept)
        np.testing.assert_allclose(q[0, m].numpy()[kept], want[kept], atol=QLP_TOL,
                                   rtol=QLP_TOL)
    jobs = [([9, 1, 9, 1, 9], dict(max_tokens=12, temperature=0.9, top_p=0.85, seed=321)),
            (REPEAT, dict(max_tokens=10))]
    runs = [_tokens(_drive(_pair(models, drafts, "first_layer", False, spec_k=3)[1], jobs))
            for _ in range(2)]
    assert runs[0] == runs[1] and [len(s) for s in runs[0]] == [12, 10]


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


PAIR_CHECKS = {
    "vocab": dict(vocab_size=320),
    "paged": dict(pool_pages=10, page_size=8),
    "slots": dict(microbatches=2),
    "chunk": dict(prefill_chunk=16),
    "capacity": dict(max_seq=32),
    "spec_k": dict(spec_k=0),
    "async_on": dict(async_sched="on"),
}


@pytest.mark.parametrize("case", sorted(PAIR_CHECKS))
def test_pair_checks_match_jax(models, drafts, case):
    """Each mismatch of the (target, draft) pair, a zero ``spec_k`` and
    ``async_sched='on'`` are refused with JAX's messages."""
    jm, params, tm = models
    djm, dparams, dtm = drafts["other_seed"]
    over = dict(PAIR_CHECKS[case])
    batcher_kw = {k: over.pop(k) for k in ("spec_k", "async_sched") if k in over}
    if "vocab_size" in over:
        cfg = LlamaConfig(**dict(TINY, num_hidden_layers=1, **over))
        djm = JLlamaModel(cfg)
        dparams = djm.init_params(jax.random.PRNGKey(5), jnp.float32)
        dtm = params_from_numpy(cfg, jax.tree.map(np.asarray, dparams), device="cpu")
        over = {}
    geometry = {**DENSE, **over}
    jdraft = JPipelineEngine(djm, dparams, pipeline_mesh(1), cache_dtype=jnp.float32, **geometry)
    want = _error(lambda: jscheduler.ContinuousBatcher(
        _jax_engine(("target", False), jm, params, **DENSE), draft_engine=jdraft, **batcher_kw))
    tdraft = PipelineEngine(dtm, device="cpu", **geometry)
    assert _error(lambda: ContinuousBatcher(PipelineEngine(tm, device="cpu", **DENSE),
                                            draft_engine=tdraft, **batcher_kw)) == want
