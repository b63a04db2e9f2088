"""The port's dense-slot batcher (an engine without a pool: M+1 slot caches)
and its ``gather`` decode path against the JAX package's batchers with the
same weights, both driven tick by tick on the test's thread
(``chip_smoke.serve_on_this_thread``), every request submitted first.

The tiny configs are those of ``tests/test_torch_scheduler.py`` (Llama: 2
layers, hidden 32, Hq 4 / Hkv 2, 3 slots, capacity 64, chunk 8, page 8,
pool 10, decode blocks of 3) and of ``tests/test_torch_deepseek_v2.py``
(DeepSeek-V2's compressed MLA cache). Each JAX engine serves one short run
(its compiles are most of the file's time). Tolerances: f32 greedy streams
must be token-identical; the first step's bf16 logits (a slot's prefill
chunk, whose last row gives the first token) within ``BF16_TOL`` of JAX's;
a device plan exactly equal to the host's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch import cache
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_deepseek_v2 import port
from tests.test_torch_families import FAMILIES, j_build_model
from tests.test_torch_graph_step import _assert_replayable, _record, tiny_models  # noqa: F401
from tests.test_torch_scheduler import ENGINE, _jobs, models  # noqa: F401

DENSE = {k: v for k, v in ENGINE.items() if k not in ("pool_pages", "page_size")}
# three of the mixed-length jobs: prompts of 3, 8 and 13 tokens (one
# penalised), 6-12 tokens each
JOBS = 3
#: bf16 logits of the port against JAX's, both in bf16 (absolute, on logits
#: of magnitude ~1: a few bf16 roundings of the activations)
BF16_TOL = 0.1


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


def _jax_engine(key, jm, params, dtype=jnp.float32, **kw):
    """One JAX engine per (model, geometry) for the module: its compiled
    programs serve every batcher built on it."""
    if key not in _JAX:
        _JAX[key] = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=dtype, **kw)
    return _JAX[key]


def _drive(batcher, jobs):
    tick = None
    if isinstance(batcher, jscheduler.ContinuousBatcher):
        tick = batcher._tick_async if batcher._async else batcher._tick
    items, _ = serve_on_this_thread(batcher, jobs, tick=tick)
    return [[t for t, _ in s] for s in items]


@pytest.fixture(scope="module")
def deepseek():
    """DeepSeek-V2's tiny f32 pair (``tests/test_torch_deepseek_v2.py``'s
    config) with the compressed MLA cache, its JAX weights drawn in one
    jitted program."""
    jm, cfg = j_build_model({**FAMILIES["deepseek_v2"], "mla_cache_mode": "compressed"})
    params = jax.jit(lambda key: jm.init_params(key, jnp.float32))(jax.random.PRNGKey(2))
    return jm, params, port(cfg, params)


@pytest.mark.parametrize("family", ["llama", "deepseek_v2"])
def test_dense_greedy_streams_match_jax(models, deepseek, family):
    """Three of the mixed-length jobs over 3 dense slots: the port's sync
    and async ticks each token-identical to JAX's dense batcher (whose
    sync and async streams are the same bits), with no page accounting."""
    jm, params, tm = models if family == "llama" else deepseek
    jobs = _jobs()[:JOBS]
    jb = jscheduler.ContinuousBatcher(_jax_engine(family, jm, params, **DENSE), decode_block=3,
                                      async_sched="off")
    want = _drive(jb, jobs)
    assert [len(s) for s in want] == [kw["max_tokens"] for _, kw in jobs]
    assert jb.page_stats() is None
    for sched in ("off", "auto"):
        batcher = ContinuousBatcher(PipelineEngine(tm, device="cpu", **DENSE), decode_block=3,
                                    async_sched=sched)
        assert batcher._async is (sched == "auto")
        assert _drive(batcher, jobs) == want, sched
        assert batcher.page_stats() is None and batcher.prefix_stats() is None
        assert all(r is None for r in batcher._slots)


def test_first_step_bf16_logits_match_jax(models):
    """bf16 weights and slot caches: the logits of two slots' prefill
    chunks (the second slot's written beside the first's), whose last row
    gives each request's first token, within ``BF16_TOL`` of JAX's dense
    ``prefill_slot``, with the same argmax."""
    jm, params32, _ = models
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params32)
    tm = params_from_numpy(jm.config, jax.tree.map(np.asarray, params), device="cpu")
    assert tm.dtype == torch.bfloat16
    jeng = _jax_engine("llama-bf16", jm, params, dtype=jnp.bfloat16, **DENSE)
    peng = PipelineEngine(tm, device="cpu", **DENSE)
    jc, pc, table = jeng.init_cache(), peng.init_cache(), cache.slot_table(3)
    for slot, prompt in ((0, [5, 9, 2, 7, 11]), (2, [3, 17, 42])):
        chunk = np.pad(prompt, (0, 8 - len(prompt)))
        want, jc = jeng.prefill_slot()(
            jeng.layer_params, jeng.layer_masks, jeng.vocab_parts, jeng.shared_params,
            jnp.asarray(chunk[None], jnp.int32), jnp.asarray(slot, jnp.int32), jc,
            jnp.asarray(len(prompt), jnp.int32))
        got = peng.prefill_slot(chunk, slot, pc, len(prompt), table).float().numpy()
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, atol=BF16_TOL)
        assert np.argmax(got) == np.argmax(want)
    assert pc.offsets == [5, 0, 3]


@pytest.mark.parametrize("path", ["dense", "gather"])
def test_live_slot_stream_does_not_depend_on_idle_slots(models, path):
    """A live slot's greedy tokens are the same alone, beside requests that
    finish early (their slots go idle mid-run, to length 0), and beside
    ones that outlast it."""
    tm = models[2]
    kw = DENSE if path == "dense" else dict(ENGINE, paged_attention="gather")
    long = ([9, 4, 4, 6, 1, 3, 8, 8, 2], dict(max_tokens=20))
    runs = [[long], [long, ([7, 7, 2], dict(max_tokens=2)), ([5], dict(max_tokens=4))],
            [([3, 1], dict(max_tokens=30)), long, ([2, 6, 6], dict(max_tokens=26))]]
    streams = []
    for jobs in runs:
        batcher = ContinuousBatcher(PipelineEngine(tm, device="cpu", **kw), decode_block=3)
        out = _drive(batcher, jobs)
        streams.append(out[jobs.index(long)])
    assert streams[0] == streams[1] == streams[2] and len(streams[0]) == 20


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["model_dtype_pool", "int8_pool"])
def test_gather_streams_match_jax(models, kv_dtype):
    """``paged_attention="gather"`` over a pool of 10 pages (three of the
    jobs, which need 11 pages at once: one waits): token-identical to JAX's gather batcher, and to the
    ragged path's for the unquantized pool (an int8 gather step attends its
    own row unquantized, as JAX's does, where the ragged one reads it back
    quantized)."""
    jm, params, tm = models
    kw = dict(ENGINE, paged_attention="gather", kv_dtype=kv_dtype)
    jobs = _jobs()[1:4]
    jb = jscheduler.ContinuousBatcher(_jax_engine(("gather", kv_dtype), jm, params, **kw),
                                      decode_block=3)
    want = _drive(jb, jobs)
    batcher = ContinuousBatcher(PipelineEngine(tm, device="cpu", **kw), decode_block=3)
    got = _drive(batcher, jobs)
    assert batcher.engine.decode_path == "gather" and batcher.page_waits >= 1
    assert got == want
    if kv_dtype is None:
        ragged = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3)
        assert _drive(ragged, jobs) == got
    total, in_use, high = batcher.page_stats()
    assert in_use == 0 and high <= total


REPEAT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]


def test_ngram_on_dense_slots_matches_jax(models):
    """N-gram speculation (windows of 2) over the dense slot caches,
    async ticks (the T=K
    verify writes its rows into the slot caches and attends them in place;
    the dense rewind is the offsets' move by each count, planned on the
    device while a round is in flight): streams and ``spec_stats()`` equal
    JAX's."""
    jm, params, tm = models
    jobs = [(REPEAT, dict(max_tokens=14)), ([3, 17, 42], dict(max_tokens=6)),
            (REPEAT[:8] * 2, dict(max_tokens=12, repetition_penalty=1.2,
                                  repetition_context_size=6))]

    def clock():
        n = iter(range(10**6))
        return lambda: 0.25 * next(n)

    jb = jscheduler.ContinuousBatcher(_jax_engine("llama", jm, params, **DENSE), decode_block=3,
                                      draft="ngram", spec_window_max=2, spec_clock=clock())
    want = _drive(jb, jobs)
    batcher = ContinuousBatcher(PipelineEngine(tm, device="cpu", **DENSE), decode_block=3,
                                draft="ngram", spec_window_max=2, spec_clock=clock())
    got = _drive(batcher, jobs)
    assert batcher._async and jb._async
    assert got == want
    assert batcher.spec_stats() == jb.spec_stats() and batcher.spec_stats()["accepted_tokens"] > 0


def test_dense_prefill_step_is_one_program_for_every_slot(tiny_models):
    """At chunk offset 128 the flash kernel's plain version reads the slot
    through ``kv_index``, a device value: two slots with other tokens and
    ``n_valid`` run the same (op, shapes) sequence, with no host read, so
    one captured chunk per offset serves every slot."""
    engine = PipelineEngine(tiny_models[0], microbatches=3, max_seq=512, prefill_chunk=128,
                            device="cpu")
    pc, table = engine.init_cache(), cache.slot_table(3)
    rng = np.random.default_rng(8)
    logs = []
    for slot, n_valid in ((0, 128), (2, 40)):
        engine.prefill_inputs(rng.integers(0, 256, size=128), slot, n_valid, table)
        logs.append(_record(lambda: engine.prefill_step(pc, 128)))
    _assert_replayable(*logs)
    assert any("index_copy" in op for op, _ in logs[0])  # the rows at the device slot


def test_dense_device_plan_equals_the_host_plan(models):
    """The dense plan from the slot offsets on the device: the write slot
    (the scratch slot M for an inactive slot or a position past the
    capacity), the row, the length and the position of every step."""
    eng = PipelineEngine(models[2], device="cpu", **DENSE)
    table = cache.slot_table(3)
    for offsets, active in (([3, 7, 0], [True, True, False]), ([62, 8, 60], [True, True, True])):
        for steps in (1, 4):
            inputs = eng.device_inputs(("t", steps), table, active, offsets, True)
            plan = eng.device_plan(inputs.offsets.long(), inputs, steps)
            act = np.asarray(active)
            pos = np.where(act[None, :], np.asarray(offsets)[None, :] + np.arange(steps)[:, None],
                           0)
            slots = np.where(act[None, :] & (pos < 64), np.arange(3)[None, :], 3)
            np.testing.assert_array_equal(plan.page_ids.numpy(), slots)
            np.testing.assert_array_equal(plan.row_pos.numpy(), pos % 64)
            np.testing.assert_array_equal(plan.lengths.numpy(), np.where(act, pos + 1, 0))
            np.testing.assert_array_equal(plan.positions.numpy(), pos)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(paged_attention="ragged")],
                         ids=["int8_without_pool", "ragged_without_pool"])
def test_dense_engine_checks_match_jax(models, kw):
    jm, params, tm = models
    want = _error(lambda: JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                                          **DENSE, **kw))
    assert _error(lambda: PipelineEngine(tm, device="cpu", **DENSE, **kw)) == want
