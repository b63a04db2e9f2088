"""The parts of the port's captured steps against the JAX package, on the
CPU, at a tiny size (2 layers, narrow widths), with inputs made from a seed
with numpy:

- the KV write at a device position and the T=1 attention masked over the
  whole capacity from it, against JAX's ``write_layer_kv`` and plain
  ``causal_attention``, at positions 0, 5 and capacity - 1;
- the batched sampler with its settings in device tensors, against JAX's
  ``transform_logits_batched`` / ``nucleus_logits_batched`` (bit for bit)
  and its greedy rows' tokens;
- that a decode step can be replayed: the (op, shapes) sequence of one
  step, recorded under a ``TorchDispatchMode`` at positions 5 and 300, is
  the same at both and holds no host read (``aten._local_scalar_dense``),
  for the dense, the packed and the paged step;
- the batcher's prefill step (``PipelineEngine.prefill_slot``, which the
  card captures once per chunk offset) against JAX's ``prefill_slot`` at
  two slots, two page rows and several ``n_valid``, logits and the whole
  pool after each chunk; and that at one offset it is the same program for
  any slot, page row, write page and ``n_valid``, with no host read.

Tolerance: fp32 attention, logits and pool rows within 1e-5 relative (the
two packages sum the scores and products in another order); the int8
pool's codes bit-equal; writes and sampler transforms are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from chip_smoke import pack_llama
from mlx_sharding_tpu import cache as jcache
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu import sample as jsample
from mlx_sharding_tpu.ops.attention import causal_attention as j_causal_attention
from mlx_sharding_tpu_torch import cache, sample
from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW, Generator
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops.attention import causal_attention, masked_attention
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_scheduler import ENGINE, _engine, _jax_engine, models  # noqa: F401
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

ATTN_RTOL = 1e-5
CAPACITY = 64
POSITIONS = [0, 5, CAPACITY - 1]
TINY = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64)


def _pos(p):
    return torch.tensor([p], dtype=torch.int64)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("position", POSITIONS)
def test_write_at_a_device_position_matches_jax(position, t):
    """T rows written at a (1,) device position: JAX's
    ``dynamic_update_slice`` clamps a start past ``S - T``, and so does the
    port, so a write at the last position never leaves the buffer."""
    rng = np.random.default_rng(position + 10 * t)
    k_buf = rng.standard_normal((1, CAPACITY, 2, 16)).astype(np.float32)
    v_buf = rng.standard_normal((1, CAPACITY, 2, 16)).astype(np.float32)
    k_new = rng.standard_normal((1, t, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((1, t, 2, 16)).astype(np.float32)
    jk, jv = jcache.write_layer_kv(jnp.asarray(k_buf), jnp.asarray(v_buf), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(position, jnp.int32))
    tk, tv = torch.from_numpy(k_buf.copy()), torch.from_numpy(v_buf.copy())
    cache.write_layer_kv(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), _pos(position))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 1)], ids=["gqa", "mha", "mqa"])
@pytest.mark.parametrize("position", POSITIONS)
def test_full_capacity_t1_attention_matches_jax(position, hq, hkv):
    """One query at ``position`` over the whole cache, keys past it masked:
    JAX's plain path within 1e-5 relative, and the host-offset path (which
    reads only the prefix) within the same."""
    rng = np.random.default_rng(position + hq)
    q = rng.standard_normal((1, 1, hq, 32)).astype(np.float32)
    k = rng.standard_normal((1, CAPACITY, hkv, 32)).astype(np.float32)
    v = rng.standard_normal((1, CAPACITY, hkv, 32)).astype(np.float32)
    want = np.asarray(j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(position, jnp.int32), 32**-0.5))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = causal_attention(tq, tk, tv, 0, 32**-0.5, position=_pos(position))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_RTOL, atol=ATTN_RTOL)
    host = causal_attention(tq, tk, tv, position, 32**-0.5)
    np.testing.assert_allclose(got.numpy(), host.numpy(), rtol=ATTN_RTOL, atol=ATTN_RTOL)


def test_masked_attention_over_a_chunk_matches_jax():
    """T = 5 queries from position 7 (a chunk the flash kernel does not
    take), with a batch of two: the same function."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, CAPACITY, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, CAPACITY, 2, 32)).astype(np.float32)
    want = np.asarray(j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(7, jnp.int32), 0.2))
    got = masked_attention(*(torch.from_numpy(x) for x in (q, k, v)), _pos(7), 0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_RTOL, atol=ATTN_RTOL)


# ---------------------------------------------------------------- sampler
ROWS = [
    dict(),  # greedy
    dict(temperature=0.7, top_p=0.5),  # top-p
    dict(repetition_penalty=1.3),  # penalised, greedy
    dict(logit_bias={3: 2.5, 7: -1.0, 3 + 40: 4.0}),  # biased, greedy
    dict(temperature=1.1, repetition_penalty=0.8, logit_bias={5: 1.0}, top_p=0.9),
    dict(temperature=0.9),  # sampled, no nucleus
]


def _sampler_case(seed=0, v=96):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(ROWS), v)) * 3).astype(np.float32)
    recent = rng.integers(-1, v, size=(len(ROWS), 8))
    jsp = jsample.stack_sampler_params([jsample.make_sampler_params(**r) for r in ROWS])
    tsp = sample.stack_sampler_params([sample.make_sampler_params(device="cpu", **r)
                                       for r in ROWS], device="cpu")
    return logits, recent, jsp, tsp


def test_batched_sampler_transforms_equal_jax_with_device_params():
    logits, recent, jsp, tsp = _sampler_case()
    assert all(isinstance(getattr(tsp, f), torch.Tensor)
               for f in ("temperature", "top_p", "repetition_penalty"))
    want = jsample.transform_logits_batched(jnp.asarray(logits), jnp.asarray(recent), jsp)
    got = sample.transform_logits_batched(torch.from_numpy(logits), torch.from_numpy(recent), tsp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nucleus_want = np.asarray(jsample.nucleus_logits_batched(want, jsp))
    nucleus_got = sample.nucleus_logits_batched(got, tsp).numpy()
    np.testing.assert_array_equal(np.isneginf(nucleus_got), np.isneginf(nucleus_want))
    np.testing.assert_array_equal(nucleus_got, nucleus_want)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "greedy-only"])
def test_batched_sampler_greedy_rows_match_jax(sampled):
    """Greedy rows take JAX's token in both branches; sampled rows draw
    inside their nucleus from their own generator, the same tokens twice
    from the same seeds."""
    logits, recent, jsp, tsp = _sampler_case(seed=1)
    keys = jax.random.split(jax.random.PRNGKey(0), len(ROWS))
    jt, jlp = jsample.sample_token_batched(keys, jnp.asarray(logits), jsp, jnp.asarray(recent))

    def run(seed):
        gens = [torch.Generator().manual_seed(seed + r) for r in range(len(ROWS))]
        return sample.sample_token_batched(gens, torch.from_numpy(logits), tsp,
                                           torch.from_numpy(recent), sampled=sampled)

    tt, tlp = run(5)
    greedy = np.asarray([r.get("temperature", 0.0) == 0 for r in ROWS])
    np.testing.assert_array_equal(tt.numpy()[greedy], np.asarray(jt)[greedy])
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)
    if sampled:
        assert torch.equal(tt, run(5)[0])
        transformed = sample.transform_logits_batched(torch.from_numpy(logits),
                                                      torch.from_numpy(recent), tsp)
        allowed = torch.isfinite(sample.nucleus_logits_batched(transformed, tsp))
        assert bool(allowed.gather(1, tt[:, None]).all())
    else:  # no draw: every row is the argmax
        np.testing.assert_array_equal(tt.numpy(), np.argmax(np.asarray(
            jsample.transform_logits_batched(jnp.asarray(logits), jnp.asarray(recent), jsp)), -1))


def test_draw_is_the_multinomial_race():
    """One generator: the same tokens as ``torch.multinomial`` from the same
    state; one per row: row r's draw from generator r alone."""
    probs = torch.softmax(torch.from_numpy(_sampler_case(seed=2)[0]), -1)
    want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(9))[:, 0]
    assert torch.equal(sample.draw(probs, torch.Generator().manual_seed(9)), want)
    per_row = sample.draw(probs, [torch.Generator().manual_seed(40 + r) for r in range(6)])
    for r in range(6):
        assert per_row[r] == sample.draw(probs[r : r + 1], torch.Generator().manual_seed(40 + r))


# ----------------------------------------------------- replayable steps
class _OpLog(TorchDispatchMode):
    """Every aten op the step runs, with its tensor arguments' shapes and
    dtypes and its other arguments (a generator by name)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        sig = tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                    else "generator" if isinstance(x, torch.Generator) else repr(x)
                    for x in leaves)
        self.ops.append((str(func), sig))
        return func(*args, **kwargs)


def _record(step):
    with _OpLog() as log:
        step()
    return log.ops


def _assert_replayable(a, b):
    assert a == b, next((x, y) for x, y in zip(a, b) if x != y)
    names = {op for op, _ in a}
    assert not any("_local_scalar_dense" in op or "nonzero" in op for op in names), names


@pytest.fixture(scope="module")
def tiny_models():
    dense, _ = build_model(TINY, dtype=torch.float32)
    dense.init_params(torch.Generator().manual_seed(0), "cpu")
    return dense, pack_llama(dense, TINY)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_single_stream_decode_step_is_the_same_program_at_every_position(tiny_models, kind):
    model = tiny_models[0] if kind == "dense" else tiny_models[1]
    gen = Generator(model, max_seq=512, prefill_chunk=128)
    rng = np.random.default_rng(4)
    logs = []
    for n in (5, 300):
        gen.run_prefill(rng.integers(0, 256, size=(1, n)))
        assert int(gen.cache.pos) == n
        gen._window(REPETITION_WINDOW)
        logs.append(_record(lambda: gen._decode_steps(1, REPETITION_WINDOW, True, True)))
        assert int(gen.cache.pos) == n + 1
    _assert_replayable(*logs)
    assert any("index_copy" in op for op, _ in logs[0])  # the write at the device position


@pytest.mark.parametrize("route", ["1", "0"], ids=["flash_decode", "masked"])
def test_decode_step_on_each_t1_route_is_the_same_program_at_every_position(
        tiny_models, monkeypatch, route):
    """``MST_FLASH_DECODE=1``: the dense step's attention is the T=1 route,
    once a layer, with its lengths made once for the step; ``0``: the plain
    masked attention. Either way the step is one program at positions 5 and
    300, with no host read."""
    from mlx_sharding_tpu_torch.ops import attention as attention_mod
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    monkeypatch.setenv("MST_FLASH_DECODE", route)
    calls = []

    def spy(*args, **kw):
        calls.append(kw["lengths"])
        return fa.flash_decode(*args, **kw)

    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    gen = Generator(tiny_models[0], max_seq=512, prefill_chunk=128)
    rng = np.random.default_rng(6)
    logs = []
    for n in (5, 300):
        gen.run_prefill(rng.integers(0, 256, size=(1, n)))
        gen._window(REPETITION_WINDOW)
        calls.clear()
        logs.append(_record(lambda: gen._decode_steps(1, REPETITION_WINDOW, False, False)))
        layers = TINY["num_hidden_layers"]
        assert len(calls) == (layers if route == "1" else 0)
        assert all(c is calls[0] for c in calls)  # one lengths tensor for the step
        if calls:
            assert calls[0].tolist() == [n + 1]
    _assert_replayable(*logs)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_paged_decode_step_is_the_same_program_at_every_position(tiny_models, kv_dtype):
    engine = PipelineEngine(tiny_models[0], microbatches=2, max_seq=512, prefill_chunk=128,
                            pool_pages=8, kv_dtype=kv_dtype, device="cpu")
    batcher = ContinuousBatcher(engine, decode_block=1)
    batcher.table[0, :4] = np.arange(4)
    batcher.table[1, :4] = np.arange(4, 8)
    batcher.active = [True, True]
    logs = []
    for n in (5, 300):
        batcher.cache.offsets = [n, n]
        inputs = engine.device_inputs(("decode", 1), batcher.table, batcher.active,
                                      batcher.cache.offsets, True)
        logs.append(_record(lambda: batcher._decode_steps(inputs, True, True)))
    _assert_replayable(*logs)


# ------------------------------------------------- the batcher's prefill step
# (slot, its page row, chunk offset, n_valid): two slots, two rows, the
# chunk's write page at row positions 0, 1 and 2, full and ragged chunks
PREFILL_CASES = [(0, [3, 1, 4, 0], 0, 8), (2, [6, 9, 2, 5], 16, 5), (0, [3, 1, 4, 0], 8, 1),
                 (2, [6, 9, 2, 5], 0, 3)]


def _pool_leaves(kv, rng, shape):
    """Random pool contents as numpy: f32 rows, or int8 codes and scales."""
    if kv is None:
        return {"": rng.standard_normal(shape).astype(np.float32)}
    return {"d": rng.integers(-127, 128, size=shape).astype(np.int8),
            "s": (rng.random((*shape[:-1], 1)) * 0.05 + 0.01).astype(np.float32)}


def _to_jax(leaves):
    # the JAX leaf is (S, L, P+1, B, page, H, D) with S = B = 1
    out = {k: jnp.asarray(v[None, :, :, None]) for k, v in leaves.items()}
    return out[""] if "" in out else out


def _from_jax(tree):
    tree = tree if isinstance(tree, dict) else {"": tree}
    return {k: np.asarray(v)[0, :, :, 0] for k, v in tree.items()}


def _from_port(pool):
    pool = pool if isinstance(pool, dict) else {"": pool}
    return {k: v.numpy() for k, v in pool.items()}


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_prefill_slot_matches_jax(models, kv_dtype):
    """Chunks of two slots over a pool of random earlier rows: the logits at
    the last valid row and the whole pool after each chunk agree with the
    JAX program (f32 within 1e-5; int8 codes bit-equal, scales within
    1e-5), and each slot's offset moves by ``n_valid``."""
    jeng, peng = _jax_engine(models, kv_dtype), _engine(models, kv_dtype)
    jc, jtable = jeng.init_cache_paged()
    pc, ptable = peng.init_cache_paged()
    rng = np.random.default_rng(6)
    shape = tuple(cache.kv_data(pc.k).shape)
    pools = {name: _pool_leaves(kv_dtype, rng, shape) for name in ("k", "v")}
    jc = jc._replace(k=_to_jax(pools["k"]), v=_to_jax(pools["v"]))
    for name in ("k", "v"):
        dst = getattr(pc, name)
        for key, value in pools[name].items():
            (dst[key] if key else dst).copy_(torch.from_numpy(value))
    for slot, row, off, n_valid in PREFILL_CASES:
        tokens = rng.integers(1, 300, size=ENGINE["prefill_chunk"])
        ptable[slot, : len(row)] = row
        jtable = jtable.at[slot, : len(row)].set(jnp.asarray(row, jnp.int32))
        pc.offsets[slot] = off
        jc = jc._replace(offset=jc.offset.at[slot].set(off))
        want, jc = jeng.prefill_slot()(
            jeng.layer_params, jeng.layer_masks, jeng.vocab_parts, jeng.shared_params,
            jnp.asarray(tokens[None], jnp.int32), jnp.asarray(slot, jnp.int32), jc,
            jnp.asarray(n_valid, jnp.int32), jtable)
        got = peng.prefill_slot(tokens, slot, pc, n_valid, ptable)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_RTOL, atol=ATTN_RTOL)
        assert pc.offsets[slot] == off + n_valid == int(jc.offset[slot])
        for name in ("k", "v"):
            p, j = _from_port(getattr(pc, name)), _from_jax(getattr(jc, name))
            for key in p:
                if key == "d":
                    np.testing.assert_array_equal(p[key], j[key])
                else:
                    np.testing.assert_allclose(p[key], j[key], rtol=ATTN_RTOL, atol=ATTN_RTOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_prefill_step_is_the_same_program_for_any_slot_and_page(tiny_models, kv_dtype):
    """At chunk offset 128 (pages of 256: the write page is the row's first
    entry, the view two pages), two slots with other page rows, tokens and
    ``n_valid`` run the same (op, shapes) sequence, with no host read: the
    step's inputs come from the engine's persistent buffer."""
    engine = PipelineEngine(tiny_models[0], microbatches=2, max_seq=512, prefill_chunk=128,
                            pool_pages=8, page_size=256, kv_dtype=kv_dtype, device="cpu")
    pc, table = engine.init_cache_paged()
    table[0, :2] = [3, 1]
    table[1, :2] = [6, 2]
    rng = np.random.default_rng(8)
    logs = []
    for slot, n_valid in ((0, 128), (1, 40)):
        engine.prefill_inputs(rng.integers(0, 256, size=128), slot, n_valid, table)
        logs.append(_record(lambda: engine.prefill_step(pc, 128)))
    _assert_replayable(*logs)
    assert any("index_copy" in op for op, _ in logs[0])  # the write at a device page


# ------------------------------------------------------ speculative rounds
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_single_stream_verify_step_is_the_same_program_at_every_position(tiny_models, kind,
                                                                         sampled):
    """The n-gram generator's T=4 verify (window cap 3) at positions 5 and
    300: one (op, shapes) sequence with no host read; the device position
    moves by the count, 1 to 3."""
    from mlx_sharding_tpu_torch.device import upload_into
    from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator

    gen = NgramSpeculativeGenerator(tiny_models[0] if kind == "dense" else tiny_models[1],
                                    max_seq=512, prefill_chunk=128)
    t = gen.target
    rng = np.random.default_rng(5)
    logs = []
    for n in (5, 300):
        t.run_prefill(rng.integers(0, 256, size=(1, n)))
        t._window(REPETITION_WINDOW)
        upload_into(gen._inputs, np.asarray([3, 7, 8, 9, 10], np.int64))
        logs.append(_record(lambda: gen._verify_step(4, REPETITION_WINDOW, sampled)))
        assert n + 1 <= int(t.cache.pos) <= n + 3
    _assert_replayable(*logs)
    assert any("index_copy" in op for op, _ in logs[0])  # the K rows at the device position


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_draft_steps_are_the_same_program_at_every_position(tiny_models, sampled):
    """The draft model's K = 4 steps (a self-draft) at positions 5 and 300:
    one sequence, no host read; the draft's position moves by 4."""
    from mlx_sharding_tpu_torch.speculative import SpeculativeGenerator

    gen = SpeculativeGenerator(tiny_models[0], tiny_models[0], spec_k=4, max_seq=512,
                               prefill_chunk=128)
    gen._qlps = torch.zeros((4, 1, TINY["vocab_size"]))
    d = gen.draft
    rng = np.random.default_rng(6)
    logs = []
    for n in (5, 300):
        d.run_prefill(rng.integers(0, 256, size=(1, n)))
        gen.target._window(REPETITION_WINDOW)
        logs.append(_record(lambda: gen._draft_step(4, REPETITION_WINDOW, sampled)))
        assert int(d.cache.pos) == n + 4
    _assert_replayable(*logs)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_paged_verify_step_is_the_same_program_at_every_position(tiny_models, kv_dtype):
    """The batcher's T=4 verify of two slots at offsets 5, 126 (its rows
    straddle a page) and 300: one sequence, no host read (the table rows,
    offsets, drafts and caps come from the engine's persistent buffer, the
    plan is made on the device)."""
    engine = PipelineEngine(tiny_models[0], microbatches=2, max_seq=512, prefill_chunk=128,
                            pool_pages=8, kv_dtype=kv_dtype, device="cpu")
    batcher = ContinuousBatcher(engine, decode_block=1, draft="ngram")
    batcher.table[0, :4] = np.arange(4)
    batcher.table[1, :4] = np.arange(4, 8)
    batcher.active = [True, True]
    drafts = np.asarray([[3, 4], [5, 6], [7, 8], [9, 10]], np.int32)
    logs = []
    for n in (5, 126, 300):
        batcher.cache.offsets = [n, n + 1]
        inputs = engine.device_inputs(("verify", 4), batcher.table, batcher.active,
                                      batcher.cache.offsets, True, drafts,
                                      np.asarray([4, 2], np.int32))
        logs.append(_record(lambda: batcher._verify_step(4, inputs, True)))
        assert n + 1 <= int(batcher._dev_off[0]) <= n + 4  # moved by the count
    for log in logs[1:]:
        _assert_replayable(logs[0], log)
