"""The port's speculative decoding (``mlx_sharding_tpu_torch/speculative.py``)
against the JAX package's, on the CPU at a tiny size (the Llama of
``tests/test_speculative.py``: vocab 300, hidden 32, 2 layers, Hq 4 / Hkv 2,
prefill chunk 8, capacity 96, f32; its draft has 1 layer), the weights made
from one seed and shared by both packages:

- the n-gram proposer and the acceptance tracker equal JAX's on the same
  histories and observations (proposals, windows, EWMAs, ``stats()``),
  under fake clocks;
- ``one_hot_draft_logprobs`` equals JAX's; ``rejection_round`` accepts a
  perfect draft whole, and the token it emits first follows p: over 20000
  rounds at a 12-token vocabulary the total variation distance to p is
  below 0.03 (JAX's own test's limit);
- both single-stream generators give greedy streams token-identical to the
  JAX generators and to plain greedy decode, penalty and bias included,
  with equal counters; at the capacity edge and in the tail; a logprobs
  request takes the plain path; sampled streams repeat per seed."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import speculative as jspec
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu_torch import speculative as spec
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
MAX_SEQ, CHUNK = 96, 8
# the first prompt repeats, so n-gram proposals land; the model's own
# output repeats too, so later rounds draft from the history
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [3, 17, 42, 9], [9, 1, 9, 1, 9, 1, 9, 1, 9]]
# a penalty over the default window (a window of another size is another
# program for both packages' generators to compile) and a bias
PENALTY = dict(repetition_penalty=1.3, logit_bias={7: 2.0, 9: -1.5})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps run on one torch thread in this module: under
    the test run's several workers, a thread pool per small op contends for
    the cores and multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    """Advances by ``step`` at every read: a disabled window re-probes after
    a fixed number of rounds, the same in both packages."""

    def __init__(self, step=0.25):
        self.n = itertools.count()
        self.step = step

    def __call__(self):
        return self.step * next(self.n)


# ------------------------------------------------------------ the proposer
PROPOSER_CASES = [
    (dict(max_ngram=3), [1, 7, 8, 9, 10, 2, 7, 8], 4),  # continues the most recent match
    (dict(max_ngram=3), [4, 5, 6, 11, 0, 5, 6, 22, 0, 4, 5, 6], 2),  # longer context wins
    (dict(), [1, 2, 3, 4, 5], 4),  # no match: padded with token 0
    (dict(), [9, 9, 3, 9, 9], 4),  # partial continuation
    (dict(window=8, min_ngram=2), [7, 7, 5] + [1, 2, 3, 4] * 3 + [7, 7], 2),  # out of the ring
    (dict(min_ngram=2), [7, 7, 5] + [1, 2, 3, 4] * 3 + [7, 7], 2),
    (dict(), [], 4),
    (dict(), [1, 2, 3], 0),
    (dict(max_ngram=4), list(np.random.default_rng(1).integers(0, 6, size=200)), 8),
]


@pytest.mark.parametrize("kw,tokens,k", PROPOSER_CASES)
def test_ngram_proposer_matches_jax(kw, tokens, k):
    want = jspec.NgramDraftProposer(**kw).propose(tokens, k)
    got = spec.NgramDraftProposer(**kw).propose(tokens, k)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype


def test_ngram_proposer_validation_matches_jax():
    with pytest.raises(ValueError) as j:
        jspec.NgramDraftProposer(max_ngram=2, min_ngram=3)
    with pytest.raises(ValueError) as t:
        spec.NgramDraftProposer(max_ngram=2, min_ngram=3)
    assert str(t.value) == str(j.value)


# -------------------------------------------------------------- the tracker
class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _saturate_then_collapse(tr, clk):
    for _ in range(12):
        tr.observe(0, tr.window(0), tr.window(0))
        yield
    for _ in range(30):
        w = tr.window(1)
        if w == 0:
            break
        tr.observe(1, w, 1)
        yield


def _reprobe(tr, clk):
    while tr.window(0) != 0:
        tr.observe(0, tr.window(0), 1)
        yield
    for now in (0.5, 1.5):
        clk.now = now
        tr.window(0)
        yield
    tr.observe(0, 2, 2)
    yield


def _reset(tr, clk):
    while tr.window(0) != 0:
        tr.observe(0, tr.window(0), 1)
        yield
    tr.reset(0)
    yield


def _sequence(tr, clk):
    for count in [2, 2, 4, 4, 1, 1, 1, 3, 1, 1, 1, 1]:
        w = tr.window(0)
        tr.observe(0, w, min(count, max(w, 1)))
        yield


def _brownout(tr, clk):
    for s, count in zip([1, 2, 3], [2, 3, 4]):
        tr.observe(s, 2, 2)
        tr.observe(s, 4, count)
        yield
    for level in (2, 3, 0, 2):
        tr.last = tr.effective_windows([0, 1, 2, 3], level=level)
        yield


TRACKER_CASES = [(2, dict(w_max=8), _saturate_then_collapse), (1, dict(w_max=4), _reprobe),
                 (1, dict(w_max=8), _reset), (1, dict(w_max=8), _sequence),
                 (4, dict(w_max=4), _brownout)]


@pytest.mark.parametrize("slots,kw,script", TRACKER_CASES,
                         ids=[c[2].__name__.strip("_") for c in TRACKER_CASES])
def test_acceptance_tracker_matches_jax(slots, kw, script):
    """The same script of observations, clock moves and brownout levels on
    both trackers: after every step the windows, the EWMAs, ``stats()`` and
    the brownout plans are equal."""
    jclk, tclk = _Clock(), _Clock()
    jt = jspec.AcceptanceTracker(slots, clock=jclk, **kw)
    tt = spec.AcceptanceTracker(slots, clock=tclk, **kw)
    assert tt.rungs == jt.rungs and spec.SPEC_WINDOW_LADDER == jspec.SPEC_WINDOW_LADDER
    steps = 0
    for _ in itertools.zip_longest(script(jt, jclk), script(tt, tclk)):
        steps += 1
        assert [tt.window(s) for s in range(slots)] == [jt.window(s) for s in range(slots)]
        assert [tt.ewma(s) for s in range(slots)] == [jt.ewma(s) for s in range(slots)]
        assert tt.stats() == jt.stats()
        assert getattr(tt, "last", None) == getattr(jt, "last", None)
    assert steps >= 2


# ------------------------------------------------------- rejection sampling
def test_one_hot_draft_logprobs_matches_jax():
    drafts = np.random.default_rng(0).integers(0, 50, size=(4, 3)).astype(np.int64)
    want = np.asarray(jspec.one_hot_draft_logprobs(jnp.asarray(drafts, jnp.int32), 50))
    got = spec.one_hot_draft_logprobs(torch.from_numpy(drafts), 50)
    assert got.dtype == torch.float32 and got.shape == (4, 3, 50)
    np.testing.assert_array_equal(got.numpy(), want)


def _log_dist(rng, shape):
    return torch.log_softmax(torch.from_numpy(rng.standard_normal(shape) * 1.5), -1).float()


def test_rejection_round_accepts_a_perfect_draft_whole():
    """q == p: the acceptance probability is 1 at every position, for one
    generator and for one generator per column."""
    rng = np.random.default_rng(1)
    p = _log_dist(rng, (4, 3, 20))
    drafts = torch.from_numpy(rng.integers(0, 20, size=(4, 3)))
    for gens in (torch.Generator().manual_seed(2), [torch.Generator().manual_seed(s)
                                                    for s in range(3)]):
        gs, m, count = spec.rejection_round(gens, drafts, p, p)
        assert torch.equal(gs, drafts)
        assert m.tolist() == [3, 3, 3] and count.tolist() == [4, 4, 4]


def test_rejection_round_emits_the_target_distribution():
    """Whatever q is, the token emitted at the first position is
    distributed as p there: 20000 rounds (one column each) with drafts drawn
    from q; total variation distance to p below 0.03."""
    v, k, n = 12, 3, 20000
    rng = np.random.default_rng(0)
    p = _log_dist(rng, (k, 1, v))
    q = _log_dist(rng, (k, 1, v))
    gen = torch.Generator().manual_seed(7)
    drafts = torch.multinomial(q[:, 0].exp(), n, replacement=True, generator=gen)  # (K, N)
    gs, _, _ = spec.rejection_round(gen, drafts, q.expand(k, n, v), p.expand(k, n, v))
    empirical = np.bincount(gs[0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(empirical - p[0, 0].exp().numpy()).sum()
    assert tv < 0.03, tv


def test_rejection_round_with_a_one_hot_q_resamples_without_the_draft():
    """A deterministic proposer whose token p rates 0 is always rejected,
    and the residual never draws it again."""
    rng = np.random.default_rng(3)
    p = _log_dist(rng, (2, 64, 10))
    p[..., 4] = -float("inf")
    p = torch.log_softmax(p, -1)
    drafts = torch.full((2, 64), 4, dtype=torch.int64)
    gs, m, _ = spec.rejection_round(torch.Generator().manual_seed(1), drafts,
                                    spec.one_hot_draft_logprobs(drafts, 10), p)
    assert (m == 0).all() and (gs[0] != 4).all()


# -------------------------------------------------------- the generators
@pytest.fixture(scope="module")
def models():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    dcfg = LlamaConfig(**{**TINY, "num_hidden_layers": 1})
    jd = JLlamaModel(dcfg)
    dparams = jd.init_params(jax.random.PRNGKey(1), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    td = params_from_numpy(dcfg, jax.tree.map(np.asarray, dparams), device="cpu")
    return dict(jax=(jm, params), jax_draft=(jd, dparams), port=tm, port_draft=td)


def _tokens(gen, prompt, **kw):
    return [t for t, _ in gen.generate_step(prompt, **kw)]


@pytest.fixture(scope="module")
def jax_gen(models):
    """One JAX generator per configuration for the module: each compiles its
    programs once (the counters are compared as per-request deltas)."""
    made = {}

    def get(kind, arg):
        if (kind, arg) not in made:
            jm, params = models["jax"]
            common = dict(max_seq=MAX_SEQ, prefill_chunk=CHUNK, cache_dtype=jnp.float32)
            if kind == "ngram":
                made[kind, arg] = jspec.NgramSpeculativeGenerator(
                    jm, params, spec_window_max=arg, clock=FakeClock(), **common)
            else:
                made[kind, arg] = jspec.SpeculativeGenerator(
                    jm, params, *models["jax_draft" if kind == "draft" else "jax"], spec_k=arg,
                    **common)
        return made[kind, arg]

    return get


def _port_gen(models, kind, arg):
    if kind == "ngram":
        return spec.NgramSpeculativeGenerator(models["port"], spec_window_max=arg,
                                              max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                              clock=FakeClock())
    return spec.SpeculativeGenerator(models["port"],
                                     models["port_draft" if kind == "draft" else "port"],
                                     spec_k=arg, max_seq=MAX_SEQ, prefill_chunk=CHUNK)


def _counted(gen, prompt, **kw):
    """The stream and the counters it moved: (rounds, accepted, drafted)."""
    before = (gen.rounds, gen.accepted_tokens, getattr(gen, "draft_tokens", 0))
    toks = _tokens(gen, prompt, **kw)
    after = (gen.rounds, gen.accepted_tokens, getattr(gen, "draft_tokens", 0))
    return toks, tuple(a - b for a, b in zip(after, before))


@pytest.fixture(scope="module")
def plain(models):
    return Generator(models["port"], max_seq=MAX_SEQ, prefill_chunk=CHUNK)


@pytest.mark.parametrize("kw", [dict(max_tokens=40), dict(max_tokens=30, **PENALTY)],
                         ids=["greedy", "penalty_bias"])
def test_ngram_generator_matches_jax_and_plain_greedy(models, jax_gen, plain, kw):
    """Every prompt: the port's stream equals JAX's and plain greedy decode,
    with the same counters and windows; rounds drafted and accepted tokens
    (not a vacuous parity)."""
    jg, tg = jax_gen("ngram", 8), _port_gen(models, "ngram", 8)
    for prompt in PROMPTS:
        want, moved = _counted(jg, prompt, **kw)
        assert _counted(tg, prompt, **kw) == (want, moved)
        assert _tokens(plain, prompt, **kw) == want
        assert tg.tracker.stats() == jg.tracker.stats()
    st = tg.spec_stats()
    assert st["mode"] == "ngram" and st["window_max"] == 8
    assert tg.draft_tokens > 0 and tg.accepted_tokens > 0 and tg.rounds > 0


@pytest.mark.parametrize("window_max", [2, 4])
def test_ngram_generator_window_max_matches_jax(models, jax_gen, window_max):
    jg, tg = jax_gen("ngram", window_max), _port_gen(models, "ngram", window_max)
    assert _counted(tg, PROMPTS[0], max_tokens=40) == _counted(jg, PROMPTS[0], max_tokens=40)
    assert tg.tracker.stats() == jg.tracker.stats()
    assert tg.spec_stats()["window_max"] == window_max


@pytest.mark.parametrize("draft,spec_k,kw", [
    ("draft", 4, dict(max_tokens=24)), ("draft", 1, dict(max_tokens=24)),
    ("self", 2, dict(max_tokens=24)), ("self", 4, dict(max_tokens=24)),
    ("draft", 4, dict(max_tokens=20, **PENALTY)), ("self", 4, dict(max_tokens=20, **PENALTY)),
], ids=["draft-4", "draft-1", "self-2", "self-4", "draft-4-penalty_bias",
        "self-4-penalty_bias"])
def test_draft_model_generator_matches_jax_and_plain_greedy(models, jax_gen, plain, draft,
                                                           spec_k, kw):
    """An unrelated 1-layer draft and the target as its own draft (which
    accepts every greedy token): streams equal to JAX's and plain greedy,
    and equal rounds and accepted tokens."""
    jg, tg = jax_gen(draft, spec_k), _port_gen(models, draft, spec_k)
    for prompt in PROMPTS[:2]:
        want, (rounds, accepted, _) = _counted(jg, prompt, **kw)
        got, moved = _counted(tg, prompt, **kw)
        assert got == want and moved == (rounds, accepted, spec_k * rounds)
        assert _tokens(plain, prompt, **kw) == want
    if draft == "self" and "repetition_penalty" not in kw:
        assert tg.accepted_tokens == spec_k * tg.rounds  # a perfect draft


@pytest.mark.parametrize("kind,arg", [("ngram", 8), ("draft", 4)])
@pytest.mark.parametrize("max_tokens", [37, 2, 1])
def test_capacity_edge_and_tail_match_jax(models, jax_gen, plain, kind, arg, max_tokens):
    """59 prompt tokens and 37 more fill the 96-token capacity: the rounds
    hand off to plain decode blocks without a write past the capacity; 2
    and 1 tokens take the tail at once."""
    prompt = list(range(1, 60))
    want, moved = _counted(jax_gen(kind, arg), prompt, max_tokens=max_tokens)
    got = _counted(_port_gen(models, kind, arg), prompt, max_tokens=max_tokens)
    assert got[0] == want == _tokens(plain, prompt, max_tokens=max_tokens)
    assert got[1][:2] == moved[:2]


@pytest.mark.parametrize("kind,arg", [("ngram", 8), ("draft", 4)])
def test_logprobs_request_takes_the_plain_path(models, plain, kind, arg):
    tg = _port_gen(models, kind, arg)
    kw = dict(max_tokens=10, want_logprobs=True, seed=42)
    got = list(tg.generate_step(PROMPTS[0], **kw))
    want = list(plain.generate_step(PROMPTS[0], **kw))
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.chosen == w.chosen
        np.testing.assert_array_equal(g.top_indices, w.top_indices)
    assert tg.rounds == 0


@pytest.mark.parametrize("kind,arg", [("ngram", 8), ("draft", 4), ("self", 4)])
def test_sampled_streams_repeat_per_seed(models, kind, arg):
    """Port against port: the same seed gives the same stream, another seed
    another one (the draws equal JAX's in distribution only)."""
    tg = _port_gen(models, kind, arg)
    kw = dict(max_tokens=18, temperature=0.8, top_p=0.9, seed=11, **PENALTY)
    a = _tokens(tg, PROMPTS[2], **kw)
    assert _tokens(tg, PROMPTS[2], **kw) == a
    assert _tokens(tg, PROMPTS[2], **{**kw, "seed": 12}) != a
    assert len(a) == 18 and tg.rounds > 0


def test_sampled_self_draft_accepts_everything(models):
    """Draft == target: p == q at every position, so every round emits the
    whole window."""
    tg = _port_gen(models, "self", 4)
    toks = _tokens(tg, [5, 9, 2], max_tokens=21, temperature=0.9, top_p=0.95, seed=3)
    assert len(toks) == 21 and tg.rounds > 0
    assert tg.accepted_tokens == tg.spec_k * tg.rounds


def test_each_generator_owns_its_target(models, plain):
    """Each generator holds a Generator of its own (cache and graphs apart
    from plain decode's and from each other's); a self-draft's draft runs
    the target's weight tensors. Requests interleaved over the three give
    plain greedy's stream every time."""
    ng = spec.NgramSpeculativeGenerator(models["port"], clock=FakeClock())
    sg = spec.SpeculativeGenerator(models["port"], models["port_draft"], spec_k=3)
    self_draft = spec.SpeculativeGenerator(models["port"], models["port"], spec_k=3)
    targets = [plain, ng.target, sg.target, self_draft.target]
    assert len({id(t) for t in targets}) == len({id(t.cache) for t in targets}) == 4
    assert all(t.model is models["port"] for t in targets)
    assert sg.draft.model is models["port_draft"] and sg.draft is not sg.target
    assert self_draft.draft.model is self_draft.target.model
    want = _tokens(plain, PROMPTS[0], max_tokens=30)
    for gen in (ng, sg, plain, self_draft, ng, sg):
        assert _tokens(gen, PROMPTS[0], max_tokens=30) == want
    assert self_draft.accepted_tokens == 3 * self_draft.rounds > 0


def _error(fn, exc=ValueError):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_generator_checks_match_jax(models):
    jm, params = models["jax"]
    wide = LlamaConfig(**{**TINY, "vocab_size": 320})
    jw = JLlamaModel(wide)
    jwp = jw.init_params(jax.random.PRNGKey(2), jnp.float32)
    tw = params_from_numpy(wide, jax.tree.map(np.asarray, jwp), device="cpu")
    cases = [
        (lambda: jspec.NgramSpeculativeGenerator(jm, params, spec_window_max=1),
         lambda: spec.NgramSpeculativeGenerator(models["port"], spec_window_max=1)),
        (lambda: jspec.SpeculativeGenerator(jm, params, jm, params, spec_k=0),
         lambda: spec.SpeculativeGenerator(models["port"], models["port"], spec_k=0)),
        (lambda: jspec.SpeculativeGenerator(jm, params, jw, jwp),
         lambda: spec.SpeculativeGenerator(models["port"], tw)),
    ]
    for j, t in cases:
        assert _error(t) == _error(j)
    stage = LlamaConfig(**{**TINY, "start_layer": 0, "end_layer": 1})
    js = JLlamaModel(stage)
    ts = params_from_numpy(stage, jax.tree.map(np.asarray, js.init_params(
        jax.random.PRNGKey(0), jnp.float32)), device="cpu")
    want = _error(lambda: jspec.NgramSpeculativeGenerator(js, None))
    assert _error(lambda: spec.NgramSpeculativeGenerator(ts)) == want
