"""Speculative decoding (port of ``mlx_sharding_tpu/speculative.py``).

A proposer offers K tokens a round; the target scores all of them in ONE
T=K forward over ``[t0, d1..d_{K-1}]`` and the longest prefix it agrees
with is emitted, plus its own correction token at the first divergence.
Greedy rounds emit exactly what plain greedy decode emits; sampled rounds
use rejection sampling (:func:`rejection_round`), so the emitted stream is
distributed exactly as plain sampling from the target. Rejected rows cost
one device scalar: the cache's position moves by the round's count, and the
rows past it are stale but masked (the T=K attention and the T=1 route both
read the position).

- :class:`NgramDraftProposer` and :class:`AcceptanceTracker` (with
  ``SPEC_WINDOW_LADDER``) are numpy and the standard library only: they
  are copied from ``mlx_sharding_tpu/speculative.py``, a module that
  imports JAX and so cannot be imported here.
- :func:`rejection_round`, :func:`one_hot_draft_logprobs`,
  :func:`dist_logits` and :func:`verify_round` (the verify's scoring,
  acceptance and epilogue, shared by the single stream and the batcher's
  slots) are torch, with explicit ``torch.Generator``\\ s: the draws equal
  JAX's in distribution only.
- :class:`NgramSpeculativeGenerator` (prompt-lookup drafts, adaptive
  window) and :class:`SpeculativeGenerator` (a draft model) keep the
  ``generate_step`` contract over one port :class:`~mlx_sharding_tpu_torch.
  generate.Generator` each (two for the draft model), whose prefill chunks
  and decode blocks they reuse as they are. On the card a round is CUDA
  graph replays: the verify is one graph per (K, sampled, window), the
  draft model's K steps one graph per (K, sampled, window). The n-gram
  drafts and the window cap go up in one upload; the host reads one thing
  per round, ``(count, gs)``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import upload_into
from mlx_sharding_tpu_torch.generate import (
    DEFAULT_DECODE_BLOCK,
    DEFAULT_PREFILL_CHUNK,
    REPETITION_WINDOW,
    Generator,
    TokenLogprobs,
)
from mlx_sharding_tpu_torch.sample import (
    BatchedSamplerParams,
    draw,
    nucleus_logits,
    nucleus_logits_batched,
    transform_logits,
    transform_logits_batched,
    update_recent_tokens,
)

# the adaptive window ladder: 0 == drafting disabled for the slot, the
# nonzero rungs are the candidate speculation windows. Powers of two keep
# the number of distinct verify-program compilations at 3.
SPEC_WINDOW_LADDER = (0, 2, 4, 8)
# each speculating generator's verify graphs are keyed by its own number:
# generators over one target Generator (``target=``) share its graphs
_GENERATOR_KEYS = itertools.count()


def dist_logits(logits, recent, sp):
    """The request's full sampling distribution in log domain
    (unnormalized), through the pipeline the sampler draws from
    (``transform_logits`` then ``nucleus_logits``; their batched forms for
    per-row :class:`BatchedSamplerParams`): p and q are both defined by it,
    which is what makes the acceptance ratio meaningful (JAX
    ``_dist_logits``)."""
    if isinstance(sp, BatchedSamplerParams):
        return nucleus_logits_batched(transform_logits_batched(logits, recent, sp), sp)
    return nucleus_logits(transform_logits(logits, recent, sp), sp)


def _uniform(shape, generators, device) -> torch.Tensor:
    """(K, B) uniforms: from one generator, or column b from ``generators[b]``."""
    if isinstance(generators, torch.Generator):
        return torch.rand(shape, generator=generators, device=device)
    return torch.stack([torch.rand(shape[0], generator=g, device=device) for g in generators],
                       dim=1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """(K, B) bool -> (B,) the first True row of each column, K-1 if none."""
    k = mask.shape[0]
    return torch.where(mask.any(dim=0), torch.argmax(mask.to(torch.int8), dim=0), k - 1)


def rejection_round(generators, drafts, q_logprobs, p_logprobs):
    """One round of speculative rejection sampling (Leviathan et al.).

    drafts: (K, B) proposals; q_logprobs / p_logprobs: (K, B, V) draft and
    target log-distributions at each position. ``generators``: one
    ``torch.Generator`` for every column, or a list of one per column.
    Returns (gs, m, count): gs (K, B), the emitted token per position (the
    draft where accepted, the residual resample where rejected; only rows
    <= m are meaningful), m (B,) the last emitted row, count = m + 1. The
    token emitted at a position is distributed exactly as p there."""
    k, b = drafts.shape
    u = _uniform((k, b), generators, drafts.device)
    d_lp_q = q_logprobs.gather(-1, drafts[..., None])[..., 0]
    d_lp_p = p_logprobs.gather(-1, drafts[..., None])[..., 0]
    # accept with prob min(1, p/q); exp of a clamped-to-0 log ratio avoids
    # overflow and u < 1 makes a ratio >= 1 an unconditional accept
    reject = ~(u < torch.exp(torch.clamp_max(d_lp_p - d_lp_q, 0.0)))
    # residual per position: norm(max(p - q, 0)); with ~0 mass (p ~ q
    # everywhere) resampling from p is the correct limit
    res = torch.clamp_min(torch.exp(p_logprobs) - torch.exp(q_logprobs), 0.0)
    mass = res.sum(dim=-1, keepdim=True)
    res_logits = torch.where(mass > 1e-9, torch.log(res), p_logprobs)
    probs = torch.softmax(res_logits, dim=-1)
    if isinstance(generators, torch.Generator):
        r = draw(probs.reshape(k * b, -1), generators).view(k, b)
    else:
        r = torch.stack([draw(probs[:, j], g) for j, g in enumerate(generators)], dim=1)
    gs = torch.where(reject, r, drafts)
    m = _first_true(reject)
    return gs, m, m + 1


def one_hot_draft_logprobs(drafts, vocab_size: int) -> torch.Tensor:
    """The q-distribution of a DETERMINISTIC proposer (n-gram lookup) in
    log domain, (K, B, V) float32: 0 on the proposed token, -1e9 elsewhere.
    With it the rejection identity degenerates to: accept d with
    probability p(d), else resample from p with d removed. Built on the
    device from the (K, B) draft ids; it never crosses the host."""
    hot = torch.arange(vocab_size, device=drafts.device) == drafts[..., None]
    return torch.where(hot, 0.0, -1e9)


def verify_round(logits, drafts, recent, sp: BatchedSamplerParams, generators, *,
                 sampled: bool, q_logprobs=None, wcap=None, active=None, rep_mask=None):
    """The verify's scoring, acceptance and epilogue over B rows (the
    single stream's one row, or the batcher's M slots), device work only.

    logits (B, K, V) of the target's T=K forward over ``[t0, d1..]``;
    drafts (K, B); recent (B, W), the pre-round window (``rep_mask`` keeps
    the entries each row's penalty sees). Greedy rows take the longest
    prefix where the transformed argmax agrees with the draft; with
    ``sampled`` (the host knows some row samples) every row also runs
    :func:`rejection_round` against ``q_logprobs`` (one-hot on the drafts
    when None) with its generator, and rows at temperature > 0 take its
    verdict. ``wcap`` (B,) caps m at ``wcap - 1`` before anything commits;
    an inactive row (``active`` False) emits nothing. Returns (gs (K, B),
    count (B,), next token (B,), the window after replaying ONLY the
    emitted tokens)."""
    b, k, vocab = logits.shape

    def masked(rec):
        return rec if rep_mask is None else torch.where(rep_mask, rec, torch.full_like(rec, -1))

    row_sampled = sp.temperature > 0
    rec, greedy, plps = recent, [], []
    for i in range(k):
        tl = transform_logits_batched(logits[:, i], masked(rec), sp)
        g = torch.argmax(tl, dim=-1)
        greedy.append(g)
        consumed = g
        if sampled:
            plps.append(torch.log_softmax(nucleus_logits_batched(tl, sp), dim=-1))
            # the token consumed at position i+1: the proposal for a sampled
            # row (exact on the accepted prefix, discarded past it)
            consumed = torch.where(row_sampled, drafts[i], g)
        rec = update_recent_tokens(rec, consumed)
    gs = torch.stack(greedy)  # (K, B)
    m = _first_true(gs != drafts)
    if sampled:
        q = one_hot_draft_logprobs(drafts, vocab) if q_logprobs is None else q_logprobs
        gs_s, m_s, _ = rejection_round(generators, drafts, q, torch.stack(plps))
        gs = torch.where(row_sampled[None, :], gs_s, gs)
        m = torch.where(row_sampled, m_s, m)
    if wcap is not None:
        m = torch.minimum(m, wcap.to(m.dtype) - 1)  # the round's window cap
    count = m + 1
    if active is not None:
        count = torch.where(active, count, 0)
    out = recent
    for i in range(k):
        keep = m >= i if active is None else (m >= i) & active
        out = torch.where(keep[:, None], update_recent_tokens(out, gs[i]), out)
    nxt = gs.gather(0, m[None, :])[0]
    return gs, count, nxt, out


class NgramDraftProposer:
    """Prompt-lookup drafting: propose the K tokens that followed the most
    recent occurrence of the stream's trailing n-gram (n = max_ngram down
    to min_ngram) in the slot's prompt + produced history. Free speculation
    — no second checkpoint, no draft KV cache, no device work; repetitive
    streams (code, extraction, chat with quoting) accept long runs while
    novel text simply proposes nothing and the round degenerates to plain
    decode for that slot.

    Host-pure by contract: ``propose`` touches numpy only — it runs inside
    the scheduler's tick-hot path (mstcheck MST114 enforces that neither it
    nor the acceptance tracker ever performs a device sync). The trailing
    ``window`` tokens of the history act as the ring buffer: matching cost
    is O(window) vectorized per round, independent of stream length.

    Proposals shorter than ``k`` are padded with token 0 — a VALID id, not
    a sentinel: padded rows still flow through the verify forward, and the
    caller cuts them off via the per-slot window cap (``n_valid``). A -1
    pad would be clamped to row 0 by ``take_along_axis`` and one_hot(-1)
    is all-zero, which silently corrupts the sampled acceptance math."""

    def __init__(self, *, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 2048):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.window = window

    def propose(self, tokens, k: int):
        """tokens: 1-D int sequence, most recent last (prompt + history).
        Returns ``(drafts, n_valid)``: drafts is (k,) int32 padded with
        token 0 past ``n_valid``; n_valid == 0 means no match anywhere."""
        toks = np.asarray(tokens, np.int32).ravel()
        if self.window and toks.size > self.window:
            toks = toks[-self.window:]
        out = np.zeros(k, np.int32)
        n_tok = int(toks.size)
        if k < 1 or n_tok < self.min_ngram + 1:
            return out, 0
        # longest context first; the trailing window itself is excluded
        # (a window over toks[:-1] can't start at the trailing position)
        hay = toks[:-1]
        for n in range(min(self.max_ngram, n_tok - 1), self.min_ngram - 1, -1):
            pat = toks[-n:]
            wins = np.lib.stride_tricks.sliding_window_view(hay, n)
            hits = np.nonzero((wins == pat).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # most recent occurrence wins
            cont = toks[start:start + k]
            out[:cont.size] = cont
            return out, int(cont.size)
        return out, 0


class AcceptanceTracker:
    """Per-slot adaptive speculation-window controller.

    Tracks an EWMA of tokens-emitted-per-round (``count`` ∈ [1, w]: 1 means
    the draft never agreed — the round cost a K-wide forward to emit what
    plain decode emits with a 1-wide one) and walks the slot's window along
    ``SPEC_WINDOW_LADDER``:

    - grow to the next rung when the EWMA fills ≥ ``grow_frac`` of the
      current window (the draft is saturating it);
    - shrink one rung when the EWMA pays for ≤ max(1.25, shrink_frac·w)
      tokens — below the bottom rung the slot DISABLES (window 0) and
      re-probes at the bottom rung after ``probe_after_s`` (injectable
      ``clock`` keeps the schedule deterministic under test).

    The same per-slot EWMAs order brownout shedding: at pressure level 2
    ``effective_windows`` sheds the lowest-acceptance half of live slots
    (speculation that barely pays is the first capacity lever to drop);
    level ≥ 3 sheds all. Shedding is per-round pressure, not slot state —
    the EWMA keeps evolving and the window returns the moment pressure
    clears. Host-pure: observe/effective_windows touch python ints only
    (MST114)."""

    def __init__(self, n_slots: int, *, w_max: int = 8, alpha: float = 0.25,
                 grow_frac: float = 0.85, shrink_frac: float = 0.35,
                 probe_after_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        rungs = tuple(w for w in SPEC_WINDOW_LADDER if 0 < w <= max(w_max, 2))
        self.rungs = rungs
        self.alpha = alpha
        self.grow_frac = grow_frac
        self.shrink_frac = shrink_frac
        self.probe_after_s = probe_after_s
        self.clock = clock
        self.shed_events = 0
        self._win = [rungs[0]] * n_slots
        self._ewma: list[Optional[float]] = [None] * n_slots
        self._disabled_at: list[Optional[float]] = [None] * n_slots
        self._shed_prev: set[int] = set()

    def reset(self, slot: int):
        """New request in the slot: fresh window at the bottom rung (probe
        first, grow on evidence) and no carried-over acceptance history."""
        self._win[slot] = self.rungs[0]
        self._ewma[slot] = None
        self._disabled_at[slot] = None

    def observe(self, slot: int, window: int, count: int):
        """Fold one round's outcome (``count`` tokens emitted from a
        ``window``-wide round) into the slot's EWMA and resize."""
        if window < 1:
            return
        e = self._ewma[slot]
        e = float(count) if e is None else (
            self.alpha * count + (1.0 - self.alpha) * e
        )
        self._ewma[slot] = e
        w = self._win[slot]
        if w == 0:
            return
        if e >= self.grow_frac * w and w < self.rungs[-1]:
            self._win[slot] = self.rungs[
                min(self.rungs.index(w) + 1, len(self.rungs) - 1)
            ]
        elif e <= max(1.25, self.shrink_frac * w):
            i = self.rungs.index(w)
            if i == 0:
                self._win[slot] = 0
                self._disabled_at[slot] = self.clock()
                self._ewma[slot] = None  # the probe gets fresh evidence
            else:
                self._win[slot] = self.rungs[i - 1]

    def window(self, slot: int) -> int:
        """Current window for the slot, applying the re-probe schedule:
        a disabled slot returns to the bottom rung after probe_after_s."""
        if self._win[slot] == 0 and self._disabled_at[slot] is not None:
            if self.clock() - self._disabled_at[slot] >= self.probe_after_s:
                self._win[slot] = self.rungs[0]
                self._disabled_at[slot] = None
        return self._win[slot]

    def effective_windows(self, slots: Sequence[int], level: int = 0):
        """Per-round window plan for the live ``slots`` under brownout
        pressure ``level``: level >= 3 sheds every slot, level 2 sheds the
        lowest-EWMA half (no-evidence slots shed first — under pressure,
        unproven speculation goes before proven), below 2 sheds nothing.
        Returns {slot: window}; counts shed-set ENTRY transitions in
        ``shed_events``."""
        wins = {s: self.window(s) for s in slots}
        enabled = [s for s in slots if wins[s] > 0]
        if level >= 3:
            shed = set(enabled)
        elif level == 2 and enabled:
            order = sorted(
                enabled,
                key=lambda s: (
                    self._ewma[s] if self._ewma[s] is not None else 0.0, s
                ),
            )
            shed = set(order[: (len(enabled) + 1) // 2])
        else:
            shed = set()
        self.shed_events += len(shed - self._shed_prev)
        self._shed_prev = shed
        for s in shed:
            wins[s] = 0
        return wins

    def ewma(self, slot: int) -> Optional[float]:
        return self._ewma[slot]

    def stats(self) -> dict:
        """Gauge source for the mst_spec_* metrics and /health."""
        tracked = [e for e in self._ewma if e is not None]
        return {
            "windows": list(self._win),
            "disabled_slots": sum(
                1 for w, d in zip(self._win, self._disabled_at)
                if w == 0 and d is not None
            ),
            "shed_events": self.shed_events,
            "ewma_mean": (sum(tracked) / len(tracked)) if tracked else 0.0,
        }


def _captured(*gens: Generator) -> dict:
    """Graphs captured by ``gens``, their capture seconds and the bytes of
    their pools (a pool shared by two Generators of one model counted
    once)."""
    graphs = [g.graphs for g in gens]
    pools = {tuple(g.pool): g for g in graphs}
    return {"graphs": sum(g.captures for g in graphs),
            "seconds": sum(g.capture_seconds for g in graphs),
            "pool_bytes": sum(g.pool_bytes() for g in pools.values())}


def _target(model, target: Optional[Generator], **kw) -> Generator:
    """The Generator a speculating generator verifies on: its own over
    ``model``, or ``target``, an existing one over ``model`` whose captured
    prefill chunks and decode blocks it reuses (that Generator must not
    serve meanwhile: the rounds move its cache)."""
    if target is None:
        return Generator(model, **kw)
    if target.model is not model:
        raise ValueError("the target Generator runs another model")
    return target


def _check_full(model) -> None:
    if not (model.config.is_first_stage and model.config.is_last_stage):
        raise ValueError(
            "speculative decoding needs the FULL model on one program "
            "(no start/end-layer stage slice)"
        )


class _SpeculativeBase:
    """The verify round over ``self.target`` (a port ``Generator``): the
    proposals and the window cap sit in the persistent ``self._inputs``
    ((1 + K) int64: the cap, then the K drafts), the step runs the target's
    T=K forward at the device position and :func:`verify_round`, moves the
    position by the count, and leaves the next input token and the window
    in the target's carries. Its static output is ``(count, gs)`` as one
    (K + 1, 1) int64 tensor, the round's one host read."""

    target: Generator
    draft: Optional[Generator] = None

    def _init_rounds(self, k_max: int) -> None:
        """The rounds' buffers (for windows up to ``k_max``) and counters."""
        dev = self.target.device
        self._key = next(_GENERATOR_KEYS)
        self._inputs = torch.zeros(1 + k_max, dtype=torch.int64, device=dev)
        self._qlps: Optional[torch.Tensor] = None  # (K_max, 1, V) of a sampling draft
        # acceptance telemetry: verify rounds, tokens emitted by speculating
        # rounds and the proposals they were offered (JAX's counters), then
        # the work the rounds and the tails ran: verify rounds by width, the
        # tokens the rounds emitted, and the decode steps of the tails'
        # whole blocks
        self.rounds = 0
        self.accepted_tokens = 0
        self.draft_tokens = 0
        self.rounds_by_k: dict[int, int] = {}
        self.round_tokens = 0
        self.tail_steps = 0

    def _tail(self, remaining: int, window: int, sampled: bool):
        """The rest of the request in plain decode blocks (the tail, or the
        capacity edge)."""
        block = self.target.decode_block
        self.tail_steps += -(-remaining // block) * block
        yield from self.target.decode_stream(remaining, window, sampled, False)

    def _verify_step(self, k: int, window: int, sampled: bool) -> torch.Tensor:
        t = self.target
        drafts = self._inputs[1 : 1 + k]
        x = torch.cat([t._tok, drafts[:-1]])[None]  # (1, K): [t0, d1..d_{K-1}]
        logits, _ = t.model(x, t.cache)  # (1, K, V), rows written at the device position
        recent = t._recent[window]
        q = None
        if self.draft is not None and sampled:
            q = self._qlps[:k]
        gs, count, nxt, rec = verify_round(
            logits, drafts[:, None], recent, t.sp, t.rng, sampled=sampled, q_logprobs=q,
            wcap=self._inputs[:1] if self.draft is None else None)
        recent.copy_(rec)
        t.cache.pos.add_(count)
        t._tok.copy_(nxt)
        if self.draft is not None:
            # the draft consumed [t0, d1..d_{K-1}]: keep the verified prefix
            self.draft.cache.pos.add_(count - k)
        return torch.cat([count[None], gs])

    def _verify(self, k: int, window: int, sampled: bool) -> tuple[int, np.ndarray]:
        """One verify (a replay on the card); returns (count, gs (K,))."""
        t = self.target
        state = (t.cache.pos, t._tok, t._window(window))
        if self.draft is not None:
            state += (self.draft.cache.pos,)
        out = t._run(("verify", self._key, k, sampled, window),
                     functools.partial(self._verify_step, k, window, sampled),
                     state=state, generators=(t.rng,) if sampled else ())
        vals = out.cpu().numpy()[:, 0]  # the round's one read: (count, gs)
        self.rounds_by_k[k] = self.rounds_by_k.get(k, 0) + 1
        n = int(vals[0])
        self.round_tokens += n
        t.cache = dataclasses.replace(t.cache, offset=t.cache.offset + n)
        return n, vals[1:]

    def _fallback(self, request: dict) -> Iterator[tuple[int, Optional[TokenLogprobs]]]:
        """Logprobs need per-token summaries the verify does not compute:
        the exact plain path."""
        yield from self.target.generate_step(**request)


class NgramSpeculativeGenerator(_SpeculativeBase):
    """``generate_step`` contract with prompt-lookup drafts — no draft
    model, no draft KV cache. Proposals come from :class:`NgramDraftProposer`
    over the stream's own prompt + produced history; the target scores them
    in one T=K forward. The window adapts per round via
    :class:`AcceptanceTracker`; a disabled window runs K=1 rounds
    (verify-only decode, one token per forward, still exact) until the
    re-probe timer fires. The per-round window cap is applied inside the
    verify (m = min(m, wcap-1)), before anything commits. The target is a
    port ``Generator`` of its own (``self.target``)."""

    def __init__(
        self,
        model,
        *,
        spec_window_max: int = 8,
        max_seq: int = 4096,
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        max_ngram: int = 3,
        clock: Callable[[], float] = time.monotonic,
        cuda_graphs: bool = True,
        decode_block: int = DEFAULT_DECODE_BLOCK,
        target: Optional[Generator] = None,
    ):
        if spec_window_max < 2:
            raise ValueError(
                f"spec_window_max must be >= 2, got {spec_window_max}"
            )
        _check_full(model)
        self.target = _target(model, target, max_seq=max_seq, prefill_chunk=prefill_chunk,
                              cuda_graphs=cuda_graphs, decode_block=decode_block)
        self.max_seq = self.target.max_seq
        self.proposer = NgramDraftProposer(max_ngram=max_ngram)
        self.tracker = AcceptanceTracker(1, w_max=spec_window_max, clock=clock)
        self.spec_window_max = spec_window_max
        self._init_rounds(self.tracker.rungs[-1])

    def warm_up(self, prefill_upto: Optional[int] = None, sampled=(False, True)) -> dict:
        """The target's graphs (``Generator.warm_up``, its prefill chunks up
        to ``prefill_upto`` tokens), then the verify of every window of the
        ladder and K = 1, greedy and sampled (or the kinds in ``sampled``,
        the other captured on first use), at the default window. ``{}``
        without graphs."""
        if not self.target.warm_up(prefill_upto=prefill_upto):
            return {}
        self.target.cache.pos.zero_()  # the verify's rows stay inside the capacity
        for k in (1, *self.tracker.rungs):
            upload_into(self._inputs, np.asarray([k] + [0] * k, np.int64))  # a cap of K
            for kind in sampled:
                self._verify(k, REPETITION_WINDOW, kind)
        torch.cuda.synchronize(self.target.device)
        self.rounds_by_k, self.round_tokens = {}, 0  # the warm-up's rounds are not requests'
        return _captured(self.target)

    def generate_step(self, prompt_tokens, *, max_tokens: int = 256,
                      want_logprobs: bool = False, **sampler_kwargs):
        if want_logprobs:
            yield from self._fallback(dict(prompt_tokens=prompt_tokens, max_tokens=max_tokens,
                                           want_logprobs=True, **sampler_kwargs))
            return
        t = self.target
        self.tracker.reset(0)
        tok, _, window, sampled = t.begin(prompt_tokens, max_tokens=max_tokens, **sampler_kwargs)
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        history = list(prompt) + [tok]
        yield tok, None
        emitted = 1
        offset = prompt.size
        while emitted < max_tokens:
            w = self.tracker.window(0)
            k = w if w > 0 else 1  # disabled: verify-only decode round
            if offset + k > self.max_seq or max_tokens - emitted < 2:
                # tail (or capacity edge): plain blocked decode from here
                yield from self._tail(max_tokens - emitted, window, sampled)
                return
            drafts, n_valid = self.proposer.propose(history, k)
            wc = min(k, max(1, n_valid))
            upload_into(self._inputs, np.concatenate([[wc], drafts]).astype(np.int64))
            n, gs = self._verify(k, window, sampled)
            self.rounds += 1
            if w > 0:
                # disabled rounds are plain decode in disguise — counting
                # their single token as "accepted" with zero draft tokens
                # would push accept_rate past 1.0
                self.accepted_tokens += n
                self.draft_tokens += wc
                self.tracker.observe(0, w, n)
            for j in range(n):
                if emitted >= max_tokens:
                    break
                yield int(gs[j]), None
                history.append(int(gs[j]))
                emitted += 1
            offset += n

    def spec_stats(self) -> dict:
        """CLI/telemetry summary of this stream's speculation outcome."""
        return {
            "mode": "ngram",
            "window_max": self.spec_window_max,
            "rounds": self.rounds,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": self.accepted_tokens / max(1, self.draft_tokens),
            **self.tracker.stats(),
        }


class SpeculativeGenerator(_SpeculativeBase):
    """``generate_step`` contract over a (target, draft) model pair: two
    port Generators (their prefill chunks and decode blocks reused as they
    are), each with its own cache and graphs, plus the draft's K steps and
    the target's verify. A self-draft (the target model as its own draft)
    shares the weight tensors and copies none. The draft proposes by plain
    argmax with no transforms (greedy), or samples from the transformed
    distribution with its own generator and records q (sampled); its
    position rewinds on the device by ``count - K`` in the verify."""

    def __init__(
        self,
        model,
        draft_model,
        *,
        spec_k: int = 4,
        max_seq: int = 4096,
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        cuda_graphs: bool = True,
        decode_block: int = DEFAULT_DECODE_BLOCK,
        target: Optional[Generator] = None,
    ):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        tv = getattr(model.config, "vocab_size", None)
        dv = getattr(draft_model.config, "vocab_size", None)
        if tv != dv:
            # a mismatched pair would silently emit clamped-index garbage:
            # draft token ids index the target's embedding/logprob rows
            raise ValueError(
                f"draft vocab ({dv}) must match target vocab ({tv}) — "
                "speculation exchanges raw token ids between the models"
            )
        _check_full(model)
        if draft_model.device != model.device:
            raise ValueError(f"the draft model is on {draft_model.device}, the target on "
                             f"{model.device}")
        self.spec_k = spec_k
        self.target = _target(model, target, max_seq=max_seq, prefill_chunk=prefill_chunk,
                              cuda_graphs=cuda_graphs, decode_block=decode_block)
        self.draft = Generator(draft_model, max_seq=self.target.max_seq,
                               prefill_chunk=self.target.prefill_chunk, cuda_graphs=cuda_graphs)
        self.max_seq = self.target.max_seq
        self._init_rounds(spec_k)

    def _draft_step(self, k: int, window: int, sampled: bool) -> None:
        """K draft steps from the target's next input token at the draft's
        device position, into the proposals of ``_inputs`` (and their q
        rows, sampled). The draft sees the target's window and evolves a
        local copy with its own proposals."""
        t, d = self.target, self.draft
        tok, rec = t._tok, t._window(window)
        toks, qs = [], []
        for _ in range(k):
            logits, _ = d.model(tok[:, None], d.cache)
            d.cache.pos.add_(1)
            if sampled:
                f = dist_logits(logits[:, -1], rec, t.sp)
                qs.append(torch.log_softmax(f, dim=-1))
                tok = draw(torch.softmax(f, dim=-1), d.rng)
                rec = update_recent_tokens(rec, tok)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)
            toks.append(tok)
        self._inputs[1 : 1 + k].copy_(torch.cat(toks))
        if sampled:
            if self._qlps is None:
                self._qlps = torch.empty((self.spec_k, 1, logits.shape[-1]), dtype=torch.float32,
                                         device=t.device)
            self._qlps[:k].copy_(torch.stack(qs))

    def propose(self, k: int, window: int, sampled: bool) -> None:
        """The draft's K steps (a replay on the card); nothing read back."""
        d = self.draft
        d._run(("draft", k, sampled, window),
               functools.partial(self._draft_step, k, window, sampled),
               state=(d.cache.pos,), generators=(d.rng,) if sampled else ())

    def warm_up(self, prefill_upto: Optional[int] = None, sampled=(False, True)) -> dict:
        """Both Generators' prefill chunks (up to ``prefill_upto`` tokens),
        the target's decode blocks, the draft steps and the verify at
        ``spec_k``, greedy and sampled (or the kinds in ``sampled``, the
        other captured on first use), at the default window. ``{}`` without
        graphs."""
        if not self.target.warm_up(prefill_upto=prefill_upto):
            return {}
        self.draft.warm_up(decode_blocks=False, prefill_upto=prefill_upto)
        self.target.cache.pos.zero_()  # the rows stay inside the capacity
        self.draft.cache.pos.zero_()
        if self._qlps is None:
            self._qlps = torch.zeros((self.spec_k, 1, self.target.model.config.vocab_size),
                                     dtype=torch.float32, device=self.target.device)
        for kind in sampled:
            self.propose(self.spec_k, REPETITION_WINDOW, kind)
            self._verify(self.spec_k, REPETITION_WINDOW, kind)
        torch.cuda.synchronize(self.target.device)
        self.rounds_by_k, self.round_tokens = {}, 0  # the warm-up's rounds are not requests'
        return _captured(self.target, self.draft)

    def generate_step(self, prompt_tokens, *, max_tokens: int = 256,
                      want_logprobs: bool = False, seed: Optional[int] = None,
                      **sampler_kwargs):
        if want_logprobs:
            yield from self._fallback(dict(prompt_tokens=prompt_tokens, max_tokens=max_tokens,
                                           want_logprobs=True, seed=seed, **sampler_kwargs))
            return
        t, d = self.target, self.draft
        seed = time.time_ns() & 0x7FFFFFFF if seed is None else seed
        tok, _, window, sampled = t.begin(prompt_tokens, max_tokens=max_tokens, seed=seed,
                                          **sampler_kwargs)
        # the draft prefills the same prompt into its own cache and draws
        # from its own stream
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        d.run_prefill(prompt)
        d.rng.manual_seed((seed + 1) & 0x7FFFFFFF)
        yield tok, None
        emitted = 1
        # the first emitted token's row is in NEITHER cache: both models
        # consume it as the next round's input token. ``offset`` mirrors the
        # position on the host for the capacity check
        offset = prompt.shape[1]
        k = self.spec_k
        while emitted < max_tokens:
            if offset + k > self.max_seq or max_tokens - emitted < 2:
                # tail (or capacity edge): plain blocked decode from here
                yield from self._tail(max_tokens - emitted, window, sampled)
                return
            self.propose(k, window, sampled)
            n, gs = self._verify(k, window, sampled)
            self.rounds += 1
            self.accepted_tokens += n
            self.draft_tokens += k
            for j in range(n):
                if emitted >= max_tokens:
                    break
                yield int(gs[j]), None
                emitted += 1
            offset += n

    def spec_stats(self) -> dict:
        """CLI/telemetry summary of this stream's speculation outcome."""
        return {
            "mode": "engine",
            "window_max": self.spec_k,
            "rounds": self.rounds,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": self.accepted_tokens / max(1, self.draft_tokens),
        }
