"""Autoregressive generation (port of the single-stream dense path of
``mlx_sharding_tpu/generate.py``).

- Prefill runs in fixed-size chunks with a right-padded last chunk; capacity
  is rounded up to a chunk multiple so every padded write fits. Pad rows are
  overwritten by later contiguous writes before any valid query attends
  them, so they need no mask beyond the causal rule.
- Decode runs in whole blocks of ``DEFAULT_DECODE_BLOCK`` T=1 steps with
  sampling on the device, as JAX's ``blocked_token_stream`` does: the tokens
  past the request's last are dropped. The tokens (and the logprob
  summaries, when asked for) come to the host once per block. Block i+1 is
  enqueued before block i is read, so the host's read and its Python loop
  overlap the card's work.
- On a CUDA device each prefill chunk and each decode block is one captured
  CUDA graph (``graphs.py``), JAX's ``prefill_fn`` and ``decode_block_fn``
  under ``jax.jit``: a chunk's graph per chunk offset (the flash kernel
  bakes the offset into its launch), a block's per (block size, window,
  sampler branch, logprobs). The graphs hold the addresses of the
  Generator's buffers, so it owns one cache of ``max_seq`` and one of every
  other carry, and resets them per request. On the CPU the same step
  functions run eagerly.

The server's ``--decode-block`` flag, the prompt cache, the
sequence-parallel paths and speculation come with later slices.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.sample import (
    init_recent_tokens,
    make_sampler_params,
    sample_token_batched,
    set_sampler_slot,
    stack_sampler_params,
    update_recent_tokens,
)
from mlx_sharding_tpu_torch.tokenizer_utils import (
    StreamingDetokenizer,
    sequence_overlap,
    stopping_criteria,
)

DEFAULT_PREFILL_CHUNK = 256
REPETITION_WINDOW = 20
DEFAULT_DECODE_BLOCK = 16
LOGPROB_TOPK = 10


@dataclass
class TokenLogprobs:
    """Per-token logprob summary computed on the device; ``top_indices`` and
    ``top_values`` are descending, length LOGPROB_TOPK."""

    chosen: float
    top_indices: np.ndarray
    top_values: np.ndarray


def block_lp_outputs(tok, logprobs):
    """``(chosen, top_values, top_indices)`` of one step, on the device."""
    chosen = logprobs.gather(1, tok[:, None])[:, 0]
    top_v, top_i = torch.topk(logprobs, LOGPROB_TOPK, dim=-1)
    return chosen, top_v, top_i


def block_token_logprobs(outs, j, row=0) -> TokenLogprobs:
    """The summary of step j, batch row ``row`` (a continuous-batching
    slot), from a pulled block ``(tokens, chosen, top_values,
    top_indices)``."""
    return TokenLogprobs(float(outs[1][j, row]), outs[3][j, row], outs[2][j, row])


def blocked_token_stream(dispatch, remaining, block_size, want_logprobs):
    """The blocked decode loop with one block of lookahead: ``dispatch()``
    enqueues one whole block of ``block_size`` steps and returns its stacked
    outputs; the tokens past ``remaining`` are never yielded."""
    n_blocks = -(-remaining // block_size)
    pending = [dispatch()]
    emitted = 0
    for bi in range(n_blocks):
        if bi + 1 < n_blocks:
            pending.append(dispatch())
        outs = [o.cpu().numpy() for o in pending.pop(0)]
        for j in range(outs[0].shape[0]):
            if emitted >= remaining:
                return
            lp = block_token_logprobs(outs, j) if want_logprobs else None
            yield int(outs[0][j, 0]), lp
            emitted += 1


@dataclass
class StreamChunk:
    text: str = ""
    token: Optional[int] = None
    finish_reason: Optional[str] = None
    # set on the final chunk: prompt/generation tok/s and TTFT
    prompt_tokens: int = 0
    generation_tokens: int = 0
    prompt_tps: float = 0.0
    generation_tps: float = 0.0
    ttft: float = 0.0


class Generator:
    """Serves many requests, one at a time, with one model. It owns one
    cache (in the model's dtype) of ``max_seq`` positions, one sampler row,
    one random generator and a repetition window per window size, and
    resets them per request: on a CUDA device its captured steps hold their
    addresses. ``cuda_graphs=False`` runs the same steps eagerly on the card
    (for checks and measurements against the graphs).

    At construction it fuses the model's packed projection groups (QKV,
    gate+up; ``models.base.apply_projection_fusion``) so that each group is
    one kernel launch. Unlike the JAX ``Generator``, which fuses a shallow
    copy of its params, this fuses the caller's model IN PLACE, so the
    packed weights are held once; ``fused_projections`` names what was
    fused (nothing for a dense model, or one fused before)."""

    def __init__(
        self,
        model,
        *,
        max_seq: int = 4096,
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        cuda_graphs: bool = True,
    ):
        from mlx_sharding_tpu_torch.graphs import StepGraphs, model_pool
        from mlx_sharding_tpu_torch.models.base import apply_projection_fusion

        self.model = model
        self.fused_projections = apply_projection_fusion(model)
        self.device = dev = model.device
        self.max_seq = -(-max_seq // prefill_chunk) * prefill_chunk
        self.prefill_chunk = prefill_chunk
        model.place_constants(dev)
        self.cache = dataclasses.replace(model.make_cache(1, self.max_seq),
                                         pos=torch.zeros(1, dtype=torch.int64, device=dev))
        self.sp = stack_sampler_params([make_sampler_params(device="cpu")], device=dev)
        self.rng = torch.Generator(device=dev)
        self._recent: dict[int, torch.Tensor] = {}  # window size -> (1, W) int64
        self._tok = torch.zeros(1, dtype=torch.int64, device=dev)  # the last token
        self._chunk = torch.zeros((1, prefill_chunk), dtype=torch.int64, device=dev)
        self._last = torch.zeros(1, dtype=torch.int64, device=dev)  # its last valid row
        self.graphs = (StepGraphs(dev, model_pool(model))
                       if dev.type == "cuda" and cuda_graphs else None)

    # -------------------------------------------------------------- steps
    def _run(self, key, step, *, state, generators=()):
        """One step: a replay of its graph on the card, the step itself
        elsewhere (or with ``cuda_graphs=False``)."""
        if self.graphs is None:
            return step()
        return self.graphs.run(key, step, state=state, generators=generators)

    def _prefill_step(self, offset: int):
        """One chunk at ``offset``: ``_chunk`` in, the logits (1, V) at row
        ``_last`` out; the device position ends at ``offset + _last + 1``."""
        pos = self.cache.pos
        pos.fill_(offset)
        out, _ = self.model(self._chunk, dataclasses.replace(self.cache, offset=offset),
                            logits_at=self._last)
        pos.add_(self._last + 1)
        return out[:, 0]

    def _decode_steps(self, steps: int, window: int, sampled: bool, want_logprobs: bool):
        """``steps`` decode steps from ``_tok`` at the device position, each
        sampled with the sampler row, ``rng`` and the window; the carries
        are updated in place. Returns the stacked per-step outputs."""
        recent = self._recent[window]
        tok, outs = self._tok, []
        for _ in range(steps):
            logits, _ = self.model(tok[:, None], self.cache)
            self.cache.pos.add_(1)
            tok, logprobs = sample_token_batched(self.rng, logits[:, -1], self.sp, recent,
                                                 sampled=sampled)
            recent.copy_(update_recent_tokens(recent, tok))
            outs.append((tok, *block_lp_outputs(tok, logprobs)) if want_logprobs else (tok,))
        self._tok.copy_(tok)
        return tuple(torch.stack(x) for x in zip(*outs))

    def _window(self, size: int) -> torch.Tensor:
        if size not in self._recent:
            self._recent[size] = torch.full((1, size), -1, dtype=torch.int64,
                                            device=self.device)
        return self._recent[size]

    def run_chunk(self, offset: int) -> torch.Tensor:
        """One prefill chunk at ``offset`` from the chunk buffers (a replay
        on the card); returns its logits (1, V), the static output."""
        return self._run(("prefill", offset), functools.partial(self._prefill_step, offset),
                         state=(self.cache.pos,))

    def run_prefill(self, prompt: np.ndarray) -> torch.Tensor:
        """Chunked prefill of ``prompt`` (1, T) into the Generator's cache
        from position 0. Returns the logits (1, V) at the last valid
        position; the cache's offset and device position end at T."""
        c = self.prefill_chunk
        n = prompt.shape[1]
        padded = np.zeros((1, -(-n // c) * c), np.int64)
        padded[:, :n] = prompt
        tokens = upload(padded, self.device)
        logits = None
        for start in range(0, n, c):
            n_valid = min(c, n - start)
            self._chunk.copy_(tokens[:, start : start + c])
            self._last.fill_(n_valid - 1)
            logits = self.run_chunk(start)
            self.cache = dataclasses.replace(self.cache, offset=start + n_valid)
        return logits.clone()

    def decode_block(self, steps: int, window: int, sampled: bool, want_logprobs: bool):
        """Enqueue ``steps`` decode steps (one replay on the card) and
        return their stacked outputs ``(tokens (K, 1)[, chosen, top
        values, top indices])``, nothing read on the host."""
        key = ("decode", steps, window, sampled, want_logprobs)
        step = functools.partial(self._decode_steps, steps, window, sampled, want_logprobs)
        outs = self._run(key, step, state=(self.cache.pos, self._tok, self._window(window)),
                         generators=(self.rng,) if sampled else ())
        self.cache = dataclasses.replace(self.cache, offset=self.cache.offset + steps)
        return tuple(o.clone() for o in outs)

    def warm_up(self) -> dict:
        """Capture, before the first request, every prefill chunk's graph
        (one per chunk offset) and the decode blocks of the default window
        (greedy and sampled, with and without logprobs). Returns the graphs
        captured, their capture seconds and the pool's bytes; without
        graphs, nothing is captured and it returns ``{}``."""
        if self.graphs is None:
            return {}
        c = self.prefill_chunk
        self._chunk.zero_()
        self._last.fill_(c - 1)
        for start in range(0, self.max_seq, c):
            self.run_chunk(start)
        for sampled in (False, True):
            for want_logprobs in (False, True):
                self.decode_block(DEFAULT_DECODE_BLOCK, REPETITION_WINDOW, sampled, want_logprobs)
        torch.cuda.synchronize(self.device)
        return {"graphs": self.graphs.captures, "seconds": self.graphs.capture_seconds,
                "pool_bytes": self.graphs.pool_bytes()}

    # -------------------------------------------------------------- requests
    def generate_step(
        self,
        prompt_tokens,
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        repetition_penalty: Optional[float] = None,
        repetition_context_size: int = REPETITION_WINDOW,
        logit_bias: Optional[dict[int, float]] = None,
        seed: Optional[int] = None,
        max_tokens: int = 256,
        want_logprobs: bool = False,
    ) -> Iterator[tuple[int, Optional[TokenLogprobs]]]:
        """Yields ``(token, logprobs)`` per generated token; ``logprobs`` is
        a :class:`TokenLogprobs` when ``want_logprobs``, else None."""
        sp = make_sampler_params(temperature, top_p, repetition_penalty, logit_bias,
                                 device="cpu")
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        n_prompt = prompt.shape[1]
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt + max_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({n_prompt}) + max_tokens ({max_tokens}) exceeds KV "
                f"capacity {self.max_seq}"
            )
        set_sampler_slot(self.sp, 0, sp)
        self.rng.manual_seed(time.time_ns() & 0x7FFFFFFF if seed is None else seed)
        # at penalty 1 the window changes nothing: every request shares one
        window = repetition_context_size if sp.repetition_penalty != 1.0 else REPETITION_WINDOW
        recent = self._window(window)
        recent.copy_(init_recent_tokens(1, window, prompt, device=self.device))
        sampled = sp.temperature > 0
        last_logits = self.run_prefill(prompt)
        tok, logprobs = sample_token_batched(self.rng, last_logits, self.sp, recent,
                                             sampled=sampled)
        recent.copy_(update_recent_tokens(recent, tok))
        self._tok.copy_(tok)
        first_lp = None
        if want_logprobs:
            chosen, top_v, top_i = (x.cpu().numpy() for x in block_lp_outputs(tok, logprobs))
            first_lp = TokenLogprobs(float(chosen[0]), top_i[0], top_v[0])
        yield int(tok[0]), first_lp
        remaining = max_tokens - 1
        if remaining <= 0:
            return
        block = DEFAULT_DECODE_BLOCK
        yield from blocked_token_stream(
            lambda: self.decode_block(block, window, sampled, want_logprobs),
            remaining, block, want_logprobs,
        )


def stream_generate(
    generator: Generator,
    tokenizer,
    prompt_tokens: list[int],
    *,
    max_tokens: int = 256,
    stop_id_sequences: Optional[list[list[int]]] = None,
    eos_token_ids: Optional[list[int]] = None,
    **sampler_kwargs,
) -> Iterator[StreamChunk]:
    """Detokenized streaming with stop handling and tok/s + TTFT
    instrumentation, as in the JAX package."""
    stop_id_sequences = stop_id_sequences or []
    if eos_token_ids is None:
        eos = getattr(tokenizer, "eos_token_id", None)
        eos_token_ids = [eos] if eos is not None else []
    detok = StreamingDetokenizer(tokenizer)
    tokens: list[int] = []
    in_flight: list[int] = []  # withheld: could still grow into a stop sequence

    start = time.perf_counter()
    first_token_time = None
    finish_reason = "length"
    for token, _ in generator.generate_step(prompt_tokens, max_tokens=max_tokens, **sampler_kwargs):
        if first_token_time is None:
            first_token_time = time.perf_counter()
        tokens.append(token)
        if token in eos_token_ids:
            finish_reason = "stop"
            in_flight.clear()
            break
        stop = stopping_criteria(tokens, stop_id_sequences, None)
        if stop.stop_met:
            # the matched stop sequence itself is trimmed, never emitted
            finish_reason = "stop"
            tokens = tokens[: len(tokens) - stop.trim_length]
            in_flight.clear()
            break
        if stop_id_sequences and any(sequence_overlap(tokens, s) for s in stop_id_sequences):
            in_flight.append(token)
            continue
        for t in in_flight:
            detok.add_token(t)
        in_flight.clear()
        detok.add_token(token)
        if detok.last_segment:
            yield StreamChunk(text=detok.last_segment, token=token)
    # a run that ended on length while buffering emits the buffered tokens:
    # they were never part of a completed stop sequence
    for t in in_flight:
        detok.add_token(t)
    detok.finalize()
    end = time.perf_counter()

    n_prompt = len(prompt_tokens)
    ttft = (first_token_time or end) - start
    gen_time = max(end - (first_token_time or end), 1e-9)
    yield StreamChunk(
        text=detok.last_segment if detok.last_segment else "",
        finish_reason=finish_reason,
        prompt_tokens=n_prompt,
        generation_tokens=len(tokens),
        prompt_tps=n_prompt / max(ttft, 1e-9),
        generation_tps=max(len(tokens) - 1, 0) / gen_time,
        ttft=ttft,
    )
