"""Autoregressive generation (port of the single-stream dense path of
``mlx_sharding_tpu/generate.py``).

- Prefill runs in fixed-size chunks with a right-padded last chunk; capacity
  is rounded up to a chunk multiple so every padded write fits. Pad rows are
  overwritten by later contiguous writes before any valid query attends
  them, so they need no mask beyond the causal rule.
- Decode runs in blocks of ``DEFAULT_DECODE_BLOCK`` T=1 steps with
  sampling on the device; the tokens (and the logprob summaries, when asked
  for) come to the host once per block. Block i+1 is enqueued before block
  i is read, so the host's read and its Python loop overlap the card's
  work. The server's ``--decode-block`` flag comes with a later slice.

The prompt cache, the sequence-parallel paths and speculation come with
later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.sample import (
    init_recent_tokens,
    make_sampler_params,
    sample_token,
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


def blocked_token_stream(dispatch, carry, remaining, block_size, want_logprobs):
    """The blocked decode loop with one block of lookahead.
    ``dispatch(carry, n) -> (block_outputs, carry)`` enqueues ``n`` steps;
    the last block runs only the steps still needed."""
    sizes = [min(block_size, remaining - i) for i in range(0, remaining, block_size)]
    pending, carry = dispatch(carry, sizes[0])
    pending = [pending]
    for bi in range(len(sizes)):
        if bi + 1 < len(sizes):
            nxt, carry = dispatch(carry, sizes[bi + 1])
            pending.append(nxt)
        outs = [o.cpu().numpy() for o in pending.pop(0)]
        for j in range(outs[0].shape[0]):
            lp = block_token_logprobs(outs, j) if want_logprobs else None
            yield int(outs[0][j, 0]), lp


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
    """Serves many requests, one at a time, with one model; each request
    gets its own cache (in the model's dtype), repetition window and random
    generator.

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
    ):
        from mlx_sharding_tpu_torch.models.base import apply_projection_fusion

        self.model = model
        self.fused_projections = apply_projection_fusion(model)
        self.device = model.device
        self.max_seq = -(-max_seq // prefill_chunk) * prefill_chunk
        self.prefill_chunk = prefill_chunk

    def run_prefill(self, prompt: np.ndarray, cache):
        """Chunked prefill of ``prompt`` (1, T) into ``cache``. Returns the
        logits (1, V) at the last valid position, and the cache."""
        c = self.prefill_chunk
        logits = None
        for start in range(0, prompt.shape[1], c):
            chunk = prompt[:, start : start + c]
            n_valid = chunk.shape[1]
            if n_valid < c:
                chunk = np.pad(chunk, ((0, 0), (0, c - n_valid)))
            tokens = torch.from_numpy(np.ascontiguousarray(chunk, np.int64)).to(self.device)
            out, cache = self.model(tokens, cache, n_valid=n_valid, logits_at=n_valid - 1)
            logits = out[:, 0]
        return logits, cache

    def _decode_block(self, carry, steps, sp, gen, want_logprobs):
        """``steps`` decode steps enqueued back to back; nothing is read on
        the host. Returns the stacked per-step outputs and the carry."""
        tok, cache, recent = carry
        outs = []
        for _ in range(steps):
            logits, cache = self.model(tok[:, None], cache)
            tok, logprobs = sample_token(gen, logits[:, -1], sp, recent)
            recent = update_recent_tokens(recent, tok)
            outs.append((tok, *block_lp_outputs(tok, logprobs)) if want_logprobs else (tok,))
        return tuple(torch.stack(x) for x in zip(*outs)), (tok, cache, recent)

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
                                 device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(time.time_ns() & 0x7FFFFFFF if seed is None else seed)
        prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
        n_prompt = prompt.shape[1]
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt + max_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({n_prompt}) + max_tokens ({max_tokens}) exceeds KV "
                f"capacity {self.max_seq}"
            )
        recent = init_recent_tokens(1, repetition_context_size, prompt, device=self.device)
        cache = self.model.make_cache(1, self.max_seq)
        last_logits, cache = self.run_prefill(prompt, cache)
        tok, logprobs = sample_token(gen, last_logits, sp, recent)
        recent = update_recent_tokens(recent, tok)
        first_lp = None
        if want_logprobs:
            chosen, top_v, top_i = (x.cpu().numpy() for x in block_lp_outputs(tok, logprobs))
            first_lp = TokenLogprobs(float(chosen[0]), top_i[0], top_v[0])
        yield int(tok[0]), first_lp
        remaining = max_tokens - 1
        if remaining <= 0:
            return
        yield from blocked_token_stream(
            lambda carry, n: self._decode_block(carry, n, sp, gen, want_logprobs),
            (tok, cache, recent), remaining, DEFAULT_DECODE_BLOCK, want_logprobs,
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
