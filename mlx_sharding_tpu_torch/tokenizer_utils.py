# Copy of mlx_sharding_tpu/tokenizer_utils.py, kept here so the port imports nothing of the JAX package.
"""Tokenizer runtime: incremental detokenization + stop-sequence machinery.

The reference borrows both from mlx_lm (TokenizerWrapper detokenizer,
SURVEY §2.2) and implements stop handling itself
(stopping_criteria ref: shard/openai_api.py:30-43; streaming partial-stop
buffering ref: shard/openai_api.py:436-505). Here both are first-party.

Works with any object exposing ``decode(list[int]) -> str`` (HF tokenizers
do); no network access is assumed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


class StreamingDetokenizer:
    """Incremental detokenizer emitting only *stable* UTF-8 text.

    Decodes a tail window starting at the last safe boundary; withholds
    segments that end in U+FFFD (a token split mid-codepoint — the byte-level
    BPE edge case called out in SURVEY §7 hard-parts (e))."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self.reset()

    # Region restart cap: decoding is O(region length) per token, so without
    # restarts a long newline-free output costs O(n²) total. Restarts keep
    # the last token as a decode prefix: tokenizers that strip leading
    # whitespace at sequence start (SentencePiece-family "▁word") strip it
    # from the prefix-only decode and the prefix+next decode equally, so the
    # emitted *difference* stays correct.
    MAX_REGION_TOKENS = 64
    # A region that never decodes cleanly (adversarial lone continuation
    # bytes) is force-dropped at this bound so per-token cost stays bounded.
    MAX_DIRTY_REGION_TOKENS = 256

    def reset(self):
        self.tokens: list[int] = []
        self._region_start = 0  # first token of the un-flushed decode region
        self._emitted = ""  # text already emitted from the current region
        self.text = ""  # all emitted text
        self.last_segment = ""

    def _restart_region(self):
        """Start a new region keeping the last token as decode prefix."""
        self._region_start = len(self.tokens) - 1
        self._emitted = self._tokenizer.decode(self.tokens[self._region_start :])

    def add_token(self, token: int):
        self.tokens.append(token)
        region = self.tokens[self._region_start :]
        decoded = self._tokenizer.decode(region)
        if decoded.endswith("�"):
            # Mid-codepoint; wait for more tokens — but never unboundedly.
            self.last_segment = ""
            if len(region) >= self.MAX_DIRTY_REGION_TOKENS:
                # drop the undecodable tail entirely
                self._region_start = len(self.tokens)
                self._emitted = ""
            return
        segment = decoded[len(self._emitted) :]
        self.last_segment = segment
        self.text += segment
        if decoded.endswith("\n") or len(region) >= self.MAX_REGION_TOKENS:
            self._restart_region()
        else:
            self._emitted = decoded

    def finalize(self):
        """Flush anything withheld (e.g. trailing U+FFFD bytes are dropped)."""
        region = self.tokens[self._region_start :]
        decoded = self._tokenizer.decode(region).rstrip("�")
        segment = decoded[len(self._emitted) :]
        self.last_segment = segment
        self.text += segment
        self._emitted = decoded


@dataclass
class StopCondition:
    stop_met: bool
    trim_length: int  # tokens to cut from the tail when stop was token-based


def stopping_criteria(
    tokens: Sequence[int],
    stop_id_sequences: Sequence[Sequence[int]],
    eos_token_id: int | None,
) -> StopCondition:
    """Token-level stop check, same contract as ref shard/openai_api.py:30-43:
    EOS stops with no trim; a matched stop sequence stops and trims itself."""
    if tokens and eos_token_id is not None and tokens[-1] == eos_token_id:
        return StopCondition(stop_met=True, trim_length=0)
    for stop_ids in stop_id_sequences:
        n = len(stop_ids)
        if n and len(tokens) >= n and list(tokens[-n:]) == list(stop_ids):
            return StopCondition(stop_met=True, trim_length=n)
    return StopCondition(stop_met=False, trim_length=0)


def sequence_overlap(s1: Sequence, s2: Sequence) -> bool:
    """True if some suffix of ``s1`` is a prefix of ``s2`` — used to buffer
    streamed text that might be the start of a stop sequence, so partial stop
    words are never emitted (ref: shard/openai_api.py:486-505 behavior)."""
    max_overlap = min(len(s1), len(s2))
    return any(s1[-i:] == s2[:i] for i in range(1, max_overlap + 1))
