"""Single-stream token sampling on the device (port of the single-stream
part of ``mlx_sharding_tpu/sample.py``).

The same transforms in the same order: logit bias, the repetition penalty
over a prompt-seeded window, temperature, the top-p nucleus ("kept iff the
mass before it < top_p"), then argmax at temperature 0 or a draw. JAX
traces every branch into one program with dynamic scalars; here the
sampler settings are host floats and the branches are plain ``if``s. The
draw uses an explicit ``torch.Generator``, so it matches the JAX stream in
distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    temperature: float  # 0 -> greedy
    top_p: float  # 1 -> full distribution
    repetition_penalty: float  # 1 -> off
    bias_indices: Optional[torch.Tensor]  # (K,) int64, or None
    bias_values: Optional[torch.Tensor]  # (K,) float32, or None


def make_sampler_params(
    temperature: float = 0.0,
    top_p: float = 1.0,
    repetition_penalty: Optional[float] = None,
    logit_bias: Optional[dict[int, float]] = None,
    *,
    device: torch.device | str,
) -> SamplerParams:
    idx = val = None
    if logit_bias:
        idx = torch.tensor([int(k) for k in logit_bias], dtype=torch.int64, device=device)
        val = torch.tensor([float(v) for v in logit_bias.values()], dtype=torch.float32,
                           device=device)
    return SamplerParams(
        temperature=float(temperature),
        top_p=float(top_p),
        repetition_penalty=1.0 if repetition_penalty is None else float(repetition_penalty),
        bias_indices=idx,
        bias_values=val,
    )


def apply_logit_bias(logits, indices, values):
    """Add ``values`` at ``indices`` along the vocab axis (repeated indices
    add up, as JAX's scatter-add does)."""
    if indices is None:
        return logits
    return logits.index_add(-1, indices, values.expand(*logits.shape[:-1], -1))


def apply_repetition_penalty(logits, recent_tokens, penalty: float):
    """Penalize the tokens of ``recent_tokens`` (B, W), -1 = empty slot:
    positive scores are divided by ``penalty``, negative ones multiplied."""
    b, vocab = logits.shape
    valid = recent_tokens >= 0
    scores = logits.gather(1, torch.where(valid, recent_tokens, 0))
    penalized = torch.where(scores > 0, scores / penalty, scores * penalty)
    # empty slots write into a scratch column that is dropped
    ext = torch.cat([logits, logits.new_zeros(b, 1)], dim=1)
    ext = ext.scatter(1, torch.where(valid, recent_tokens, vocab), penalized)
    return ext[:, :vocab]


def top_p_filter(logits, top_p: float):
    """Mask logits outside the top-p nucleus: keep the smallest prefix of
    the sorted distribution whose mass reaches ``top_p``."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p  # kept iff mass before it < top_p
    min_kept = torch.where(keep_sorted, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits >= min_kept, logits, float("-inf"))


def transform_logits(logits, recent_tokens, params: SamplerParams):
    """bias -> repetition penalty, in fp32."""
    logits = apply_logit_bias(logits.float(), params.bias_indices, params.bias_values)
    if recent_tokens is not None and params.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, recent_tokens, params.repetition_penalty)
    return logits


def nucleus_logits(lo, params: SamplerParams):
    """Temperature, then the top-p cut on the tempered distribution."""
    return top_p_filter(lo / max(params.temperature, 1e-6), params.top_p)


def sample_token(
    generator: torch.Generator,
    logits: torch.Tensor,  # (B, V)
    params: SamplerParams,
    recent_tokens: Optional[torch.Tensor] = None,  # (B, W) int64, -1 padded
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (token (B,) int64, logprobs (B, V) float32), on the device."""
    logits = transform_logits(logits, recent_tokens, params)
    logprobs = torch.log_softmax(logits, dim=-1)
    if params.temperature > 0:
        probs = torch.softmax(nucleus_logits(logits, params), dim=-1)
        token = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        token = torch.argmax(logits, dim=-1)
    return token, logprobs


def update_recent_tokens(recent, token):
    """Shift the (B, W) window left and append the new token."""
    return torch.cat([recent[:, 1:], token[:, None].to(recent.dtype)], dim=1)


def init_recent_tokens(batch: int, window: int, prompt=None, *, device) -> torch.Tensor:
    """Start the window from the prompt tail so the penalty applies to prompt
    content at once. ``prompt``: optional (B, T) array-like."""
    recent = torch.full((batch, window), -1, dtype=torch.int64)
    if prompt is not None:
        tail = np.asarray(prompt, np.int64)[:, -window:]
        recent[:, window - tail.shape[1]:] = torch.from_numpy(tail)
    return recent.to(device)
