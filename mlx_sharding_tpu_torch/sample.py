"""Token sampling on the device (port of ``mlx_sharding_tpu/sample.py``):
the single-stream sampler and the batched one of continuous batching.

The same transforms in the same order: logit bias, the repetition penalty
over a prompt-seeded window, temperature, the top-p nucleus ("kept iff the
mass before it < top_p"), then argmax at temperature 0 or a draw. JAX
traces every branch into one program with dynamic scalars; here the
sampler settings are host floats and the branches are plain ``if``s. The
draw uses an explicit ``torch.Generator``, so it matches the JAX stream in
distribution only.

The batched sampler (:class:`BatchedSamplerParams`) gives every slot its
own row of settings and its own ``torch.Generator``: a sampled row draws
from its slot's generator alone, with the single-stream functions, so a
seeded request draws the same tokens alone and among others.
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


def apply_repetition_penalty(logits, recent_tokens, penalty):
    """Penalize the tokens of ``recent_tokens`` (B, W), -1 = empty slot:
    positive scores are divided by ``penalty`` (a float, or a (B, 1)
    tensor of per-row penalties), negative ones multiplied."""
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


# ------------------------------------------------------------------ batched
#: per-slot logit-bias width of the continuous batcher: covers OpenAI's
#: documented cap of 300 entries
BIAS_WIDTH = 512


@dataclasses.dataclass
class BatchedSamplerParams:
    """Per-row sampler settings, one row per continuous-batching slot:
    device tensors for the transforms, host copies of the scalars for the
    branches (which rows sample, whether any row is penalized)."""

    temperature: list  # (M,) host floats
    top_p: list  # (M,) host floats
    repetition_penalty: torch.Tensor  # (M, 1) float32
    penalties: list  # (M,) host floats
    bias_indices: torch.Tensor  # (M, K) int64, padded with 0
    bias_values: torch.Tensor  # (M, K) float32, padded with 0 (a no-op)


def _bias_row(params: SamplerParams, width: int) -> tuple[np.ndarray, np.ndarray]:
    idx, val = np.zeros(width, np.int64), np.zeros(width, np.float32)
    if params.bias_indices is not None:
        n = params.bias_indices.shape[0]
        if n > width:
            raise ValueError(f"logit_bias with {n} entries exceeds the scheduler's per-slot "
                             f"bias width {width}")
        idx[:n] = params.bias_indices.cpu().numpy()
        val[:n] = params.bias_values.cpu().numpy()
    return idx, val


def stack_sampler_params(params_list: list, *, width: int = BIAS_WIDTH,
                         device) -> BatchedSamplerParams:
    """Per-request sampler params -> one batched set with a (M,) leading
    dim, bias buffers padded to ``width``."""
    rows = [_bias_row(p, width) for p in params_list]
    pens = [p.repetition_penalty for p in params_list]
    return BatchedSamplerParams(
        temperature=[p.temperature for p in params_list],
        top_p=[p.top_p for p in params_list],
        repetition_penalty=torch.tensor(pens, dtype=torch.float32, device=device)[:, None],
        penalties=pens,
        bias_indices=torch.from_numpy(np.stack([r[0] for r in rows])).to(device),
        bias_values=torch.from_numpy(np.stack([r[1] for r in rows])).to(device),
    )


def set_sampler_slot(batched: BatchedSamplerParams, slot: int, one: SamplerParams) -> None:
    """Write one request's params into row ``slot``, in place (its bias
    padded to the batched width; a wider one raises)."""
    idx, val = _bias_row(one, batched.bias_indices.shape[1])
    dev = batched.bias_indices.device
    batched.temperature[slot] = one.temperature
    batched.top_p[slot] = one.top_p
    batched.penalties[slot] = one.repetition_penalty
    batched.repetition_penalty[slot] = one.repetition_penalty
    batched.bias_indices[slot] = torch.from_numpy(idx).to(dev)
    batched.bias_values[slot] = torch.from_numpy(val).to(dev)


def select_rows(batched: BatchedSamplerParams, rows: list) -> BatchedSamplerParams:
    """The params of ``rows`` only (a slot's first sample reads its own)."""
    index = torch.tensor(rows, dtype=torch.long, device=batched.bias_indices.device)
    return BatchedSamplerParams(
        temperature=[batched.temperature[r] for r in rows],
        top_p=[batched.top_p[r] for r in rows],
        repetition_penalty=batched.repetition_penalty[index],
        penalties=[batched.penalties[r] for r in rows],
        bias_indices=batched.bias_indices[index],
        bias_values=batched.bias_values[index],
    )


def transform_logits_batched(logits, recent_tokens, params: BatchedSamplerParams):
    """Per-row bias -> repetition penalty, in fp32: the batched
    :func:`transform_logits`."""
    logits = logits.float().scatter_add(1, params.bias_indices, params.bias_values)
    if recent_tokens is not None and any(p != 1.0 for p in params.penalties):
        # a penalty of 1 leaves a row as it is, exactly
        logits = apply_repetition_penalty(logits, recent_tokens, params.repetition_penalty)
    return logits


def nucleus_logits_batched(lo, params: BatchedSamplerParams):
    """Per-row temperature, then top-p: the batched :func:`nucleus_logits`."""
    rows = []
    for r, (t, p) in enumerate(zip(params.temperature, params.top_p)):
        rows.append(top_p_filter(lo[r : r + 1] / max(t, 1e-6), p))
    return torch.cat(rows)


def sample_token_batched(generators: list, logits, params: BatchedSamplerParams,
                         recent_tokens, active=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling with per-row params and per-row generators: argmax
    for a row at temperature 0, else a draw from that row's own nucleus with
    that row's generator, as :func:`sample_token` draws for one request.
    ``recent_tokens`` (M, W) is already masked to each row's window. Rows
    that ``active`` marks False (idle slots, whose tokens are dropped) take
    the argmax and leave their generator untouched. Returns (token (M,)
    int64, logprobs (M, V) float32)."""
    logits = transform_logits_batched(logits, recent_tokens, params)
    logprobs = torch.log_softmax(logits, dim=-1)
    token = torch.argmax(logits, dim=-1)
    for r, t in enumerate(params.temperature):
        if t > 0 and (active is None or active[r]):
            lo = top_p_filter(logits[r : r + 1] / max(t, 1e-6), params.top_p[r])
            token[r] = torch.multinomial(torch.softmax(lo, dim=-1), 1, generator=generators[r])[0, 0]
    return token, logprobs


def window_mask(window: int, sizes: list, device) -> torch.Tensor:
    """(M, W) bool: the last ``sizes[m]`` entries of row m's window take
    part in its penalty, so each slot keeps a solo run's context size."""
    sizes_t = torch.tensor(sizes, dtype=torch.long)
    mask = torch.arange(window)[None, :] >= (window - sizes_t)[:, None]
    return mask.to(device)
