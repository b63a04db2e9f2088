"""Token sampling on the device (port of ``mlx_sharding_tpu/sample.py``):
the single-stream sampler and the batched one of continuous batching.

The same transforms in the same order: logit bias, the repetition penalty
over a prompt-seeded window, temperature, the top-p nucleus ("kept iff the
mass before it < top_p"), then argmax at temperature 0 or a draw.

One program serves every setting, as in JAX: the batched sampler
(:func:`sample_token_batched`) reads temperature, top-p, penalty and bias
from device tensors (:class:`BatchedSamplerParams`, one row per request or
slot), filters all rows at once as JAX's ``vmap`` does, draws every row
with that row's own ``torch.Generator`` and picks ``where(temperature > 0,
sampled, greedy)``. JAX's ``lax.cond`` on the temperature becomes one
captured program per branch, chosen by a flag the host knows from the
requests (``sampled``): a block with no sampled row never sorts the
vocabulary, and a branch chosen on the card would need the host to read it
back. The draw is the exponential race that ``torch.multinomial`` runs for
one sample (:func:`draw`), without its host-side checks, so it can be
captured; a captured draw reads the generator's seed and offset when the
graph is replayed. The draws match the JAX stream in distribution only.

:func:`sample_token` is the one-request form over host floats
(:class:`SamplerParams`), on the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import upload


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


def top_p_filter(logits, top_p):
    """Mask logits outside the top-p nucleus: keep the smallest prefix of
    the sorted distribution whose mass reaches ``top_p``. ``top_p`` is a
    float, or a (B,) tensor of per-row values; a row at ``top_p >= 1``
    keeps everything (JAX's ``lax.cond``, which ``vmap`` makes a select)."""
    if not isinstance(top_p, torch.Tensor):
        if top_p >= 1.0:
            return logits
        top_p = torch.full(logits.shape[:-1], top_p, dtype=torch.float32, device=logits.device)
    top_p = top_p[..., None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p  # kept iff mass before it < top_p
    min_kept = torch.where(keep_sorted, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    filtered = torch.where(logits >= min_kept, logits, float("-inf"))
    return torch.where(top_p < 1.0, filtered, logits)


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
    """Every row under one request's settings and ``generator``. Returns
    (token (B,) int64, logprobs (B, V) float32), on the device."""
    n_bias = 0 if params.bias_indices is None else params.bias_indices.shape[0]
    rows = stack_sampler_params([params] * logits.shape[0], width=max(1, n_bias),
                                device=logits.device)
    return sample_token_batched(generator, logits, rows, recent_tokens,
                                sampled=params.temperature > 0)


def draw(probs: torch.Tensor, generators) -> torch.Tensor:
    """One draw per row of ``probs`` (M, V): the argmax of ``probs / E``
    with E ~ Exp(1), the race ``torch.multinomial`` runs for one sample
    (same numbers from the same generator state), without its host checks.
    ``generators``: one ``torch.Generator`` for every row, or a list of one
    per row."""
    race = torch.empty_like(probs)
    if isinstance(generators, torch.Generator):
        race.exponential_(1.0, generator=generators)
    else:
        for r, gen in enumerate(generators):
            race[r].exponential_(1.0, generator=gen)
    return torch.argmax(probs / race, dim=-1)


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
    return upload(recent.numpy(), device)


# ------------------------------------------------------------------ batched
#: per-slot logit-bias width of the continuous batcher: covers OpenAI's
#: documented cap of 300 entries
BIAS_WIDTH = 512


@dataclasses.dataclass
class BatchedSamplerParams:
    """Per-row sampler settings on the device, one row per request or
    continuous-batching slot: the batched JAX ``SamplerParams``."""

    temperature: torch.Tensor  # (M,) float32
    top_p: torch.Tensor  # (M,) float32
    repetition_penalty: torch.Tensor  # (M, 1) float32
    bias_indices: torch.Tensor  # (M, K) int64, padded with 0
    bias_values: torch.Tensor  # (M, K) float32, padded with 0 (a no-op)


def _host_row(params: SamplerParams, width: int) -> tuple:
    """One row's settings on the host: (temperature, top-p, penalty) as
    float32, then the bias indices and values padded to ``width``."""
    idx, val = np.zeros(width, np.int64), np.zeros(width, np.float32)
    if params.bias_indices is not None:
        n = params.bias_indices.shape[0]
        if n > width:
            raise ValueError(f"logit_bias with {n} entries exceeds the scheduler's per-slot "
                             f"bias width {width}")
        idx[:n] = params.bias_indices.cpu().numpy()
        val[:n] = params.bias_values.cpu().numpy()
    head = np.asarray([params.temperature, params.top_p, params.repetition_penalty], np.float32)
    return head, idx, val


def stack_sampler_params(params_list: list, *, width: int = BIAS_WIDTH,
                         device) -> BatchedSamplerParams:
    """Per-request sampler params -> one batched set with a (M,) leading
    dim, bias buffers padded to ``width``."""
    rows = [_host_row(p, width) for p in params_list]
    head = upload(np.stack([r[0] for r in rows]), device)
    return BatchedSamplerParams(
        temperature=head[:, 0].clone(),
        top_p=head[:, 1].clone(),
        repetition_penalty=head[:, 2:3].clone(),
        bias_indices=upload(np.stack([r[1] for r in rows]), device),
        bias_values=upload(np.stack([r[2] for r in rows]), device),
    )


def set_sampler_slot(batched: BatchedSamplerParams, slot: int, one: SamplerParams) -> None:
    """Write one request's params into row ``slot``, in place (its bias
    padded to the batched width; a wider one raises). No host sync: the
    row goes up from pinned memory."""
    head, idx, val = _host_row(one, batched.bias_indices.shape[1])
    dev = batched.bias_indices.device
    head = upload(head, dev)
    batched.temperature[slot] = head[0]
    batched.top_p[slot] = head[1]
    batched.repetition_penalty[slot] = head[2]
    batched.bias_indices[slot] = upload(idx, dev)
    batched.bias_values[slot] = upload(val, dev)


def select_rows(batched: BatchedSamplerParams, rows: list) -> BatchedSamplerParams:
    """The params of ``rows`` only (a slot's first sample reads its own)."""
    index = torch.tensor(rows, dtype=torch.long)
    if batched.bias_indices.device.type == "cuda":
        index = index.pin_memory().to(batched.bias_indices.device, non_blocking=True)
    return BatchedSamplerParams(*(getattr(batched, f.name)[index]
                                  for f in dataclasses.fields(BatchedSamplerParams)))


def transform_logits_batched(logits, recent_tokens, params: BatchedSamplerParams):
    """Per-row bias -> repetition penalty, in fp32: the batched
    :func:`transform_logits`. The penalty applies to every row, as in JAX:
    at 1 it leaves a row exactly as it is."""
    logits = logits.float().scatter_add(1, params.bias_indices, params.bias_values)
    if recent_tokens is not None:
        logits = apply_repetition_penalty(logits, recent_tokens, params.repetition_penalty)
    return logits


def nucleus_logits_batched(lo, params: BatchedSamplerParams):
    """Per-row temperature, then top-p, on all rows at once: the batched
    :func:`nucleus_logits`."""
    return top_p_filter(lo / params.temperature.clamp_min(1e-6)[:, None], params.top_p)


def sample_token_batched(generators, logits, params: BatchedSamplerParams,
                         recent_tokens, *, sampled: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling with per-row params and per-row generators: argmax
    for a row at temperature 0, else a draw from that row's nucleus with
    that row's generator (``generators``: a list of one per row, or one for
    all), as :func:`sample_token` draws for one request. ``recent_tokens``
    (M, W) is already masked to each row's window. ``sampled`` is the
    host's knowledge that some row may sample: False skips the nucleus and
    the draw (every row takes the argmax, no generator moves); True draws
    for every row, whatever its temperature, so a captured step moves each
    generator by the same amount at every replay. Returns (token (M,)
    int64, logprobs (M, V) float32)."""
    logits = transform_logits_batched(logits, recent_tokens, params)
    logprobs = torch.log_softmax(logits, dim=-1)
    token = torch.argmax(logits, dim=-1)
    if sampled:
        picked = draw(torch.softmax(nucleus_logits_batched(logits, params), dim=-1), generators)
        token = torch.where(params.temperature > 0, picked, token)
    return token, logprobs


def window_mask(window: int, sizes: list, device) -> torch.Tensor:
    """(M, W) bool: the last ``sizes[m]`` entries of row m's window take
    part in its penalty, so each slot keeps a solo run's context size."""
    sizes_t = torch.tensor(sizes, dtype=torch.long)
    mask = torch.arange(window)[None, :] >= (window - sizes_t)[:, None]
    return upload(mask.numpy(), device)
