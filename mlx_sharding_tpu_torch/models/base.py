"""Shared model infrastructure (port of ``mlx_sharding_tpu/models/base.py``).

A model is an ``nn.Module`` holding its weights. It is built on the
``meta`` device (no memory) and then either filled with random weights by
``init_params`` or given real tensors with ``load_state_dict(...,
assign=True)`` by the loaders. Dense weights keep PyTorch's ``(out, in)``
layout for ``F.linear``; the JAX package keeps ``(in, out)`` for ``x @ W``
(``convert.py`` transposes). The JAX ``lax.scan`` over stacked layers is a
Python loop over an ``nn.ModuleList``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlx_sharding_tpu_torch.cache import KVCache, init_cache


class BaseModel(nn.Module):
    """Common surface: ``forward(x, cache) -> (logits or hidden, cache)``
    where ``x`` is token ids (B, T) on the first stage or hidden states
    (B, T, H) downstream."""

    def __init__(self, config):
        super().__init__()
        self.config = config

    @staticmethod
    def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        """Dense ``x @ W.T (+ b)``. Packed 4-bit weights come with the
        keep-quantized slice."""
        return F.linear(x, layer.weight, layer.bias)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def make_cache(self, batch: int, max_seq: int) -> KVCache:
        """An empty cache for the stage's layers, in the model's dtype and on
        its device."""
        cfg = self.config
        return init_cache(cfg.num_local_layers, batch, max_seq, cfg.num_key_value_heads,
                          cfg.head_dim, self.dtype, self.device)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed_tokens.weight)

    def head_input(self, h):
        """Transform before the vocab projection (the final norm)."""
        raise NotImplementedError

    def apply_head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits through the LM head, or the embedding when it is tied."""
        tied = self.config.tie_word_embeddings
        w = self.embed_tokens.weight if tied else self.lm_head.weight
        return F.linear(self.head_input(h), w)
