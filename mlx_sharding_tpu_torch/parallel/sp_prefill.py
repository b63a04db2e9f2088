"""Sequence-parallel prefill (port of ``mlx_sharding_tpu/parallel/sp_prefill.py``):
a long prompt's sequence split over the ``sp`` shards. Each shard projects
Q/K/V for its T/S tokens (RoPE at global positions), the attention is ring
attention (``parallel.ring_attention``) and the MLP stays local; one pass
prefills the whole prompt with O(T/S) activations a shard.

The per-layer K/V either gathers into the Generator's one cache (decode
continues on the ordinary path) or, ``keep_sharded``, stays split over the
shards for ``parallel.sp_decode``. It runs through the models' ``sp_layer``
hooks (``layer_attn_inputs``, ``attn_options``, ``layer_finish``): the
Llama family, Gemma-2's windows and softcap, DeepSeek-V2's compressed
latent (``values_from_k``). Every shard holds the whole model: the model
itself on one device, a copy on each other device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.parallel.ring_attention import ring_attention_local


def supports_sp_prefill(model) -> bool:
    cfg = model.config
    return getattr(model, "supports_sp", False) and cfg.is_first_stage and cfg.is_last_stage


def sp_devices(mesh) -> list:
    """The sp axis's devices of ``mesh``: a (pp, sp, ep, tp) grid
    (``parallel.mesh.device_grid``) or a list of devices."""
    grid = np.asarray(mesh, dtype=object)
    return list(grid[0, :, 0, 0]) if grid.ndim == 4 else list(grid.flat)


def replicas(model, devices: list) -> list:
    """The model on every shard's device: the model itself where it lies,
    a copy elsewhere (JAX replicates the params over the sp mesh once)."""
    out = []
    for dev in devices:
        if dev == model.device:
            out.append(model)
        else:
            rep = copy.deepcopy(model).to(dev)
            rep.place_constants(dev)
            out.append(rep)
    return out


def sp_ring_attn_fn(model, qs: list, ks: list, vs: list, logit_softcap=None,
                    sliding_window=None, values_from_k=None) -> list:
    """The prefill's attention over the shards' blocks: exact ring
    attention with the layer's options (with ``values_from_k`` only the
    key blocks rotate)."""
    return ring_attention_local(qs, ks, vs, model.scale, logit_softcap=logit_softcap,
                                sliding_window=sliding_window, values_from_k=values_from_k)


def sp_prefill_run(models: list, tokens: torch.Tensor, n_valid: int):
    """One sequence-parallel prefill of ``tokens`` (B, T_pad) on shard 0's
    device, T_pad a multiple of the shards: returns ``(logits (B, V) f32 at
    position n_valid - 1, ks, vs)``, ``ks`` / ``vs`` a list a layer of each
    shard's (B, T_local, Hkv, D) rows (JAX ``build_sp_prefill``'s body)."""
    size = len(models)
    t_local = tokens.shape[1] // size
    hs = [m.embed(tokens[:, r * t_local : (r + 1) * t_local].to(m.device))
          for r, m in enumerate(models)]
    ks, vs = [], []
    for i in range(len(models[0].layers)):
        ps = [m.layers[i] for m in models]
        qkv = [m.layer_attn_inputs(p, h, r * t_local)
               for r, (m, p, h) in enumerate(zip(models, ps, hs))]
        opts = models[0].attn_options(ps[0])
        outs = sp_ring_attn_fn(models[0], [x[0] for x in qkv], [x[1] for x in qkv],
                               [x[2] for x in qkv], **opts)
        hs = [m.layer_finish(p, h, o) for m, p, h, o in zip(models, ps, hs, outs)]
        ks.append([x[1] for x in qkv])
        vs.append([x[2] for x in qkv])
    # the last real position lives on shard (n_valid - 1) // t_local, which
    # alone computes the head (JAX sums the owner's logits with zeros)
    owner = (n_valid - 1) // t_local
    local_last = n_valid - 1 - owner * t_local
    logits = models[owner].apply_head(hs[owner][:, local_last]).float()
    return logits.to(models[0].device), ks, vs


class SpPrefill:
    """Reusable sequence-parallel prefill for one (model, sp devices).
    Prompt lengths are padded to multiples of ``sp · prefill_chunk`` (the
    quantum). ``keep_sharded``: the K/V stays split for ``SpDecode``."""

    def __init__(self, model, mesh, prefill_chunk: int, keep_sharded: bool = False):
        self.model = model
        self.devices = sp_devices(mesh)
        self.size = len(self.devices)
        self.quantum = self.size * prefill_chunk
        self.keep_sharded = keep_sharded
        self.models = replicas(model, self.devices)

    def padded_len(self, t: int) -> int:
        return -(-t // self.quantum) * self.quantum

    def _run(self, prompt: np.ndarray):
        t = prompt.shape[1]
        tokens = np.zeros((prompt.shape[0], self.padded_len(t)), np.int64)
        tokens[:, :t] = prompt
        return sp_prefill_run(self.models, upload(tokens, self.devices[0]), t)

    def prefill_sharded(self, prompt: np.ndarray):
        """Sharded mode: ``(logits (B, V), ks, vs)``, each layer's rows a
        list over the shards (``SpDecode.write_prefill`` installs them)."""
        return self._run(prompt)

    def __call__(self, prompt: np.ndarray, k_cache: torch.Tensor, v_cache: torch.Tensor):
        """Prefill ``prompt`` (B, T) into the (L, B, S, H, D) caches from row
        0, the shards' rows gathered; returns the logits (B, V). Padded rows
        sit past the prompt and are never attended before decode
        overwrites them."""
        t_pad = self.padded_len(prompt.shape[1])
        if t_pad > k_cache.shape[2]:
            raise ValueError(f"sp prefill needs {t_pad} cache rows, capacity {k_cache.shape[2]}")
        logits, ks, vs = self._run(prompt)
        dev = k_cache.device
        for i, (kl, vl) in enumerate(zip(ks, vs)):
            k_cache[i, :, :t_pad] = torch.cat([k.to(dev) for k in kl], dim=1)
            v_cache[i, :, :t_pad] = torch.cat([v.to(dev) for v in vl], dim=1)
        return logits
