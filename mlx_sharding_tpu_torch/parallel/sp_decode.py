"""Decode over a sequence-sharded KV cache (port of
``mlx_sharding_tpu/parallel/sp_decode.py``): the long-context decode path.

The cache keeps its sequence dim split over the ``sp`` shards for the whole
generation (each shard holds ``max_seq / sp`` rows a layer), and a T=1 step
runs the attention as a partial-softmax merge: every shard computes
streaming-softmax statistics ``(m, l, acc)`` over its own rows, then one
pmax and two psums over the shards (``parallel.mesh``) merge them exactly:

    m_g = max_i m_i;  l_g = sum_i l_i exp(m_i - m_g);  acc_g likewise;  out = acc_g / l_g

Activations and weights are every shard's (each runs the projections and
the MLP on the same hidden state, as JAX's replicated SPMD body does); what
is split is the KV memory. The new token's row is written only by the shard
whose rows hold the position (``where`` over a clamped row, as JAX writes
it), so a step reads no host state and the Generator captures its decode
blocks as CUDA graphs on one card.

JAX computes the attention in XLA, so plain PyTorch it is here; the
projections run through the port's kernels as on every other path.
"""

from __future__ import annotations

import math

import torch

from mlx_sharding_tpu_torch.cache import KVCache, kv_dims
from mlx_sharding_tpu_torch.parallel.mesh import AXIS_SP, ShardAxis, reduce, run_shards
from mlx_sharding_tpu_torch.parallel.sp_prefill import replicas, sp_devices


def sp_decode_attention(q, k_buf, v_buf, offset, scale, axis: ShardAxis, logit_softcap=None,
                        sliding_window=None):
    """One shard's program (a generator, ``parallel.mesh``): attention of q
    (B, T, Hq, Dk) over this shard's rows ``k_buf`` / ``v_buf`` (B, cap,
    Hkv, D), global positions ``index·cap + j``, merged over ``axis``.
    A row is valid at global position <= offset + its query index (and
    within ``sliding_window``); ``logit_softcap`` caps the scores before
    masking. ``offset``: an int or a (1,) device tensor."""
    b, t, hq, dk = q.shape
    cap, hkv = k_buf.shape[1], k_buf.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, t, hkv, groups, dk)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_buf.float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    dev = q.device
    q_pos = offset + torch.arange(t, device=dev)[:, None]  # (T, 1) global
    k_pos = axis.index * cap + torch.arange(cap, device=dev)[None, :]  # (1, cap)
    allowed = k_pos <= q_pos
    if sliding_window is not None:
        allowed &= k_pos > q_pos - sliding_window
    scores = torch.where(allowed, scores, -math.inf)
    m_loc = scores.amax(dim=-1)  # (B, Hkv, G, T)
    m_glob = yield from reduce(m_loc, axis, "max")
    m_safe = torch.where(torch.isneginf(m_glob), 0.0, m_glob)
    p = torch.exp(scores - m_safe[..., None])  # -inf rows -> 0
    l_glob = yield from reduce(p.sum(dim=-1), axis)
    acc_glob = yield from reduce(torch.einsum("bhgts,bshd->bhgtd", p, v_buf.float()), axis)
    out = acc_glob / torch.clamp(l_glob[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, -1).to(q.dtype)


class SpDecode:
    """T=1 steps over an sp-sharded cache for one (model, sp devices), as
    the model a ``Generator`` steps (``Generator(sp_mesh=..., sp_decode=True)``):
    :meth:`make_cache` gives the Generator a cache holding only its offset
    and device position, the shards' rows live here (:attr:`k`, :attr:`v`:
    a list a shard of (L, B, cap, H, D)), and a call runs one step at the
    cache's device position. ``models``: the model on every shard's device
    (``SpPrefill.models``, so the weights are held once)."""

    def __init__(self, model, mesh, *, max_seq: int, models=None):
        self.model = model
        self.devices = sp_devices(mesh)
        self.size = len(self.devices)
        if max_seq % self.size:
            raise ValueError(f"sp={self.size} must divide the cache capacity {max_seq}")
        self.models = models if models is not None else replicas(model, self.devices)
        self.device = self.devices[0]
        self.layers = model.layers
        self.config = model.config
        self.max_seq = max_seq
        self.cap = max_seq // self.size
        self.k = self.v = None
        self._axes = [ShardAxis(AXIS_SP, r, self.size) for r in range(self.size)]

    # the Generator's model surface
    def fused_projection_groups(self) -> dict:
        return {}

    def place_constants(self, device) -> None:
        for m, dev in zip(self.models, self.devices):
            m.place_constants(dev)

    def shared_sample(self, run, rows: int, want_lp: bool):
        return run()

    def make_cache(self, batch: int, max_seq: int) -> KVCache:
        """The shards' caches (zeros, the model's layout: its per-tensor
        head dims and cache heads), and an empty cache for the Generator."""
        k_dim, v_dim = kv_dims(self.model.cache_head_dim())
        heads, layers = self.model.cache_num_heads(), self.config.num_local_layers
        dtype = self.model.dtype
        self.k = [torch.zeros((layers, batch, self.cap, heads, k_dim), dtype=dtype, device=d)
                  for d in self.devices]
        self.v = [torch.zeros((layers, batch, self.cap, heads, v_dim), dtype=dtype, device=d)
                  for d in self.devices]
        empty = torch.empty((0, batch, max_seq, 1, 1), device=self.device)
        return KVCache(k=empty, v=empty)

    def write_prefill(self, ks: list, vs: list) -> None:
        """Install a sharded prefill's rows (a list a layer of each prefill
        shard's T_pad/sp rows) into the cache's max_seq/sp row blocks: the
        one reshard between the two layouts."""
        for i, (kl, vl) in enumerate(zip(ks, vs)):
            for rows, caches in ((torch.cat([k.to(self.device) for k in kl], dim=1), self.k),
                                 (torch.cat([v.to(self.device) for v in vl], dim=1), self.v)):
                for r, c in enumerate(caches):
                    part = rows[:, r * self.cap : (r + 1) * self.cap]
                    if part.shape[1]:
                        c[i, :, : part.shape[1]] = part.to(c.device)

    def __call__(self, x, cache: KVCache, n_valid=None, logits_at=None):
        """One T=1 step of ``x`` (B, 1) at ``cache.pos``: every shard's
        projections, the owner's row write, the merged attention, every
        shard's MLP. Returns ``(logits (B, 1, V), cache)``."""
        if x.shape[1] != 1:
            raise ValueError("SpDecode steps one token; the prompt goes through SpPrefill")
        pos = cache.pos
        hs = [m.embed(x.to(m.device)) for m in self.models]
        for i in range(len(self.layers)):
            programs, ps = [], []
            for r, m in enumerate(self.models):
                p, off = m.layers[i], pos.to(m.device)
                q, k_new, v_new = m.layer_attn_inputs(p, hs[r], off)
                opts = m.attn_options(p)
                vfk = opts.pop("values_from_k", None)
                kb, vb = self.k[r][i], self.v[r][i]
                local = off - r * self.cap
                in_range = (local >= 0) & (local < self.cap)
                row = local.clamp(0, self.cap - 1)
                for buf, new in ((kb, k_new), (vb, v_new)):
                    old = buf.index_select(1, row)
                    buf.index_copy_(1, row, torch.where(in_range, new.to(buf.dtype), old))
                vv = kb[..., :vfk] if vfk is not None else vb
                programs.append(sp_decode_attention(q, kb, vv, off, m.scale, self._axes[r],
                                                    **opts))
                ps.append(p)
            outs = run_shards(programs, {AXIS_SP: [list(range(self.size))]})
            hs = [m.layer_finish(p, h, o) for m, p, h, o in zip(self.models, ps, hs, outs)]
        return self.models[0].apply_head(hs[0]), cache
