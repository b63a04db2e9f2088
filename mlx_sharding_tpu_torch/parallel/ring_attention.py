"""Ring attention over the ``sp`` axis (port of
``mlx_sharding_tpu/parallel/ring_attention.py``).

A long sequence is split into ``sp`` blocks of T_local rows, one a shard:
each shard keeps its query block and the key/value blocks go round the ring
(JAX's ``lax.ppermute``; here a rotation of the shard list,
``parallel.mesh.ppermute``) while a streaming softmax (running max, sum and
output, f32) accumulates the exact attention. A received block is walked in
``block_k`` sub-tiles, so no (T_local)^2 score matrix exists.

Causality uses global positions: shard s holds positions ``s·T_local + i``;
at ring step j it sees the block of shard ``(s - j) mod S``. A block wholly
in the causal future, or wholly behind every query's window, is skipped (JAX
skips it with ``lax.cond``; the positions are host numbers here, so the
skip is a Python branch and exact). A row that has seen no valid key keeps
the running max at -1e30 and its sum at 0 (JAX starts at -inf and guards
the exponentials; the results are the same).

JAX computes this in XLA, not in a Pallas kernel, so its counterpart here is
plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from mlx_sharding_tpu_torch.parallel.mesh import ppermute

_NO_MAX = -1e30


def _block_update(scores, v_blk, o, m, l):
    """One streaming-softmax step. scores (B, Hkv, G, T, Tk) f32 (masked
    entries -inf), v_blk (B, Tk, Hkv, Dv). Returns the updated (o, m, l)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])  # masked -> 0
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgtk,bkhd->bhgtd", p, v_blk.float())
    return o * corr[..., None] + pv, m_new, l


def ring_attention_local(qs: list, ks: list, vs: list, scale: float, block_k: int = 512,
                         logit_softcap=None, sliding_window=None, values_from_k=None) -> list:
    """Causal GQA attention of a sequence split over the shards: ``qs`` /
    ``ks`` / ``vs`` are the shards' (B, T_local, H, D) blocks, in rank
    order, each on its shard's device. Returns each shard's (B, T_local,
    Hq, Dv). ``logit_softcap`` caps the scores (before masking);
    ``sliding_window`` keeps the last W positions; ``values_from_k`` (MLA):
    the values are ``keys[..., :n]``, ``vs`` is ignored and only the key
    blocks rotate."""
    size = len(qs)
    b, t, hq, dk = qs[0].shape
    hkv = ks[0].shape[2]
    groups = hq // hkv
    bk = math.gcd(t, block_k)  # the largest aligned sub-tile <= block_k
    nb = t // bk
    dv = values_from_k if values_from_k is not None else vs[0].shape[-1]
    state = []
    for idx, q in enumerate(qs):
        kw = dict(dtype=torch.float32, device=q.device)
        state.append([torch.zeros((b, hkv, groups, t, dv), **kw),
                      torch.full((b, hkv, groups, t), _NO_MAX, **kw),
                      torch.zeros((b, hkv, groups, t), **kw)])
    k_blks = list(ks)
    v_blks = None if values_from_k is not None else list(vs)
    for j in range(size):
        for idx, q in enumerate(qs):
            blk = (idx - j) % size
            # whole-block relevance: its oldest position against the newest
            # query (causal future), its newest against the oldest query's
            # window edge; a skipped block would contribute exactly nothing
            relevant = blk * t <= idx * t + (t - 1)
            if sliding_window is not None:
                relevant &= (blk * t + t - 1) >= (idx * t - sliding_window + 1)
            if not relevant:
                continue
            k_blk = k_blks[idx]
            v_blk = k_blk[..., :values_from_k] if v_blks is None else v_blks[idx]
            qg = q.reshape(b, t, hkv, groups, dk)
            q_pos = idx * t + torch.arange(t, device=q.device)
            o, m, l = state[idx]
            for si in range(nb):
                ksub = k_blk[:, si * bk : (si + 1) * bk]
                vsub = v_blk[:, si * bk : (si + 1) * bk]
                k_pos = blk * t + si * bk + torch.arange(bk, device=q.device)
                scores = torch.einsum("bthgd,bkhd->bhgtk", qg.float(), ksub.float()) * scale
                if logit_softcap is not None:
                    scores = logit_softcap * torch.tanh(scores / logit_softcap)
                allowed = k_pos[None, :] <= q_pos[:, None]
                if sliding_window is not None:
                    allowed &= k_pos[None, :] > q_pos[:, None] - sliding_window
                scores = torch.where(allowed, scores, -math.inf)
                o, m, l = _block_update(scores, vsub, o, m, l)
            state[idx] = [o, m, l]
        k_blks = ppermute(k_blks)
        if v_blks is not None:
            v_blks = ppermute(v_blks)
    outs = []
    for q, (o, m, l) in zip(qs, state):
        o = o / torch.clamp(l[..., None], min=1e-30)
        # (B, Hkv, G, T, Dv) -> (B, T, Hq, Dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, t, hq, -1).to(q.dtype))
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   devices: list) -> torch.Tensor:
    """Top-level entry: q/k/v (B, T, H, D) split on T over the shards'
    ``devices`` and attended exactly; T must divide by their number.
    Returns (B, T, Hq, Dv) on q's device."""
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not divide over sp={n}")

    def split(x):
        return [c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)]

    outs = ring_attention_local(split(q), split(k), split(v), scale)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
