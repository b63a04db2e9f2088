"""Chained chunk digests over token prefixes: the ONE content-address
(copied from ``mlx_sharding_tpu/utils/digests.py``, standard library only).

Both the router's prefix-affinity map (``ReplicaSet._affinity_chunks``)
and the fleet-wide prefix KV store (``prefix_store.PrefixStore``) key on
the same scheme: the prompt is cut into fixed-size token chunks and each
chunk's blake2b digest is seeded with the previous chunk's digest, so the
k-th digest content-addresses the ENTIRE k-chunk prefix — matching one
digest means matching every token before it. Extracting the chain here is
what makes the two consumers structurally unable to disagree on chunk
size semantics or chain seed: a router affinity hit and a store lookup
hit describe the same shared prefix.

The digest text is the comma-joined decimal token ids (not raw bytes):
stable across int dtypes and platforms, and identical to what the router
has always hashed — extraction changes no digest value.
"""

from __future__ import annotations

import hashlib
from typing import Optional


def chunk_digests(tokens, page: int, max_chunks: Optional[int] = None) -> list:
    """Chained 16-byte blake2b digests over fixed ``page``-token chunks of
    ``tokens``; ``keys[i]`` addresses the whole ``(i+1) * page``-token
    prefix. A trailing partial chunk contributes nothing (prefix reuse is
    chunk-granular). ``max_chunks`` caps the walk (the router bounds its
    hashing work; the store caps at the last FULL page before the final
    prompt token). Raises ``TypeError``/``ValueError`` on non-int tokens —
    callers with untrusted prompts guard, exactly as the router did."""
    toks = list(tokens)
    if max_chunks is not None:
        toks = toks[: page * max_chunks]
    toks = [int(t) for t in toks]
    n = len(toks) // page
    keys, h = [], b""
    for c in range(n):
        m = hashlib.blake2b(h, digest_size=16)
        m.update(",".join(map(str, toks[c * page:(c + 1) * page])).encode())
        h = m.digest()
        keys.append(h)
    return keys
