"""Layer-wise KV sharing maps (KVSharer, arXiv:2410.18517), copied from
``mlx_sharding_tpu/kv_share.py`` (standard library and numpy only).

KVSharer's finding is counterintuitive: sharing the KV cache between the
*most dissimilar* layer pairs — not the most similar — preserves output
quality while cutting pool bytes roughly in proportion to the layers
merged. This module is the pure bookkeeping half of that idea:

- :class:`KVShareMap` — a canonical, hashable layer→group assignment.
  Pools allocate one physical (k, v) buffer per *group*; every layer
  reads/writes through the group indirection. The identity map (every
  layer its own group) is bit-exact with the unshared layout and hashes
  to ``None`` so legacy exported blocks stay importable.
- :func:`calibrate_share_map` — offline ranking of layer pairs by KV
  dissimilarity over a calibration batch, emitting the share map the
  ``cli/kv_share_calibrate.py`` tool writes to disk.

The map's ``share_hash`` joins the ``KVPageBlock`` integrity fingerprint
(kv_transfer.py): a block exported under one layout can never scatter
into a pool with a different one — the import fails closed with a
remediation hint instead of producing silently-wrong attention.

Sharing semantics (documented deviation from the paper's weight-level
trick): every layer still computes its own k/v *projection* for the
current tick, but non-owner layers attend over the owner's historical
KV plus their own current-tick row; only the owner layer's rows persist
into the pool. Greedy outputs under a calibrated map therefore differ
from unshared within a tolerance measured at calibration time — the
identity map is exact.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

FORMAT = "mst-kv-share-map-v1"


class ShareMapError(ValueError):
    """A share map failed validation or doesn't fit the engine geometry."""


def _canonical_groups(group_of: Sequence[int]) -> tuple[int, ...]:
    """Renumber group ids to first-appearance order so two maps with the
    same partition always compare (and hash) equal."""
    remap: dict[int, int] = {}
    out = []
    for g in group_of:
        if g not in remap:
            remap[g] = len(remap)
        out.append(remap[g])
    return tuple(out)


@dataclass(frozen=True)
class KVShareMap:
    """Layer→share-group assignment over one engine's local layer stack.

    ``group_of[layer] == group`` with group ids canonicalized to
    first-appearance order; the *owner* of a group is its lowest layer
    index (the layer whose rows physically persist)."""

    num_layers: int
    group_of: tuple[int, ...]
    meta: dict = field(default_factory=dict, compare=False, hash=False)

    def __post_init__(self):
        object.__setattr__(
            self, "group_of", _canonical_groups(tuple(self.group_of))
        )
        if self.num_layers < 1:
            raise ShareMapError("share map needs num_layers >= 1")
        if len(self.group_of) != self.num_layers:
            raise ShareMapError(
                f"share map lists {len(self.group_of)} layers but "
                f"num_layers={self.num_layers}"
            )

    # ------------------------------------------------------------ derived
    @property
    def num_groups(self) -> int:
        return max(self.group_of) + 1

    @property
    def is_identity(self) -> bool:
        return self.num_groups == self.num_layers

    @property
    def owner_layers(self) -> tuple[int, ...]:
        """Per group: the lowest layer index assigned to it (canonical
        ordering makes this exactly the first layer that names it)."""
        owners = [-1] * self.num_groups
        for layer, g in enumerate(self.group_of):
            if owners[g] < 0:
                owners[g] = layer
        return tuple(owners)

    @property
    def owner_mask(self) -> tuple[bool, ...]:
        """Per layer: does this layer's KV physically persist?"""
        owners = set(self.owner_layers)
        return tuple(layer in owners for layer in range(self.num_layers))

    @property
    def share_hash(self) -> Optional[str]:
        """Layout identity for export/import integrity checks.

        ``None`` for the identity map — the layout is byte-identical to
        the unshared pool, so legacy blocks (and blocks from unshared
        peers) compose without a flag-day."""
        if self.is_identity:
            return None
        payload = f"{FORMAT}:{self.num_layers}:{','.join(map(str, self.group_of))}"
        return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()

    def bytes_saved_fraction(self) -> float:
        """Fraction of KV pool bytes the map removes vs unshared."""
        return 1.0 - self.num_groups / self.num_layers

    # --------------------------------------------------------- validation
    def validate_for(self, num_layers: int) -> None:
        """Engine-geometry fit check with a remediation hint."""
        if num_layers != self.num_layers:
            raise ShareMapError(
                f"share map was calibrated for {self.num_layers} layers but "
                f"this engine stages {num_layers} local layers — recalibrate "
                f"with cli/kv_share_calibrate.py against this checkpoint/"
                f"stage split, or drop --kv-share-map"
            )

    # -------------------------------------------------------- constructors
    @classmethod
    def identity(cls, num_layers: int) -> "KVShareMap":
        return cls(num_layers=num_layers,
                   group_of=tuple(range(num_layers)))

    @classmethod
    def from_pairs(cls, num_layers: int,
                   pairs: Sequence[tuple[int, int]],
                   meta: Optional[dict] = None) -> "KVShareMap":
        """Build a map by merging ``pairs`` of layers into shared groups
        (union-find, so chained pairs coalesce)."""
        parent = list(range(num_layers))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in pairs:
            if not (0 <= a < num_layers and 0 <= b < num_layers):
                raise ShareMapError(
                    f"share pair ({a}, {b}) out of range for "
                    f"{num_layers} layers"
                )
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        return cls(num_layers=num_layers,
                   group_of=tuple(find(i) for i in range(num_layers)),
                   meta=dict(meta or {}))

    # --------------------------------------------------------------- disk
    def to_json(self) -> dict:
        return {
            "format": FORMAT,
            "num_layers": self.num_layers,
            "group_of": list(self.group_of),
            "share_hash": self.share_hash,
            "meta": self.meta,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "KVShareMap":
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ShareMapError(
                f"--kv-share-map {path!r} is not readable JSON: {e}"
            ) from e
        if not isinstance(doc, dict) or doc.get("format") != FORMAT:
            raise ShareMapError(
                f"--kv-share-map {path!r} is not a {FORMAT} artifact "
                f"(found format={doc.get('format') if isinstance(doc, dict) else type(doc).__name__!r}) "
                f"— emit one with cli/kv_share_calibrate.py"
            )
        try:
            m = cls(num_layers=int(doc["num_layers"]),
                    group_of=tuple(int(g) for g in doc["group_of"]),
                    meta=dict(doc.get("meta") or {}))
        except (KeyError, TypeError, ValueError) as e:
            raise ShareMapError(
                f"--kv-share-map {path!r} is malformed: {e}"
            ) from e
        stamped = doc.get("share_hash")
        if stamped is not None and stamped != m.share_hash:
            raise ShareMapError(
                f"--kv-share-map {path!r} stamped share_hash {stamped!r} "
                f"disagrees with its own group assignment (hash "
                f"{m.share_hash!r}) — the artifact was hand-edited; "
                f"recalibrate instead of patching the JSON"
            )
        return m


# ------------------------------------------------------------- calibration
def layer_kv_signatures(k, v):
    """Per-layer KV signature vectors from a dense calibration cache.

    ``k``/``v`` are the dense stacked-layer buffers ``(L, B, S, H, D)``
    (cache.py layout) after a calibration prefill. The signature is the
    per-layer mean KV direction — cheap, and enough to rank pairwise
    dissimilarity the way KVSharer's Euclidean ranking does."""
    import numpy as np

    k = np.asarray(k, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    L = k.shape[0]
    sigs = []
    for layer in range(L):
        kv = np.concatenate(
            [k[layer].reshape(-1), v[layer].reshape(-1)]
        )
        sigs.append(kv)
    return np.stack(sigs)


def rank_layer_pairs(k, v, valid_tokens: Optional[int] = None):
    """All layer pairs ranked MOST-dissimilar first.

    Returns ``[((a, b), dissimilarity), ...]`` with ``a < b`` and
    dissimilarity = 1 − cosine(sig_a, sig_b). KVSharer's core observation
    is that the *dissimilar* pairs are the safe ones to share."""
    import numpy as np

    k = np.asarray(k, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    if valid_tokens is not None:
        k = k[:, :, :valid_tokens]
        v = v[:, :, :valid_tokens]
    sigs = layer_kv_signatures(k, v)
    norms = np.linalg.norm(sigs, axis=1)
    norms = np.maximum(norms, 1e-12)
    unit = sigs / norms[:, None]
    cos = unit @ unit.T
    L = sigs.shape[0]
    ranked = [
        ((a, b), float(1.0 - cos[a, b]))
        for a in range(L) for b in range(a + 1, L)
    ]
    ranked.sort(key=lambda t: (-t[1], t[0]))
    return ranked


def calibrate_share_map(
    k,
    v,
    *,
    num_share: int,
    max_group: int = 2,
    valid_tokens: Optional[int] = None,
    meta: Optional[dict] = None,
) -> KVShareMap:
    """Greedy KVSharer calibration: merge the ``num_share`` most
    dissimilar layer pairs into shared groups, capping group size at
    ``max_group`` (the paper shares pairs; >2 compounds quality loss).

    ``k``/``v`` are dense ``(L, B, S, H, D)`` calibration buffers;
    ``valid_tokens`` trims right-padding before ranking."""
    import numpy as np  # noqa: F401 — keeps the dep surface explicit

    L = int(k.shape[0] if hasattr(k, "shape") else len(k))
    if num_share < 0 or num_share > L - 1:
        raise ShareMapError(
            f"num_share must be in [0, {L - 1}] for {L} layers"
        )
    if max_group < 2:
        raise ShareMapError("max_group must be >= 2")
    ranked = rank_layer_pairs(k, v, valid_tokens=valid_tokens)
    group: dict[int, int] = {i: i for i in range(L)}
    size = {i: 1 for i in range(L)}
    chosen: list[tuple[int, int]] = []
    scores: list[float] = []
    for (a, b), score in ranked:
        if len(chosen) >= num_share:
            break
        ga, gb = group[a], group[b]
        if ga == gb or size[ga] + size[gb] > max_group:
            continue
        lo, hi = min(ga, gb), max(ga, gb)
        for layer, g in group.items():
            if g == hi:
                group[layer] = lo
        size[lo] += size.pop(hi)
        chosen.append((a, b))
        scores.append(score)
    info = dict(meta or {})
    info.setdefault("calibration", {})
    info["calibration"].update({
        "num_share_requested": num_share,
        "pairs": [list(p) for p in chosen],
        "dissimilarity": scores,
        "max_group": max_group,
    })
    return KVShareMap.from_pairs(L, chosen, meta=info)


def load_share_map(path: Optional[str],
                   num_layers: Optional[int] = None) -> Optional[KVShareMap]:
    """Engine-facing loader: ``None`` path → no sharing; otherwise load
    and validate against the engine's local layer count when given.
    Identity maps come back as maps (``share_hash is None``) — the engine
    keeps its unshared fast paths selected for them."""
    if not path:
        return None
    m = KVShareMap.load(path)
    if num_layers is not None:
        m.validate_for(num_layers)
    return m
