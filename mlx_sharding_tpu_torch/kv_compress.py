"""Compressed-latent KV transport (port of ``mlx_sharding_tpu/kv_compress.py``):
a codec that rewrites a ``KVPageBlock``'s page payload into a compact wire
form at the host boundary (``KVPageBlock.to_host``) and rebuilds it at
import, in one of two modes:

- **``latent`` (MLA-native, exact)**: DeepSeek-V2's
  ``mla_cache_mode="compressed"`` pool already stores one shared latent
  "head" per row (``cache_num_heads() == 1``, head dim ``kv_lora_rank +
  qk_rope_head_dim``) beside a dummy V. The codec ships the latent K pages
  as they are and replaces every dummy-V leaf with a :class:`ZeroLeaf`
  geometry stub; the rebuild is bit-identical.
- **``lowrank`` (calibrated, bounded error)**: for GQA pools, an offline
  :class:`KVCompressMap` (per-layer SVD down/up projections over the
  flattened ``H*D`` row axis) projects every K/V row to ``rank`` float16
  coefficients at export and back at import. Opt-in with
  ``--kv-compress-map`` (``--kv-compress-rank`` truncates the nested SVD
  basis).

The map's artifact format, its ``compress_hash`` and the latent geometry
hash are JAX's, byte for byte: a map saved by either package loads in the
other and names the same layout. The codec works on host payloads, which in
the port are CPU tensors of the pool leaves' shape ``(L, n, page, H, D)``
(JAX's leaves are ``(S, L, n, B, page, H, D)`` numpy arrays): compression
runs where ``to_host`` runs (the spill tier's flusher thread), the rebuild
at prefetch or import, never on the tick's stream.

Layout identity: :attr:`KVCompressCodec.compress_hash` joins the block
fingerprint, so a block compressed under one geometry never rebuilds into a
pool running another; the import fails closed and the consumer's counted
re-prefill runs. Fault site ``cache.compress``: an encode fault leaves the
block raw (counted), a decode fault lands on the importer's re-prefill.

The calibrate CLI is ``cli/kv_compress_calibrate.py``;
:func:`calibrate_compress_map` takes numpy buffers.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.cache import is_quantized_kv
from mlx_sharding_tpu_torch.testing.faults import inject

FORMAT = "mst-kv-compress-map-v1"

# wire dtype of the low-rank coefficients: the SVD truncation dominates
# the error, and half precision halves the moved bytes again
_WIRE_DTYPE = torch.float16


class CompressError(ValueError):
    """A compress map or codec failed validation, does not fit the pool, or
    a compress/rebuild step failed."""


class ZeroLeaf:
    """Geometry stub for an all-zero payload leaf on the wire (the MLA pool's
    dummy V): ~0 bytes in the payload, fingerprinted by its ``repr``, and
    rebuilt as zeros of the same shape and dtype at import."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype: torch.dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def __repr__(self):  # joins the block fingerprint; JAX's dtype names
        return f"ZeroLeaf(shape={self.shape}, dtype={dtype_name(self.dtype)})"

    def __eq__(self, other):
        return (isinstance(other, ZeroLeaf) and self.shape == other.shape
                and self.dtype == other.dtype)

    def nbytes(self) -> int:
        return 0


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's and ml_dtypes' names)."""
    return str(dtype).removeprefix("torch.")


# ------------------------------------------------------ payload trees
def tree_leaves(tree) -> list:
    """The leaves of a payload tree: a tensor (or :class:`ZeroLeaf`), an
    int8 pool's ``{"d", "s"}`` pair in key order, or a tuple of trees."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *others):
    """``fn`` over a payload tree's leaves (with the matching leaves of
    ``others``), keeping its structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(o[key] for o in others)) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(o[i] for o in others)) for i, t in enumerate(tree))
    return fn(tree, *others)


def tree_structure(tree) -> str:
    """A printable structure of a payload tree (the keys, not the shapes)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: *" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(tree_structure(t) for t in tree) + ")"
    return "*"


def leaf_nbytes(leaf) -> int:
    if isinstance(leaf, ZeroLeaf):
        return 0
    return leaf.numel() * leaf.element_size()


def _as_f32_rows(buf) -> torch.Tensor:
    """Host payload leaf or int8 pair -> dense float32 rows ``(..., H, D)``."""
    if is_quantized_kv(buf):
        return buf["d"].float() * buf["s"].float()
    return buf.float()


def _latent_geometry_hash(num_heads: int, k_dim: int, v_dim: int) -> str:
    payload = f"mst-kv-latent-v1:{num_heads}:{k_dim}:{v_dim}"
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


# ---------------------------------------------------------------- artifact
@dataclass(frozen=True)
class KVCompressMap:
    """Per-layer low-rank KV projection pair, calibrated offline (JAX's
    artifact): ``k_down``/``v_down`` ``(L, H*D, r)`` applied to flattened
    rows at export, ``k_up``/``v_up`` ``(L, r, H*D)`` at import, float32
    numpy. ``num_layers`` counts the pool's layer axis."""

    num_layers: int
    rank: int
    num_heads: int
    head_dim_k: int
    head_dim_v: int
    k_down: np.ndarray
    k_up: np.ndarray
    v_down: np.ndarray
    v_up: np.ndarray
    share_hash: Optional[str] = None
    meta: dict = field(default_factory=dict, compare=False, hash=False)

    def __post_init__(self):
        if self.num_layers < 1 or self.rank < 1:
            raise CompressError(
                f"compress map needs num_layers >= 1 and rank >= 1 "
                f"(got {self.num_layers}, {self.rank})")
        fk = self.num_heads * self.head_dim_k
        fv = self.num_heads * self.head_dim_v
        want = {
            "k_down": (self.num_layers, fk, self.rank),
            "k_up": (self.num_layers, self.rank, fk),
            "v_down": (self.num_layers, fv, self.rank),
            "v_up": (self.num_layers, self.rank, fv),
        }
        for name, shape in want.items():
            arr = np.ascontiguousarray(np.asarray(getattr(self, name), np.float32))
            if arr.shape != shape:
                raise CompressError(f"compress map {name} has shape {arr.shape}, "
                                    f"expected {shape}")
            object.__setattr__(self, name, arr)
        if self.rank >= fk or self.rank >= fv:
            raise CompressError(
                f"rank {self.rank} does not compress "
                f"{self.num_heads}x({self.head_dim_k},{self.head_dim_v}) "
                f"KV rows — pick rank < H*D")

    @property
    def compress_hash(self) -> str:
        """Layout identity over the geometry and the matrices' bytes (JAX's
        hash: a map names the same layout in both packages)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{FORMAT}:{self.num_layers}:{self.rank}:{self.num_heads}:"
                 f"{self.head_dim_k}:{self.head_dim_v}:share={self.share_hash}".encode())
        for arr in (self.k_down, self.k_up, self.v_down, self.v_up):
            h.update(np.ascontiguousarray(arr, np.float32).tobytes())
        return h.hexdigest()

    def truncate(self, rank: int) -> "KVCompressMap":
        """Slice to a lower rank: SVD bases are nested, so this is the
        calibration at the smaller rank."""
        if rank == self.rank:
            return self
        if not (1 <= rank < self.rank):
            raise CompressError(
                f"--kv-compress-rank {rank} must be in [1, {self.rank}] "
                f"for this artifact (calibrated at rank {self.rank})")
        return KVCompressMap(
            num_layers=self.num_layers, rank=rank, num_heads=self.num_heads,
            head_dim_k=self.head_dim_k, head_dim_v=self.head_dim_v,
            k_down=self.k_down[:, :, :rank], k_up=self.k_up[:, :rank, :],
            v_down=self.v_down[:, :, :rank], v_up=self.v_up[:, :rank, :],
            share_hash=self.share_hash, meta=dict(self.meta, truncated_from=self.rank))

    def validate_for(self, num_layers: int, num_heads: int, head_dim_k: int,
                     head_dim_v: int, share_hash: Optional[str] = None) -> None:
        """Pool-geometry fit check with a remediation hint."""
        got = (num_layers, num_heads, head_dim_k, head_dim_v)
        have = (self.num_layers, self.num_heads, self.head_dim_k, self.head_dim_v)
        if got != have:
            raise CompressError(
                f"compress map was calibrated for pool geometry "
                f"(layers, heads, k_dim, v_dim)={have} but this engine's "
                f"pool is {got} — recalibrate with "
                f"cli/kv_compress_calibrate.py against this checkpoint, "
                f"or drop --kv-compress-map")
        if share_hash != self.share_hash:
            raise CompressError(
                f"compress map was calibrated on a pool with "
                f"share_hash={self.share_hash!r} but this engine runs "
                f"{share_hash!r} — the two layout artifacts must be "
                f"calibrated together (rerun cli/kv_compress_calibrate.py "
                f"with the same --kv-share-map)")

    def save(self, path: str) -> None:
        header = json.dumps({
            "format": FORMAT, "num_layers": self.num_layers, "rank": self.rank,
            "num_heads": self.num_heads, "head_dim_k": self.head_dim_k,
            "head_dim_v": self.head_dim_v, "share_hash": self.share_hash,
            "compress_hash": self.compress_hash, "meta": self.meta,
        }, sort_keys=True)
        with open(path, "wb") as f:
            np.savez(f, header=np.frombuffer(header.encode(), np.uint8),
                     k_down=self.k_down, k_up=self.k_up, v_down=self.v_down, v_up=self.v_up)

    @classmethod
    def load(cls, path: str) -> "KVCompressMap":
        try:
            with np.load(path) as z:
                doc = json.loads(bytes(z["header"]).decode())
                mats = {n: np.asarray(z[n], np.float32)
                        for n in ("k_down", "k_up", "v_down", "v_up")}
        except Exception as e:  # noqa: BLE001 — any read failure is a bad artifact
            raise CompressError(
                f"--kv-compress-map {path!r} is not a readable npz artifact: {e}") from e
        if not isinstance(doc, dict) or doc.get("format") != FORMAT:
            raise CompressError(
                f"--kv-compress-map {path!r} is not a {FORMAT} artifact "
                f"(found format="
                f"{doc.get('format') if isinstance(doc, dict) else type(doc).__name__!r}) "
                f"— emit one with cli/kv_compress_calibrate.py")
        try:
            m = cls(num_layers=int(doc["num_layers"]), rank=int(doc["rank"]),
                    num_heads=int(doc["num_heads"]), head_dim_k=int(doc["head_dim_k"]),
                    head_dim_v=int(doc["head_dim_v"]), share_hash=doc.get("share_hash"),
                    meta=dict(doc.get("meta") or {}), **mats)
        except CompressError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise CompressError(f"--kv-compress-map {path!r} is malformed: {e}") from e
        stamped = doc.get("compress_hash")
        if stamped is not None and stamped != m.compress_hash:
            raise CompressError(
                f"--kv-compress-map {path!r} stamped compress_hash "
                f"{stamped!r} disagrees with its own projections (hash "
                f"{m.compress_hash!r}) — the artifact was edited; "
                f"recalibrate instead of patching it")
        return m


def load_compress_map(path: Optional[str], rank: Optional[int] = None) -> Optional[KVCompressMap]:
    """Engine-facing loader: no path, no compression; ``rank`` truncates
    the artifact."""
    if not path:
        if rank is not None:
            raise CompressError(
                "--kv-compress-rank needs --kv-compress-map (the rank "
                "slices a calibrated artifact; there is nothing to "
                "truncate without one)")
        return None
    m = KVCompressMap.load(path)
    if rank is not None:
        m = m.truncate(int(rank))
    return m


# ------------------------------------------------------------- calibration
def calibrate_compress_map(k, v, *, rank: int, valid_tokens: Optional[int] = None,
                           share_hash: Optional[str] = None,
                           meta: Optional[dict] = None) -> KVCompressMap:
    """Per-layer truncated SVD over flattened KV rows (JAX's, in numpy):
    ``k``/``v`` are dense ``(L, B, S, H, D)`` calibration buffers;
    ``valid_tokens`` trims right-padding. Each layer's rows ``(B*S, H*D)``
    get the top ``rank`` right-singular vectors as an orthonormal basis,
    ``down = V_r`` and ``up = V_r^T``; the per-layer relative error over
    the calibration set goes into ``meta["calibration"]``."""
    k = np.asarray(k, np.float32)
    v = np.asarray(v, np.float32)
    if k.ndim != 5 or v.ndim != 5:
        raise CompressError(f"calibration buffers must be (L, B, S, H, D); got "
                            f"k{k.shape} v{v.shape}")
    if valid_tokens is not None:
        k = k[:, :, :valid_tokens]
        v = v[:, :, :valid_tokens]
    L, _, _, H, Dk = k.shape
    Dv = v.shape[-1]

    def fit(buf, feat):
        downs, ups, errs = [], [], []
        for layer in range(L):
            rows = buf[layer].reshape(-1, feat)
            _, _, vt = np.linalg.svd(rows, full_matrices=False)
            basis = vt[:rank].T  # (feat, r)
            downs.append(basis)
            ups.append(basis.T)
            recon = (rows @ basis) @ basis.T
            denom = max(float(np.linalg.norm(rows)), 1e-12)
            errs.append(float(np.linalg.norm(rows - recon) / denom))
        return np.stack(downs), np.stack(ups), errs

    if not (1 <= rank < min(H * Dk, H * Dv)):
        raise CompressError(f"rank must be in [1, {min(H * Dk, H * Dv) - 1}] for "
                            f"{H}x({Dk},{Dv}) KV rows (got {rank})")
    k_down, k_up, k_err = fit(k, H * Dk)
    v_down, v_up, v_err = fit(v, H * Dv)
    info = dict(meta or {})
    info["calibration"] = {"rank": rank, "k_rel_err": k_err, "v_rel_err": v_err,
                           "max_rel_err": max(k_err + v_err),
                           "rows_per_layer": int(np.prod(k.shape[1:3]))}
    return KVCompressMap(num_layers=L, rank=rank, num_heads=H, head_dim_k=Dk, head_dim_v=Dv,
                         k_down=k_down, k_up=k_up, v_down=v_down, v_up=v_up,
                         share_hash=share_hash, meta=info)


# ------------------------------------------------------------------- codec
class KVCompressCodec:
    """Pool-side compress/rebuild of ``KVPageBlock`` payloads, built once
    per engine (``parallel/pipeline.py``) from the pool's geometry. Its
    counters are the ``mst_kv_compress_*`` families, updated off the tick
    path (the flusher, prefetch, import) under ``_lock``."""

    def __init__(self, mode: str, *, compress_map: Optional[KVCompressMap] = None,
                 num_heads: int = 1, head_dim_k: int = 0, head_dim_v: int = 0):
        if mode not in ("latent", "lowrank"):
            raise CompressError(f"unknown codec mode {mode!r}")
        if mode == "lowrank" and compress_map is None:
            raise CompressError("lowrank codec needs a compress map")
        self.mode = mode
        self.map = compress_map
        self.num_heads = int(num_heads)
        self.head_dim_k = int(head_dim_k)
        self.head_dim_v = int(head_dim_v)
        self.compress_hash = (compress_map.compress_hash if mode == "lowrank"
                              else _latent_geometry_hash(num_heads, head_dim_k, head_dim_v))
        self._mats: dict = {}  # the map's matrices as float32 CPU tensors
        self._lock = threading.Lock()
        self.blocks_compressed = 0
        self.blocks_reconstructed = 0
        self.compress_faults = 0
        self.reconstruct_faults = 0
        self.bytes_raw_total = 0
        self.bytes_wire_total = 0

    def _note(self, raw: int, wire: int) -> None:
        with self._lock:
            self.blocks_compressed += 1
            self.bytes_raw_total += int(raw)
            self.bytes_wire_total += int(wire)

    def note_fault(self, op: str) -> None:
        with self._lock:
            if op == "encode":
                self.compress_faults += 1
            else:
                self.reconstruct_faults += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "mode": self.mode,
                "compress_hash": self.compress_hash,
                "rank": self.map.rank if self.map is not None else None,
                "blocks_compressed": self.blocks_compressed,
                "blocks_reconstructed": self.blocks_reconstructed,
                "compress_faults": self.compress_faults,
                "reconstruct_faults": self.reconstruct_faults,
                "bytes_raw_total": self.bytes_raw_total,
                "bytes_wire_total": self.bytes_wire_total,
                "bytes_saved_total": self.bytes_raw_total - self.bytes_wire_total,
            }

    @staticmethod
    def _tree_bytes(tree) -> int:
        return sum(leaf_nbytes(leaf) for leaf in tree_leaves(tree))

    def _mat(self, name: str) -> torch.Tensor:
        if name not in self._mats:
            self._mats[name] = torch.from_numpy(getattr(self.map, name))
        return self._mats[name]

    def compress_pages(self, k_pages, v_pages) -> tuple:
        """Host payload trees -> ``(kind, k_wire, v_wire)``, at the
        ``to_host`` boundary. Fault site ``cache.compress`` (op="encode"):
        the caller keeps the raw payload and counts it."""
        inject("cache.compress", op="encode", mode=self.mode)
        raw = self._tree_bytes((k_pages, v_pages))
        if self.mode == "latent":
            # the pool already stores the shared latent in K; V is the dummy
            # MLA never reads: ship its geometry, not its bytes
            v_wire = tree_map(lambda leaf: ZeroLeaf(leaf.shape, leaf.dtype), v_pages)
            self._note(raw, self._tree_bytes((k_pages, v_wire)))
            return "latent", k_pages, v_wire
        m = self.map

        def down(buf, mats, feat):
            rows = _as_f32_rows(buf)  # (L, n, page, H, D)
            if rows.dim() != 5:
                raise CompressError(f"lowrank compress wants 5-D pool page leaves; got "
                                    f"{tuple(rows.shape)}")
            flat = rows.reshape(*rows.shape[:3], feat)
            return torch.einsum("lptf,lfr->lptr", flat, mats).to(_WIRE_DTYPE)

        k_wire = down(k_pages, self._mat("k_down"), m.num_heads * m.head_dim_k)
        v_wire = down(v_pages, self._mat("v_down"), m.num_heads * m.head_dim_v)
        self._note(raw, self._tree_bytes((k_wire, v_wire)))
        return "lowrank", k_wire, v_wire

    def reconstruct_pages(self, kind: str, k_wire, v_wire) -> tuple:
        """Wire trees -> pool-shaped ``(k_pages, v_pages)`` on the host, at
        prefetch or import. Fault site ``cache.compress`` (op="decode"):
        the importer's counted re-prefill."""
        inject("cache.compress", op="decode", mode=self.mode)
        if kind == "latent":
            if self.mode != "latent":
                raise CompressError("latent block reached a lowrank codec — layout "
                                    "identity check should have rejected it upstream")
            v_pages = tree_map(lambda z: torch.zeros(z.shape, dtype=z.dtype), v_wire)
            with self._lock:
                self.blocks_reconstructed += 1
            return k_wire, v_pages
        if kind != "lowrank" or self.mode != "lowrank":
            raise CompressError(f"cannot reconstruct kind={kind!r} with a {self.mode} codec")
        m = self.map

        def up(wire, mats, heads, dim):
            coef = wire.float()
            if coef.dim() != 4 or coef.shape[-1] != m.rank:
                raise CompressError(f"lowrank wire leaf has shape {tuple(coef.shape)}; "
                                    f"expected rank-{m.rank} coefficients")
            flat = torch.einsum("lptr,lrf->lptf", coef, mats)
            return flat.reshape(*flat.shape[:3], heads, dim)

        k_pages = up(k_wire, self._mat("k_up"), m.num_heads, m.head_dim_k)
        v_pages = up(v_wire, self._mat("v_up"), m.num_heads, m.head_dim_v)
        with self._lock:
            self.blocks_reconstructed += 1
        return k_pages, v_pages

    def reconstruct_block(self, block) -> tuple:
        """Rebuild a compressed block's pool payload (the caller may hold
        the block's lock)."""
        return self.reconstruct_pages(block.compress_kind, block.k_pages, block.v_pages)


def build_codec(model, *, paged: bool, kv_quant: bool, num_stages: int, pool_layers: int,
                share_hash: Optional[str] = None,
                compress_map: Optional[KVCompressMap] = None) -> Optional[KVCompressCodec]:
    """Engine-side codec selection (JAX's rules and messages): an MLA-native
    pool (``mla_cache_mode="compressed"``, one latent head) gets the exact
    ``latent`` codec; a calibrated map opts a bf16 GQA pool into
    ``lowrank``; mismatches fail closed at construction."""
    if not paged:
        if compress_map is not None:
            raise CompressError("--kv-compress-map requires a paged engine (pool_pages): "
                                "compression rides the KVPageBlock export path")
        return None
    hd = model.cache_head_dim()
    k_dim, v_dim = (hd, hd) if not isinstance(hd, (tuple, list)) else hd
    heads = model.cache_num_heads()
    mla_native = heads == 1 and getattr(model.config, "mla_cache_mode", None) == "compressed"
    if mla_native:
        if compress_map is not None:
            raise CompressError(
                "--kv-compress-map is redundant on an MLA-native pool "
                "(mla_cache_mode='compressed' already stores the latent; "
                "export ships it exactly) — drop the flag")
        return KVCompressCodec("latent", num_heads=heads, head_dim_k=k_dim, head_dim_v=v_dim)
    if compress_map is None:
        return None
    if num_stages != 1:
        raise CompressError(
            "--kv-compress-map requires a pp=1 engine: the per-layer "
            "projections span the full layer stack, which a stage split cuts")
    if kv_quant:
        raise CompressError(
            "--kv-compress-map composes with bf16 pools only: int8 pages "
            "already halve row bytes and a dequant→project→requant trip "
            "compounds both error terms — pick one of --kv-dtype int8 or "
            "--kv-compress-map")
    compress_map.validate_for(pool_layers, heads, k_dim, v_dim, share_hash=share_hash)
    return KVCompressCodec("lowrank", compress_map=compress_map, num_heads=heads,
                           head_dim_k=k_dim, head_dim_v=v_dim)
