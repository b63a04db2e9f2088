"""Cross-replica shared weights: one resident copy per device (copied
from ``mlx_sharding_tpu/weights.py``; the store is framework-free, and a
resident tree here is the port's loaded model module).

Each data-parallel replica of the JAX package used to upload its own
device copy of the params, N replicas costing N×W of memory. The
``WeightStore`` keys resident trees by (checkpoint, stage bounds, dtype,
quant/fusion config, placement) and places each ONCE; every replica whose
engine runs on the same device aliases the same tensors through a
refcounted lease, so fleet weight bytes drop from N×W to ~W and a spawn
that hits the store costs slot/cache setup only.

Lifecycle contract:

- ``acquire(key, build)`` returns a ``WeightLease``; the first acquire of
  a key runs ``build()`` (the one real load), later acquires alias it.
- Each engine holds exactly one lease and releases it from ``close()``
  (``PipelineEngine.on_close``); ``ReplicaSet.drain``/``close`` ride that
  hook, so retirement releases refs and the LAST release drops the store's
  reference (the tensors die with the last engine).
- A faulted spawn must release the lease it acquired before re-raising
  (``aliased_spawn`` wraps that), so ``replica.spawn`` faults leave
  refcounts consistent: never a leaked tree, never one freed in use.
- Releasing a key the store doesn't hold — or the same lease twice — is a
  bug, and raises.

The store holds whatever resident object the builder returns
(:class:`ResidentWeights` in practice) and only reads its ``weight_bytes``
for the ``mst_weight_store_bytes`` gauge.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from mlx_sharding_tpu_torch.utils.locks import make_lock, note_acquire, note_release


@dataclass
class ResidentWeights:
    """A loaded model module on its device, with the bytes its tensors
    hold: what ``PipelineEngine(model)`` runs against. Engines that alias
    one share the module; everything an engine changes per step (its
    plans, its pool, its graphs and their memory pool) lives on the
    engine. ``stage_bounds`` and ``devices``: the pipeline split it was
    placed for (``parallel.pipeline.place_weights``) and each stage's
    device; None is the whole model on ``device``."""

    model: Any
    device: Any
    weight_bytes: int
    stage_bounds: Optional[tuple] = None
    devices: Optional[tuple] = None
    #: the tensor- and expert-parallel widths, the (pp, sp, ep, tp) device
    #: grid and, at tp or ep > 1, each stage's per-shard layer modules
    tp: int = 1
    ep: int = 1
    grid: Any = None
    shard_layers: Optional[tuple] = None


def model_weight_bytes(model) -> int:
    """Bytes of every tensor of ``model`` once (tied tensors once)."""
    sizes = {}
    for t in model.state_dict().values():
        sizes.setdefault(t.data_ptr(), t.numel() * t.element_size())
    return sum(sizes.values())


def tree_weight_bytes(parts) -> int:
    """Bytes of every tensor of ``parts`` (modules or tensors) once: a
    tensor that several shards share (a replicated norm) counts once, and a
    shard's view of a model tensor counts its own slice."""
    sizes = {}
    for part in parts:
        tensors = part.state_dict().values() if hasattr(part, "state_dict") else [part]
        for t in tensors:
            sizes.setdefault((str(t.device), t.data_ptr()), t.numel() * t.element_size())
    return sum(sizes.values())


@dataclass(frozen=True)
class WeightKey:
    """Identity of a resident tree. Two engines share arrays iff every
    field matches: the checkpoint's weight content (resolved path + quant
    config + packed/dense residency, see ``loading.checkpoint_signature``),
    the stage split, the compute dtype, the build-time fusion config and
    the tp / ep widths (``quant``: ``tp2:ep1`` ...), and the placement (the
    device grid, ``parallel.mesh.mesh_fingerprint``) — tensors are
    device-resident, so WHERE they live is part of WHAT they are."""

    checkpoint: str
    stage_bounds: tuple
    dtype: str
    quant: str
    placement: str


def key_digest(key: WeightKey) -> str:
    """Short stable identity of a WeightKey for the pod control plane:
    hosts gossip digests (16 hex chars), not full keys — the checkpoint
    path alone can exceed a pod message slot, and equality is all the
    cross-host arbitration needs."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(repr((
        key.checkpoint, key.stage_bounds, key.dtype, key.quant,
        key.placement,
    )).encode())
    return h.hexdigest()


class WeightLease:
    """One engine's refcounted handle on a resident tree. ``release()`` is
    single-shot by contract — the double-release of a shared tree is how a
    freed-in-use bug starts, so the second call raises instead of silently
    decrementing someone else's ref."""

    __slots__ = ("store", "key", "weights", "_released")

    def __init__(self, store: "WeightStore", key: WeightKey, weights):
        self.store = store
        self.key = key
        self.weights = weights
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> bool:
        """Drop this lease's ref. Returns True when this was the last ref
        and the store freed the tree."""
        if self._released:
            raise RuntimeError(
                f"weight lease for {self.key.checkpoint!r} released twice"
            )
        self._released = True
        note_release("weights.lease", id(self))
        return self.store.release(self.key)


class _Entry:
    __slots__ = ("weights", "refs")

    def __init__(self, weights):
        self.weights = weights
        self.refs = 0


@dataclass
class WeightStore:
    """Refcounted registry of device-resident weight trees, one per
    ``WeightKey``. Per-host singleton in serving (``weight_store()``);
    tests build private instances."""

    _lock: Any = field(default_factory=lambda: make_lock("WeightStore._lock"))
    _entries: dict = field(default_factory=dict)

    def acquire(self, key: WeightKey, build: Callable[[], Any]) -> WeightLease:
        """Lease the tree for ``key``, building (uploading) it iff absent.
        The build runs under the store lock: two concurrent spawns of the
        same key must produce ONE placement, and an upload racing a
        last-release free must not resurrect a half-dropped entry. A build
        that raises leaves no entry behind."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = _Entry(build())
                self._entries[key] = entry
            entry.refs += 1
            lease = WeightLease(self, key, entry.weights)
            note_acquire("weights.lease", id(lease), checkpoint=key.checkpoint)
            return lease

    def release(self, key: WeightKey) -> bool:
        """Drop one ref on ``key``; the last release frees the store's
        reference (engines still alive keep the arrays alive through their
        own attributes — the device memory dies with the last of them).
        Releasing a key the store doesn't hold raises: it means a lease
        was double-released or never acquired."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise RuntimeError(
                    f"release of weight tree the store does not hold: {key}"
                )
            entry.refs -= 1
            if entry.refs == 0:
                del self._entries[key]
                return True
            return False

    def refs(self, key: WeightKey) -> int:
        with self._lock:
            entry = self._entries.get(key)
            return 0 if entry is None else entry.refs

    def stats(self) -> dict:
        """Gauge source for ``mst_weight_store_{bytes,trees,refs}`` and the
        /health store block. Each entry carries its :func:`key_digest` so
        the pod weight registry can gossip which trees THIS host holds
        without shipping the full WeightKey over the control plane."""
        with self._lock:
            entries = [
                {
                    "checkpoint": key.checkpoint,
                    "placement": key.placement,
                    "digest": key_digest(key),
                    "refs": e.refs,
                    "bytes": int(getattr(e.weights, "weight_bytes", 0) or 0),
                }
                for key, e in self._entries.items()
            ]
        return {
            "trees": len(entries),
            "refs": sum(e["refs"] for e in entries),
            "bytes": sum(e["bytes"] for e in entries),
            "entries": entries,
        }

    def find(self, digest: str) -> Optional[WeightKey]:
        """Resolve a gossiped digest back to this host's WeightKey, or None
        when this host holds no such tree — the pod teardown handler uses
        this to map a ``weights.teardown`` message onto a local key."""
        with self._lock:
            for key in self._entries:
                if key_digest(key) == digest:
                    return key
        return None


def aliased_spawn(
    store: WeightStore,
    key: WeightKey,
    build: Callable[[], Any],
    make_engine: Callable[[WeightLease], Any],
):
    """The spawn-path contract in one place: acquire a lease, construct the
    engine against it, and on ANY construction failure release the lease
    before re-raising — a faulted ``replica.spawn`` degrades to the static
    fleet with refcounts exactly as they were, never holding a ref for an
    engine that doesn't exist (leak) and never having freed a tree another
    replica is executing against."""
    lease = store.acquire(key, build)
    try:
        return make_engine(lease)
    except BaseException:
        lease.release()
        raise


_STORE: Optional[WeightStore] = None
_STORE_LOCK = make_lock("weights._STORE_LOCK")


def weight_store() -> WeightStore:
    """The per-host (per-process) store serving and /metrics share."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = WeightStore()
        return _STORE
