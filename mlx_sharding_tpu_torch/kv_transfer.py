"""KV page-block movement (port of the single-host part of
``mlx_sharding_tpu/kv_transfer.py``): a request's KV pages plus the sampler
state that makes its continuation exact, as a :class:`KVPageBlock`, and the
host-memory :class:`KVSpillTier` that preemption and cold-slot spill park
blocks in.

- **Spill instead of discard**: ``ContinuousBatcher._preempt`` exports the
  victim's page chain into the tier (an LRU over ``--spill-bytes``); the
  resume imports the pages into fresh pool pages instead of re-prefilling.
- The block carries the slot's ``torch.Generator`` state (``resume_gen``,
  JAX's ``resume_keys``) and its repetition window (``resume_recent``).

Streams and the host (torch tensors are mutable, JAX arrays are not):

- :func:`export_block` enqueues the gather (``index_select``, a new tensor
  per leaf) on the tick's stream and records a CUDA event after it; it
  reads nothing back.
- :meth:`KVPageBlock.to_host` (the tier's flusher thread) makes a side
  stream wait on that event, copies each leaf into pinned host memory with
  ``non_blocking=True`` there, marks the gathered tensor used on the side
  stream (``record_stream``, so the caching allocator does not hand its
  memory to the next tick), and waits for its own copy alone before it
  stamps the checksum.
- :meth:`KVPageBlock.prefetch` stages the host payload back on a second
  side stream from pinned memory and records an event; the import's
  scatter makes the tick's stream wait on it (``wait_event``) and never
  blocks the host. Without a stage the import copies the payload itself
  on that side stream and waits for the copy: the demand import, whose
  host wait ``mst_tick_device_blocked_ms{path="kv_import"}`` shows.
- No function on the tick's path calls ``.cpu()``, ``.item()`` or
  ``synchronize()`` on a block (JAX's MST106 rule).

Host leaves are CPU tensors (numpy has no bf16): the checksum and the wire
format cover their exact bytes. The checksum is a blake2b of the whole
payload (~1 GB/s on the host): the flusher stamps it, ``from_bytes``
checks it on arrival, and an explicit :meth:`KVPageBlock.verify` checks
it again; the import (on the tick's thread) checks the structure and
hashes only a block whose checksum this process has not stamped or
checked, so that a resume does not spend the hash on the tick. :meth:`KVPageBlock.to_bytes` /
:meth:`from_bytes` are the port's own wire format (a JSON header, then the
leaves' bytes), not JAX's pickles.

Failure degradation (JAX's): a failed export, import or prefetch (fault
sites ``cache.export``, ``cache.import``, ``cache.prefetch``, a corrupt
checksum, the budget) is counted by the caller, logged, and the request
re-prefills from its folded history; the stream stays exact.

A block carries the pool's KV share map hash (``share_hash``, None for an
unshared pool or the identity map); an import into a pool of another
layout is refused. The batcher's drain (``migrate_out``) moves blocks
between replicas on the host, and so does the disagg handoff: the prefill
replica exports (``ContinuousBatcher._handoff_out``), the coordinator
calls :meth:`KVPageBlock.to_host` on the request's thread, the decode
replica imports; the pod (``pod.py``) ships :meth:`KVPageBlock.to_bytes`
between hosts.

Pipeline stages: a block exported from an S-stage engine's pool
(``cache.StagedKV``) holds one payload per stage, in stage order (lists of
the per-stage trees), and records the stage layout (``stage_layers``, each
stage's layer count), which the checksum and the wire format cover. Each
stage's gather runs on its stage's device and records an event on that
device's stream; its flush, stage and import copies run on that device's
side streams and wait on that stage's event alone. JAX's block is one leaf
with every stage on axis 0, padded to the largest stage: at an uneven split
the port's ``nbytes`` is smaller than JAX's, at an even one equal. On one
card every stage is ``cuda:0``; stages on distinct cards have not been run.
"""

from __future__ import annotations

import hashlib
import json
import logging
import queue
import struct
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.cache import (
    StagedKV,
    export_pool_pages,
    import_pool_pages,
    is_sharded_kv,
    pool_device,
    stage_caches,
    stage_layers,
)
from mlx_sharding_tpu_torch.device import upload
from mlx_sharding_tpu_torch.kv_compress import (
    ZeroLeaf,
    dtype_name,
    leaf_nbytes,
    tree_leaves,
    tree_map,
    tree_structure,
)
from mlx_sharding_tpu_torch.parallel.mesh import DEFER_KV
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)

WIRE_MAGIC = b"MSTKVB1\0"
_WIRE_DIGEST = 16  # bytes of the trailing blake2b

# one side stream per (device, direction): device-to-host flushes and
# host-to-device stages each keep their copy engine busy on their own
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def side_stream(device: torch.device, direction: str) -> "torch.cuda.Stream":
    """The side stream of ``direction`` ("d2h" or "h2d") on ``device``."""
    key = (device.index if device.index is not None else torch.cuda.current_device(),
           direction)
    with _STREAMS_LOCK:
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=key[0])
        return _STREAMS[key]


class BlockIntegrityError(RuntimeError):
    """A block failed its checksum or structural validation: treat it as
    corrupt and re-prefill."""


def _tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """The exact bytes of a host tensor, as a uint8 array (any dtype, bf16
    included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise BlockIntegrityError(f"unknown dtype {name!r} on the wire")
    return dt


@dataclass(eq=False)
class KVPageBlock:
    """One request's relocatable decode state: its page payloads (codes and
    scales for an int8 pool) and what the sampler needs to continue the
    exact stream on a pool of the same geometry.

    ``k_pages`` / ``v_pages`` mirror the pool's leaves ``(L, n, page, H,
    D)`` with the pool axis (1) narrowed to the request's page chain, in
    chain order: tensors on the pool's device after the export (the gather
    enqueued, not waited on), CPU tensors in pinned memory after
    :meth:`to_host`, which stamps ``checksum``.

    KV rows (the batcher's decode-write rule): a request that has emitted
    ``len(history)`` tokens has ``prompt.size + len(history) - 1`` valid
    rows; the last token's id is ``last_tok``, the next step's input.

    A block of an S-stage pool: ``k_pages`` / ``v_pages`` are lists of S
    such trees, one per stage over its own layers, and ``stage_layers``
    the stages' layer counts (None for a single pool)."""

    k_pages: object
    v_pages: object
    n_tokens: int
    page_size: int
    prompt: np.ndarray  # original prompt ids (before a fold)
    history: list  # tokens emitted since admission or the last fold
    produced: int  # tokens delivered to the client
    last_tok: int  # next decode input (history[-1]), -1 for a pure prefix
    resume_gen: Optional[torch.Tensor]  # the slot generator's state (CPU bytes)
    resume_recent: Optional[torch.Tensor]  # the slot's repetition window row
    share_hash: Optional[str] = None
    compress_kind: Optional[str] = None
    compress_hash: Optional[str] = None
    checksum: Optional[str] = None
    stage_layers: Optional[tuple] = None
    _host: bool = False
    # the checksum was stamped (to_host) or checked (verify) in this
    # process over the payload it holds
    _verified: bool = False
    # (k_pages, v_pages) staged on the device by prefetch() (rebuilt first
    # for a compressed block) and the event after their copy (a list, one
    # a stage, for a staged block)
    _staged: Optional[tuple] = None
    _staged_event: Optional[object] = None
    # the export gather's event (CUDA; a list, one a stage, for a staged
    # block): the flush waits on it
    _ready: Optional[object] = None
    # the devices the pages were exported from, one a stage (a prefetch
    # stages there)
    _devices: Optional[list] = None
    # the exporting engine's codec: the flusher compresses with it
    _codec: object = None
    _lock: object = field(default_factory=lambda: make_lock("KVPageBlock._lock"), repr=False)

    @property
    def n_pages(self) -> int:
        return tree_leaves(self.k_pages)[0].shape[1]

    @property
    def nbytes(self) -> int:
        """Payload bytes charged against the spill budget (the sampler rows
        are not counted)."""
        return int(sum(leaf_nbytes(leaf) for leaf in tree_leaves((self.k_pages, self.v_pages))))

    @property
    def is_host(self) -> bool:
        return self._host

    @property
    def is_prefetched(self) -> bool:
        return self._staged is not None

    def _stages(self, tree) -> list:
        """A payload tree's per-stage parts: the list a staged block holds,
        or ``[tree]``."""
        return list(tree) if self.stage_layers is not None else [tree]

    def _join(self, parts: list):
        """The inverse of :meth:`_stages`."""
        return list(parts) if self.stage_layers is not None else parts[0]

    # ----------------------------------------------------------- residency
    def prefetch(self, device=None, codec=None) -> "KVPageBlock":
        """Stage the host payload on ``device`` (default: the one it was
        exported from; a list gives each stage's) ahead of a scheduled
        import: on a card the copy is enqueued from pinned memory on the
        host-to-device side stream of each stage's device with an event
        after it, and nothing waits. Idempotent; a block not yet flushed
        needs no stage. A compressed block is rebuilt here. Fault site
        ``cache.prefetch``: the caller counts it and the import takes the
        demand path."""
        inject("cache.prefetch", n_bytes=self.nbytes)
        with self._lock:
            if not self._host or self._staged is not None:
                return self
            if self.compress_kind is not None:
                dec = codec if codec is not None else self._codec
                if dec is None:
                    return self  # the demand import, with the pool's codec, rebuilds it
                k_pages, v_pages = dec.reconstruct_block(self)
            else:
                k_pages, v_pages = self.k_pages, self.v_pages
            ks, vs = self._stages(k_pages), self._stages(v_pages)
            if isinstance(device, (list, tuple)):
                devs = [torch.device(d) for d in device]
            elif device is not None:
                devs = [torch.device(device)] * len(ks)
            else:
                devs = self._devices or [torch.device("cpu")] * len(ks)
            if len(devs) != len(ks):
                return self  # another stage layout: the import refuses it
            events = []
            for i, dev in enumerate(devs):
                if dev.type != "cuda":
                    events.append(None)
                    continue
                stream = side_stream(dev, "h2d")
                with torch.cuda.stream(stream):
                    put = lambda t, dev=dev: _pinned(t).to(dev, non_blocking=True)  # noqa: E731
                    ks[i], vs[i] = tree_map(put, ks[i]), tree_map(put, vs[i])
                    event = torch.cuda.Event()
                    event.record(stream)
                events.append(event)
            self._staged = (self._join(ks), self._join(vs))
            self._staged_event = None if not any(events) else self._join(events)
        return self

    def payload(self) -> tuple:
        """``(k_pages, v_pages, event)`` for the import's scatter: the staged
        copies and their event when present, else the raw payload (host
        tensors after a flush, the demand path; device tensors before one)
        and None."""
        with self._lock:
            if self._staged is not None:
                return (*self._staged, self._staged_event)
            return self.k_pages, self.v_pages, None

    def drop_prefetch(self) -> None:
        """Release the staged device copies (they served their import)."""
        with self._lock:
            self._staged = self._staged_event = None

    def to_host(self) -> "KVPageBlock":
        """Copy the payload into pinned host memory and stamp the checksum.
        Idempotent and thread-safe. On a card: the device-to-host side
        stream waits on the export's event, the copies run there, and this
        thread waits for them alone, never for the tick's stream. The copy,
        the compression and the checksum run outside the block's lock, so
        an import meanwhile takes the device payload without waiting for
        them; the host payload replaces it once complete. Never call it on
        the tick's path."""
        tr = tracing.current()
        t0 = time.perf_counter() if tr is not None else 0.0
        with self._lock:
            if self._host:
                return self
            k, v, recent, ready = self.k_pages, self.v_pages, self.resume_recent, self._ready
        ks, vs = self._stages(k), self._stages(v)
        readies = self._stages(ready) if ready is not None else [None] * len(ks)
        dones = []
        for i in range(len(ks)):
            first = tree_leaves(ks[i])[0]
            if not (isinstance(first, torch.Tensor) and first.is_cuda):
                continue
            # each stage's copy on its own device's side stream, after that
            # stage's gather alone
            stream = side_stream(first.device, "d2h")
            with torch.cuda.stream(stream):
                if readies[i] is not None:
                    stream.wait_event(readies[i])
                fetch = _fetcher(stream)
                ks[i], vs[i] = tree_map(fetch, ks[i]), tree_map(fetch, vs[i])
                if i == 0:
                    recent = fetch(recent)
                done = torch.cuda.Event()
                done.record(stream)
            dones.append(done)
        for done in dones:
            done.synchronize()
        k, v = self._join(ks), self._join(vs)
        kind = chash = None
        if self._codec is not None:
            # compress at the host boundary; a failure leaves the block raw
            # (counted): the bytes still move
            try:
                kind, k, v = self._codec.compress_pages(k, v)
                chash = self._codec.compress_hash
            except Exception:  # noqa: BLE001 — degrade to raw, never lose the block
                self._codec.note_fault("encode")
                logger.warning("KV compress failed; block ships raw", exc_info=True)
        checksum = self._fingerprint(k, v, kind, chash)
        with self._lock:
            if self._host:
                return self  # another thread flushed it meanwhile
            self.k_pages, self.v_pages, self.resume_recent = k, v, recent
            self.compress_kind, self.compress_hash = kind, chash
            self._ready = None
            self.checksum = checksum
            self._verified = True
            self._host = True
        if tr is not None:
            tr.add("kv_to_host", t0, time.perf_counter(), bytes=self.nbytes)
        return self

    # ----------------------------------------------------------- integrity
    def _fingerprint(self, k_pages, v_pages, compress_kind, compress_hash) -> str:
        h = hashlib.blake2b(digest_size=16)
        head = f"{self.n_tokens}:{self.page_size}:{self.last_tok}"
        if self.share_hash:
            head += f":share={self.share_hash}"
        if compress_kind:
            head += f":compress={compress_kind}:{compress_hash}"
        if self.stage_layers is not None:
            head += ":stages=" + "+".join(str(n) for n in self.stage_layers)
        h.update(head.encode())
        for leaf in tree_leaves((k_pages, v_pages)):
            if isinstance(leaf, ZeroLeaf):
                h.update(repr(leaf).encode())
            else:
                h.update(_tensor_bytes(leaf))
        return h.hexdigest()

    def verify(self, recheck: bool = True) -> None:
        """Structural checks always; the checksum once on the host (with
        ``recheck`` False, only if it was not stamped or checked here
        before). Raises :class:`BlockIntegrityError`; importers catch it
        and re-prefill."""
        if self.page_size < 1 or self.n_tokens < 1:
            raise BlockIntegrityError(f"degenerate block: page_size={self.page_size} "
                                      f"n_tokens={self.n_tokens}")
        if self.n_tokens > self.n_pages * self.page_size:
            raise BlockIntegrityError(
                f"block claims {self.n_tokens} KV rows but carries only "
                f"{self.n_pages} pages of {self.page_size}")
        if not self.history and self.produced != 0:
            # only a pure-prefix block (prefix-store demotion) is history-less
            raise BlockIntegrityError("block without emitted history")
        with self._lock:
            if self._host and self.checksum is not None and (recheck or not self._verified):
                if self._fingerprint(self.k_pages, self.v_pages, self.compress_kind,
                                     self.compress_hash) != self.checksum:
                    raise BlockIntegrityError("KV page payload checksum mismatch (corrupt block)")
                self._verified = True

    # --------------------------------------------------------------- wire
    def to_bytes(self) -> bytes:
        """The port's wire format for a host block: ``WIRE_MAGIC``, the
        header's length (8 bytes, little-endian), a JSON header (every
        resume field, the checksum, each leaf's dtype and shape), each
        leaf's bytes in order, and a 16-byte blake2b of all of it. The
        pages' checksum does not cover the sampler rows; the trailing
        digest covers every byte, so :meth:`from_bytes` turns any
        corruption in transit into :class:`BlockIntegrityError`."""
        with self._lock:
            if not self._host:
                raise BlockIntegrityError("to_bytes() needs a host-materialized block — "
                                          "call to_host() first (off the tick path)")
            chunks: list = []

            def spec(leaf):
                if isinstance(leaf, ZeroLeaf):
                    return {"zero": list(leaf.shape), "dtype": dtype_name(leaf.dtype)}
                chunks.append(_tensor_bytes(leaf.cpu()).tobytes())
                return {"shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype)}

            # chunks follow the walk: k's leaves, v's, then the sampler rows
            pages = {"k_pages": tree_map(spec, self.k_pages),
                     "v_pages": tree_map(spec, self.v_pages)}
            extra = {name: None if getattr(self, name) is None else spec(getattr(self, name))
                     for name in ("resume_gen", "resume_recent")}
            header = {
                **pages,
                "n_tokens": self.n_tokens, "page_size": self.page_size,
                "prompt": [int(t) for t in self.prompt], "history": list(self.history),
                "produced": self.produced, "last_tok": self.last_tok,
                "share_hash": self.share_hash, "compress_kind": self.compress_kind,
                "compress_hash": self.compress_hash, "checksum": self.checksum,
                "stage_layers": (None if self.stage_layers is None
                                 else list(self.stage_layers)), **extra,
            }
        head = json.dumps(header, sort_keys=True).encode()
        body = b"".join([WIRE_MAGIC, struct.pack("<Q", len(head)), head, *chunks])
        return body + hashlib.blake2b(body, digest_size=_WIRE_DIGEST).digest()

    @staticmethod
    def from_bytes(data: bytes) -> "KVPageBlock":
        """Rebuild a shipped block and verify it. Any truncation, malformed
        header or checksum mismatch raises :class:`BlockIntegrityError`."""
        try:
            if data[: len(WIRE_MAGIC)] != WIRE_MAGIC:
                raise BlockIntegrityError("not a KV page-block wire payload")
            data, digest = data[:-_WIRE_DIGEST], data[-_WIRE_DIGEST:]
            if hashlib.blake2b(data, digest_size=_WIRE_DIGEST).digest() != digest:
                raise BlockIntegrityError("wire checksum mismatch (corrupt or truncated block)")
            pos = len(WIRE_MAGIC)
            (n_head,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            if pos + n_head > len(data):
                raise BlockIntegrityError("truncated block header")
            header = json.loads(data[pos : pos + n_head].decode())
            pos += n_head
            view = memoryview(data)

            def leaf(spec):
                nonlocal pos
                dt = _dtype(spec["dtype"])
                if "zero" in spec:
                    return ZeroLeaf(spec["zero"], dt)
                shape = tuple(int(s) for s in spec["shape"])
                n = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                if pos + n > len(data):
                    raise BlockIntegrityError("truncated block payload")
                buf = bytearray(view[pos : pos + n])
                pos += n
                return torch.frombuffer(buf, dtype=torch.uint8).view(dt).reshape(shape)

            def walk(spec):
                if isinstance(spec, list):  # a staged payload: one tree a stage
                    return [walk(part) for part in spec]
                if "dtype" in spec:
                    return leaf(spec)
                return {key: walk(spec[key]) for key in sorted(spec)}

            k_pages = walk(header["k_pages"])
            v_pages = walk(header["v_pages"])
            extra = {name: None if header[name] is None else leaf(header[name])
                     for name in ("resume_gen", "resume_recent")}
            if pos != len(data):
                raise BlockIntegrityError(f"{len(data) - pos} trailing bytes after the payload")
            layers = header.get("stage_layers")
            if (layers is None) != (not isinstance(k_pages, list)):
                raise BlockIntegrityError("stage layout disagrees with the payload")
            blk = KVPageBlock(
                k_pages=k_pages, v_pages=v_pages, n_tokens=int(header["n_tokens"]),
                page_size=int(header["page_size"]),
                prompt=np.asarray(header["prompt"], np.int64),
                history=[int(t) for t in header["history"]], produced=int(header["produced"]),
                last_tok=int(header["last_tok"]), share_hash=header.get("share_hash"),
                compress_kind=header.get("compress_kind"),
                compress_hash=header.get("compress_hash"), checksum=header["checksum"],
                stage_layers=None if layers is None else tuple(int(n) for n in layers),
                _host=True, **extra)
        except BlockIntegrityError:
            raise
        except Exception as e:  # noqa: BLE001 — any decode failure is corruption
            raise BlockIntegrityError(f"undecodable shipped block: {e!r}") from e
        blk.verify()
        return blk

    def compatible_with(self, cache) -> Optional[str]:
        """None if the pages can be scattered into ``cache``'s pool, else
        the reason (an int8 block into a bf16 pool, a geometry mismatch
        off the pool axis, a dtype, another stage layout)."""
        theirs = stage_layers(cache)
        if self.stage_layers != theirs:
            return (f"page geometry mismatch: block stage layers {self.stage_layers} vs pool "
                    f"{theirs}")
        with self._lock:
            return pages_compatible(self.k_pages, self.v_pages, cache)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_cuda or t.is_pinned() else t.pin_memory()


def _fetcher(stream):
    """A leaf's copy into pinned host memory on ``stream`` (a side stream
    of the leaf's device); the device tensor is marked used there."""
    def fetch(t):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        t.record_stream(stream)
        return host
    return fetch


def pages_compatible(k_pages, v_pages, cache, check_dtype: bool = True) -> Optional[str]:
    """None if the payload trees fit ``cache``'s pool, else the reason.
    ``check_dtype=False`` is the lossy low-rank import: the rebuilt float32
    rows are cast into the pool's dtype. A :class:`cache.StagedKV` is
    checked stage by stage against a staged payload's lists: another stage
    count or split is a geometry mismatch, as JAX's ``(S, L, ...)`` leaf
    check finds it. JAX compares a split padded to its largest stage, so it
    takes a 0-3 / 3-4 block into a 0-1 / 1-4 pool; the port refuses it."""
    pools = stage_caches(cache)
    staged = isinstance(cache, StagedKV)
    if isinstance(k_pages, list) != staged or (staged and len(k_pages) != len(pools)):
        ours = tuple(tree_leaves(k)[0].shape[0] for k in
                     (k_pages if isinstance(k_pages, list) else [k_pages]))
        return (f"page geometry mismatch: block stage layers {ours} vs pool "
                f"{stage_layers(cache) or (tree_leaves(cache.k)[0].shape[0],)}")
    if staged:
        for k, v, pool in zip(k_pages, v_pages, pools):
            reason = pages_compatible(k, v, pool, check_dtype)
            if reason is not None:
                return reason
        return None
    ours, theirs = tree_structure((k_pages, v_pages)), tree_structure((cache.k, cache.v))
    if ours != theirs:
        return f"KV storage mode mismatch: block {ours} vs pool {theirs}"
    for blk, pool in zip(tree_leaves((k_pages, v_pages)), tree_leaves((cache.k, cache.v))):
        bs, ps = tuple(blk.shape), tuple(pool.shape)
        if len(bs) != len(ps) or bs[:1] != ps[:1] or bs[2:] != ps[2:]:
            return f"page geometry mismatch: block leaf {bs} vs pool {ps}"
        if check_dtype and blk.dtype != pool.dtype:
            return f"dtype mismatch: block {dtype_name(blk.dtype)} vs pool {dtype_name(pool.dtype)}"
    return None


def export_block(cache, page_ids, *, page_size: int, n_tokens: int, prompt, history,
                 produced: int, resume_gen, resume_recent, share_hash: Optional[str] = None,
                 codec=None) -> KVPageBlock:
    """Lift a request's page chain out of a paged cache as a
    :class:`KVPageBlock`: the gather is enqueued on the current stream and
    an event recorded after it; the block holds device tensors until
    someone calls :meth:`KVPageBlock.to_host`. ``codec``: the pool's
    ``KVCompressCodec``, which the flush compresses with. A
    :class:`cache.StagedKV` gives a staged block: each stage's gather on
    its device's current stream, an event recorded there after it. Fault
    site ``cache.export`` fires before any device work."""
    if is_sharded_kv(cache):
        raise NotImplementedError(DEFER_KV)
    inject("cache.export", n_pages=len(page_ids), n_tokens=n_tokens)
    devices = [pool_device(c) for c in stage_caches(cache)]
    ids = upload(np.asarray(list(page_ids), np.int64), devices[0])
    tr = tracing.current()
    if tr is not None:
        with tr.timed("kv_export", pages=len(page_ids), tokens=n_tokens):
            k_pages, v_pages = export_pool_pages(cache, ids)
    else:
        k_pages, v_pages = export_pool_pages(cache, ids)
    events = []
    for device in devices:
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        events.append(event)
    layers = stage_layers(cache)
    ready = (events if layers is not None else events[0]) if any(events) else None
    history = [int(t) for t in history]
    return KVPageBlock(
        k_pages=k_pages, v_pages=v_pages, n_tokens=int(n_tokens), page_size=int(page_size),
        prompt=np.array(prompt, np.int64, copy=True), history=history, produced=int(produced),
        last_tok=int(history[-1]) if history else -1,
        resume_gen=resume_gen, resume_recent=resume_recent, share_hash=share_hash,
        stage_layers=layers, _ready=ready, _devices=devices, _codec=codec)


def _onto(cache, k_pages, v_pages, event):
    """The payload on the pool's devices (:func:`_onto_one`), stage by
    stage for a :class:`cache.StagedKV`: each stage's copy waits on its own
    event, on its own device's stream."""
    if not isinstance(cache, StagedKV):
        return _onto_one(pool_device(cache), k_pages, v_pages, event)
    events = event if event is not None else [None] * len(cache.stages)
    parts = [_onto_one(pool_device(c), k, v, e)
             for c, k, v, e in zip(cache.stages, k_pages, v_pages, events, strict=True)]
    return [k for k, _ in parts], [v for _, v in parts]


def _onto_one(device: torch.device, k_pages, v_pages, event):
    """The payload on the pool's device, for a scatter enqueued on the
    current stream. A staged payload (``event`` set): the stream waits on
    the stage's event, no host wait. Host tensors on a card (the demand
    import): copied on the host-to-device side stream, and this thread
    waits for that copy alone. Device tensors not yet flushed were made on
    this stream and need nothing."""
    if device.type != "cuda":
        return tree_map(lambda t: t.to(device), k_pages), tree_map(lambda t: t.to(device),
                                                                    v_pages)
    current = torch.cuda.current_stream(device)
    if event is None and not tree_leaves(k_pages)[0].is_cuda:
        stream = side_stream(device, "h2d")
        with torch.cuda.stream(stream):
            put = lambda t: _pinned(t).to(device, non_blocking=True)  # noqa: E731
            k_pages, v_pages = tree_map(put, k_pages), tree_map(put, v_pages)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
    if event is not None:
        current.wait_event(event)
        for t in tree_leaves((k_pages, v_pages)):
            t.record_stream(current)
    return k_pages, v_pages


def import_block(cache, block: KVPageBlock, page_ids, *, share_hash=None, codec=None):
    """Scatter ``block``'s pages into pool pages ``page_ids`` of ``cache``,
    in place, and return the cache. Validates first (the structure, the
    checksum unless this process stamped or checked it, the geometry, the
    share-map and compress layouts against the pool's ``share_hash`` /
    ``codec``) and raises on any problem, so the caller releases the pages
    and re-prefills. A compressed block is rebuilt here unless a prefetch
    staged its rebuild. Fault sites ``cache.import`` / ``cache.compress``."""
    if is_sharded_kv(cache):
        raise NotImplementedError(DEFER_KV)
    inject("cache.import", n_pages=len(page_ids), n_tokens=block.n_tokens)
    block.verify(recheck=False)
    if block.share_hash != share_hash:
        raise BlockIntegrityError(
            f"KV share-map layout mismatch: block was exported under "
            f"share_hash={block.share_hash!r} but this pool runs "
            f"{share_hash!r} — re-prefill, or serve both hosts with the "
            f"same --kv-share-map artifact")
    if block.compress_kind is not None:
        want = codec.compress_hash if codec is not None else None
        if block.compress_hash != want:
            raise BlockIntegrityError(
                f"KV compress layout mismatch: block carries a "
                f"{block.compress_kind!r} payload under compress_hash="
                f"{block.compress_hash!r} but this pool's codec is "
                f"{want!r} — re-prefill, or serve both hosts with the "
                f"same model/--kv-compress-map geometry")
    if len(page_ids) != block.n_pages:
        raise BlockIntegrityError(
            f"import wants {len(page_ids)} pages for a {block.n_pages}-page block")
    event = None
    if block.compress_kind is not None and not block.is_prefetched:
        try:
            k_pages, v_pages = codec.reconstruct_block(block)
        except Exception as e:  # noqa: BLE001 — fault or codec failure, same fallback
            codec.note_fault("decode")
            raise BlockIntegrityError(f"compressed block reconstruction failed: {e}") from e
        reason = pages_compatible(k_pages, v_pages, cache,
                                  check_dtype=block.compress_kind == "latent")
    elif block.compress_kind is not None:
        k_pages, v_pages, event = block.payload()
        reason = pages_compatible(k_pages, v_pages, cache, check_dtype=False)
    else:
        reason = block.compatible_with(cache)
        k_pages, v_pages, event = block.payload()
    if reason is not None:
        raise BlockIntegrityError(reason)
    ids = upload(np.asarray(list(page_ids), np.int64), pool_device(stage_caches(cache)[0]))
    tr = tracing.current()
    if tr is not None:
        with tr.timed("kv_import", pages=len(page_ids), tokens=block.n_tokens):
            return import_pool_pages(cache, *_onto(cache, k_pages, v_pages, event), ids)
    return import_pool_pages(cache, *_onto(cache, k_pages, v_pages, event), ids)


class KVSpillTier:
    """Host-memory LRU spill tier for KV blocks (JAX's, unchanged in
    behaviour).

    ``put`` is cheap on the caller's (the scheduler's) thread: it links the
    block into the LRU map and queues it for the flusher thread, which runs
    the device-to-host copy off the tick's path. Eviction is strict LRU; a
    block larger than the whole budget is rejected (the caller re-prefills).
    Keys are the owning requests (identity) or, for the prefix store, the
    prefix digests."""

    def __init__(self, budget_bytes: int, flush_async: bool = True):
        if not isinstance(budget_bytes, int) or isinstance(budget_bytes, bool) \
                or budget_bytes <= 0:
            raise ValueError("spill budget must be a positive byte count")
        self.budget_bytes = budget_bytes
        self._blocks: "OrderedDict[object, KVPageBlock]" = OrderedDict()
        # bytes each block is charged; a flush that compresses shrinks a
        # block, so the charge is re-made after it (_reaccount)
        self._sizes: dict = {}
        self._bytes = 0
        self.bytes_compress_saved = 0
        self._lock = make_lock("KVSpillTier._lock")
        self.evictions = 0
        self.rejects = 0
        self.rejects_oversize = 0
        self.rejects_closed = 0
        self.hits = 0
        self.misses = 0
        self.bytes_spilled_total = 0
        self._flush_async = flush_async
        self._flush_q: "queue.Queue" = queue.Queue()
        self._flusher: Optional[threading.Thread] = None
        self._stopped = False

    # ------------------------------------------------------------- flusher
    def _ensure_flusher(self):
        # the caller holds self._lock
        if self._flusher is None or not self._flusher.is_alive():
            self._flusher = threading.Thread(target=self._flush_loop, name="kv-spill-flusher",
                                             daemon=True)
            self._flusher.start()

    def _flush_loop(self):
        while True:
            item = self._flush_q.get()
            if item is None:
                return
            key, blk = item
            try:
                blk.to_host()
            except Exception:
                # a failed flush leaves the block on the device: take() still
                # works, and verify() has no checksum to mismatch
                logger.exception("KV spill flush failed; block stays on device")
            else:
                self._reaccount(key, blk)

    def _reaccount(self, key, blk: KVPageBlock) -> None:
        nb = blk.nbytes
        with self._lock:
            if self._blocks.get(key) is not blk:
                return  # dropped or replaced while flushing
            old = self._sizes.get(key, nb)
            if nb != old:
                self._sizes[key] = nb
                self._bytes += nb - old
                if nb < old:
                    self.bytes_compress_saved += old - nb

    # ------------------------------------------------------------- LRU map
    def put(self, key, block: KVPageBlock) -> bool:
        """Admit ``block`` under the budget, evicting LRU entries as needed.
        False (a counted reject) when the block alone exceeds the budget or
        the tier is closed."""
        nb = block.nbytes
        with self._lock:
            if self._stopped:
                self.rejects += 1
                self.rejects_closed += 1
                return False
            if nb > self.budget_bytes:
                self.rejects += 1
                self.rejects_oversize += 1
                return False
            old = self._blocks.pop(key, None)
            if old is not None:
                self._bytes -= self._sizes.pop(key, old.nbytes)
            while self._bytes + nb > self.budget_bytes and self._blocks:
                ek, evicted = self._blocks.popitem(last=False)
                self._bytes -= self._sizes.pop(ek, evicted.nbytes)
                self.evictions += 1
            self._blocks[key] = block
            self._sizes[key] = nb
            self._bytes += nb
            self.bytes_spilled_total += nb
            if self._flush_async:
                self._ensure_flusher()
        if self._flush_async:
            self._flush_q.put((key, block))
        else:
            block.to_host()
            self._reaccount(key, block)
        return True

    def _pop(self, key) -> Optional[KVPageBlock]:
        with self._lock:
            blk = self._blocks.pop(key, None)
            if blk is not None:
                self._bytes -= self._sizes.pop(key, blk.nbytes)
            return blk

    def take(self, key) -> Optional[KVPageBlock]:
        """Remove and return ``key``'s block for a resume, or None if LRU
        pressure evicted it; counts the hit or miss."""
        blk = self._pop(key)
        with self._lock:
            if blk is not None:
                self.hits += 1
            else:
                self.misses += 1
        return blk

    def peek(self, key) -> Optional[KVPageBlock]:
        with self._lock:
            return self._blocks.get(key)

    def touch(self, key) -> None:
        """LRU refresh without removal (a block about to be re-imported)."""
        with self._lock:
            if key in self._blocks:
                self._blocks.move_to_end(key)

    def contains(self, key) -> bool:
        with self._lock:
            return key in self._blocks

    def keys(self) -> list:
        """Resident keys, most recently used first."""
        with self._lock:
            return list(reversed(self._blocks.keys()))

    def share_hashes(self) -> set:
        with self._lock:
            return {b.share_hash for b in self._blocks.values()}

    def compress_hashes(self) -> set:
        """Distinct ``compress_hash`` values of the resident blocks (None for
        a raw one, which imports anywhere its geometry fits)."""
        with self._lock:
            return {b.compress_hash for b in self._blocks.values()}

    def drop(self, key) -> None:
        self._pop(key)

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._sizes.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "budget_bytes": self.budget_bytes,
                "bytes_in_use": self._bytes,
                "blocks": len(self._blocks),
                # flushed blocks: the population a prefetch can stage
                "blocks_host": sum(1 for b in self._blocks.values() if b.is_host),
                "evictions": self.evictions,
                "rejects": self.rejects,
                "rejects_oversize": self.rejects_oversize,
                "rejects_closed": self.rejects_closed,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "bytes_spilled_total": self.bytes_spilled_total,
                "bytes_compress_saved": self.bytes_compress_saved,
            }

    def close(self) -> None:
        with self._lock:
            self._stopped = True
            flusher = self._flusher
        self._flush_q.put(None)
        if flusher is not None and flusher.is_alive():
            flusher.join(timeout=5)
        self.clear()
