"""Pod-scale fleet: one front door over N host-local fleets (copied from
``mlx_sharding_tpu/pod.py``, framework-free there but for its collective
transport and its self-test, which are ported onto ``torch.distributed``).

Everything below this module is per-host: the ``WeightStore`` keeps ONE
resident tree per process, ``DisaggCoordinator`` hands KV blocks between
pools on one machine, ``FleetAutoscaler`` scales one host's replicas. This
module stitches N of those hosts into a pod with three coordinated pieces:

- **Pod weight registry** (:class:`PodWeightRegistry`) — every host gossips
  which resident trees it holds (``weights.key_digest`` + refs + bytes), so
  the pod view shows one copy per host, aliased by all local replicas, and
  a checkpoint retirement broadcast (``weights.teardown``) reaches every
  host's store.
- **Cross-host disagg handoff** (:class:`PodHandoff`) — the prefill host
  exports the ``KVPageBlock``, serializes it (``KVPageBlock.to_bytes``,
  checksummed), ships it through the ``pod.handoff`` fault site to the
  least-loaded remote decode host, and relays the remote pool's tokens
  back to the origin's client. The receiver stages the block on its card
  (``ContinuousBatcher.stage_resume``, a side-stream copy) before serving
  it. Every failure degrades exactly like the single-host contract:
  serve-in-place or blockless re-prefill, counted by kind, never a dropped
  stream.
- **Pod autoscaler** (:class:`PodAutoscaler`) — aggregates per-host
  ``FleetAutoscaler`` pressure (slot-weighted, ``fleet.aggregate_pressure``)
  and nudges spawn/drain on the right host; a host whose heartbeat goes
  stale past the timeout is declared dead, its relayed sessions resume on
  the survivors via the token-exact migration path, and it leaves routing.
- **Prefix federation** (:class:`PodPrefixFederation`) — a local prefix
  miss pulls the owner host's block into the local host tier.

Transports: :class:`LoopbackTransport` is the in-process fabric (N
simulated hosts in one process, as JAX's quick-tier tests drive it);
:class:`CollectiveTransport` is the real one, one process a host, over
``parallel.multihost.PodControlPlane`` (an all_gather of the pod's own
gloo group), behind the server's ``--pod``. Both speak the same 4-call
surface (publish / peers / send / handler). ``python -m
mlx_sharding_tpu_torch.pod --coordinator H:P --num-processes 2
--process-id R`` runs the two-process self-test (:func:`_selftest_main`).
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
import time
import uuid
from collections import deque
from typing import Callable, Optional

import numpy as np

from mlx_sharding_tpu_torch.fleet import aggregate_pressure
from mlx_sharding_tpu_torch.kv_transfer import BlockIntegrityError, KVPageBlock
from mlx_sharding_tpu_torch.resilience import ResumeState
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.clock import MONOTONIC, Clock
from mlx_sharding_tpu_torch.utils.locks import make_lock
from mlx_sharding_tpu_torch.weights import weight_store

logger = logging.getLogger(__name__)

# a peer whose heartbeat is older than this is dead: its sessions resume
# on the survivors and it leaves routing (override per-instance or via env)
HEARTBEAT_TIMEOUT_S = 10.0

# how long the origin waits for the next relayed token before declaring
# the remote leg dead and resuming locally (must exceed a worst-case
# remote decode tick + one transport tick)
RELAY_TIMEOUT_S = 30.0


class PodTransportError(RuntimeError):
    """A pod message could not be delivered (dead peer, closed fabric)."""


class PodHandoffFallback(Exception):
    """The cross-host leg failed; the origin continues on its local plan.

    ``kind`` is the counted fallback; ``tokens_relayed`` is how many tokens
    the remote pool already delivered to the client (the local resume must
    start AFTER them); ``keep_block`` means the origin's host copy of the
    block is still trustworthy (the failure happened before/instead of the
    remote import), so the local leg may import it instead of re-prefilling."""

    def __init__(self, kind: str, *, tokens_relayed: int = 0,
                 keep_block: bool = False):
        self.kind = kind
        self.tokens_relayed = tokens_relayed
        self.keep_block = keep_block
        super().__init__(f"pod handoff fallback: {kind}")


# --------------------------------------------------------------------------
# transports


class LoopbackHub:
    """In-process pod fabric: N simulated hosts in one interpreter.

    Delivery is synchronous push — ``send`` invokes the destination's
    handler on the calling thread (handlers that need concurrency spawn
    their own worker, exactly like the collective transport's tick thread
    would). ``kill(host)`` models SIGKILL: the host stops publishing and
    every message to or from it raises, so peers discover the death the
    same way they would for real — a stale heartbeat."""

    def __init__(self, clock: Clock = MONOTONIC):
        self.clock = clock
        self._lock = make_lock("LoopbackHub._lock")
        self._info: dict = {}      # host -> (info dict, published stamp)
        self._handlers: dict = {}  # host -> callable(src, kind, payload)
        self._dead: set = set()

    def register(self, host_id: int) -> "LoopbackTransport":
        with self._lock:
            self._info[host_id] = ({}, self.clock())
        return LoopbackTransport(self, host_id)

    def kill(self, host_id: int) -> None:
        """Simulated host death: heartbeats freeze, messages bounce."""
        with self._lock:
            self._dead.add(host_id)
            self._handlers.pop(host_id, None)

    def _publish(self, host_id: int, info: dict) -> None:
        with self._lock:
            if host_id in self._dead:
                return
            self._info[host_id] = (dict(info), self.clock())

    def _peers(self, host_id: int) -> dict:
        now = self.clock()
        with self._lock:
            return {
                h: {"info": dict(info), "age_s": now - stamp}
                for h, (info, stamp) in self._info.items()
                if h != host_id
            }

    def _send(self, src: int, dest: int, kind: str, payload: bytes) -> None:
        with self._lock:
            if src in self._dead or dest in self._dead:
                raise PodTransportError(f"host {dest} is unreachable")
            handler = self._handlers.get(dest)
        if handler is None:
            raise PodTransportError(f"host {dest} has no handler attached")
        handler(src, kind, payload)


class LoopbackTransport:
    """One simulated host's endpoint on a :class:`LoopbackHub`."""

    def __init__(self, hub: LoopbackHub, host_id: int):
        self.hub = hub
        self.host_id = host_id
        self._closed = False

    def set_handler(self, cb: Callable[[int, str, bytes], None]) -> None:
        with self.hub._lock:
            self.hub._handlers[self.host_id] = cb

    def publish(self, info: dict) -> None:
        if self._closed:
            raise PodTransportError("transport closed")
        self.hub._publish(self.host_id, info)

    def peers(self) -> dict:
        return self.hub._peers(self.host_id)

    def send(self, dest: int, kind: str, payload: bytes) -> None:
        if self._closed:
            raise PodTransportError("transport closed")
        self.hub._send(self.host_id, dest, kind, payload)

    def close(self) -> None:
        self._closed = True
        with self.hub._lock:
            self.hub._handlers.pop(self.host_id, None)


class CollectiveTransport:
    """The real pod fabric: every host contributes one fixed-shape buffer
    per tick through ``PodControlPlane.pod_exchange`` (a symmetric
    allgather) and receives everyone's. Heartbeats are the ticks; queued
    messages are framed into the tick blob, fragmented when larger than one
    blob, so a block of many megabytes ships across consecutive ticks while
    both hosts' decode loops keep running.

    A peer that stops arriving turns the collective into a timeout
    (``WorkerTimeoutError`` from the plane); the transport then reports
    every peer dead, and the local fleet degrades to single-host serving
    rather than wedging a request thread in a collective."""

    # blob framing: [4B n_msgs] then per message
    # [4B dest][4B kind_len][4B payload_len][kind][payload]; dest -1 = all
    _HDR = 12

    def __init__(self, *, interval_s: float = 0.05, plane=None,
                 clock: Clock = MONOTONIC):
        from mlx_sharding_tpu_torch.parallel.multihost import (
            PodControlPlane,
            process_count,
            process_index,
        )

        self.plane = plane if plane is not None else PodControlPlane()
        self.host_id = process_index()
        self.n_hosts = process_count()
        self.interval_s = interval_s
        self.clock = clock
        self._lock = make_lock("CollectiveTransport._lock")
        self._outbox: deque = deque()   # framed (dest, kind, payload) bytes
        self._info: dict = {}
        self._peers: dict = {}          # host -> (info, stamp)
        self._handler: Optional[Callable] = None
        self._frags: dict = {}          # (src, msgid) -> {idx: part, ...}
        self._seq = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- surface
    def set_handler(self, cb: Callable[[int, str, bytes], None]) -> None:
        self._handler = cb

    def publish(self, info: dict) -> None:
        with self._lock:
            self._info = dict(info)

    def peers(self) -> dict:
        now = self.clock()
        with self._lock:
            if self.plane.dead:
                # a dead plane means no peer is provably alive: report every
                # known peer at infinite age so death detection fires
                return {
                    h: {"info": dict(info), "age_s": float("inf")}
                    for h, (info, stamp) in self._peers.items()
                }
            return {
                h: {"info": dict(info), "age_s": now - stamp}
                for h, (info, stamp) in self._peers.items()
            }

    def send(self, dest: int, kind: str, payload: bytes) -> None:
        if self._closed or self.plane.dead:
            raise PodTransportError("pod fabric is down")
        kb = kind.encode()
        # fragment anything that cannot ride one tick blob (leave header
        # room); reassembly is keyed by a random message id
        cap = self.plane.blob_bytes - 4 - self._HDR - len(kb) - 64
        if len(payload) <= cap:
            msgs = [(dest, kind, payload)]
        else:
            msgid = uuid.uuid4().bytes  # 16B
            msgs = []
            parts = [payload[i:i + cap] for i in range(0, len(payload), cap)]
            for i, part in enumerate(parts):
                head = msgid + np.asarray(
                    [i, len(parts), len(kb)], np.int32
                ).tobytes() + kb
                msgs.append((dest, "_frag", head + part))
        with self._lock:
            self._outbox.extend(msgs)

    # ---------------------------------------------------------------- loop
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mst-pod-transport", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        from mlx_sharding_tpu_torch.parallel.multihost import WorkerTimeoutError

        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except WorkerTimeoutError:
                logger.error(
                    "pod collective timed out — peers presumed dead; "
                    "degrading to single-host serving"
                )
                return
            except Exception:  # noqa: BLE001 — the fabric must not die quietly
                logger.exception("pod transport tick failed")
                return

    def tick(self) -> None:
        """One pod exchange: frame as much of the outbox as fits, allgather,
        deliver every received message to the handler."""
        blob, n_msgs = self._drain_outbox()
        with self._lock:
            self._seq += 1
            seq = self._seq
        hdr = np.asarray(
            [seq, self.host_id, n_msgs, len(blob), 0, 0, 0, 0], np.int32
        )
        headers, blobs = self.plane.pod_exchange(
            hdr, np.frombuffer(blob, np.uint8)
        )
        now = self.clock()
        for h in range(headers.shape[0]):
            src = int(headers[h][1])
            if src == self.host_id:
                continue
            used = int(headers[h][3])
            with self._lock:
                info, _ = self._peers.get(src, ({}, now))
                self._peers[src] = (info, now)
            self._deliver(src, bytes(blobs[h][:used].tobytes()))

    def _drain_outbox(self) -> tuple:
        # heartbeat info rides every tick as message 0
        with self._lock:
            msgs = [(-1, "hb", pickle.dumps(self._info))]
            used = 4 + self._HDR + 2 + len(msgs[0][2])
            budget = self.plane.blob_bytes
            while self._outbox:
                dest, kind, payload = self._outbox[0]
                need = self._HDR + len(kind.encode()) + len(payload)
                if used + need > budget:
                    if len(msgs) == 1 and 4 + need <= budget:
                        # a whole fragment leaves no room for the heartbeat
                        # (JAX's sizing reserves 64 bytes for it, and a
                        # gossiped info outgrows that): it rides this tick
                        # alone, or a block over one blob would never ship
                        msgs = [self._outbox.popleft()]
                    break
                used += need
                msgs.append(self._outbox.popleft())
        out = [np.asarray([len(msgs)], np.int32).tobytes()]
        for dest, kind, payload in msgs:
            kb = kind.encode()
            out.append(np.asarray(
                [dest, len(kb), len(payload)], np.int32
            ).tobytes())
            out.append(kb)
            out.append(payload)
        return b"".join(out), len(msgs)

    def _deliver(self, src: int, blob: bytes) -> None:
        if len(blob) < 4:
            return
        n = int(np.frombuffer(blob[:4], np.int32)[0])
        off = 4
        for _ in range(n):
            if off + self._HDR > len(blob):
                return
            dest, klen, plen = np.frombuffer(
                blob[off:off + self._HDR], np.int32
            )
            off += self._HDR
            kind = blob[off:off + klen].decode()
            off += int(klen)
            payload = blob[off:off + plen]
            off += int(plen)
            if dest not in (-1, self.host_id):
                continue
            if kind == "hb":
                try:
                    info = pickle.loads(payload)
                except Exception:  # noqa: BLE001 — a bad heartbeat is stale,
                    continue       # not fatal
                with self._lock:
                    self._peers[src] = (info, self.clock())
                continue
            if kind == "_frag":
                done = self._reassemble(src, payload)
                if done is None:
                    continue
                kind, payload = done
            if self._handler is not None:
                try:
                    self._handler(src, kind, payload)
                except Exception:  # noqa: BLE001 — one bad message must not
                    logger.exception("pod message handler failed")  # kill ticks

    def _reassemble(self, src: int, payload: bytes) -> Optional[tuple]:
        msgid = payload[:16]
        idx, total, klen = np.frombuffer(payload[16:28], np.int32)
        kind = payload[28:28 + klen].decode()
        part = payload[28 + int(klen):]
        with self._lock:
            parts = self._frags.setdefault((src, msgid), {})
            parts[int(idx)] = part
            if len(parts) < int(total):
                return None
            del self._frags[(src, msgid)]
        return kind, b"".join(parts[i] for i in range(int(total)))

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


# --------------------------------------------------------------------------
# weight registry


class PodWeightRegistry:
    """The multihost face of the per-host ``WeightStore``: gossips this
    host's resident trees every heartbeat and aggregates everyone's into
    the pod view behind ``mst_weight_store_*{host=}``. Build-once stays a
    HOST property (the store's lock arbitrates concurrent local spawns to
    one placement); what the pod adds is proof — the view shows exactly
    one tree per host per checkpoint, N_hosts×W — and coordinated
    teardown: ``request_teardown`` broadcasts a digest and every host's
    handler maps it back onto its local key."""

    def __init__(self, store=None):
        self.store = store if store is not None else weight_store()
        self._lock = make_lock("PodWeightRegistry._lock")
        self.teardowns_sent = 0
        self.teardowns_received = 0
        self._on_teardown: Optional[Callable] = None

    def local_info(self) -> dict:
        """This host's heartbeat entry (digest-keyed, wire-sized)."""
        st = self.store.stats()
        return {
            "trees": st["trees"],
            "refs": st["refs"],
            "bytes": st["bytes"],
            "digests": {
                e["digest"]: {"refs": e["refs"], "bytes": e["bytes"]}
                for e in st["entries"]
            },
        }

    def pod_view(self, peers: dict) -> dict:
        """Per-host weight occupancy from the latest gossip, local host
        included — the ``mst_weight_store_*{host=}`` source."""
        view = {}
        for host, entry in peers.items():
            w = entry.get("info", {}).get("weights")
            if w:
                view[host] = {
                    "trees": w.get("trees", 0),
                    "refs": w.get("refs", 0),
                    "bytes": w.get("bytes", 0),
                }
        return view

    def set_teardown_handler(self, cb: Callable) -> None:
        """``cb(key)`` runs when a teardown broadcast names a tree this
        host holds (the provider wires a drain of the replicas leasing it)."""
        self._on_teardown = cb

    def request_teardown(self, transport, digest: str) -> None:
        """Broadcast a checkpoint retirement to every live peer."""
        with self._lock:
            self.teardowns_sent += 1
        for host in list(transport.peers()):
            try:
                transport.send(host, "weights.teardown", digest.encode())
            except PodTransportError:
                pass  # a dead host has nothing left to tear down

    def handle_teardown(self, digest: str) -> Optional[object]:
        """Map a gossiped digest onto this host's store; returns the local
        WeightKey when found (after running the registered handler)."""
        with self._lock:
            self.teardowns_received += 1
        key = self.store.find(digest)
        if key is not None and self._on_teardown is not None:
            try:
                self._on_teardown(key)
            except Exception:  # noqa: BLE001 — teardown is advisory
                logger.exception("weight teardown handler failed")
        return key


# --------------------------------------------------------------------------
# cross-host handoff


class PodHandoff:
    """Ships a prefill host's ``ResumeState`` to a remote decode host and
    relays the remote stream back — the cross-host third phase of the
    disagg pipeline (``DisaggCoordinator.attach_pod``).

    Origin side: :meth:`pick_remote` prices the gossiped decode pools and
    returns a live host with free decode slots whose pressure beats the
    local pool's (None → serve locally, which is NOT a fallback);
    :meth:`serve_remote` runs the ``pod.handoff`` fault site, serializes
    the checksummed block, ships it, and yields relayed tokens. Receiver
    side: :meth:`attach_local` binds the local decode target; an incoming
    block is rebuilt (``KVPageBlock.from_bytes`` re-verifies the checksum),
    staged dispatch-only via ``stage_resume`` so its DMA overlaps the
    decode ticks in flight, and served through the ordinary
    ``generate_step(_resume=...)`` path — corrupt blocks fall into the
    scheduler's own re-prefill fallback, still token-exact.

    Fallback kinds (each counted, each landing on the origin's local plan,
    never a dropped stream): ``handoff_fault`` (injected control failure —
    serve in place, block intact), ``remote_unavailable`` (the chosen host
    died between pick and ship), ``serialize_error`` (block unserializable —
    local import still possible), ``transfer_fault`` (send failed mid-ship),
    ``remote_error`` (the remote pool failed before finishing),
    ``relay_timeout`` (the remote host went silent mid-stream — the
    host-death drain: the origin resumes after the last relayed token)."""

    def __init__(self, host_id: int, transport, *,
                 local_pressure: Optional[Callable[[], float]] = None,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 relay_timeout_s: float = RELAY_TIMEOUT_S,
                 clock: Clock = MONOTONIC):
        self.host_id = host_id
        self.transport = transport
        self.local_pressure = local_pressure
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.relay_timeout_s = relay_timeout_s
        self.clock = clock
        self._lock = make_lock("PodHandoff._lock")
        self.shipped = 0
        self.bytes_shipped = 0
        self.received = 0
        self.relayed_tokens = 0
        self.fallbacks: dict = {}
        self._ms: deque = deque(maxlen=512)
        self._waiters: dict = {}     # rid -> queue.Queue of relay events
        self._target = None          # local decode target (receiver side)
        self._serve_kw_allow = None

    # ---------------------------------------------------------- accounting
    def _count(self, kind: str) -> None:
        with self._lock:
            self.fallbacks[kind] = self.fallbacks.get(kind, 0) + 1

    def stats(self) -> dict:
        with self._lock:
            ms = sorted(self._ms)
            n = len(ms)
            return {
                "shipped": self.shipped,
                "bytes_shipped": self.bytes_shipped,
                "received": self.received,
                "relayed_tokens": self.relayed_tokens,
                "fallbacks": dict(self.fallbacks),
                "ms_p50": ms[n // 2] if n else None,
                "ms_p99": ms[min(n - 1, int(round(0.99 * n)))] if n else None,
            }

    # ------------------------------------------------------------- routing
    def pick_remote(self) -> Optional[int]:
        """The least-pressured LIVE peer advertising free decode slots —
        and only when it genuinely beats the local pool (a tie ships
        nothing: the wire is never free). None means serve locally."""
        best, best_p = None, None
        try:
            peers = self.transport.peers()
        except Exception:  # noqa: BLE001 — no fabric, no remote
            return None
        for host, entry in peers.items():
            if entry.get("age_s", float("inf")) > self.heartbeat_timeout_s:
                continue
            decode = entry.get("info", {}).get("decode") or {}
            if int(decode.get("free", 0) or 0) <= 0:
                continue
            p = float(decode.get("pressure", 0.0) or 0.0)
            if best_p is None or p < best_p:
                best, best_p = host, p
        if best is None:
            return None
        if self.local_pressure is not None:
            try:
                if best_p >= self.local_pressure():
                    return None
            except Exception:  # noqa: BLE001 — price conservatively: local
                return None
        return best

    # ------------------------------------------------------------- origin
    def serve_remote(self, state: ResumeState, fwd_kw: dict):
        """Generator: ship ``state`` to the picked remote decode host and
        yield the relayed tokens. Raises :class:`PodHandoffFallback` on any
        failure; by the fault-site contract the injected ``pod.handoff``
        fires BEFORE any wire work, so that path leaves the block intact
        for the local serve-in-place."""
        nbytes = int(getattr(state.block, "nbytes", 0) or 0)
        try:
            inject("pod.handoff", n_bytes=nbytes)
        except Exception:
            self._count("handoff_fault")
            raise PodHandoffFallback("handoff_fault", keep_block=True) \
                from None
        dest = self.pick_remote()
        if dest is None:
            self._count("remote_unavailable")
            raise PodHandoffFallback("remote_unavailable", keep_block=True)
        data = b""
        if state.block is not None:
            try:
                data = state.block.to_bytes()
            except Exception:  # noqa: BLE001 — ship blockless? no: the local
                # import is strictly better than a remote re-prefill
                self._count("serialize_error")
                raise PodHandoffFallback("serialize_error", keep_block=True) \
                    from None
        rid = uuid.uuid4().hex
        wire = pickle.dumps({
            "rid": rid,
            "block": data,
            "prompt": np.asarray(state.prompt, np.int32),
            "history": [int(t) for t in (state.history or [])],
            "produced": int(state.produced),
            "resume_keys": None if state.block is not None
            else getattr(state, "resume_keys", None),
            "resume_recent": None if state.block is not None
            else getattr(state, "resume_recent", None),
            "kw": {k: v for k, v in fwd_kw.items()
                   if k in ("max_tokens", "temperature", "top_p", "seed",
                            "repetition_penalty", "repetition_context_size",
                            "logit_bias", "stall_timeout")},
        }, protocol=pickle.HIGHEST_PROTOCOL)
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._waiters[rid] = q
        t0 = self.clock()
        relayed = 0
        try:
            try:
                self.transport.send(dest, "pod.block", wire)
            except Exception:  # noqa: BLE001 — the wire failed, block intact
                self._count("transfer_fault")
                raise PodHandoffFallback("transfer_fault", keep_block=True) \
                    from None
            with self._lock:
                self.shipped += 1
                self.bytes_shipped += len(wire)
            while True:
                try:
                    ev, item = q.get(timeout=self.relay_timeout_s)
                except queue.Empty:
                    # the remote host went silent mid-stream: host death.
                    # The origin owns the client stream, so it resumes
                    # locally AFTER the last relayed token — the token-exact
                    # drain of a dead host's session onto a survivor.
                    self._count("relay_timeout")
                    raise PodHandoffFallback(
                        "relay_timeout", tokens_relayed=relayed
                    ) from None
                if ev == "tok":
                    relayed += 1
                    with self._lock:
                        if relayed == 1:
                            self._ms.append((self.clock() - t0) * 1000.0)
                        self.relayed_tokens += 1
                    yield item
                elif ev == "end":
                    return
                else:  # "err": the remote pool failed before finishing
                    self._count("remote_error")
                    raise PodHandoffFallback(
                        "remote_error", tokens_relayed=relayed,
                        keep_block=relayed == 0,
                    )
        finally:
            # rid is a fresh uuid owned by this call: nothing else inserts
            # or pops it between the two lock scopes
            with self._lock:
                self._waiters.pop(rid, None)

    # ----------------------------------------------------------- receiver
    def attach_local(self, target) -> None:
        """Bind the local decode target (anything with ``generate_step``
        supporting ``_resume``; ``stage_resume`` is used when present)."""
        self._target = target

    def handle(self, src: int, kind: str, payload: bytes) -> bool:
        """Transport-handler hook. Returns True when the message was a
        handoff-protocol message (consumed)."""
        if kind == "pod.block":
            threading.Thread(
                target=self._serve_shipped, args=(src, payload),
                name="mst-pod-serve", daemon=True,
            ).start()
            return True
        if kind in ("pod.tok", "pod.end", "pod.err"):
            try:
                rid, item = pickle.loads(payload)
            except Exception:  # noqa: BLE001 — undecodable relay event
                return True
            with self._lock:
                q = self._waiters.get(rid)
            if q is not None:
                q.put((kind.split(".")[1], item))
            return True
        return False

    def _serve_shipped(self, src: int, payload: bytes) -> None:
        """Receiver worker: rebuild the state, stage the block, serve on
        the local decode target, relay every token back to the origin."""
        rid = None
        try:
            msg = pickle.loads(payload)
            rid = msg["rid"]
            block = None
            if msg["block"]:
                try:
                    block = KVPageBlock.from_bytes(msg["block"])
                except BlockIntegrityError:
                    # corrupt in flight: the blockless fold re-prefills —
                    # same degradation as a failed local import
                    block = None
            state = ResumeState(
                prompt=msg["prompt"], history=list(msg["history"]),
                produced=int(msg["produced"]), block=block,
                resume_keys=msg.get("resume_keys"),
                resume_recent=msg.get("resume_recent"),
            )
            with self._lock:
                self.received += 1
            target = self._target
            if target is None:
                raise RuntimeError("no local decode target attached")
            stage = getattr(target, "stage_resume", None)
            if stage is not None and block is not None:
                # dispatch-only host→device stage, overlapped with the
                # decode ticks already in flight on this host
                stage(state)
            for item in target.generate_step(
                state.prompt, _resume=state, **msg.get("kw", {})
            ):
                self.transport.send(src, "pod.tok", pickle.dumps((rid, item)))
            self.transport.send(src, "pod.end", pickle.dumps((rid, None)))
        except Exception as e:  # noqa: BLE001 — report, origin falls back
            logger.exception("pod remote serve failed")
            if rid is not None:
                try:
                    self.transport.send(
                        src, "pod.err", pickle.dumps((rid, repr(e)[:200]))
                    )
                except Exception:  # noqa: BLE001 — origin's relay timeout
                    pass           # covers a dead return path


# --------------------------------------------------------------------------
# pod-federated prefix store

# how long a federated fetch waits for the owner's blob before degrading
# to plain prefill (a host-tier export + one transport round trip)
PREFIX_FETCH_TIMEOUT_S = 5.0

# how long a digest that missed pod-wide stays negative-cached, so a cold
# prefix doesn't re-probe the fabric on every admission
PREFIX_NEG_CACHE_S = 30.0


class PodPrefixFederation:
    """Federates the :class:`~mlx_sharding_tpu_torch.prefix_store.PrefixStore`
    host tier across the pod, the same way weight digests federate: each
    host's heartbeat carries its prefix-digest inventory
    (``PrefixStore.host_inventory``), so a local prefix miss can consult
    the pod view and — on a remote hit — pull the owner's exported
    ``KVPageBlock`` (checksummed ``to_bytes`` wire format) into the LOCAL
    host tier, where the scheduler's ordinary staged-prefetch/demand-
    import path picks it up. Pod-wide, a hot prefix is prefilled ONCE.

    :meth:`fetch` runs strictly OFF the decode tick (the scheduler calls
    it from admission's store-consult slow path, never from ``_tick``),
    fires the ``pod.prefix_fetch`` fault
    site requester-side before touching the wire, and degrades to plain
    prefill on EVERY failure, each counted by kind and none able to drop
    or corrupt a stream:

    - ``fetch_fault`` — injected control failure at the fault site;
    - ``miss`` — no live peer advertises the digest (negative-cached);
    - ``stale_inventory`` — only stale heartbeats advertise it, or the
      owner's tier evicted the block between gossip and fetch;
    - ``owner_dead`` — the send to the advertised owner failed;
    - ``timeout`` — the owner went silent past ``fetch_timeout_s``;
    - ``integrity`` — the blob failed its checksum, page geometry, or
      KV share-map layout check (kv_share.py) on arrival;
    - ``host_reject`` — the local tier refused the block (budget).
    """

    def __init__(self, host_id: int, transport, store, *,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 fetch_timeout_s: float = PREFIX_FETCH_TIMEOUT_S,
                 neg_cache_s: float = PREFIX_NEG_CACHE_S,
                 clock: Clock = MONOTONIC):
        self.host_id = host_id
        self.transport = transport
        self.store = store
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.fetch_timeout_s = fetch_timeout_s
        self.neg_cache_s = neg_cache_s
        self.clock = clock
        self._lock = make_lock("PodPrefixFederation._lock")
        self._waiters: dict = {}   # rid -> queue.Queue of (ev, data)
        self._neg: dict = {}       # digest hex -> clock() expiry
        self.hits = 0              # pod-view consults that found an owner
        self.fetches = 0           # blobs imported into the local tier
        self.fetch_bytes = 0
        self.blobs_served = 0      # owner side: blobs exported to peers
        self.bytes_served = 0
        self.fallbacks: dict = {}
        self._ms: deque = deque(maxlen=512)

    # ---------------------------------------------------------- accounting
    def _count(self, kind: str) -> None:
        with self._lock:
            self.fallbacks[kind] = self.fallbacks.get(kind, 0) + 1

    def stats(self) -> dict:
        try:
            inventory = len(self.store.host_inventory())
        except Exception:  # noqa: BLE001 — a sick store reports nothing
            inventory = 0
        with self._lock:
            ms = sorted(self._ms)
            n = len(ms)
            return {
                "inventory_keys": inventory,
                "hits": self.hits,
                "fetches": self.fetches,
                "fetch_bytes": self.fetch_bytes,
                "blobs_served": self.blobs_served,
                "bytes_served": self.bytes_served,
                "fallbacks": dict(self.fallbacks),
                "fetch_ms_p50": ms[n // 2] if n else None,
                "fetch_ms_p99": (
                    ms[min(n - 1, int(round(0.99 * n)))] if n else None
                ),
            }

    # ----------------------------------------------------------- heartbeat
    def local_info(self) -> dict:
        """This host's prefix heartbeat entry: the host-tier digest
        inventory plus the geometry peers need to pre-judge compatibility
        (page size and KV share-map hash both ride the blob check anyway —
        advertising them just saves a doomed fetch)."""
        try:
            return {
                "keys": self.store.host_inventory(),
                "page_size": self.store.page_size,
                "share": self.store.share_hash,
                "compress": self.store.compress_hash,
            }
        except Exception:  # noqa: BLE001 — advertise nothing, not garbage
            return {}

    # ------------------------------------------------------------- routing
    def _owner_for(self, hexd: str):
        """(owner host, None) for the freshest LIVE peer advertising the
        digest; (None, fallback kind) otherwise."""
        try:
            peers = self.transport.peers()
        except Exception:  # noqa: BLE001 — no fabric, no federation
            return None, "miss"
        local = {
            "page_size": self.store.page_size,
            "share": self.store.share_hash,
            "compress": self.store.compress_hash,
        }
        best = None
        stale_only = False
        layout_only = False
        for host, entry in peers.items():
            info = (entry.get("info") or {}).get("prefix") or {}
            if hexd not in (info.get("keys") or ()):
                continue
            if info.get("page_size") != local["page_size"] \
                    or info.get("share") != local["share"] \
                    or info.get("compress") != local["compress"]:
                # incompatible geometry (page size / share map / compress
                # layout): the fetch would fail the blob check — skip
                # before any bytes move
                layout_only = True
                continue
            age = entry.get("age_s", float("inf"))
            if age > self.heartbeat_timeout_s:
                stale_only = True
                continue
            if best is None or age < best[0]:
                best = (age, host)
        if best is not None:
            return best[1], None
        if stale_only:
            return None, "stale_inventory"
        return None, ("layout_mismatch" if layout_only else "miss")

    # ------------------------------------------------------------ requester
    def _neg_cached(self, hexd: str) -> bool:
        """One lock scope: purge an expired entry, report a live one."""
        now = self.clock()
        with self._lock:
            exp = self._neg.get(hexd)
            if exp is None:
                return False
            if now < exp:
                return True
            del self._neg[hexd]
            return False

    def _neg_add(self, hexd: str) -> None:
        with self._lock:
            self._neg[hexd] = self.clock() + self.neg_cache_s

    def fetch(self, digest: bytes) -> bool:
        """Pull the prefix block for ``digest`` from its pod owner into
        the LOCAL host tier. True iff the block is now locally resident
        (the caller re-probes the store and rides the normal import path);
        False means plain prefill, with the reason counted. Blocking —
        call it from admission's store-consult slow path, NEVER from the
        decode tick."""
        hexd = digest.hex()
        if self._neg_cached(hexd):
            self._count("neg_cached")
            return False
        try:
            inject("pod.prefix_fetch", digest=hexd)
        except Exception:  # noqa: BLE001 — injected control failure
            self._count("fetch_fault")
            return False
        owner, why = self._owner_for(hexd)
        if owner is None:
            self._count(why)
            if why in ("miss", "layout_mismatch"):
                # a mismatched layout is as durable as a miss: the peer
                # would need a restart with new maps to become compatible
                self._neg_add(hexd)
            return False
        with self._lock:
            self.hits += 1
        rid = uuid.uuid4().hex
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._waiters[rid] = q
        t0 = self.clock()
        try:
            try:
                self.transport.send(
                    owner, "prefix.fetch",
                    pickle.dumps({"rid": rid, "digest": digest},
                                 protocol=pickle.HIGHEST_PROTOCOL),
                )
            except Exception:  # noqa: BLE001 — the advertised owner died
                self._count("owner_dead")
                return False
            try:
                ev, data = q.get(timeout=self.fetch_timeout_s)
            except queue.Empty:
                self._count("timeout")
                return False
        finally:
            # rid is a fresh uuid owned by this call
            with self._lock:
                self._waiters.pop(rid, None)
        if ev != "blob" or not data:
            # the owner's tier evicted the block after the last heartbeat
            self._count("stale_inventory")
            self._neg_add(hexd)
            return False
        try:
            block = KVPageBlock.from_bytes(data)
        except BlockIntegrityError:
            self._count("integrity")
            return False
        if (self.store.page_size is not None
                and block.page_size != self.store.page_size) \
                or block.share_hash != self.store.share_hash:
            self._count("integrity")
            return False
        if block.compress_hash is not None \
                and block.compress_hash != self.store.compress_hash:
            # the owner lied (or re-calibrated) since its last heartbeat:
            # the latent layout cannot be reconstructed here
            self._count("layout_mismatch")
            return False
        if not self.store.host_put(digest, block):
            self._count("host_reject")
            return False
        with self._lock:
            self.fetches += 1
            self.fetch_bytes += len(data)
            self._ms.append((self.clock() - t0) * 1000.0)
        return True

    # ----------------------------------------------------------- receiver
    def handle(self, src: int, kind: str, payload: bytes) -> bool:
        """Transport-handler hook. Returns True when the message was a
        prefix-federation message (consumed)."""
        if kind == "prefix.fetch":
            # serve off the transport receive thread: to_bytes of a big
            # block must not stall the heartbeat loop (handoff discipline)
            threading.Thread(
                target=self._serve_fetch, args=(src, payload),
                name="mst-pod-prefix", daemon=True,
            ).start()
            return True
        if kind in ("prefix.blob", "prefix.miss"):
            try:
                rid, data = pickle.loads(payload)
            except Exception:  # noqa: BLE001 — undecodable reply
                return True
            with self._lock:
                q = self._waiters.get(rid)
            if q is not None:
                q.put(("blob" if kind == "prefix.blob" else "miss", data))
            return True
        return False

    def _serve_fetch(self, src: int, payload: bytes) -> None:
        rid = None
        blob = b""
        try:
            msg = pickle.loads(payload)
            rid = msg["rid"]
            blk = self.store.host_block(msg["digest"])
            if blk is not None:
                blob = blk.to_bytes()
        except Exception:  # noqa: BLE001 — a serve failure is the
            blob = b""     # requester's stale_inventory fallback
        if rid is None:
            return
        try:
            self.transport.send(
                src,
                "prefix.blob" if blob else "prefix.miss",
                pickle.dumps((rid, blob), protocol=pickle.HIGHEST_PROTOCOL),
            )
        except Exception:  # noqa: BLE001 — requester's fetch timeout
            return         # covers a dead return path
        if blob:
            with self._lock:
                self.blobs_served += 1
                self.bytes_served += len(blob)


# --------------------------------------------------------------------------
# pod autoscaler


class PodAutoscaler:
    """One control loop over the whole pod, run identically on every host.

    Decisions are deterministic functions of the shared gossip view, and
    each host only ever ACTS on itself — the host that the view says
    should spawn, spawns; everyone else concludes it shouldn't. No leader,
    no election, no races: disagreement is bounded by one heartbeat of
    staleness, and the per-host ``FleetAutoscaler`` bounds (min/max, the
    device-slice free list behind its factory) still gate every action.

    Host death: a peer whose heartbeat age passes ``heartbeat_timeout_s``
    is declared dead once, ``on_host_death`` fires (the fleet resumes its
    relayed sessions — see PodHandoff's relay timeout — and routing drops
    it), and the dead host's advertised capacity leaves the free list."""

    def __init__(self, host_id: int, transport, controllers=(), *,
                 scale_up_pressure: float = 0.75,
                 scale_down_pressure: float = 0.25,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 on_host_death: Optional[Callable[[int], None]] = None,
                 clock: Clock = MONOTONIC):
        self.host_id = host_id
        self.transport = transport
        self.controllers = list(controllers)
        self.scale_up_pressure = scale_up_pressure
        self.scale_down_pressure = scale_down_pressure
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.on_host_death = on_host_death
        self.clock = clock
        self._lock = make_lock("PodAutoscaler._lock")
        self.dead_hosts: set = set()
        self.deaths_detected = 0
        self.spawns = 0
        self.drains = 0
        self.ticks = 0

    # ------------------------------------------------------------- signals
    def local_info(self) -> dict:
        """This host's autoscaler heartbeat entry: pressure + headroom."""
        pressure = 0.0
        spawnable = drainable = live = 0
        slots = 0
        for ctrl in self.controllers:
            try:
                pressure = max(pressure, ctrl.pressure())
                h = ctrl.headroom()
                spawnable += h["spawnable"]
                drainable += h["drainable"]
                live += h["live"]
                slots += ctrl.rs.stats()[0]
            except Exception:  # noqa: BLE001 — a sick controller reports
                continue       # nothing, not garbage
        return {
            "pressure": round(pressure, 4),
            "slots": slots,
            "live": live,
            "spawnable": spawnable,
            "drainable": drainable,
        }

    def _live_view(self) -> tuple:
        """(infos by host incl. self, newly dead hosts)."""
        infos = {self.host_id: self.local_info()}
        newly_dead = []
        with self._lock:
            known_dead = set(self.dead_hosts)
        for host, entry in self.transport.peers().items():
            if host in known_dead:
                continue
            if entry.get("age_s", float("inf")) > self.heartbeat_timeout_s:
                newly_dead.append(host)
                continue
            fl = entry.get("info", {}).get("fleet")
            if fl:
                infos[host] = fl
        return infos, newly_dead

    # ------------------------------------------------------------ decision
    def tick(self) -> dict:
        """One pod control decision on the current gossip view."""
        with self._lock:
            self.ticks += 1
        infos, newly_dead = self._live_view()
        for host in newly_dead:
            with self._lock:
                if host in self.dead_hosts:
                    continue
                self.dead_hosts.add(host)
                self.deaths_detected += 1
            logger.warning(
                "pod host %d heartbeat stale — declaring it dead; its "
                "relayed sessions resume on the survivors", host,
            )
            if self.on_host_death is not None:
                try:
                    self.on_host_death(host)
                except Exception:  # noqa: BLE001 — detection must not die
                    logger.exception("host-death handler failed")
        pod_pressure = aggregate_pressure(list(infos.values()))
        action = None
        mine = infos[self.host_id]
        if pod_pressure >= self.scale_up_pressure:
            # the least-loaded host WITH headroom spawns; that might be us
            cands = [
                (info.get("pressure", 0.0), host)
                for host, info in infos.items()
                if int(info.get("spawnable", 0) or 0) > 0
            ]
            if cands and min(cands)[1] == self.host_id:
                action = self._spawn_local()
        elif pod_pressure <= self.scale_down_pressure:
            # the MOST loaded drainable host sheds — it frees the most
            # contended hardware back to the pod free list
            cands = [
                (info.get("pressure", 0.0), host)
                for host, info in infos.items()
                if int(info.get("drainable", 0) or 0) > 0
            ]
            if cands and max(cands)[1] == self.host_id:
                action = self._drain_local()
        with self._lock:
            dead = sorted(self.dead_hosts)
        return {
            "pod_pressure": round(pod_pressure, 4),
            "hosts": len(infos),
            "dead": dead,
            "action": action,
            "local_pressure": mine.get("pressure", 0.0),
        }

    def _spawn_local(self) -> Optional[str]:
        for ctrl in self.controllers:
            try:
                out = ctrl.spawn_one()
            except Exception:  # noqa: BLE001 — controller's own quarantine
                continue
            if out == "spawn":
                with self._lock:
                    self.spawns += 1
                return out
        return None

    def _drain_local(self) -> Optional[str]:
        for ctrl in self.controllers:
            try:
                out = ctrl.drain_one()
            except Exception:  # noqa: BLE001
                continue
            if out == "drain":
                with self._lock:
                    self.drains += 1
                return out
        return None

    def state(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "spawns": self.spawns,
                "drains": self.drains,
                "dead_hosts": sorted(self.dead_hosts),
                "deaths_detected": self.deaths_detected,
                "heartbeat_timeout_s": self.heartbeat_timeout_s,
            }


# --------------------------------------------------------------------------
# the front door


class PodFleet:
    """One host's membership in the pod: local fleet + weight registry +
    cross-host handoff + pod autoscaler, bound to one transport.

    ``generate_step`` delegates to the local generator (a
    ``DisaggCoordinator`` with the pod handoff attached serves the decode
    leg remotely when a remote pool is cheaper); :meth:`tick` publishes the
    heartbeat and runs the pod autoscaler — call it from a loop
    (:meth:`start`) in serving, or directly in tests."""

    def __init__(self, host_id: int, transport, local, *,
                 controllers=(), decode_pool=None, registry=None,
                 prefix_store=None,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 relay_timeout_s: float = RELAY_TIMEOUT_S,
                 interval_s: float = 0.5,
                 clock: Clock = MONOTONIC):
        self.host_id = host_id
        self.transport = transport
        self.local = local
        self.interval_s = interval_s
        self.clock = clock
        self.registry = registry if registry is not None \
            else PodWeightRegistry()
        # the decode target remote prefill hosts ship into: an explicit
        # pool, the local coordinator's decode pool, or the generator itself
        target = decode_pool
        if target is None:
            target = getattr(local, "decode", local)
        self._decode_target = target
        self.handoff = PodHandoff(
            host_id, transport,
            local_pressure=self._local_decode_pressure,
            heartbeat_timeout_s=heartbeat_timeout_s,
            relay_timeout_s=relay_timeout_s, clock=clock,
        )
        self.handoff.attach_local(target)
        if hasattr(local, "attach_pod"):
            local.attach_pod(self.handoff)
        self.autoscaler = PodAutoscaler(
            host_id, transport, controllers,
            heartbeat_timeout_s=heartbeat_timeout_s,
            on_host_death=self._host_died, clock=clock,
        )
        self.prefix: Optional[PodPrefixFederation] = None
        if prefix_store is not None:
            self.attach_prefix_store(prefix_store)
        self.host_deaths = 0
        self._lock = make_lock("PodFleet._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        transport.set_handler(self._on_message)

    def attach_prefix_store(self, store) -> "PodPrefixFederation":
        """Federate ``store``'s host tier over this pod: its digest
        inventory rides the heartbeat, and the federation handle lands on
        ``store.federation`` so the scheduler's store-consult slow path
        reaches :meth:`PodPrefixFederation.fetch` without knowing about
        the pod at all."""
        self.prefix = PodPrefixFederation(
            self.host_id, self.transport, store,
            heartbeat_timeout_s=self.autoscaler.heartbeat_timeout_s,
            clock=self.clock,
        )
        store.federation = self.prefix
        return self.prefix

    # ------------------------------------------------------------- serving
    def generate_step(self, prompt_tokens, **kw):
        return self.local.generate_step(prompt_tokens, **kw)

    def __getattr__(self, name):
        # stat surfaces (stats/fleet_stats/health/...) pass through to the
        # local generator so the server drives a PodFleet unchanged
        return getattr(self.local, name)

    def _local_decode_pressure(self) -> float:
        from mlx_sharding_tpu_torch.fleet import pool_pressure

        slots, active, queued = self._decode_target.stats()
        return pool_pressure(slots, active, queued, 0)

    # ----------------------------------------------------------- heartbeat
    def _local_info(self) -> dict:
        decode = {}
        try:
            load = getattr(self._decode_target, "pool_load", None)
            if load is not None:
                decode = load()
            else:
                slots, active, queued = self._decode_target.stats()
                decode = {"slots": slots, "active": active,
                          "queued": queued, "free": max(0, slots - active)}
            decode["pressure"] = round(self._local_decode_pressure(), 4)
        except Exception:  # noqa: BLE001 — advertise nothing, not garbage
            decode = {}
        spec = None
        try:
            # speculation summary rides the heartbeat so pod placement can
            # see which hosts speculate and how well it pays (draft-engine
            # WEIGHT trees already gossip via the registry block above —
            # they live in the same WeightStore as the base)
            fn = getattr(self.local, "spec_stats", None)
            if fn is not None:
                st = fn()
                if st:
                    spec = {
                        "mode": st.get("mode"),
                        "accept_rate": round(
                            float(st.get("accept_rate", 0.0)), 4
                        ),
                        "rounds": st.get("rounds", 0),
                    }
        except Exception:  # noqa: BLE001 — advertise nothing, not garbage
            spec = None
        info = {
            "host": self.host_id,
            "fleet": self.autoscaler.local_info(),
            "decode": decode,
            "weights": self.registry.local_info(),
        }
        if spec is not None:
            info["spec"] = spec
        if self.prefix is not None:
            # prefix-digest inventory rides the same heartbeat the weight
            # digests do — a miss anywhere consults this pod view
            info["prefix"] = self.prefix.local_info()
        return info

    def tick(self) -> dict:
        """Publish the heartbeat, run one pod-autoscaler decision."""
        self.transport.publish(self._local_info())
        return self.autoscaler.tick()

    def start(self) -> None:
        if self._thread is not None:
            return
        if hasattr(self.transport, "start"):
            self.transport.start()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mst-pod-fleet", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the pod loop must outlive a
                logger.exception("pod fleet tick failed")  # bad tick

    # ------------------------------------------------------------ messages
    def _on_message(self, src: int, kind: str, payload: bytes) -> None:
        if self.handoff.handle(src, kind, payload):
            return
        if self.prefix is not None and self.prefix.handle(src, kind, payload):
            return
        if kind == "weights.teardown":
            self.registry.handle_teardown(payload.decode())
            return
        logger.debug("unrecognized pod message kind %r from %d", kind, src)

    def _host_died(self, host: int) -> None:
        with self._lock:
            self.host_deaths += 1

    # ------------------------------------------------------ observability
    def pod_stats(self) -> dict:
        """The /health ``pod`` block and the host-labeled metrics source:
        every known host's fleet/weights/heartbeat view plus the handoff
        and autoscaler counters."""
        hosts = {
            str(self.host_id): {
                "alive": True,
                "heartbeat_age_s": 0.0,
                "fleet": self.autoscaler.local_info(),
                "weights": self.registry.local_info(),
            }
        }
        try:
            peers = self.transport.peers()
        except Exception:  # noqa: BLE001 — a dead fabric still renders
            peers = {}
        dead = set(self.autoscaler.state()["dead_hosts"])
        with self._lock:
            host_deaths = self.host_deaths
        for host, entry in peers.items():
            info = entry.get("info", {})
            age = entry.get("age_s")
            hosts[str(host)] = {
                "alive": host not in dead and (
                    age is not None
                    and age <= self.autoscaler.heartbeat_timeout_s
                ),
                "heartbeat_age_s": (
                    None if age is None or age == float("inf")
                    else round(age, 3)
                ),
                "fleet": info.get("fleet", {}),
                "weights": info.get("weights", {}),
            }
        out = {
            "host_id": self.host_id,
            "hosts": hosts,
            "handoff": self.handoff.stats(),
            "autoscaler": self.autoscaler.state(),
            "host_deaths": host_deaths,
        }
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out

    def close(self, close_local: bool = True) -> None:
        """Stop the pod loop and transport. ``close_local`` follows the
        server's ownership (the PodFleet replaced the provider's generator,
        so tearing it down tears the chain); pass False when the local
        generator outlives this pod membership (tests, re-attachment)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        try:
            self.transport.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        if close_local:
            close = getattr(self.local, "close", None)
            if close is not None:
                close()


# --------------------------------------------------------------------------
# two-process self-test (``python -m mlx_sharding_tpu_torch.pod``)

#: the self-test's default model: a tiny Llama in f32
SELFTEST_TINY = dict(model_type="llama", vocab_size=256, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)


def _selftest_main(argv=None):  # pragma: no cover — driven by the tests in subprocesses
    """Two-process acceptance run over real gloo collectives (JAX's
    ``_selftest_main``).

    Rank 0 runs a disagg coordinator (prefill and decode batchers aliasing
    one weight tree) with the pod attached; rank 1 runs a decode host (two
    batchers aliasing one tree, one of them pod-attached). The run proves:
    (1) one weight tree per host with >= 2 local refs, visible through the
    gossip view; (2) a cross-host prefill→decode handoff whose greedy stream
    is bit-identical to a monolithic batcher's; (3) the ``pod.handoff``
    fault and a real host death mid-relay both degrading to the local plan
    with no dropped stream and counted fallbacks. Rank 0 prints one JSON
    document. The model is random (``--seed``): the tiny f32 Llama, or
    ``--config`` (a config.json) cut to ``--layers`` layers in ``--dtype``;
    ``--device`` is every engine's (the first card without it)."""
    import argparse
    import json
    import os
    import sys

    import torch

    os.environ.setdefault("MST_POD_TIMEOUT_S", "20")

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--config", default=None, help="a config.json (default: a tiny Llama)")
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--page", type=int, default=8)
    p.add_argument("--pool-pages", type=int, default=10)
    args = p.parse_args(argv)

    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.disagg import DisaggCoordinator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel.multihost import init_process, process_index
    from mlx_sharding_tpu_torch.parallel.pipeline import place_weights
    from mlx_sharding_tpu_torch.replicas import ReplicaSet
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.testing import faults
    from mlx_sharding_tpu_torch.weights import WeightKey, aliased_spawn

    device = resolve_device(args.device)
    init_process(args.coordinator, args.num_processes, args.process_id)
    host = process_index()
    config = dict(SELFTEST_TINY)
    if args.config is not None:
        with open(args.config) as f:
            config = json.load(f)
    if args.layers is not None:
        config["num_hidden_layers"] = args.layers
    dtype = getattr(torch, args.dtype)
    model, _ = build_model(config, dtype=dtype)
    model.init_params(torch.Generator(device=device).manual_seed(args.seed), device)
    key = WeightKey(checkpoint="pod-demo", stage_bounds=(("auto", 1),), dtype=args.dtype,
                    quant="tp1", placement=f"pod-host-{host}")
    store = weight_store()
    eng_kw = dict(microbatches=2, max_seq=args.max_seq, prefill_chunk=args.chunk,
                  pool_pages=args.pool_pages, page_size=args.page, device=device)

    def batcher(eng):
        b = ContinuousBatcher(eng, decode_block=3)
        b.warm_up(blocks=((False, False),))
        return b

    def aliased_batcher():
        def make(lease):
            eng = PipelineEngine(model, weights=lease.weights, **eng_kw)
            eng.on_close(lease.release)
            return batcher(eng)

        return aliased_spawn(store, key, lambda: place_weights(model, device=device), make)

    transport = CollectiveTransport(interval_s=0.05)
    job = ([3, 17, 42], dict(max_tokens=24))

    with torch.no_grad():
        if host == 0:
            # prefill and decode pools alias one local tree (trees=1, refs=2)
            co = DisaggCoordinator(
                ReplicaSet([aliased_batcher()], role="prefill"),
                ReplicaSet([aliased_batcher()], role="decode"),
            )
            fleet = PodFleet(host, transport, co, relay_timeout_s=5.0, interval_s=0.1)
            # the monolithic reference, built outside the store so the
            # tree and ref gauges stay an exact statement about the fleet
            mono = batcher(PipelineEngine(model, **eng_kw))
            ref = [t for t, _ in mono.generate_step(job[0], **job[1])]
            fleet.start()
            # price the local decode pool as hot, so routing picks the remote
            fleet.handoff.local_pressure = lambda: 1.0
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                view = fleet.pod_stats()["hosts"]
                if "1" in view and (view["1"].get("weights") or {}).get("trees"):
                    break
                time.sleep(0.2)
            report = {"hosts": fleet.pod_stats()["hosts"]}

            # 2: a cross-host handoff, its greedy stream bit-identical
            got = [t for t, _ in co.generate_step(job[0], **job[1])]
            h = fleet.handoff.stats()
            report["handoff"] = {
                "match": got == ref, "shipped": h["shipped"],
                "bytes_shipped": h["bytes_shipped"],
                "relayed_tokens": h["relayed_tokens"],
                "ms_p50": h["ms_p50"], "ms_p99": h["ms_p99"],
            }

            # 3: an injected pod.handoff fault, served in place
            faults.arm("pod.handoff", exc=faults.FaultError, times=1)
            got_fault = [t for t, _ in co.generate_step(job[0], **job[1])]
            faults.disarm()
            report["fault_sweep"] = {
                "match": got_fault == ref,
                "fallbacks": fleet.handoff.stats()["fallbacks"],
            }

            # 4: a real host death mid-relay, drained token-exact locally
            transport.send(1, "demo.die", b"2")  # die after 2 relayed tokens
            time.sleep(0.5)
            got_death = [t for t, _ in co.generate_step(job[0], **job[1])]
            h = fleet.handoff.stats()
            report["host_death"] = {
                "match": got_death == ref,
                "fallbacks": h["fallbacks"],
                "dropped_streams": 0 if got_death == ref else 1,
            }
            report["ok"] = all((
                report["handoff"]["match"], report["handoff"]["shipped"] >= 1,
                report["handoff"]["bytes_shipped"] > 0,
                report["fault_sweep"]["match"],
                report["fault_sweep"]["fallbacks"].get("handoff_fault") == 1,
                report["host_death"]["match"],
                (report["host_death"]["fallbacks"].get("relay_timeout", 0)
                 + report["host_death"]["fallbacks"].get("remote_error", 0)
                 + report["host_death"]["fallbacks"].get("transfer_fault", 0)
                 >= 1),
                all((v.get("weights") or {}).get("trees") == 1
                    and (v.get("weights") or {}).get("refs", 0) >= 2
                    for v in report["hosts"].values()),
            ))
            print(json.dumps(report))
            sys.stdout.flush()
            os._exit(0 if report["ok"] else 1)
        else:
            # the decode host: two batchers alias one tree; the first is the
            # pod-attached decode target, the second proves the aliasing
            b1 = aliased_batcher()
            _b2 = aliased_batcher()  # noqa: F841 — holds the second ref live
            die_after = [None]

            class _Mortal:
                """A decode target that can die mid-relay on command."""

                def __init__(self, inner):
                    self.inner = inner

                def __getattr__(self, name):
                    return getattr(self.inner, name)

                def generate_step(self, prompt, **kw):
                    n = 0
                    for item in self.inner.generate_step(prompt, **kw):
                        yield item
                        n += 1
                        if die_after[0] is not None and n >= die_after[0]:
                            os._exit(0)  # SIGKILL-grade: no goodbyes

            fleet = PodFleet(host, transport, _Mortal(b1), interval_s=0.1)
            inner_handler = transport._handler

            def handler(src, kind, payload):
                if kind == "demo.die":
                    die_after[0] = int(payload or b"1")
                    return
                inner_handler(src, kind, payload)

            transport.set_handler(handler)
            fleet.start()
            time.sleep(300)  # ended by the host death demo (or the caller's timeout)


if __name__ == "__main__":
    # run the canonical module's driver: under ``python -m`` this file is
    # imported twice (as __main__ and as mlx_sharding_tpu_torch.pod), and
    # the fallback exceptions must be the classes disagg.py catches
    from mlx_sharding_tpu_torch.pod import _selftest_main as _canonical_main

    _canonical_main()
