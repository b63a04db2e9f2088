"""Content-addressed prefix KV store (port of
``mlx_sharding_tpu/prefix_store.py``, its single-host part): fleet-wide
copy-on-write reuse.

At production traffic shapes — many sessions over a handful of system
prompts — the fleet should prefill each hot prefix ONCE. The engine-level
prompt cache (``--prompt-cache``) cannot grow into that: its index is
slot-local raw-byte page hashes inside one batcher, invisible to the
router, the other replicas, and the disagg coordinator. This module
composes the pieces the stack already has into the shared subsystem:

- **keying** — the chained chunk digests of ``utils.digests.chunk_digests``
  (the router's affinity scheme, extracted so router and store can never
  disagree): because digests are chained, the k-th digest alone
  content-addresses the entire k-page prefix, so lookup is
  longest-prefix-match over single dict probes, longest first.
- **device tier** — per-batcher entries mapping a digest chain to the pool
  pages holding its KV. Pages are shared copy-on-write across live slots:
  a hitting slot maps them read-only and starts decode/tail-prefill past
  them (writes land in its private pages — the same immutability argument
  as the engine prompt cache). Entries are refcounted WeightStore-style:
  one :class:`PrefixLease` per slot mapping the pages, plus the entry's
  own +1 on each page in the batcher's ``_page_ref`` accounting.
- **host tier** — a digest-keyed :class:`~mlx_sharding_tpu_torch.kv_transfer.
  KVSpillTier` of host-materialized ``KVPageBlock``s. On LAST lease
  release the entry demotes: the batcher exports the pages (dispatch-only
  gather; the device→host copy runs on the tier's flusher) and the pool
  pages return to the free list — device residency exists only while some
  slot is live on the prefix. A later admission anywhere in the fleet
  re-imports the block (prefetch-staged when the scheduler sees it
  coming; demand import is the counted fallback) and re-registers the
  pages as a fresh device entry.

Insertion policy (one-shot prompts must not churn the store): a prefix is
registered only after ``insert_min_hits`` lookup MISSES of its full chain,
under a token bucket refilled per admission (``insert_burst``), and not at
all while the fleet brownout controller has paused inserts (serving hits
stays free — pausing reuse under pressure would be backwards).

Failure contract: fault site ``cache.prefix_lookup`` fires at the top of
every lookup/coverage probe; callers catch, count, and degrade to plain
prefill. An import failure re-prefills from token 0 into the pages the
slot already holds. Neither path can drop or corrupt a stream — greedy
token streams are bit-identical with the store on or off."""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Optional

import numpy as np

from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.kv_transfer import KVPageBlock, KVSpillTier
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.digests import chunk_digests
from mlx_sharding_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)


class _DeviceEntry:
    """One registered prefix resident in one batcher's page pool."""

    __slots__ = ("owner", "digests", "pages", "tokens", "nbytes", "refs",
                 "hits", "keys", "dropped")

    def __init__(self, owner, digests, pages, tokens, nbytes):
        self.owner = owner            # the batcher whose pool holds the pages
        self.digests = list(digests)  # full chain; digests[-1] is the host key
        self.pages = list(pages)      # pool page ids, chain order
        self.tokens = np.asarray(tokens, np.int64)  # the prefix ids (export)
        self.nbytes = int(nbytes)
        self.refs = 0                 # live leases (slots mapping the pages)
        self.hits = 0
        self.keys = []                # index keys THIS entry owns
        self.dropped = False          # drop_owner() ran; leases are orphans


class PrefixLease:
    """One slot's claim on a device entry's shared pages. Release is
    exactly-once (double release raises — the WeightStore discipline);
    the LAST release returns the entry to the caller for demotion."""

    __slots__ = ("_store", "_entry", "cover", "pages", "n_tokens", "_released")

    def __init__(self, store, entry, cover: int, n_tokens: int):
        self._store = store
        self._entry = entry
        self.cover = cover                       # chain prefix this slot maps
        self.pages = list(entry.pages[:cover])   # the shared page ids
        self.n_tokens = n_tokens
        self._released = False

    def release(self) -> Optional[_DeviceEntry]:
        """Drop this lease's ref; returns the entry iff this was the last
        ref (the caller demotes it to the host tier and unrefs its pages)."""
        return self._store._release(self)


class PrefixStore:
    """Fleet-wide two-tier prefix KV store shared by every batcher (and
    read by the router and disagg coordinator) in one serving process."""

    def __init__(self, *, host_bytes: int = 1 << 28,
                 insert_min_hits: int = 1, insert_burst: int = 32):
        if not isinstance(host_bytes, int) or isinstance(host_bytes, bool) \
                or host_bytes <= 0:
            raise ValueError(
                f"host_bytes must be a positive byte count, got {host_bytes!r}"
            )
        if insert_min_hits < 1:
            raise ValueError(
                f"insert_min_hits must be >= 1, got {insert_min_hits}"
            )
        if insert_burst < 1:
            raise ValueError(
                f"insert_burst must be >= 1, got {insert_burst}"
            )
        self._lock = make_lock("PrefixStore._lock")
        # (id(owner), digest) -> (entry, chain position + 1). Chained
        # digests make the probe exact: matching digests[i] means matching
        # the whole (i+1)-page prefix, so cover IS the index position.
        self._index: dict = {}
        # digest -> entries from ANY owner holding it (router hint + disagg
        # coverage probes, which don't care whose pool the pages sit in)
        self._by_digest: dict = {}
        self._host = KVSpillTier(host_bytes)
        self.page_size: Optional[int] = None
        # KV share-map layout the attached engines run (None == unshared).
        # Bound write-once like page_size; host-tier blocks carry the hash
        # they were exported under and a mismatch at bind time is a
        # configuration error, not an import-time checksum surprise.
        self.share_hash: Optional[str] = None
        self._share_bound = False
        # Compressed-latent codec layout the attached engines run
        # (kv_compress.py; None == raw transport). Same write-once
        # discipline: host-tier blocks compress under ONE geometry and the
        # pod heartbeat gossips this hash so mismatched peers skip each
        # other before any fetch moves bytes.
        self.compress_hash: Optional[str] = None
        self._compress_bound = False
        # pod federation handle (pod.PodFleet.attach_prefix_store sets it):
        # the scheduler's store-consult slow path calls federation.fetch()
        # on a local miss; None == single-host store, no pod consult
        self.federation = None
        # ---------------------------------------------- insertion policy
        self.insert_min_hits = insert_min_hits
        self.insert_burst = insert_burst
        self._bucket = float(insert_burst)  # refilled 1/admission, capped
        self._seen: "OrderedDict[bytes, int]" = OrderedDict()  # miss counts
        self._seen_cap = 4096
        self._paused = False
        # ---------------------------------------------------- counters
        self.queries = 0
        self.hits_device = 0
        self.hits_host = 0
        self.misses = 0
        self.tokens_reused = 0
        self.inserts = 0
        self.inserts_damped = 0
        self.cow_forks = 0
        self.demotions = 0
        self.demote_drops = 0     # last-release exports that failed/skipped
        self.evictions_reset = 0  # entries dropped by drop_owner (no export)
        self.imports_staged = 0   # host-tier imports that consumed a stage
        self.imports_demand = 0   # host-tier imports that marshaled numpy
        self.lookup_faults = 0    # cache.prefix_lookup degradations
        self.import_faults = 0    # host-block imports that fell to prefill

    # ------------------------------------------------------------ geometry
    def bind_page_size(self, page: int):
        """Each attaching batcher declares its pool page size; the chain is
        only shareable across identical page geometry, so a mismatch is a
        construction error, not a runtime degradation. Construction-time
        wiring (batchers are built sequentially), so no lock: ``page_size``
        is write-once-then-read-only."""
        existing = self.page_size
        if existing is None:
            self.page_size = int(page)
        elif existing != int(page):
            raise ValueError(
                f"prefix store is chained at page_size={existing}; an "
                f"engine with page_size={page} cannot share it"
            )

    def bind_share_hash(self, share_hash: Optional[str]):
        """Each attaching batcher declares its pool's KV share-map layout
        hash (``engine.kv_share_hash``; None == unshared/identity). Blocks
        only compose across identical layouts, so the check runs HERE, at
        construction — not as a geometry-checksum failure deep in an
        import at serve time. Write-once: a second engine binding a
        different layout, or a bind that disagrees with blocks already
        resident in the host tier, is a configuration error with a
        remediation hint."""
        if self._share_bound:
            if self.share_hash != share_hash:
                raise ValueError(
                    f"prefix store is bound to KV share-map hash "
                    f"{self.share_hash!r}; an engine with share hash "
                    f"{share_hash!r} cannot share it — serve every attached "
                    f"engine with the same --kv-share-map artifact"
                )
            return
        stale = {
            h for h in self._host.share_hashes() if h != share_hash
        }
        if stale:
            raise ValueError(
                f"prefix store host tier already holds blocks exported "
                f"under share-map hash(es) {sorted(str(h) for h in stale)} "
                f"but this engine binds {share_hash!r} — restart with the "
                f"matching --kv-share-map artifact (or a fresh store) "
                f"instead of changing KV layouts over resident blocks"
            )
        self.share_hash = share_hash
        self._share_bound = True

    def bind_compress_hash(self, compress_hash: Optional[str]):
        """Each attaching batcher declares its pool's compressed-latent
        codec layout (``engine.kv_compress_hash``; None == raw). Same
        write-once contract as :meth:`bind_share_hash`: blocks compressed
        under one geometry can only reconstruct under the same one, so a
        mismatch is a construction error with a remediation hint, not an
        import-time integrity surprise. Raw resident blocks (hash None)
        are always compatible — they import anywhere their geometry fits."""
        if self._compress_bound:
            if self.compress_hash != compress_hash:
                raise ValueError(
                    f"prefix store is bound to KV compress hash "
                    f"{self.compress_hash!r}; an engine with compress hash "
                    f"{compress_hash!r} cannot share it — serve every "
                    f"attached engine with the same model/--kv-compress-map "
                    f"geometry"
                )
            return
        stale = {
            h for h in self._host.compress_hashes()
            if h is not None and h != compress_hash
        }
        if stale:
            raise ValueError(
                f"prefix store host tier already holds blocks compressed "
                f"under hash(es) {sorted(str(h) for h in stale)} but this "
                f"engine binds {compress_hash!r} — restart with the "
                f"matching --kv-compress-map artifact (or a fresh store) "
                f"instead of changing KV layouts over resident blocks"
            )
        self.compress_hash = compress_hash
        self._compress_bound = True

    def digests_for(self, prompt) -> list:
        """The store's digest chain for ``prompt``: page-aligned chunks,
        capped one token short of the full prompt — the last prompt token
        must go through prefill to produce the first sample's logits."""
        if self.page_size is None:
            return []
        n = len(prompt)
        kmax = (n - 1) // self.page_size
        if kmax < 1:
            return []
        try:
            return chunk_digests(prompt, self.page_size, max_chunks=kmax)
        except (TypeError, ValueError):
            return []

    # ------------------------------------------------------------- lookup
    def lookup(self, owner, digests: list) -> Optional[tuple]:
        """Longest-prefix-match for an admission in ``owner``'s batcher:
        ``("device", cover)`` when the owner's pool already holds the
        prefix pages (zero-copy COW share), ``("host", cover)`` when the
        host tier holds an importable block, else None. Pure probe with no
        counter side effects — the scheduler polls this from its fit check
        every tick for a blocked queue head, then counts ONE resolution
        per admission via :meth:`count_lookup`. Fault site
        ``cache.prefix_lookup`` fires first — callers degrade to plain
        prefill and count via :meth:`count_lookup_fault`."""
        inject("cache.prefix_lookup", engine=id(owner))
        # self-instrumentation: the scheduler binds the admitting request's
        # trace (tracing.bind) around this call, so the LPM probe lands on
        # the right timeline without a signature change
        tr = tracing.current()
        if tr is None:
            return self._lookup(owner, digests)
        with tr.timed("prefix_lookup", chain=len(digests)):
            return self._lookup(owner, digests)

    def _lookup(self, owner, digests: list) -> Optional[tuple]:
        if not digests:
            return None
        oid = id(owner)
        with self._lock:
            for i in range(len(digests) - 1, -1, -1):
                if (oid, digests[i]) in self._index:
                    return ("device", i + 1)
        # host probe outside our lock (the tier locks internally; never
        # nest the two so the static lock graph stays a DAG)
        for i in range(len(digests) - 1, -1, -1):
            if self._host.contains(digests[i]):
                return ("host", i + 1)
        return None

    def count_lookup(self, kind: str, digests: Optional[list] = None):
        """Record one admission's lookup resolution: ``"device"`` /
        ``"host"`` / ``"miss"``. A miss also bumps the full-chain digest's
        seen-count, the signal ``insert_min_hits`` gates registration on —
        admissions, not polls, measure demand for a prefix."""
        with self._lock:
            self.queries += 1
            if kind == "device":
                self.hits_device += 1
            elif kind == "host":
                self.hits_host += 1
            else:
                self.misses += 1
                if digests:
                    full = digests[-1]
                    self._seen[full] = self._seen.get(full, 0) + 1
                    self._seen.move_to_end(full)
                    while len(self._seen) > self._seen_cap:
                        self._seen.popitem(last=False)

    def acquire(self, owner, digests: list, cover: int) -> Optional[PrefixLease]:
        """Lease the device entry covering ``digests[:cover]`` for one more
        slot (the COW fork: the new slot maps pages another holder still
        references). None if the entry vanished since lookup — callers
        fall back to plain prefill."""
        n_tokens = cover * (self.page_size or 0)
        with self._lock:
            hit = self._index.get((id(owner), digests[cover - 1]))
            if hit is None:
                return None
            entry, pos = hit
            if pos != cover:  # chained digests make this impossible; guard
                return None
            entry.refs += 1
            entry.hits += 1
            self.cow_forks += 1
            self.tokens_reused += n_tokens
            lease = PrefixLease(self, entry, cover, n_tokens)
        tr = tracing.current()
        if tr is not None:
            # the COW fork on the admitting request's timeline: how many
            # prefill tokens the store just deleted from its TTFT
            tr.point("prefix_lease", cover=cover, tokens=n_tokens)
        return lease

    def host_block(self, digest: bytes) -> Optional[KVPageBlock]:
        """The host tier's block for ``digest`` (shared — NOT removed; any
        number of admissions may import the same prefix). LRU-refreshes the
        entry so budget pressure evicts a colder prefix instead."""
        blk = self._host.peek(digest)
        if blk is not None:
            self._host.touch(digest)
        return blk

    # ----------------------------------------------------------- insertion
    def note_admission(self):
        """Token-bucket refill: one insert credit per admitted request, so
        the insert rate tracks admission rate instead of wall clock (and
        stays deterministic for tests)."""
        with self._lock:
            self._bucket = min(float(self.insert_burst), self._bucket + 1.0)

    def register(self, owner, digests: list, pages: list, tokens,
                 nbytes: int, *, force: bool = False) -> Optional[PrefixLease]:
        """Register a freshly prefilled (or freshly imported, with
        ``force=True``) prefix as a device entry and return the inserting
        slot's lease. Pure bookkeeping — no data moves; the pages are the
        slot's own prompt pages, which decode never rewrites. Returns None
        when the insertion policy declines (already resident, paused,
        below ``insert_min_hits``, bucket empty)."""
        if not digests:
            return None
        oid = id(owner)
        full = digests[-1]
        n_tok = len(digests) * (self.page_size or 0)
        # host probe before taking our lock (the tier locks internally;
        # never nest the two so the static lock graph stays a DAG)
        host_has = (not force) and self._host.contains(full)
        with self._lock:
            if (oid, full) in self._index:
                return None  # already resident (a concurrent twin won)
            if not force:
                if host_has:
                    return None  # host tier already serves it; no duplicate
                if self._paused:
                    self.inserts_damped += 1
                    return None
                if self._seen.get(full, 0) < self.insert_min_hits:
                    self.inserts_damped += 1
                    return None
                if self._bucket < 1.0:
                    self.inserts_damped += 1
                    return None
                self._bucket -= 1.0
            entry = _DeviceEntry(owner, digests, pages, tokens, nbytes)
            for i, d in enumerate(digests):
                key = (oid, d)
                if key not in self._index:  # first writer wins per digest
                    self._index[key] = (entry, i + 1)
                    entry.keys.append(key)
                    self._by_digest.setdefault(d, []).append(entry)
            if not entry.keys:
                return None  # every digest already indexed elsewhere
            entry.refs = 1
            self.inserts += 1
            self._seen.pop(full, None)
            lease = PrefixLease(self, entry, len(digests), n_tok)
            return lease

    # ------------------------------------------------------------- release
    def _release(self, lease: PrefixLease) -> Optional[_DeviceEntry]:
        with self._lock:
            if lease._released:
                raise RuntimeError(
                    "prefix lease released twice — the exactly-once release "
                    "discipline is broken (double-free of shared KV pages)"
                )
            lease._released = True
            entry = lease._entry
            if entry.dropped:
                return None  # drop_owner already reclaimed it wholesale
            entry.refs -= 1
            if entry.refs > 0:
                return None
            self._unindex(entry)
            return entry

    def _unindex(self, entry: _DeviceEntry):
        # caller holds self._lock
        for key in entry.keys:
            self._index.pop(key, None)
            lst = self._by_digest.get(key[1])
            if lst is not None:
                try:
                    lst.remove(entry)
                except ValueError:
                    pass
                if not lst:
                    self._by_digest.pop(key[1], None)
        entry.keys = []

    def host_put(self, digest: bytes, block: KVPageBlock) -> bool:
        """Demotion (or a pod-federated fetch): park an exported prefix
        block in the host tier under its full-chain digest. Returns the
        tier's verdict (budget/oversize rejects mean the prefix is simply
        gone — re-prefilled on next use). A block exported under a
        different share-map layout than the bound one is refused the same
        way: degraded to re-prefill, never resident-but-unimportable."""
        if self._share_bound and block.share_hash != self.share_hash:
            self.count_demote_drop()
            return False
        if (
            self._compress_bound
            and block.compress_hash is not None
            and block.compress_hash != self.compress_hash
        ):
            # compressed under a geometry no attached engine can
            # reconstruct — parking it would be resident-but-unimportable
            self.count_demote_drop()
            return False
        ok = self._host.put(digest, block)
        with self._lock:
            if ok:
                self.demotions += 1
            else:
                self.demote_drops += 1
        return ok

    def host_contains(self, digest: bytes) -> bool:
        return self._host.contains(digest)

    def host_inventory(self, cap: int = 64) -> list:
        """Hex digests of host-tier-resident prefix blocks, MRU-first and
        capped — the pod federation's gossip payload (pod.py rides it on
        the control-plane heartbeat exactly like WeightStore key digests).
        Hex, not bytes: heartbeat payloads must stay JSON-serializable."""
        out = []
        for key in self._host.keys():
            if len(out) >= cap:
                break
            if isinstance(key, (bytes, bytearray)):
                out.append(bytes(key).hex())
        return out

    def count_demote_drop(self):
        with self._lock:
            self.demote_drops += 1

    def drop_owner(self, owner):
        """Forget every device entry in ``owner``'s pool WITHOUT export —
        the pool was reset wholesale (``_fail_all``) or the batcher is
        closing, so the pages (and their contents) are already gone.
        Outstanding leases become orphans whose release is a no-op."""
        oid = id(owner)
        with self._lock:
            entries = {e for (o, _), (e, _) in list(self._index.items())
                       if o == oid}
            for entry in entries:
                self._unindex(entry)
                entry.dropped = True
                self.evictions_reset += 1

    # ------------------------------------------------- fleet-facing probes
    def covers_full(self, prompt) -> bool:
        """True when the store can serve ``prompt``'s ENTIRE page-aligned
        prefix (the disagg full-hit: phase 1 would prefill nothing worth a
        handoff, so the decode pool serves from token 0). Fires the
        ``cache.prefix_lookup`` fault site — the coordinator catches and
        runs the normal two-phase path."""
        inject("cache.prefix_lookup", probe="covers")
        digests = self.digests_for(prompt)
        if not digests:
            return False
        full = digests[-1]
        with self._lock:
            if self._by_digest.get(full):
                return True
        return self._host.contains(full)

    def owner_hint(self, prompt):
        """The batcher whose pool device-holds the longest prefix of
        ``prompt`` — the router's store-hit placement hint. None when only
        the host tier (importable anywhere) or nothing holds it."""
        digests = self.digests_for(prompt)
        with self._lock:
            for i in range(len(digests) - 1, -1, -1):
                entries = self._by_digest.get(digests[i])
                if entries:
                    return entries[0].owner
        return None

    # ------------------------------------------------------------ controls
    def pause_inserts(self, flag: bool):
        """Brownout rung (fleet.py ladder, level >= 1): under pressure new
        prefixes stop being ADMITTED to the store — registration is cheap
        but demotion exports and host-tier churn are not — while lookups
        keep serving hits, which shed prefill work exactly when the fleet
        needs it most."""
        with self._lock:
            self._paused = bool(flag)

    @property
    def inserts_paused(self) -> bool:
        with self._lock:
            return self._paused

    # -------------------------------------------------- counters for peers
    def count_lookup_fault(self):
        with self._lock:
            self.lookup_faults += 1

    def count_import(self, *, staged: bool, n_tokens: int = 0):
        with self._lock:
            if staged:
                self.imports_staged += 1
            else:
                self.imports_demand += 1
            self.tokens_reused += int(n_tokens)

    def count_import_fault(self):
        with self._lock:
            self.import_faults += 1

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        host = self._host.stats()  # tier lock first; never under ours
        with self._lock:
            entries = {e for e, _ in self._index.values()}
            device_blocks = len(entries)
            device_bytes = sum(e.nbytes for e in entries)
            lookups = self.hits_device + self.hits_host + self.misses
            hits = self.hits_device + self.hits_host
            return {
                "device_blocks": device_blocks,
                "device_bytes": device_bytes,
                "host_blocks": host["blocks"],
                "host_bytes": host["bytes_in_use"],
                "host_budget_bytes": host["budget_bytes"],
                "queries": self.queries,
                "hits": hits,
                "hits_device": self.hits_device,
                "hits_host": self.hits_host,
                "misses": self.misses,
                "hit_rate": (hits / lookups) if lookups else 0.0,
                "tokens_reused": self.tokens_reused,
                "inserts": self.inserts,
                "inserts_damped": self.inserts_damped,
                "inserts_paused": self._paused,
                "cow_forks": self.cow_forks,
                "demotions": self.demotions,
                "demote_drops": self.demote_drops,
                "evictions_budget": host["evictions"],
                "evictions_oversize": host["rejects_oversize"],
                "evictions_reset": self.evictions_reset,
                "imports_staged": self.imports_staged,
                "imports_demand": self.imports_demand,
                "lookup_faults": self.lookup_faults,
                "import_faults": self.import_faults,
            }

    def close(self):
        self._host.close()
        with self._lock:
            for entry, _ in list(self._index.values()):
                entry.dropped = True
            self._index.clear()
            self._by_digest.clear()
