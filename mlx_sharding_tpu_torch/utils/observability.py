"""Profiling and metrics (copied from ``mlx_sharding_tpu/utils/
observability.py``, with the profiler on ``torch.profiler``).

- :func:`profile_trace` records a ``torch.profiler`` trace (host ops of
  every thread and, on a card, its kernels) around a generation call and
  writes it as Chrome trace JSON under ``--profile-dir``;
- :class:`ServingMetrics` is the lock-guarded counter set the server
  exposes at ``/metrics``: request counts, token totals, TTFT and
  decode-rate summaries, and the batcher's read-outs.

The families whose sources come with later slices are left out, as the
source module leaves out a family whose source is None: the pod and the
resource ledger's anomalies (``ROADMAP.md`` lists each under its slice).
A replica set's families (replicas, the fleet, routing, autoscale events),
the disaggregated handoff, the brownout level, the weight store, the fault
harness, KV sharing, KV spill, migration and prefetch (a paged batcher's
``spill_stats``), the prefix store and KV compression are rendered as the
source renders them.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import random
import threading
import time
from dataclasses import dataclass, field

from mlx_sharding_tpu_torch.utils.locks import make_lock

# Shared bucket bounds (the source module's): they straddle the CPU test
# rig's millisecond ticks and serving on a card; +Inf is the last slot.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
ITL_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0)
# the disagg handoff's control + device-to-host time, in ms
HANDOFF_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` capture of the host ops of every thread (the
    batcher's scheduler thread included) and, with a card, its kernels,
    written to ``log_dir`` as ``trace-<ns>.json`` (Chrome trace JSON); a
    no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


class _Reservoir:
    """Bounded uniform sample for percentile summaries."""

    def __init__(self, capacity: int = 512, seed: int = 0):
        self.capacity = capacity
        self.values: list[float] = []
        self.count = 0
        self._rng = random.Random(seed)

    def add(self, value: float):
        self.count += 1
        if len(self.values) < self.capacity:
            self.values.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.values[j] = value

    def percentile(self, p: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        idx = min(len(s) - 1, max(0, round(p / 100 * (len(s) - 1))))
        return s[idx]


class Histogram:
    """Cumulative bucketed histogram, the Prometheus ``_bucket{le=}`` /
    ``_sum`` / ``_count`` shape. Bucket counts merge exactly (elementwise
    addition), which is why the latency families live here rather than in
    :class:`_Reservoir`."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds, lock_name: str = "Histogram._lock"):
        self._bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self._bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = make_lock(lock_name)

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            # the smallest le bucket holding v; past every bound, +Inf
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v
            self._count += 1

    def to_dict(self) -> dict:
        """A serializable snapshot (what ``latency_stats()`` returns)."""
        with self._lock:
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    @staticmethod
    def merge_dicts(dicts) -> dict | None:
        """Elementwise merge of :meth:`to_dict` snapshots. Snapshots with
        mismatched bounds are skipped (a mixed-version fleet must degrade,
        not crash a scrape)."""
        out = None
        for d in dicts:
            if not d or "counts" not in d:
                continue
            if out is None:
                out = {"bounds": list(d["bounds"]), "counts": list(d["counts"]),
                       "sum": float(d["sum"]), "count": int(d["count"])}
            elif list(d["bounds"]) == out["bounds"]:
                out["counts"] = [a + b for a, b in zip(out["counts"], d["counts"])]
                out["sum"] += float(d["sum"])
                out["count"] += int(d["count"])
        return out

    @staticmethod
    def render_into(lines: list, family: str, snap: dict | None, help_text: str = ""):
        """Append one family's exposition block from a :meth:`to_dict`
        snapshot (nothing when the snapshot is absent)."""
        if not snap or "counts" not in snap:
            return
        if help_text:
            lines.append(f"# HELP {family} {help_text}")
        lines.append(f"# TYPE {family} histogram")
        acc = 0
        for bound, n in zip(snap["bounds"], snap["counts"]):
            acc += n
            lines.append(f'{family}_bucket{{le="{bound:g}"}} {acc}')
        acc += snap["counts"][-1]
        lines.append(f'{family}_bucket{{le="+Inf"}} {acc}')
        lines.append(f"{family}_sum {snap['sum']:.6f}")
        lines.append(f"{family}_count {snap['count']}")


def _render_spec_family(lines: list, spec: dict):
    """The speculation gauges from a ``spec_stats()`` dict: whether this
    generator drafts, how wide, and whether it pays."""
    lines += [
        "# TYPE mst_spec_enabled gauge",
        f'mst_spec_enabled{{mode="{spec["mode"]}"}} 1',
        "# TYPE mst_spec_window gauge",
        f"mst_spec_window {spec.get('window_max', 0)}",
        "# TYPE mst_spec_accept_rate gauge",
        f"mst_spec_accept_rate {spec.get('accept_rate', 0.0):.4f}",
        "# TYPE mst_spec_draft_tokens_total counter",
        f"mst_spec_draft_tokens_total {spec.get('draft_tokens', 0)}",
        "# TYPE mst_spec_accepted_tokens_total counter",
        f"mst_spec_accepted_tokens_total {spec.get('accepted_tokens', 0)}",
        "# TYPE mst_spec_rounds_total counter",
        f"mst_spec_rounds_total {spec.get('rounds', 0)}",
        "# TYPE mst_spec_fallback_ticks_total counter",
        f"mst_spec_fallback_ticks_total {spec.get('fallback_ticks', 0)}",
        "# TYPE mst_spec_draft_faults_total counter",
        f"mst_spec_draft_faults_total {spec.get('draft_faults', 0)}",
    ]
    if "disabled_slots" in spec:
        # per-slot adaptive control only (a tracker behind it)
        lines += [
            "# TYPE mst_spec_disabled_slots gauge",
            f"mst_spec_disabled_slots {spec['disabled_slots']}",
            "# TYPE mst_spec_shed_events_total counter",
            f"mst_spec_shed_events_total {spec['shed_events']}",
        ]


def _render_spill_family(lines: list, spill: dict):
    """KV spill, migration and prefetch: how often pressure moved page
    blocks instead of discarding them, the host bytes the tier holds, and
    the resumes' staged-against-demand split."""
    lines += [
        "# TYPE mst_kv_spill_enabled gauge",
        f"mst_kv_spill_enabled {int(bool(spill['enabled']))}",
        "# TYPE mst_kv_spill_total counter",
        f"mst_kv_spill_total {spill['spills']}",
        "# TYPE mst_kv_spill_hits_total counter",
        f"mst_kv_spill_hits_total {spill['spill_hits']}",
        "# TYPE mst_kv_spill_fallbacks_total counter",
        f"mst_kv_spill_fallbacks_total {spill['spill_fallbacks']}",
        "# TYPE mst_kv_spill_evictions_total counter",
        f"mst_kv_spill_evictions_total {spill['evictions']}",
        "# TYPE mst_kv_spill_bytes gauge",
        f"mst_kv_spill_bytes {spill['bytes_in_use']}",
        "# TYPE mst_kv_spill_budget_bytes gauge",
        f"mst_kv_spill_budget_bytes {spill['budget_bytes']}",
        "# TYPE mst_kv_migration_out_total counter",
        f"mst_kv_migration_out_total {spill['migrations_out']}",
        "# TYPE mst_kv_migration_in_total counter",
        f"mst_kv_migration_in_total {spill['migrations_in']}",
        "# TYPE mst_kv_reprefill_tokens_total counter",
        f"mst_kv_reprefill_tokens_total {spill['reprefill_tokens']}",
        # a replica set's aggregate lacks the residency keys (JAX's .get)
        "# TYPE mst_kv_spill_cold_total counter",
        f"mst_kv_spill_cold_total {spill.get('cold_spills', 0)}",
        "# TYPE mst_kv_spill_wakes_total counter",
        f"mst_kv_spill_wakes_total {spill.get('cold_wakes', 0)}",
        "# TYPE mst_kv_spill_parked gauge",
        f"mst_kv_spill_parked {spill.get('parked', 0)}",
        "# TYPE mst_kv_spill_hit_rate gauge",
        f"mst_kv_spill_hit_rate {spill.get('hit_rate', 0.0):.4f}",
        "# TYPE mst_kv_spill_rejects_total counter",
        f'mst_kv_spill_rejects_total{{reason="oversize"}} {spill.get("rejects_oversize", 0)}',
        f'mst_kv_spill_rejects_total{{reason="closed"}} {spill.get("rejects_closed", 0)}',
        "# TYPE mst_kv_prefetch_enabled gauge",
        f"mst_kv_prefetch_enabled {int(bool(spill.get('prefetch_enabled', False)))}",
        "# TYPE mst_kv_prefetch_total counter",
        f"mst_kv_prefetch_total {spill.get('prefetches', 0)}",
        "# TYPE mst_kv_prefetch_hits_total counter",
        f"mst_kv_prefetch_hits_total {spill.get('prefetch_hits', 0)}",
        "# TYPE mst_kv_prefetch_demand_total counter",
        f"mst_kv_prefetch_demand_total {spill.get('demand_imports', 0)}",
        "# TYPE mst_kv_prefetch_faults_total counter",
        f"mst_kv_prefetch_faults_total {spill.get('prefetch_faults', 0)}",
    ]
    if "migrated_streams" in spill:
        # a replica set's: streams re-placed across replicas by a drain or
        # a crash
        lines += [
            "# TYPE mst_kv_migration_streams_total counter",
            f"mst_kv_migration_streams_total {spill['migrated_streams']}",
        ]


def _prefix_store_lines(ps: dict) -> list:
    """The fleet prefix store: residency by tier, lookup quality, COW
    forks, insertion damping, and evictions by reason."""
    return [
        "# TYPE mst_prefix_store_blocks gauge",
        f'mst_prefix_store_blocks{{tier="device"}} {ps["device_blocks"]}',
        f'mst_prefix_store_blocks{{tier="host"}} {ps["host_blocks"]}',
        "# TYPE mst_prefix_store_bytes gauge",
        f'mst_prefix_store_bytes{{tier="device"}} {ps["device_bytes"]}',
        f'mst_prefix_store_bytes{{tier="host"}} {ps["host_bytes"]}',
        "# TYPE mst_prefix_store_budget_bytes gauge",
        f"mst_prefix_store_budget_bytes {ps['host_budget_bytes']}",
        "# TYPE mst_prefix_store_hits_total counter",
        f'mst_prefix_store_hits_total{{tier="device"}} {ps["hits_device"]}',
        f'mst_prefix_store_hits_total{{tier="host"}} {ps["hits_host"]}',
        "# TYPE mst_prefix_store_misses_total counter",
        f"mst_prefix_store_misses_total {ps['misses']}",
        "# TYPE mst_prefix_store_hit_rate gauge",
        f"mst_prefix_store_hit_rate {ps['hit_rate']:.4f}",
        "# TYPE mst_prefix_store_tokens_reused_total counter",
        f"mst_prefix_store_tokens_reused_total {ps['tokens_reused']}",
        "# TYPE mst_prefix_store_cow_forks_total counter",
        f"mst_prefix_store_cow_forks_total {ps['cow_forks']}",
        "# TYPE mst_prefix_store_inserts_total counter",
        f"mst_prefix_store_inserts_total {ps['inserts']}",
        "# TYPE mst_prefix_store_inserts_damped_total counter",
        f"mst_prefix_store_inserts_damped_total {ps['inserts_damped']}",
        "# TYPE mst_prefix_store_inserts_paused gauge",
        f"mst_prefix_store_inserts_paused {int(bool(ps['inserts_paused']))}",
        "# TYPE mst_prefix_store_demotions_total counter",
        f"mst_prefix_store_demotions_total {ps['demotions']}",
        "# TYPE mst_prefix_store_demote_drops_total counter",
        f"mst_prefix_store_demote_drops_total {ps['demote_drops']}",
        "# TYPE mst_prefix_store_evictions_total counter",
        f'mst_prefix_store_evictions_total{{reason="budget"}} {ps["evictions_budget"]}',
        f'mst_prefix_store_evictions_total{{reason="oversize"}} {ps["evictions_oversize"]}',
        f'mst_prefix_store_evictions_total{{reason="reset"}} {ps["evictions_reset"]}',
        "# TYPE mst_prefix_store_imports_total counter",
        f'mst_prefix_store_imports_total{{kind="staged"}} {ps["imports_staged"]}',
        f'mst_prefix_store_imports_total{{kind="demand"}} {ps["imports_demand"]}',
        "# TYPE mst_prefix_store_faults_total counter",
        f'mst_prefix_store_faults_total{{kind="lookup"}} {ps["lookup_faults"]}',
        f'mst_prefix_store_faults_total{{kind="import"}} {ps["import_faults"]}',
    ]


def _kv_compress_lines(comp: dict) -> list:
    """Compressed-latent KV transport: blocks and bytes moved compressed
    against raw, and the counted degradations."""
    mode = str(comp.get("mode", "latent"))
    return [
        "# TYPE mst_kv_compress_enabled gauge",
        f'mst_kv_compress_enabled{{mode="{mode}"}} 1',
        "# TYPE mst_kv_compress_blocks_total counter",
        f'mst_kv_compress_blocks_total{{op="compress"}} {comp.get("blocks_compressed", 0)}',
        f'mst_kv_compress_blocks_total{{op="reconstruct"}} '
        f'{comp.get("blocks_reconstructed", 0)}',
        "# TYPE mst_kv_compress_faults_total counter",
        f'mst_kv_compress_faults_total{{op="encode"}} {comp.get("compress_faults", 0)}',
        f'mst_kv_compress_faults_total{{op="decode"}} {comp.get("reconstruct_faults", 0)}',
        "# TYPE mst_kv_compress_bytes_total counter",
        f'mst_kv_compress_bytes_total{{kind="raw"}} {comp.get("bytes_raw_total", 0)}',
        f'mst_kv_compress_bytes_total{{kind="wire"}} {comp.get("bytes_wire_total", 0)}',
        "# TYPE mst_kv_compress_bytes_saved gauge",
        f"mst_kv_compress_bytes_saved {comp.get('bytes_saved_total', 0)}",
    ]


def _none():
    return None


def _render_batcher(lines: list, b) -> bool:
    """The families a continuous batcher (or a replica set over batchers)
    feeds, each from a read-out that takes host counters under the
    batcher's locks and never reads the card; a read-out the source lacks
    leaves its family out, as in JAX. Returns whether the speculation
    family was rendered."""
    slots, active, queued = b.stats()
    lines += [
        "# TYPE mst_batch_slots gauge",
        f"mst_batch_slots {slots}",
        "# TYPE mst_batch_slots_active gauge",
        f"mst_batch_slots_active {active}",
        "# TYPE mst_batch_queue_depth gauge",
        f"mst_batch_queue_depth {queued}",
    ]
    pages = getattr(b, "page_stats", _none)()
    if pages is not None:
        total, in_use, high = pages
        lines += [
            "# TYPE mst_kv_pool_pages gauge",
            f"mst_kv_pool_pages {total}",
            "# TYPE mst_kv_pool_pages_in_use gauge",
            f"mst_kv_pool_pages_in_use {in_use}",
            "# TYPE mst_kv_pool_pages_high_water gauge",
            f"mst_kv_pool_pages_high_water {high}",
        ]
        if getattr(b, "overcommit", False):
            lines += [
                "# TYPE mst_preemptions_total counter",
                f"mst_preemptions_total {b.preemptions}",
            ]
    spill = getattr(b, "spill_stats", _none)()
    if spill is not None:
        _render_spill_family(lines, spill)
    kv = getattr(b, "kv_read_stats", _none)()
    if kv is not None:
        path, last_tick, total_bytes = kv
        lines += [
            # 1 = ragged in-place paged attention, 0 = the gather path
            "# TYPE mst_paged_attention_ragged gauge",
            f"mst_paged_attention_ragged {int(path == 'ragged')}",
            "# TYPE mst_kv_bytes_read_last_tick gauge",
            f"mst_kv_bytes_read_last_tick {last_tick}",
            "# TYPE mst_kv_bytes_read_total counter",
            f"mst_kv_bytes_read_total {total_bytes}",
        ]
    hbm = getattr(b, "hbm_bytes_per_token_stats", _none)()
    if hbm is not None:
        lines += [
            "# TYPE mst_decode_hbm_bytes_per_token gauge",
            f'mst_decode_hbm_bytes_per_token{{kind="weights"}} {hbm["weights"]:.1f}',
            f'mst_decode_hbm_bytes_per_token{{kind="kv"}} {hbm["kv"]:.1f}',
        ]
    lat = getattr(b, "latency_stats", _none)()
    if lat is not None:
        # inter-token gaps from the emit path, queue wait from submit to slot
        Histogram.render_into(lines, "mst_itl_seconds", lat.get("itl"))
        Histogram.render_into(lines, "mst_queue_wait_seconds", lat.get("queue_wait"))
    tick = getattr(b, "tick_timing_stats", _none)()
    if tick is not None:
        path = tick["path"]
        lines += [
            "# TYPE mst_sched_async gauge",
            f"mst_sched_async {int(path == 'async')}",
            "# TYPE mst_tick_host_ms gauge",
            f'mst_tick_host_ms{{path="{path}"}} {tick["host_ms_last"]:.3f}',
            "# TYPE mst_tick_device_blocked_ms gauge",
            f'mst_tick_device_blocked_ms{{path="{path}"}} {tick["device_blocked_ms_last"]:.3f}',
            # the resume's import: ~0 when a prefetch staged the pages, the
            # whole host-to-device copy on a demand import
            f'mst_tick_device_blocked_ms{{path="kv_import"}} '
            f"{tick.get('kv_import_ms_last', 0.0):.3f}",
        ]
    spec = getattr(b, "spec_stats", _none)()
    if spec is not None:
        _render_spec_family(lines, spec)
    res = getattr(b, "resilience_stats", _none)()
    if res is not None:
        lines += [
            "# TYPE mst_requests_timeout_total counter",
            f"mst_requests_timeout_total {res['timeouts']}",
            # shed = rejected before any work: the queue bound at submission
            # (429), or the TTFT deadline while queued
            "# TYPE mst_requests_shed_total counter",
            f'mst_requests_shed_total{{reason="queue_full"}} {res["shed_queue_full"]}',
            f'mst_requests_shed_total{{reason="deadline"}} {res["shed_deadline"]}',
            "# TYPE mst_scheduler_thread_live gauge",
            f"mst_scheduler_thread_live {int(bool(res['scheduler_thread_live']))}",
        ]
        if res.get("max_queue") is not None:
            lines += [
                "# TYPE mst_max_queue gauge",
                f"mst_max_queue {res['max_queue']}",
            ]
    _render_fleet(lines, b)
    prefix = getattr(b, "prefix_stats", _none)()
    if prefix is not None:
        queries, hits, reused, evictions, cached = prefix
        lines += [
            "# TYPE mst_prefix_cache_queries_total counter",
            f"mst_prefix_cache_queries_total {queries}",
            "# TYPE mst_prefix_cache_hits_total counter",
            f"mst_prefix_cache_hits_total {hits}",
            "# TYPE mst_prefix_cache_tokens_reused_total counter",
            f"mst_prefix_cache_tokens_reused_total {reused}",
            "# TYPE mst_prefix_cache_evictions_total counter",
            f"mst_prefix_cache_evictions_total {evictions}",
            "# TYPE mst_prefix_cache_pages gauge",
            f"mst_prefix_cache_pages {cached}",
        ]
    return spec is not None


def _render_fleet(lines: list, b) -> None:
    """A replica set's families (``replicas.ReplicaSet``; a disagg
    coordinator's, role-labelled): live replicas and their breakers from
    ``health()``, per-replica routing load, the fleet's size, autoscale
    events and routing hits, the handoff and the brownout level."""
    health = getattr(b, "health", _none)()
    if health is not None and "replicas_total" in health:
        lines += [
            "# TYPE mst_replicas_total gauge",
            f"mst_replicas_total {health['replicas_total']}",
            "# TYPE mst_replicas_live gauge",
            f"mst_replicas_live {health['replicas_live']}",
            "# TYPE mst_replica_breaker_open gauge",
        ]
        lines += [f'mst_replica_breaker_open{{replica="{rep["replica"]}"}} '
                  f"{int(rep['breaker'] != 'closed')}" for rep in health["replicas"]]
        lines.append("# TYPE mst_replica_failures_total counter")
        lines += [f'mst_replica_failures_total{{replica="{rep["replica"]}"}} {rep["failures"]}'
                  for rep in health["replicas"]]
    per_rep = getattr(b, "replica_stats", _none)()
    if per_rep is not None:
        # a role label keeps a disaggregated pool's replicas apart; a
        # monolithic set is unlabeled (breaker_state: 0 closed, 1 half-open,
        # 2 open; weights_shared: 1 = it aliases the store's tree)
        def label(rep):
            role = rep.get("role")
            return (f'replica="{rep["replica"]}",role="{role}"' if role
                    else f'replica="{rep["replica"]}"')

        for fam, key in (("inflight", "inflight"), ("queue_depth", "queue_depth"),
                         ("breaker_state", "breaker_state"),
                         ("weights_shared", "weights_shared")):
            lines.append(f"# TYPE mst_replica_{fam} gauge")
            lines += [f"mst_replica_{fam}{{{label(rep)}}} {int(rep[key])}" for rep in per_rep]
    fleet = getattr(b, "fleet_stats", _none)()
    if fleet is not None:
        lines += [
            "# TYPE mst_fleet_size gauge",
            f"mst_fleet_size {fleet['size']}",
        ]
        lines += [f'mst_fleet_size{{role="{pool["role"]}"}} {pool["size"]}'
                  for pool in fleet.get("pools", []) if pool.get("role")]
        lines.append("# TYPE mst_autoscale_events_total counter")
        events = fleet.get("autoscale_events", {})
        lines += [f'mst_autoscale_events_total{{kind="{kind}"}} {events[kind]}'
                  for kind in sorted(events)]
        if "sticky_hits" in fleet:
            lines += [
                "# TYPE mst_route_sticky_hits_total counter",
                f"mst_route_sticky_hits_total {fleet['sticky_hits']}",
                "# TYPE mst_route_affinity_hits_total counter",
                f"mst_route_affinity_hits_total {fleet['affinity_hits']}",
            ]
        if "store_hits" in fleet:
            lines += [
                "# TYPE mst_route_store_hits_total counter",
                f"mst_route_store_hits_total {fleet['store_hits']}",
            ]
    hand = getattr(b, "handoff_stats", _none)()
    if hand is not None:
        # disaggregated serving: prefill-to-decode handoffs, their bytes and
        # control + copy ms, and the degradation ladder's rungs by kind
        lines += [
            "# TYPE mst_disagg_handoff_total counter",
            f"mst_disagg_handoff_total {hand['handoffs']}",
            "# TYPE mst_disagg_handoff_bytes_total counter",
            f"mst_disagg_handoff_bytes_total {hand['bytes_total']}",
        ]
        Histogram.render_into(lines, "mst_disagg_handoff_ms", hand["ms_hist"])
        lines.append("# TYPE mst_disagg_fallbacks_total counter")
        lines += [f'mst_disagg_fallbacks_total{{kind="{kind}"}} {hand["fallbacks"][kind]}'
                  for kind in sorted(hand["fallbacks"])]
        # full prefix-store hits that skipped the prefill pool
        lines += [
            "# TYPE mst_disagg_store_skips_total counter",
            f"mst_disagg_store_skips_total {hand['store_skips']}",
        ]
    bro = getattr(b, "brownout", None)
    if bro is not None:
        lines += [
            "# TYPE mst_brownout_level gauge",
            f"mst_brownout_level {bro.level()}",
        ]


def _faults_lines() -> list:
    """The fault harness: a site left armed shows on every scrape, as do
    specs dropped at parse time (the disarmed steady state is an explicit
    zero)."""
    from mlx_sharding_tpu_torch.testing import faults

    lines = [
        "# TYPE mst_faults_malformed_total counter",
        f"mst_faults_malformed_total {faults.malformed_total()}",
        "# TYPE mst_faults_armed gauge",
    ]
    armed = faults.armed_sites()
    lines += ([f'mst_faults_armed{{site="{site}"}} {n}' for site, n in sorted(armed.items())]
              if armed else ["mst_faults_armed 0"])
    return lines


def _weight_store_lines(store: dict) -> list:
    """Shared weights: resident trees, the engine refs aliasing them, and
    their bytes (always rendered; zeros mean every engine owns its own)."""
    return [
        "# TYPE mst_weight_store_trees gauge",
        f"mst_weight_store_trees {store['trees']}",
        "# TYPE mst_weight_store_refs gauge",
        f"mst_weight_store_refs {store['refs']}",
        "# TYPE mst_weight_store_bytes gauge",
        f"mst_weight_store_bytes {store['bytes']}",
    ]


def _kv_share_lines(share: dict) -> list:
    """Layer-wise KV sharing: whether a non-identity map is on, its group
    count and the pool bytes it saves."""
    return [
        "# TYPE mst_kv_share_enabled gauge",
        f"mst_kv_share_enabled {int(bool(share.get('enabled')))}",
        "# TYPE mst_kv_share_groups gauge",
        f"mst_kv_share_groups {share.get('groups', 0)}",
        "# TYPE mst_kv_share_bytes_saved gauge",
        f"mst_kv_share_bytes_saved {share.get('bytes_saved', 0)}",
    ]


@dataclass
class ServingMetrics:
    # taken BEFORE any batcher lock: render() calls the batcher's locked
    # read-outs while holding it
    lock: threading.Lock = field(default_factory=lambda: make_lock("ServingMetrics.lock"))
    requests_total: int = 0
    requests_failed: int = 0
    prompt_tokens_total: int = 0
    generation_tokens_total: int = 0
    ttft_s: _Reservoir = field(default_factory=_Reservoir)
    decode_tps: _Reservoir = field(default_factory=_Reservoir)
    ttft_hist: Histogram = field(
        default_factory=lambda: Histogram(LATENCY_BUCKETS_S, "ServingMetrics.ttft_hist"))
    # zero-argument callables returning the live ContinuousBatcher, or the
    # live speculating single-stream generator (or None): callables, so a
    # model hot-swap never leaves a stale reference
    batcher_fn: object = None
    spec_fn: object = None
    # the live prefix_store.PrefixStore, and the KV compression summary
    # (``ModelProvider.kv_compress_stats``), each None when absent
    prefix_store_fn: object = None
    kv_compress_fn: object = None
    # the host's weights.WeightStore (the module's singleton when None), and
    # the KV sharing summary (``ModelProvider.kv_share_stats``, None without
    # a share map)
    weight_store_fn: object = None
    kv_share_fn: object = None
    # the pod's ``pod_stats()`` (``pod.PodFleet``), None off a pod: the
    # mst_pod_* and mst_prefix_pod_* families render only from it
    pod_stats_fn: object = None

    def record_request(self, *, prompt_tokens: int, generation_tokens: int, ttft_s: float,
                       decode_tps: float, failed: bool = False):
        with self.lock:
            self.requests_total += 1
            if failed:
                self.requests_failed += 1
            self.prompt_tokens_total += prompt_tokens
            self.generation_tokens_total += generation_tokens
            if ttft_s > 0:
                self.ttft_s.add(ttft_s)
                self.ttft_hist.observe(ttft_s)
            if decode_tps > 0:
                self.decode_tps.add(decode_tps)

    def render(self) -> str:
        """Prometheus text exposition."""
        with self.lock:
            lines = [
                "# TYPE mst_requests_total counter",
                f"mst_requests_total {self.requests_total}",
                "# TYPE mst_requests_failed_total counter",
                f"mst_requests_failed_total {self.requests_failed}",
                "# TYPE mst_prompt_tokens_total counter",
                f"mst_prompt_tokens_total {self.prompt_tokens_total}",
                "# TYPE mst_generation_tokens_total counter",
                f"mst_generation_tokens_total {self.generation_tokens_total}",
                "# TYPE mst_decode_tokens_per_second summary",
                f'mst_decode_tokens_per_second{{quantile="0.5"}} '
                f"{self.decode_tps.percentile(50):.3f}",
                f'mst_decode_tokens_per_second{{quantile="0.95"}} '
                f"{self.decode_tps.percentile(95):.3f}",
            ]
            Histogram.render_into(lines, "mst_ttft_seconds", self.ttft_hist.to_dict())
            fmark = len(lines)
            try:
                lines += _faults_lines()
            except Exception:  # noqa: BLE001 — scrapes must never 500
                del lines[fmark:]
            # a batcher read-out can die mid-scrape (the batcher closing
            # under a hot-swap): drop its whole section rather than answer
            # 500 or a half-rendered family
            mark = len(lines)
            spec_rendered = False
            try:
                b = self.batcher_fn() if self.batcher_fn is not None else None
                if b is not None:
                    spec_rendered = _render_batcher(lines, b)
            except Exception:  # noqa: BLE001 — scrapes must never 500
                del lines[mark:]
            spec = self.spec_fn() if self.spec_fn is not None and not spec_rendered else None
            if spec is not None and hasattr(spec, "spec_stats"):
                # a single-stream speculating generator, hosted without a
                # batcher: the same family under the same contract
                smark = len(lines)
                try:
                    st = spec.spec_stats()
                    if st is not None:
                        _render_spec_family(lines, st)
                except Exception:  # noqa: BLE001 — scrapes must never 500
                    del lines[smark:]
            elif spec is not None:
                rounds = max(1, spec.rounds)
                lines += [
                    "# TYPE mst_spec_rounds_total counter",
                    f"mst_spec_rounds_total {spec.rounds}",
                    "# TYPE mst_spec_tokens_accepted_total counter",
                    f"mst_spec_tokens_accepted_total {spec.accepted_tokens}",
                    "# TYPE mst_spec_acceptance_rate gauge",
                    f"mst_spec_acceptance_rate {spec.accepted_tokens / rounds:.4f}",
                    "# TYPE mst_spec_fallback_ticks_total counter",
                    f"mst_spec_fallback_ticks_total {getattr(spec, 'fallback_ticks', 0)}",
                    "# TYPE mst_spec_tokens_replayed_total counter",
                    f"mst_spec_tokens_replayed_total {getattr(spec, 'replayed_tokens', 0)}",
                ]
            sections = ((self.weight_store_fn or _host_weight_store,
                         lambda store: _weight_store_lines(store.stats())),
                        (self.prefix_store_fn, lambda store: _prefix_store_lines(store.stats())),
                        (self.kv_share_fn, _kv_share_lines),
                        (self.kv_compress_fn, _kv_compress_lines),
                        (self.pod_stats_fn, _pod_lines))
            for fn, render in sections:
                try:
                    source = fn() if fn is not None else None
                    if source is not None:
                        lines += render(source)
                except Exception:  # noqa: BLE001 — scrapes must never 500
                    pass
        return "\n".join(_finalize(lines)) + "\n"


def _pod_lines(pod: dict) -> list:
    """The pod's families (JAX's): host-labeled liveness, heartbeat age,
    fleet size and weight occupancy from the gossip view, the handoff's
    counters and latency, and the prefix federation's when the pod
    federates a store. Built whole before it joins the scrape, so a gossip
    view that races a host death drops the section instead of answering
    500."""
    lines = [
        "# TYPE mst_pod_hosts gauge",
        f"mst_pod_hosts {len(pod['hosts'])}",
        "# TYPE mst_pod_host_deaths_total counter",
        f"mst_pod_host_deaths_total {pod['autoscaler']['deaths_detected']}",
    ]
    hosts = sorted(pod["hosts"])
    lines.append("# TYPE mst_pod_host_alive gauge")
    lines += [f'mst_pod_host_alive{{host="{h}"}} {int(bool(pod["hosts"][h].get("alive")))}'
              for h in hosts]
    ages = [(h, pod["hosts"][h].get("heartbeat_age_s")) for h in hosts]
    if any(a is not None for _, a in ages):
        lines.append("# TYPE mst_pod_heartbeat_age_seconds gauge")
        lines += [f'mst_pod_heartbeat_age_seconds{{host="{h}"}} {a:.3f}'
                  for h, a in ages if a is not None]
    lines += [f'mst_fleet_size{{host="{h}"}} '
              f"{(pod['hosts'][h].get('fleet') or {}).get('live', 0)}"
              for h in hosts if pod["hosts"][h].get("fleet")]
    for fam in ("trees", "refs", "bytes"):
        lines += [f'mst_weight_store_{fam}{{host="{h}"}} '
                  f"{(pod['hosts'][h].get('weights') or {}).get(fam, 0)}"
                  for h in hosts if pod["hosts"][h].get("weights")]
    ho = pod["handoff"]
    lines += [
        "# TYPE mst_pod_handoff_total counter",
        f"mst_pod_handoff_total {ho['shipped']}",
        "# TYPE mst_pod_handoff_bytes_total counter",
        f"mst_pod_handoff_bytes_total {ho['bytes_shipped']}",
        "# TYPE mst_pod_handoff_received_total counter",
        f"mst_pod_handoff_received_total {ho['received']}",
        "# TYPE mst_pod_handoff_fallbacks_total counter",
    ]
    lines += _by_kind("mst_pod_handoff_fallbacks_total", ho.get("fallbacks") or {})
    if ho.get("ms_p50") is not None:
        lines += [
            "# TYPE mst_pod_handoff_ms summary",
            f'mst_pod_handoff_ms{{quantile="0.5"}} {ho["ms_p50"]:.3f}',
            f'mst_pod_handoff_ms{{quantile="0.99"}} {ho["ms_p99"]:.3f}',
        ]
    pp = pod.get("prefix")
    if pp is not None:
        lines += [
            "# TYPE mst_prefix_pod_inventory_keys gauge",
            f"mst_prefix_pod_inventory_keys {pp.get('inventory_keys', 0)}",
            "# TYPE mst_prefix_pod_hits_total counter",
            f"mst_prefix_pod_hits_total {pp.get('hits', 0)}",
            "# TYPE mst_prefix_pod_fetches_total counter",
            f"mst_prefix_pod_fetches_total {pp.get('fetches', 0)}",
            "# TYPE mst_prefix_pod_fetch_bytes_total counter",
            f"mst_prefix_pod_fetch_bytes_total {pp.get('fetch_bytes', 0)}",
            "# TYPE mst_prefix_pod_fallbacks_total counter",
        ]
        lines += _by_kind("mst_prefix_pod_fallbacks_total", pp.get("fallbacks") or {})
        if pp.get("fetch_ms_p50") is not None:
            lines += [
                "# TYPE mst_prefix_pod_fetch_ms summary",
                f'mst_prefix_pod_fetch_ms{{quantile="0.5"}} {pp["fetch_ms_p50"]:.3f}',
                f'mst_prefix_pod_fetch_ms{{quantile="0.99"}} {pp["fetch_ms_p99"]:.3f}',
            ]
    return lines


def _by_kind(family: str, counts: dict) -> list:
    """A counter's samples by kind, or its explicit zero (a bare ``# TYPE``
    with no sample is invalid exposition)."""
    if not counts:
        return [f"{family} 0"]
    return [f'{family}{{kind="{kind}"}} {counts[kind]}' for kind in sorted(counts)]


def _host_weight_store():
    from mlx_sharding_tpu_torch.weights import weight_store

    return weight_store()


# HELP strings of the families whose meaning is not readable off the name;
# every other family gets one made from its name
_HELP = {
    "mst_requests_total": "Requests served (including failures).",
    "mst_requests_failed_total": "Requests that ended in an error.",
    "mst_ttft_seconds": "Time to first token, seconds (histogram).",
    "mst_itl_seconds": "Inter-token latency from the scheduler emit path, seconds.",
    "mst_queue_wait_seconds": "Admission queue wait, submit to slot assignment, seconds.",
    "mst_decode_tokens_per_second": "Per-request decode rate summary.",
    "mst_tick_host_ms": "Host-side scheduler work per tick, ms.",
    "mst_tick_device_blocked_ms": "Per-tick wall time blocked on the device, ms.",
    "mst_faults_armed": "Currently armed fault-injection sites (should be 0 in prod).",
    "mst_faults_malformed_total": "MST_FAULTS entries dropped as malformed at parse time.",
}


def _help_text(family: str) -> str:
    return _HELP.get(family, family.removeprefix("mst_").replace("_", " ") + ".")


def _infer_type(family: str) -> str:
    return "counter" if family.endswith("_total") else "gauge"


def _family_of(sample: str, histograms: set) -> str:
    name = sample.split("{", 1)[0].split(" ", 1)[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in histograms:
            return name[: -len(suffix)]
    return name


def _finalize(lines: list) -> list:
    """Every family gets a ``# HELP`` ahead of its ``# TYPE``, and a sample
    whose family declared no ``# TYPE`` gets both in front of it."""
    typed = set()
    histograms = set()
    for ln in lines:
        if ln.startswith("# TYPE "):
            parts = ln.split()
            typed.add(parts[2])
            if parts[3] == "histogram":
                histograms.add(parts[2])
    out: list = []
    helped: set = set()
    for ln in lines:
        if ln.startswith("# HELP "):
            helped.add(ln.split()[2])
            out.append(ln)
            continue
        if ln.startswith("# TYPE "):
            fam = ln.split()[2]
            if fam not in helped:
                out.append(f"# HELP {fam} {_help_text(fam)}")
                helped.add(fam)
            out.append(ln)
            continue
        if not ln or ln.startswith("#"):
            out.append(ln)
            continue
        fam = _family_of(ln, histograms)
        if fam not in typed:
            out.append(f"# HELP {fam} {_help_text(fam)}")
            out.append(f"# TYPE {fam} {_infer_type(fam)}")
            helped.add(fam)
            typed.add(fam)
        out.append(ln)
    return out
