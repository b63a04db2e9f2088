"""The port's pod (``mlx_sharding_tpu_torch/pod.py``) against the JAX
package's loopback pod: the cases of ``tests/test_pod_fleet.py`` and
``tests/test_prefix_federation.py``, each scenario run through both
packages and its outcome compared.

Two simulated hosts share one process over a ``LoopbackHub``: host 0 a
disagg coordinator (prefill and decode pools of one batcher each, its
decode pool priced as saturated so that every handoff prefers the
remote), host 1 a plain batcher; the tiny f32 Llama of
``tests/test_torch_scheduler.py`` over 2 slots and a 10-page pool. The
batchers are shared by the module; every test builds its own hubs and
fleets, and the fixtures reset the fault registry, the weight store and
tracing after each test (no state crosses a test).

Greedy streams through the pod are token-identical to JAX's monolithic
batcher; a seeded sampled stream (which the packages draw differently)
equals the port's own monolithic batcher. Counters compare by kind;
bytes on the wire differ (each package has its own wire format) and are
only checked to be positive."""

import http.client
import json
import pickle
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import disagg as jdisagg
from mlx_sharding_tpu import kv_transfer as jkv
from mlx_sharding_tpu import pod as jpod
from mlx_sharding_tpu import prefix_store as jps
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import resilience as jres
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu import tracing as jtracing
from mlx_sharding_tpu import weights as jweights
from mlx_sharding_tpu.cache import KVCache
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu.utils import observability as jobs
from mlx_sharding_tpu_torch import disagg as tdisagg
from mlx_sharding_tpu_torch import kv_transfer as tkv
from mlx_sharding_tpu_torch import pod as tpod
from mlx_sharding_tpu_torch import prefix_store as tps
from mlx_sharding_tpu_torch import replicas as treplicas
from mlx_sharding_tpu_torch import resilience as tres
from mlx_sharding_tpu_torch import tracing as ttracing
from mlx_sharding_tpu_torch import weights as tweights
from mlx_sharding_tpu_torch.cache import PagedKV
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults as tfaults
from mlx_sharding_tpu_torch.utils import observability as tobs
from tests.test_torch_kv_transfer import one_torch_thread  # noqa: F401
from tests.test_torch_scheduler import models  # noqa: F401

PAGE = 8
ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=PAGE)
GREEDY = ([3, 17, 42], dict(max_tokens=24))
SAMPLED = ([9, 4, 4, 6], dict(temperature=0.9, top_p=0.85, seed=321, repetition_penalty=1.3,
                              repetition_context_size=8, max_tokens=20))
BASE = [7, 7, 2, 1, 9, 4, 4, 6, 3, 17, 42, 5, 11, 2, 2, 8]
# the pods' heartbeat timeout: these pods gossip once, and under the test
# run's workers a first JAX compile can outlast the default 10 s between
# that gossip and a handoff, which then finds its peer stale and serves
# in place
HEARTBEAT_S = 3600.0
PKGS = {
    "jax": SimpleNamespace(pod=jpod, faults=jfaults, kv=jkv, ps=jps, res=jres, obs=jobs,
                           weights=jweights),
    "port": SimpleNamespace(pod=tpod, faults=tfaults, kv=tkv, ps=tps, res=tres, obs=tobs,
                            weights=tweights),
}


@pytest.fixture(autouse=True)
def _reset_process_state():
    """Faults, tracing and the host's weight store as a fresh process has
    them, after every test."""
    yield
    tfaults.disarm()
    jfaults.disarm()
    ttracing.configure("off")
    jtracing.configure("off")
    for mod in (tweights, jweights):
        if mod._STORE is not None and mod._STORE.stats()["trees"] == 0:
            mod._STORE = None


def _toks(stream):
    return [t for t, _ in stream]


def _jbatcher(models, dev, store=None):
    jm, params, _ = models
    devices = jax.devices()
    eng = JPipelineEngine(jm, params, make_mesh(pp=1, devices=devices[dev:dev + 1]),
                          cache_dtype=jnp.float32, **ENGINE)
    return jscheduler.ContinuousBatcher(eng, decode_block=3, prefix_store=store)


def _tbatcher(models, store=None):
    return ContinuousBatcher(PipelineEngine(models[2], device="cpu", **ENGINE), decode_block=3,
                             prefix_store=store)


@pytest.fixture(scope="module")
def engines(models):
    """Per package: host 0's coordinator, host 1's batcher, and the
    monolithic references (the greedy one JAX's, the sampled one each
    package's own)."""
    out = {}
    jmono, tmono = _jbatcher(models, 3), _tbatcher(models)
    greedy = _toks(jmono.generate_step(*GREEDY[:1], **GREEDY[1]))
    for pkg in ("jax", "port"):
        if pkg == "jax":
            co = jdisagg.DisaggCoordinator(
                jreplicas.ReplicaSet([_jbatcher(models, 0)], role="prefill"),
                jreplicas.ReplicaSet([_jbatcher(models, 1)], role="decode"))
            b1, mono = _jbatcher(models, 2), jmono
        else:
            co = tdisagg.DisaggCoordinator(
                treplicas.ReplicaSet([_tbatcher(models)], role="prefill"),
                treplicas.ReplicaSet([_tbatcher(models)], role="decode"))
            b1, mono = _tbatcher(models), tmono
        out[pkg] = SimpleNamespace(co=co, b1=b1, greedy=greedy,
                                   sampled=_toks(mono.generate_step(SAMPLED[0], **SAMPLED[1])))
    assert _toks(tmono.generate_step(GREEDY[0], **GREEDY[1])) == greedy
    yield out
    for e in out.values():
        e.co.close()
        e.b1.close()
    jmono.close()
    tmono.close()


@contextmanager
def _pod(engines, pkg):
    """A fresh two-host loopback pod of ``pkg`` around the shared engines."""
    e, mod = engines[pkg], PKGS[pkg].pod
    hub = mod.LoopbackHub()
    f0 = mod.PodFleet(0, hub.register(0), e.co, heartbeat_timeout_s=HEARTBEAT_S)
    f1 = mod.PodFleet(1, hub.register(1), e.b1, heartbeat_timeout_s=HEARTBEAT_S)
    f0.tick()
    f1.tick()
    f0.handoff.local_pressure = lambda: 1.0
    try:
        yield SimpleNamespace(hub=hub, f0=f0, f1=f1, co=e.co, greedy=e.greedy,
                              sampled=e.sampled)
    finally:
        f0.close(close_local=False)
        f1.close(close_local=False)
        e.co.pod = None


def _handoff(stats):
    """A handoff's counters that both packages count alike."""
    return {k: stats[k] for k in ("shipped", "received", "relayed_tokens", "fallbacks")}


# ------------------------------------------------------- cross-host handoff
def test_cross_host_handoff_parity_matches_jax(engines):
    """A greedy and a sampled request through host 0's coordinator decode
    on host 1: the greedy stream equals the monolithic batcher's, the
    sampled one its own package's monolithic stream; shipped, received,
    relayed and fallbacks equal JAX's pod's."""
    out = {}
    for pkg in PKGS:
        with _pod(engines, pkg) as pod:
            assert _toks(pod.co.generate_step(GREEDY[0], **GREEDY[1])) == pod.greedy
            greedy = _handoff(pod.f0.handoff.stats())
            assert _toks(pod.co.generate_step(SAMPLED[0], **SAMPLED[1])) == pod.sampled
            h = pod.f0.handoff.stats()
            assert h["bytes_shipped"] > 0 and h["ms_p50"] is not None
            out[pkg] = (greedy, h["shipped"], h["fallbacks"],
                        pod.f1.handoff.stats()["received"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"shipped": 1, "received": 0, "relayed_tokens": 23,
                              "fallbacks": {}}
    assert out["port"][1:] == (2, {}, 2)


def test_pick_remote_tie_serves_locally_as_jax(engines):
    """An equally loaded remote never wins (the wire is not free); a
    cheaper one does."""
    for pkg in PKGS:
        with _pod(engines, pkg) as pod:
            pod.f0.handoff.local_pressure = lambda: 0.0
            assert pod.f0.handoff.pick_remote() is None
            pod.f0.handoff.local_pressure = lambda: 1.0
            assert pod.f0.handoff.pick_remote() == 1
            assert pod.f0.handoff.stats()["fallbacks"] == {}


def test_a_stale_peer_is_not_picked_as_jax(engines):
    """A peer whose heartbeat is older than the timeout leaves routing:
    one gossip, then more than ``heartbeat_timeout_s`` on the clock, and
    the handoff serves in place (what a slow first compile does between a
    pod's one gossip and its handoffs, in both packages)."""
    out = {}
    for pkg in PKGS:
        mod, e = PKGS[pkg].pod, engines[pkg]
        clk = [0.0]
        hub = mod.LoopbackHub(clock=lambda clk=clk: clk[0])
        kw = dict(heartbeat_timeout_s=10.0, clock=lambda clk=clk: clk[0])
        f0 = mod.PodFleet(0, hub.register(0), e.co, **kw)
        f1 = mod.PodFleet(1, hub.register(1), e.b1, **kw)
        try:
            f0.tick()
            f1.tick()
            f0.handoff.local_pressure = lambda: 1.0
            fresh = f0.handoff.pick_remote()
            clk[0] += 11.0
            out[pkg] = (fresh, f0.handoff.pick_remote(), f0.handoff.stats()["fallbacks"])
        finally:
            f0.close(close_local=False)
            f1.close(close_local=False)
            e.co.pod = None
    assert out["port"] == out["jax"] == (1, None, {})


def test_remote_unavailable_falls_back_as_jax():
    """No peer at all: ``serve_remote`` raises the counted fallback, the
    block kept for the local leg."""
    for pkg in PKGS:
        mod = PKGS[pkg]
        hub = mod.pod.LoopbackHub()
        h = mod.pod.PodHandoff(0, hub.register(0), local_pressure=lambda: 1.0)
        state = mod.res.ResumeState(prompt=np.array([1, 2], np.int32), history=[], produced=0)
        with pytest.raises(mod.pod.PodHandoffFallback) as info:
            next(h.serve_remote(state, {}))
        assert info.value.kind == "remote_unavailable" and info.value.keep_block
        assert h.stats()["fallbacks"] == {"remote_unavailable": 1}


class _Broken:
    def generate_step(self, prompt, **kw):
        raise RuntimeError("remote pool down")
        yield  # pragma: no cover


def _inject(pkg, pod, kind, monkeypatch):
    """The same failure in either package's pod."""
    mod = PKGS[pkg]
    if kind == "handoff_fault":
        mod.faults.arm("pod.handoff", exc=mod.faults.FaultError, times=1)
    elif kind == "serialize_error":
        def boom(self):
            raise RuntimeError("unserializable")
        monkeypatch.setattr(mod.kv.KVPageBlock, "to_bytes", boom)
    elif kind == "transfer_fault":
        pod.hub.kill(1)  # the heartbeat is fresh: the pick holds, the send bounces
    elif kind == "remote_error":
        pod.f1.handoff.attach_local(_Broken())


@pytest.mark.parametrize("kind", ["handoff_fault", "serialize_error", "transfer_fault",
                                  "remote_error"])
def test_each_fallback_kind_lands_on_the_local_plan_as_jax(engines, kind, monkeypatch):
    """Each degradation of the ladder under the same injected fault: the
    stream equals the monolithic one, the fallback is counted by kind, and
    ``shipped`` is JAX's (1 only when the block crossed before the
    failure)."""
    out = {}
    for pkg in PKGS:
        with _pod(engines, pkg) as pod, monkeypatch.context() as m:
            _inject(pkg, pod, kind, m)
            assert _toks(pod.co.generate_step(GREEDY[0], **GREEDY[1])) == pod.greedy
            h = pod.f0.handoff.stats()
            out[pkg] = (h["fallbacks"], h["shipped"])
        PKGS[pkg].faults.disarm()
    assert out["port"] == out["jax"]
    assert out["port"] == ({kind: 1}, int(kind == "remote_error"))


def test_host_death_mid_relay_drains_token_exact_as_jax(engines):
    """The remote goes silent after 2 relayed tokens: the origin's relay
    times out and resumes locally after them; the stream stays the
    monolithic one and the counts are JAX's."""
    out = {}
    for pkg in PKGS:
        with _pod(engines, pkg) as pod:
            orig = pod.hub._handlers[0]
            seen = [0]

            def silent_death(src, kind, payload, orig=orig, seen=seen):
                if kind == "pod.tok":
                    seen[0] += 1
                    if seen[0] > 2:
                        return
                elif kind == "pod.end":
                    return
                orig(src, kind, payload)

            pod.hub._handlers[0] = silent_death
            pod.f0.handoff.relay_timeout_s = 1.0
            assert _toks(pod.co.generate_step(GREEDY[0], **GREEDY[1])) == pod.greedy
            out[pkg] = _handoff(pod.f0.handoff.stats())
    assert out["port"] == out["jax"]
    assert out["port"]["fallbacks"] == {"relay_timeout": 1}
    assert out["port"]["relayed_tokens"] == 2


def test_pod_stats_reflect_a_death_as_jax(engines):
    """A stale heartbeat under an injected clock: host 1 leaves the live
    view, the autoscaler records it once, ``pod_stats`` shows it, with
    JAX's keys."""
    out = {}
    for pkg in PKGS:
        mod, e = PKGS[pkg].pod, engines[pkg]
        clk = [0.0]
        hub = mod.LoopbackHub(clock=lambda clk=clk: clk[0])
        kw = dict(heartbeat_timeout_s=5.0, clock=lambda clk=clk: clk[0])
        f0 = mod.PodFleet(0, hub.register(0), e.co, **kw)
        f1 = mod.PodFleet(1, hub.register(1), e.b1, **kw)
        try:
            f0.tick()
            f1.tick()
            alive = f0.pod_stats()["hosts"]["1"]["alive"]
            clk[0] += 6.0
            f0.tick()
            st = f0.pod_stats()
            out[pkg] = (alive, st["hosts"]["1"]["alive"], st["autoscaler"]["dead_hosts"],
                        st["host_deaths"], _keys(st))
        finally:
            f0.close(close_local=False)
            f1.close(close_local=False)
            e.co.pod = None
    assert out["port"] == out["jax"]
    assert out["port"][:4] == (True, False, [1], 1)


def _keys(tree):
    """The nested key structure of a stats dict (values dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


# ---------------------------------------------------------- pod autoscaler
class _Ctrl:
    """A fleet controller stand-in: fixed pressure and headroom, records
    the nudges."""

    def __init__(self, pressure=0.0, spawnable=0, drainable=0, slots=4):
        self._p, self._spawnable, self._drainable = pressure, spawnable, drainable
        self.actions = []
        self.rs = SimpleNamespace(stats=lambda: (slots, 0, 0))

    def pressure(self):
        return self._p

    def headroom(self):
        return {"live": 1, "spawnable": self._spawnable, "drainable": self._drainable}

    def spawn_one(self):
        self.actions.append("spawn")
        return "spawn"

    def drain_one(self):
        self.actions.append("drain")
        return "drain"


def _fleet_info(pressure, spawnable=0, drainable=0, slots=4):
    return {"pressure": pressure, "slots": slots, "live": 1, "spawnable": spawnable,
            "drainable": drainable}


def _autoscale(mod, scenario):
    """One scripted run of a pod autoscaler under an injected clock: each
    tick's decision, the nudges, the deaths and the final state."""
    clk = [0.0]
    hub = mod.LoopbackHub(clock=lambda: clk[0])
    t0, t1 = hub.register(0), hub.register(1)
    deaths = []
    if scenario == "spawn":
        ctrl = _Ctrl(pressure=0.8, spawnable=1)
        steps = [lambda: t1.publish({"fleet": _fleet_info(0.95)}),
                 lambda: (t1.publish({"fleet": _fleet_info(0.76, spawnable=1)}),
                          setattr(ctrl, "_p", 0.95))]
    elif scenario == "drain":
        ctrl = _Ctrl(pressure=0.2, drainable=1)
        steps = [lambda: t1.publish({"fleet": _fleet_info(0.05)}),
                 lambda: t1.publish({"fleet": _fleet_info(0.22, drainable=1)})]
    else:
        ctrl = _Ctrl(pressure=0.5)
        steps = [lambda: t1.publish({"fleet": _fleet_info(0.5)}),
                 lambda: clk.__setitem__(0, clk[0] + 6.0), lambda: None]
    a = mod.PodAutoscaler(0, t0, [ctrl], heartbeat_timeout_s=5.0, on_host_death=deaths.append,
                          clock=lambda: clk[0])
    ticks = []
    for step in steps:
        step()
        ticks.append(a.tick())
    return ticks, ctrl.actions, deaths, a.state()


@pytest.mark.parametrize("scenario", ["spawn", "drain", "death"])
def test_autoscaler_decisions_equal_jax(scenario):
    """The least-loaded host with headroom spawns, the most loaded
    drainable one drains, and a stale heartbeat is declared dead once:
    every tick's decision and the state equal JAX's pod autoscaler's on
    the same gossip and clock."""
    got, want = _autoscale(tpod, scenario), _autoscale(jpod, scenario)
    assert got == want
    ticks, actions, deaths, _ = got
    if scenario == "spawn":
        assert [t["action"] for t in ticks] == ["spawn", None] and actions == ["spawn"]
    elif scenario == "drain":
        assert [t["action"] for t in ticks] == ["drain", None] and actions == ["drain"]
    else:
        assert [t["dead"] for t in ticks] == [[], [1], [1]] and deaths == [1]


# ------------------------------------------------------------ weight gossip
def _registry(mod):
    """Build-once, the pod view and the teardown broadcast of one
    package's registry over its own store and hub."""
    key = mod.weights.WeightKey(checkpoint="ck", stage_bounds=(("auto", 1),), dtype="float32",
                                quant="none", placement="h0")
    store = mod.weights.WeightStore()
    builds = []
    a = store.acquire(key, lambda: builds.append(1) or object())
    b = store.acquire(key, lambda: builds.append(1) or object())
    reg = mod.pod.PodWeightRegistry(store=store)
    info = reg.local_info()
    view = reg.pod_view({1: {"info": {"weights": {"trees": 1, "refs": 3, "bytes": 17}}},
                         2: {"info": {}}})
    torn = []
    reg.set_teardown_handler(torn.append)
    found = (reg.handle_teardown(mod.weights.key_digest(key)) == key,
             reg.handle_teardown("ffffffffffffffff"))
    hub = mod.pod.LoopbackHub()
    t0, t1 = hub.register(0), hub.register(1)
    t1.set_handler(lambda src, kind, payload: reg.handle_teardown(payload.decode()))
    t1.publish({})
    sender = mod.pod.PodWeightRegistry(store=mod.weights.WeightStore())
    sender.request_teardown(t0, mod.weights.key_digest(key))
    b.release()
    a.release()
    return (len(builds), info["trees"], info["refs"], list(info["digests"]), view, found,
            len(torn), sender.teardowns_sent, reg.teardowns_received)


def test_registry_pod_view_and_teardown_broadcast_equal_jax():
    """One tree built once for two leases; the gossip view, the digest
    mapped back onto the local key, and the teardown broadcast over the
    fabric: every answer equals JAX's registry's."""
    got = _registry(PKGS["port"])
    assert got == _registry(PKGS["jax"])
    assert got[:3] == (1, 1, 2) and got[4] == {1: {"trees": 1, "refs": 3, "bytes": 17}}
    assert got[6:] == (2, 1, 3)


# ------------------------------------------------------- prefix federation
def _pure_prefix_block(pkg, tokens=BASE, share_hash=None):
    """The same pure-prefix block (pages 0 and 1 of a hand-made pool) in
    either package, flushed to the host."""
    shape = (1, 2, 4, 1, PAGE, 2, 4)
    vals = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    kw = dict(page_size=PAGE, n_tokens=2 * PAGE, prompt=list(tokens), history=[], produced=0,
              resume_recent=None, share_hash=share_hash)
    if pkg == "jax":
        cache = KVCache(k=jnp.asarray(vals), v=jnp.asarray(vals + 1000.0),
                        offset=jnp.zeros((), jnp.int32))
        return jkv.export_block(cache, [0, 1], resume_keys=None, **kw).to_host()
    k = torch.from_numpy(np.ascontiguousarray(vals[0, :, :, 0]))
    cache = PagedKV(k=k, v=k + 1000.0, offsets=[0])
    return tkv.export_block(cache, [0, 1], resume_gen=None, **kw).to_host()


class _FakeTransport:
    """The slice of the fabric the federation touches: a static ``peers()``
    view and a captured ``send`` with an optional synchronous responder."""

    def __init__(self, peers=None):
        self._peers = dict(peers or {})
        self.sent = []
        self.respond = None

    def peers(self):
        return self._peers

    def send(self, host, kind, payload):
        self.sent.append((host, kind, payload))
        if self.respond is not None:
            self.respond(host, kind, payload)


def _peer(keys, *, age_s=0.0, page_size=PAGE, share=None):
    return {"info": {"prefix": {"keys": list(keys), "page_size": page_size, "share": share}},
            "age_s": age_s}


def _respond_with(fed, kind, data):
    def responder(host, msg_kind, payload):
        rid = pickle.loads(payload)["rid"]
        fed.handle(host, kind, pickle.dumps((rid, data)))
    return responder


FETCH_CASES = ["fetch_fault", "miss_then_neg_cached", "neg_cache_expires", "owner_dead",
               "timeout", "stale_inventory", "corrupt_blob", "geometry_mismatch",
               "share_mismatch", "host_reject", "roundtrip", "owner_choice"]


def _fetch_case(pkg, case):
    """One federation scenario of ``tests/test_prefix_federation.py`` in
    ``pkg``: the fetch results, the stats (fetch times dropped) and what
    went on the wire."""
    mod = PKGS[pkg]
    now = [100.0]
    store = mod.ps.PrefixStore(host_bytes=1 if case == "host_reject" else 1 << 20)
    page = 16 if case == "geometry_mismatch" else PAGE
    store.bind_page_size(page)
    digest = store.digests_for(list(range(40)) if page == 16 else BASE + [5])[-1]
    peers = {1: _peer([digest.hex()], page_size=page)}
    if case in ("miss_then_neg_cached", "neg_cache_expires"):
        peers = {}
    if case == "owner_choice":
        peers = {1: _peer([digest.hex()], age_s=1.2), 2: _peer([digest.hex()], age_s=0.1),
                 3: _peer([digest.hex()], page_size=16),
                 4: _peer([digest.hex()], share="deadbeef"), 5: _peer([])}
    t = _FakeTransport(peers)
    fed = mod.pod.PodPrefixFederation(0, t, store, fetch_timeout_s=0.05, neg_cache_s=30.0,
                                      clock=lambda: now[0])
    results = []
    try:
        if case == "owner_choice":
            return fed._owner_for(digest.hex())
        if case == "fetch_fault":
            mod.faults.arm("pod.prefix_fetch", exc=mod.faults.FaultError)
        elif case == "owner_dead":
            t.respond = lambda *a: 1 / 0
        elif case == "stale_inventory":
            t.respond = _respond_with(fed, "prefix.miss", b"")
        elif case in ("corrupt_blob", "geometry_mismatch", "share_mismatch", "host_reject",
                      "roundtrip"):
            blob = _pure_prefix_block(pkg, share_hash="feedface" if case == "share_mismatch"
                                      else None).to_bytes()
            if case == "corrupt_blob":
                blob = bytearray(blob)
                blob[-3] ^= 0xFF
                blob = bytes(blob)
            t.respond = _respond_with(fed, "prefix.blob", blob)
        results.append(fed.fetch(digest))
        if case in ("miss_then_neg_cached", "stale_inventory"):
            results.append(fed.fetch(digest))
        if case == "neg_cache_expires":
            now[0] += 31.0
            results.append(fed.fetch(digest))
        st = fed.stats()
        st.pop("fetch_ms_p50")
        st.pop("fetch_ms_p99")
        if case == "roundtrip":
            st["fetch_bytes"] = st["fetch_bytes"] > 0
            results.append(store.host_contains(digest))
        return results, st, [(h, kind) for h, kind, _ in t.sent], fed._waiters == {}
    finally:
        mod.faults.disarm()
        store.close()


@pytest.mark.parametrize("case", FETCH_CASES)
def test_prefix_fetch_outcomes_equal_jax(case):
    """Each fetch outcome of the federation (a fault before the wire, a
    pod-wide miss and its negative cache, a dead or silent owner, an
    eviction since the gossip, a corrupt, mis-sized or mis-shared blob, a
    host-tier reject, a good fetch, the owner's choice) is counted by kind
    exactly as JAX's federation counts it."""
    got = _fetch_case("port", case)
    assert got == _fetch_case("jax", case)
    if case == "roundtrip":
        assert got[0] == [True, True] and got[1]["fetches"] == 1
    elif case == "owner_choice":
        assert got == (2, None)
    else:
        assert False not in [r is False for r in got[0]]


def test_prefix_serve_side_answers_as_jax():
    """Owner side: a ``prefix.fetch`` is served off the receive thread with
    the exported blob, which the requester's package decodes; a digest the
    tier does not hold answers ``prefix.miss``."""
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg]
        store = mod.ps.PrefixStore(host_bytes=1 << 20)
        store.bind_page_size(PAGE)
        digest = store.digests_for(BASE + [5])[-1]
        store.host_put(digest, _pure_prefix_block(pkg))
        t = _FakeTransport()
        fed = mod.pod.PodPrefixFederation(0, t, store)
        replies = []
        for rid, dig in (("r1", digest), ("r2", store.digests_for(list(range(50, 67)))[-1])):
            assert fed.handle(9, "prefix.fetch", pickle.dumps({"rid": rid, "digest": dig}))
            deadline = time.monotonic() + 5.0
            while len(t.sent) < len(replies) + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            host, kind, payload = t.sent[-1]
            back_rid, data = pickle.loads(payload)
            replies.append((host, kind, back_rid, len(data) > 0))
            if data:
                assert mod.kv.KVPageBlock.from_bytes(data).n_tokens == 2 * PAGE
        s = fed.stats()
        out[pkg] = (replies, s["blobs_served"], s["bytes_served"] > 0,
                    fed.handle(9, "weights.have", b"x"))
        store.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(9, "prefix.blob", "r1", True), (9, "prefix.miss", "r2", False)]


def _federated_run(pkg, models):
    """A prefix made hot on host A and continued on host B through one
    blob fetch, then a faulted fetch on a second prefix: the streams and
    each side's counts."""
    mod = PKGS[pkg]
    stores = [mod.ps.PrefixStore(host_bytes=1 << 20) for _ in range(2)]
    for store in stores:
        store._host._flush_async = False  # a demotion reaches the host tier at the release
    if pkg == "jax":
        a, b = _jbatcher(models, 4, stores[0]), _jbatcher(models, 5, stores[1])
    else:
        a, b = _tbatcher(models, stores[0]), _tbatcher(models, stores[1])
    hub = mod.pod.LoopbackHub()
    fa = mod.pod.PodFleet(0, hub.register(0), a, prefix_store=stores[0],
                          heartbeat_timeout_s=HEARTBEAT_S)
    fb = mod.pod.PodFleet(1, hub.register(1), b, prefix_store=stores[1],
                          heartbeat_timeout_s=HEARTBEAT_S)
    base2 = [11, 3, 3, 1, 2, 8, 8, 5, 9, 1, 40, 6, 12, 7, 7, 2]

    def demoted(prompt):
        # the stream ends before the scheduler releases its slot: the
        # prefix joins host A's tier (and its gossip) at that release
        digest = stores[0].digests_for(prompt)[-1]
        deadline = time.monotonic() + 30
        while not stores[0].host_contains(digest) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert stores[0].host_contains(digest)

    try:
        _toks(a.generate_step(BASE + [5], max_tokens=12))
        demoted(BASE + [5])
        fa.tick()
        fb.tick()
        streams = [_toks(b.generate_step(BASE + [9], max_tokens=12)),
                   _toks(b.generate_step(BASE + [3], max_tokens=8))]
        first = (fb.prefix.stats()["fetches"], fa.prefix.stats()["blobs_served"],
                 stores[1].stats()["tokens_reused"] >= 2 * PAGE)
        _toks(a.generate_step(base2 + [5], max_tokens=12))
        demoted(base2 + [5])
        fa.tick()
        fb.tick()
        mod.faults.arm("pod.prefix_fetch", exc=mod.faults.FaultError, times=4)
        streams.append(_toks(b.generate_step(base2 + [9], max_tokens=12)))
        st = fb.prefix.stats()
        return streams, first, st["fetches"], st["fallbacks"].get("fetch_fault", 0) >= 1
    finally:
        mod.faults.disarm()
        fa.close(close_local=False)
        fb.close(close_local=False)
        a.close()
        b.close()
        for s in stores:
            s.close()


def test_federated_prefix_prefills_once_pod_wide_as_jax(models):
    """Two real batchers on a loopback pod: the prefix made hot on host A
    is continued on host B with one counted blob fetch and its tokens
    reused, then served from B's own tier; a faulted fetch prefills plain.
    Streams and counts equal JAX's pod's."""
    got = _federated_run("port", models)
    assert got == _federated_run("jax", models)
    assert got[1:] == ((1, 1, True), 1, True)


# ------------------------------------------------------------ observability
def _families(text):
    """Each sample's name and label keys (values dropped)."""
    out = set()
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        name = ln.split(" ", 1)[0]
        labels = ""
        if "{" in name:
            name, labels = name.split("{", 1)
            labels = ",".join(sorted(kv.split("=")[0] for kv in labels.rstrip("}").split(",")))
        out.add((name, labels))
    return out


def test_pod_metrics_and_health_block_carry_jax_names_and_keys(engines):
    """After one handoff and one injected fault, ``/metrics`` renders the
    same ``mst_pod_*`` families (names and labels) as JAX's, each TYPEd
    once; ``/health``'s ``pod`` block carries JAX's keys, and a broken pod
    surface leaves ``/health`` up without it."""
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg]
        with _pod(engines, pkg) as pod:
            _toks(pod.co.generate_step(GREEDY[0], **GREEDY[1]))
            mod.faults.arm("pod.handoff", exc=mod.faults.FaultError, times=1)
            _toks(pod.co.generate_step(GREEDY[0], **GREEDY[1]))
            text = mod.obs.ServingMetrics(pod_stats_fn=pod.f0.pod_stats).render()
            types = [ln for ln in text.splitlines() if ln.startswith("# TYPE ")]
            assert len(types) == len(set(types))
            assert 'mst_pod_handoff_fallbacks_total{kind="handoff_fault"} 1' in text
            assert "mst_pod_handoff_total 1" in text
            fams = {f for f in _families(text) if "pod" in f[0] or "host" in f[1]}
            if pkg == "jax":
                out[pkg] = (fams, _keys(pod.f0.pod_stats()))
                continue
            provider = ModelProvider(SimpleNamespace(), None, model_name="tiny")
            provider.pod_fleet = pod.f0
            srv = make_server(provider, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                health = []
                for _ in range(2):
                    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                                      timeout=30)
                    conn.request("GET", "/health")
                    resp = conn.getresponse()
                    health.append((resp.status, json.loads(resp.read())))
                    conn.close()
                    provider.pod_fleet = SimpleNamespace(
                        pod_stats=lambda: (_ for _ in ()).throw(RuntimeError("x")))
            finally:
                srv.shutdown()
                srv.server_close()
            (s1, h1), (s2, h2) = health
            assert s1 == s2 == 200 and "pod" not in h2
            assert h1["pod"]["host_id"] == 0 and set(h1["pod"]["hosts"]) == {"0", "1"}
            out[pkg] = (fams, _keys(h1["pod"]))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("source", ["absent", "none", "broken"])
def test_pod_metrics_absent_off_a_pod_and_never_500(source):
    """Without a pod (no source, or one answering None) no ``mst_pod_``
    family renders, and a source that raises drops the section instead of
    failing the scrape, in both packages."""
    def broken():
        raise RuntimeError("pod stats exploded")

    fn = {"absent": None, "none": lambda: None, "broken": broken}[source]
    for mod in (tobs, jobs):
        assert "mst_pod_" not in mod.ServingMetrics(pod_stats_fn=fn).render()


def test_collective_transport_raises_naming_slice_9b3():
    """The pod's fabric over the collectives is ported (slice 9b.3c): no
    refusal names the slice. Over a plane that reports itself dead, both
    packages' transports refuse to send with the same error and report
    every known peer at infinite age, so death detection fires; one tick's
    heartbeat from a peer is seen alike (its two-process run over gloo:
    ``tests/test_torch_pod_collective.py``)."""
    class Plane:
        blob_bytes = 4096
        dead = False

        def __init__(self, headers, blobs):
            self.out = (headers, blobs)

        def pod_exchange(self, header, blob):
            return self.out

    peer = pickle.dumps({"fleet": {"slots": 2}})
    frame = (np.asarray([1], np.int32).tobytes() + np.asarray([-1, 2, len(peer)], np.int32)
             .tobytes() + b"hb" + peer)
    headers = np.asarray([[1, 0, 1, 0, 0, 0, 0, 0], [1, 1, 1, len(frame), 0, 0, 0, 0]],
                         np.int32)
    blobs = np.zeros((2, 4096), np.uint8)
    blobs[1, :len(frame)] = np.frombuffer(frame, np.uint8)
    seen = {}
    for name, pod in (("port", tpod), ("jax", jpod)):
        plane = Plane(headers, blobs)
        t = pod.CollectiveTransport(plane=plane)
        t.tick()
        alive = t.peers()
        plane.dead = True
        dead = t.peers()
        with pytest.raises(pod.PodTransportError, match="pod fabric is down"):
            t.send(1, "handoff.block", b"x")
        seen[name] = (alive[1]["info"], alive[1]["age_s"] < 60, dead[1]["age_s"])
    assert seen["port"] == seen["jax"] == ({"fleet": {"slots": 2}}, True, float("inf"))
