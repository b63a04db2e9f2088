"""The server's fleet surfaces in the port against the JAX server, on the
CPU: the refusals of ``--kv-share-map``, ``--replicas`` and
``--shared-weights`` with JAX's messages; a replica set of two paged
batchers under a KV share map, aliasing one resident model, behind each
server: the same requests, then ``/health`` (the replica set's block,
``weight_store`` and ``kv_share``), ``/metrics`` (the replica, fleet,
routing, weight-store, fault-harness, share and migration families with
JAX's names, every counter equal) and ``POST /admin/drain`` (its answers,
the validation errors, and the migration counters after it); the flags
end to end through ``main`` on a checkpoint of the tiny model, and a
hot-swap that builds a replica set again. ``--disagg``, ``--autoscale*``,
``--brownout`` and ``/admin/autoscaler`` are held against JAX's in
``tests/test_torch_fleet.py`` and ``tests/test_torch_disagg_server.py``."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from mlx_sharding_tpu import kv_share as jks
from mlx_sharding_tpu import replicas as jreplicas
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch import kv_share as tks
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.replicas import ReplicaSet
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.weights import ResidentWeights, model_weight_bytes
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import _compare, _jax_provider, _scrape
from tests.test_torch_scheduler import models  # noqa: F401

ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
GROUPS = (0, 0)  # the tiny model's 2 layers in one group: layer 1 a non-owner
REQUESTS = [
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 6}),
    ("/v1/completions", {"prompt": "hello there, general", "max_tokens": 5, "stream": True}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 4, "user": "s1"}),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", [
    ["--kv-share-map", "m.json"],
    ["--replicas", "2", "--draft", "ngram"],
    ["--replicas", "2", "--draft-model", "d"],
    ["--shared-weights", "on"],
    ["--replicas", "2", "--prompt-cache"],
], ids=["share-without-pool", "replicas-ngram", "replicas-draft", "shared-on-alone",
        "replicas-prompt-cache"])
def test_flag_refusals_match_jax(argv, capsys):
    """Each refusal exits 2 with JAX's message."""
    errs = []
    for main in (japi.main, tapi.main):
        with pytest.raises(SystemExit) as info:
            main(["--model", "unused", *argv] + (["--device", "cpu"] if main is tapi.main
                                                  else []))
        assert info.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errs[1] == errs[0]


def test_shared_weights_off_needs_a_device_per_replica(models):
    """``--replicas 2 --shared-weights off`` on one device: JAX's "needs N
    devices" refusal at load."""
    with pytest.raises(ValueError, match=r"2 replicas x 1 devices each needs 2 devices, "
                                         r"have 1"):
        tapi.build_generator("tiny", model=models[2], device="cpu", max_seq=64,
                             prefill_chunk=8, concurrent=2, paged_pool=10, page_size=8,
                             replicas=2, shared_weights="off")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _jax_set(models):
    """Two JAX batchers aliasing one resident tree on one device."""
    from mlx_sharding_tpu.parallel.pipeline import place_weights

    jm, params, _ = models
    rw = place_weights(jm, params, make_mesh(pp=1, devices=jax.devices()[:1]))
    reps = [jscheduler.ContinuousBatcher(
        JPipelineEngine(jm, None, rw.mesh, weights=rw, cache_dtype=jnp.float32,
                        kv_share_map=jks.KVShareMap(2, GROUPS), **ENGINE),
        decode_block=3, async_sched="off") for _ in range(2)]
    return jreplicas.ReplicaSet(reps)


def _port_set(models):
    tm = models[2]
    resident = ResidentWeights(model=tm, device=torch.device("cpu"),
                               weight_bytes=model_weight_bytes(tm))
    reps = [ContinuousBatcher(PipelineEngine(tm, weights=resident, device="cpu",
                                             kv_share_map=tks.KVShareMap(2, GROUPS), **ENGINE),
                              decode_block=3, async_sched="off") for _ in range(2)]
    rs = ReplicaSet(reps)
    rs.shared_weights_active = True
    return rs


def test_fleet_surfaces_match_jax(models):
    """Both servers over their replica sets: /health, /metrics and
    /admin/drain with JAX's names, counters and answers."""
    jprov = _jax_provider(_jax_set(models))
    jprov.kv_share_map = jks.KVShareMap(2, GROUPS)
    jprov.shared_weights_active = True
    tprov = tapi.ModelProvider(_port_set(models), ByteTokenizer(), model_name="tiny")
    tprov.kv_share_map = tks.KVShareMap(2, GROUPS)
    srvs = [japi.make_server(jprov, "127.0.0.1", 0), tapi.make_server(tprov, "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    seen = []
    try:
        for srv in srvs:
            port = srv.server_address[1]
            out = {"bodies": []}
            for path, body in REQUESTS:
                status, data = _post(port, path, body)
                assert status == 200
                if not body.get("stream"):
                    out["bodies"].append(json.loads(data)["choices"][0]["text"])
            status, health = _get(port, "/health")
            out["health"] = (status, json.loads(health))
            out["metrics"] = _scrape(port)
            out["drain_bad"] = [_post(port, "/admin/drain", b) for b in (
                {}, {"replica": "x"}, {"replica": 0, "deadline": -1}, {"replica": 5})]
            out["drain"] = _post(port, "/admin/drain", {"replica": 0, "deadline": 10})
            out["drain_last"] = _post(port, "/admin/drain", {"replica": 1})
            status, health = _get(port, "/health")
            out["health_after"] = (status, json.loads(health))
            out["metrics_after"] = _scrape(port)
            seen.append(out)
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
        jprov.generator.close()
        tprov.generator.close()
    j, t = seen
    assert t["bodies"] == j["bodies"]
    for key in ("health", "health_after"):
        assert t[key][0] == j[key][0] == 200
        jh, th = j[key][1], t[key][1]
        assert th.keys() == jh.keys()
        for block in ("status", "replicas_total", "replicas_live", "replicas_draining",
                      "replicas_retired", "replicas", "kv_share"):
            assert th[block] == jh[block], block
        # the store's trees and refs are the process's: each package its own
        assert th["weight_store"]["shared_weights"] is True
    assert t["health"][1]["kv_share"] == {"enabled": True, "groups": 1, "layers": 2,
                                          "share_hash": jks.KVShareMap(2, GROUPS).share_hash,
                                          "bytes_saved": 0}
    assert [(s, json.loads(b)) for s, b in t["drain_bad"]] == \
        [(s, json.loads(b)) for s, b in j["drain_bad"]]
    assert json.loads(t["drain"][1]) == json.loads(j["drain"][1]) and t["drain"][0] == 200
    assert t["drain_last"][0] == j["drain_last"][0] == 400
    assert json.loads(t["drain_last"][1]) == json.loads(j["drain_last"][1])
    for key in ("metrics", "metrics_after"):
        ts, js = _compare(j[key], t[key])
        for fam in ("mst_replicas_total", "mst_replicas_live", "mst_fleet_size",
                    "mst_kv_share_enabled", "mst_kv_share_groups", "mst_faults_armed",
                    'mst_replica_inflight{replica="0"}', 'mst_replica_breaker_state{replica="1"}',
                    'mst_replica_weights_shared{replica="0"}'):
            assert ts[fam] == js[fam], (key, fam)
    ts, _ = _compare(j["metrics_after"], t["metrics_after"])
    assert ts["mst_fleet_size"] == 1 and ts["mst_route_sticky_hits_total"] == 0
    assert ts["mst_kv_migration_streams_total"] == 0  # the drained replica was idle
    for fam, kind in (("mst_weight_store_trees", "gauge"), ("mst_weight_store_refs", "gauge"),
                      ("mst_weight_store_bytes", "gauge"),
                      ("mst_autoscale_events_total", "counter")):
        assert f"# TYPE {fam} {kind}" in t["metrics_after"], fam


def test_main_serves_replicas_under_a_share_map(models, tmp_path, monkeypatch):
    """``main`` with ``--concurrent 2 --paged-pool 10 --kv-share-map MAP
    --replicas 2`` on a checkpoint of the tiny model: a replica set of two
    batchers aliasing one resident model under the map, the provider's
    share block, and a hot-swap to another checkpoint builds a replica set
    again; the store's refs follow."""
    from chip_smoke import write_llama_checkpoint
    from mlx_sharding_tpu_torch import loading
    from mlx_sharding_tpu_torch.weights import weight_store
    from tests.test_torch_scheduler import TINY

    for name in ("a", "b"):
        write_llama_checkpoint(models[2], {"model_type": "llama", **TINY},
                               str(tmp_path / name))
    share = tmp_path / "share.json"
    tks.KVShareMap(2, GROUPS).save(str(share))
    monkeypatch.setattr(loading, "load_tokenizer", lambda path: ByteTokenizer())
    monkeypatch.chdir(tmp_path)
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep(provider, host, port, **kw):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep)
    refs0 = weight_store().stats()["refs"]
    tapi.main(["--model", "a", "--device", "cpu", "--max-seq", "64", "--prefill-chunk", "8",
               "--concurrent", "2", "--paged-pool", "10", "--page-size", "8", "--replicas", "2",
               "--kv-share-map", str(share)])
    prov = built["p"]
    try:
        rs = prov.generator
        assert isinstance(rs, ReplicaSet) and len(rs.replicas) == 2
        assert all(r.weights_shared and r.engine.kv_share_hash
                   == tks.KVShareMap(2, GROUPS).share_hash for r in rs.replicas)
        assert prov.shared_weights_active and weight_store().stats()["refs"] == refs0 + 2
        assert prov.kv_share_stats()["enabled"] is True
        out = list(rs.generate_step([3, 5, 7], max_tokens=4))
        assert len(out) == 4
        gen, _ = prov.load("b")  # a swap: the old set closes, a new one is built
        assert isinstance(gen, ReplicaSet) and gen is not rs
        assert weight_store().stats()["refs"] == refs0 + 2
        assert len(list(gen.generate_step([3, 5, 7], max_tokens=3))) == 3
    finally:
        prov.generator.close()
    assert weight_store().stats()["refs"] == refs0
