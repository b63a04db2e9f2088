"""The server's disaggregated and fleet-controller surfaces in the port
against the JAX server, on the CPU: the refusals of ``--disagg``,
``--prefill-replicas``, ``--decode-replicas``, ``--autoscale*`` and
``--brownout`` with JAX's messages; both servers over a disagg coordinator
of one prefill and one decode replica (the tiny f32 Llama of
``tests/test_torch_scheduler.py``): the same requests, then ``/health``
(the pools' blocks and the ``handoff`` block) and ``/metrics``
(``mst_disagg_*`` and the role-labelled fleet and replica families) with
JAX's names and counters; and ``main`` end to end on a checkpoint of the
tiny model with ``--disagg --autoscale``: one resident model under both
pools, a controller per pool, ``POST /admin/autoscaler``, the ``autoscaler``
and ``brownout`` blocks of ``/health``, the brownout cap and its headers,
``mst_brownout_level`` and the ``brownout_level_*`` events, and a hot-swap
that builds the pools and their controllers again."""

import http.client
import json
import threading

import pytest
import torch

from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu.testing import faults as jfaults
from mlx_sharding_tpu_torch.disagg import DisaggCoordinator
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.testing import faults as tfaults
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_disagg import _coordinator, _jax_coordinator
from tests.test_torch_fleet_server import _get, _post
from tests.test_torch_metrics import _compare, _jax_provider, _scrape
from tests.test_torch_scheduler import models  # noqa: F401

REQUESTS = [
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 6}),
    ("/v1/completions", {"prompt": "hello there, general", "max_tokens": 5, "stream": True}),
    ("/v1/completions", {"prompt": "a", "max_tokens": 1}),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", [
    ["--disagg"],
    ["--disagg", "--concurrent", "2", "--replicas", "2"],
    ["--disagg", "--concurrent", "2", "--draft-model", "d"],
    ["--disagg", "--concurrent", "2", "--decode-replicas", "0"],
    ["--disagg", "--concurrent", "2", "--autoscale", "--autoscale-max", "3"],
    ["--prefill-replicas", "2"],
    ["--autoscale"],
    ["--concurrent", "2", "--replicas", "2", "--autoscale-min", "2"],
    ["--concurrent", "2", "--replicas", "2", "--autoscale", "--autoscale-min", "0"],
    ["--concurrent", "2", "--replicas", "2", "--autoscale", "--autoscale-min", "3",
     "--autoscale-max", "2"],
    ["--concurrent", "2", "--replicas", "2", "--autoscale", "--autoscale-interval", "0"],
    ["--prompt-cache", "--disagg"],
    ["--brownout", "maybe"],
], ids=["disagg-alone", "disagg-replicas", "disagg-draft-model", "decode-zero",
        "disagg-autoscale-max", "pool-sizes-alone", "autoscale-alone", "min-alone",
        "min-zero", "max-below-min", "interval-zero", "prompt-cache-disagg", "brownout-choice"])
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


def _shape(value):
    """A JSON value's keys, recursively (numbers and strings as their type)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    return type(value).__name__


def test_disagg_surfaces_match_jax(models):
    """The same requests through both servers over fresh coordinators, then
    /health and /metrics with JAX's shapes, names and counters (a
    ``disagg.handoff`` fault on the last request adds a ``handoff_fault``
    rung to both)."""
    jco = _jax_coordinator(models, None, 0)
    tco = _coordinator(models)
    srvs = [japi.make_server(_jax_provider(jco), "127.0.0.1", 0),
            tapi.make_server(tapi.ModelProvider(tco, ByteTokenizer(), model_name="tiny"),
                             "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    seen = []
    try:
        for srv, faults in zip(srvs, (jfaults, tfaults)):
            port = srv.server_address[1]
            out = {"bodies": []}
            for i, (path, body) in enumerate(REQUESTS + REQUESTS[:1]):
                if i == len(REQUESTS):
                    faults.arm("disagg.handoff", exc=faults.FaultError, times=1)
                status, data = _post(port, path, body)
                assert status == 200
                if not body.get("stream"):
                    out["bodies"].append(json.loads(data)["choices"][0]["text"])
            status, health = _get(port, "/health")
            out["health"] = (status, json.loads(health))
            out["metrics"] = _scrape(port)
            seen.append(out)
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
        tco.close()
        jco.close()
    j, t = seen
    assert t["bodies"] == j["bodies"]
    (jstatus, jh), (tstatus, th) = j["health"], t["health"]
    assert tstatus == jstatus == 200
    assert th["status"] == jh["status"] == "ok" and th["disagg"] is jh["disagg"] is True
    for key in ("pools", "handoff"):
        assert _shape(th[key]) == _shape(jh[key]), key
    for key in ("handoffs", "bytes_total", "fallbacks", "store_skips", "window"):
        assert th["handoff"][key] == jh["handoff"][key], key
    assert th["handoff"]["handoffs"] == 2 and th["handoff"]["fallbacks"] == {"handoff_fault": 1}
    ts, js = _compare(j["metrics"], t["metrics"])
    for fam in ("mst_disagg_handoff_total", "mst_disagg_handoff_bytes_total",
                'mst_disagg_fallbacks_total{kind="handoff_fault"}',
                "mst_disagg_store_skips_total", "mst_disagg_handoff_ms_count",
                'mst_fleet_size{role="prefill"}', 'mst_fleet_size{role="decode"}',
                'mst_replica_inflight{replica="0",role="decode"}',
                'mst_replica_weights_shared{replica="0",role="prefill"}',
                "mst_kv_migration_in_total"):
        assert ts[fam] == js[fam], fam
    assert ts["mst_disagg_handoff_total"] == 2 and ts["mst_disagg_handoff_bytes_total"] > 0
    assert "mst_brownout_level" not in ts  # no controller: no ladder




def test_main_serves_disagg_with_autoscalers(models, tmp_path, monkeypatch):
    """``main`` with ``--concurrent 2 --paged-pool 16 --disagg --autoscale``
    on a checkpoint of the tiny model: one prefill and one decode replica
    aliasing one resident model, a started controller per pool with JAX's
    bounds on one device slice (min 1, max 2), /admin/autoscaler stopping
    both, the pools' ``autoscaler`` and ``brownout`` blocks in /health; the
    decode pool's ladder at level 3 caps a request to 96 tokens with both
    headers, /metrics renders the level and the ``brownout_level_3`` event;
    a hot-swap builds the pools and their controllers again and stops the
    old ones; the store's refs follow."""
    from chip_smoke import write_llama_checkpoint
    from mlx_sharding_tpu_torch import loading
    from mlx_sharding_tpu_torch.weights import weight_store
    from tests.test_torch_scheduler import TINY

    for name in ("a", "b"):
        write_llama_checkpoint(models[2], {"model_type": "llama", **TINY},
                               str(tmp_path / name))
    monkeypatch.setattr(loading, "load_tokenizer", lambda path: ByteTokenizer())
    monkeypatch.chdir(tmp_path)
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep(provider, host, port, **kw):
        built["p"] = provider
        return _NoServe()

    make_server = tapi.make_server
    monkeypatch.setattr(tapi, "make_server", keep)
    refs0 = weight_store().stats()["refs"]
    tapi.main(["--model", "a", "--device", "cpu", "--max-seq", "128", "--prefill-chunk", "8",
               "--concurrent", "2", "--paged-pool", "16", "--page-size", "8", "--disagg",
               "--autoscale", "--autoscale-interval", "0.5", "--autoscale-cooldown", "0"])
    prov = built["p"]
    srv = make_server(prov, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        co = prov.generator
        assert isinstance(co, DisaggCoordinator)
        pools = (co.prefill, co.decode)
        assert [len(p.replicas) for p in pools] == [1, 1]
        assert all(r.weights_shared for p in pools for r in p.replicas)
        assert co.prefill.replicas[0]._spec_mode == "off"
        assert weight_store().stats()["refs"] == refs0 + 2
        ctrls = prov.fleet
        assert isinstance(ctrls, tuple) and [c.rs for c in ctrls] == list(pools)
        assert [(c.min_replicas, c.max_replicas, c.interval_s, c.cooldown_s) for c in ctrls] \
            == [(1, 2, 0.5, 0.0)] * 2
        status, body = _post(port, "/admin/autoscaler", {"enabled": "yes"})
        assert status == 400
        status, body = _post(port, "/admin/autoscaler", {"enabled": False})
        state = json.loads(body)
        assert status == 200 and [p["running"] for p in state["pools"]] == [False, False]
        assert [p["role"] for p in state["pools"]] == ["prefill", "decode"]
        assert all(p["brownout"]["level"] == 0 for p in state["pools"])
        status, health = _get(port, "/health")
        health = json.loads(health)
        assert status == 200 and health["disagg"] is True
        for role in ("prefill", "decode"):
            assert health["pools"][role]["autoscaler"]["running"] is False
            assert health["pools"][role]["brownout"]["level"] == 0
        decode = ctrls[1]
        decode.brownout.observe(2.5)
        decode.tick()  # publishes the level to the decode pool's batchers
        assert co.decode.replicas[0].resilience_stats()["brownout_level"] == 3
        assert co.prefill.replicas[0].resilience_stats()["brownout_level"] == 0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": "hi", "max_tokens": 120}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert resp.getheader("X-MST-Brownout-Level") == "3"
        assert resp.getheader("X-MST-Max-Tokens-Capped") == "96"
        assert out["usage"]["completion_tokens"] == 96
        text = _scrape(port)
        assert "mst_brownout_level 3" in text
        assert 'mst_autoscale_events_total{kind="brownout_level_3"} 1' in text
        assert "mst_disagg_handoff_total 1" in text
        gen, _ = prov.load("b")  # a swap: the old pools close, new ones are built
        assert isinstance(gen, DisaggCoordinator) and gen is not co
        assert not any(c.state()["running"] for c in ctrls)
        assert prov.fleet is not ctrls and all(c.state()["running"] for c in prov.fleet)
        assert weight_store().stats()["refs"] == refs0 + 2
        assert len(list(gen.generate_step([3, 5, 7], max_tokens=3))) == 3
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        prov.generator.close()
    assert weight_store().stats()["refs"] == refs0
