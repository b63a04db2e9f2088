"""Request tracing (``tracing.py``, ``/admin/trace``, ``--trace-profile``)
against the JAX package's: the recorder's units on the same inputs (off
mode allocates nothing, sampling one in N, the ring bounded, the Chrome
export's shape), one streamed request's timeline through both servers over
the same f32 weights (the tiny config of ``tests/test_torch_scheduler.py``)
on the paged batcher and on the single stream, and the profiler bridge on
the CPU (``mst.decode_block`` ranges in a ``--profile-dir`` trace).

The scheduler thread stamps ``queue_wait``, ``prefill`` and ``decode_tick``
while the server thread stamps ``sse_write``: their interleaving is timing,
so the order is compared per thread, and the marks in full."""

import glob
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu import tracing as jtracing
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch import tracing
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import _jax_provider

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
SCHEDULER_SPANS = ("queue_wait", "prefill", "decode_tick")
BODY = {"prompt": "the quick brown fox jumps over", "max_tokens": 8, "stream": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracers_off():
    """Each test installs the tracers it needs; both end unconfigured."""
    yield
    jtracing._TRACER = None
    tracing._TRACER = None


@pytest.fixture(scope="module")
def weights():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    jeng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                           paged_attention="ragged", **ENGINE)
    return jm, params, tm, jeng


# ------------------------------------------------------------------ units
@pytest.mark.parametrize("mod", [jtracing, tracing], ids=["jax", "port"])
def test_off_mode_never_allocates(mod, monkeypatch):
    t = mod.Tracer(mode="off")
    monkeypatch.setattr(mod, "RequestTrace", None)  # a trace object would fail to build
    assert not t.enabled
    assert t.begin("r") is None
    t.finish(None)
    s = t.stats()
    assert s["live"] == 0 and s["ring"] == 0 and s["begun"] == 0


def test_sampling_ring_and_lookup_match_jax():
    """One in four sampled; a ring of 4 keeps the newest; lookups over the
    live table and the ring: the same answers from both recorders."""
    out = []
    for mod in (jtracing, tracing):
        t = mod.Tracer(mode="sample", sample_n=4)
        sampled = [i for i in range(12) if t.begin(f"r{i}") is not None]
        ring = mod.Tracer(mode="on", buffer=4)
        live = ring.begin("still-live")
        for i in range(10):
            tr = ring.begin(f"r{i}")
            tr.add("prefill", 0.0, 1.0)
            ring.finish(tr)
        st = ring.stats()
        out.append((sampled, t.stats(), st["ring"], st["live"], ring.get("r3"),
                    ring.get("r9")["done"], ring.get("still-live")["done"],
                    ring.export_request("nope")))
        ring.finish(live)
    assert out[1] == out[0]
    assert out[1][0] == [0, 4, 8] and out[1][2:4] == (4, 1)


def test_chrome_export_has_jax_shape():
    """The same frozen trace exported by both: identical events."""
    frozen = {"request_id": "r1", "t0": 10.0, "done": True, "dropped": 0, "meta": {},
              "spans": [("queue_wait", 10.0, 10.5, {"slot": 0}), ("decode_tick", 11.0,
                                                                    11.25, None)],
              "marks": [("first_token", 10.75, {"slot": 0}), ("fault:x", 12.0, None)]}
    assert (tracing.chrome_trace([frozen], epoch=9.0)
            == jtracing.chrome_trace([frozen], epoch=9.0))
    assert tracing.SPAN_TYPES == jtracing.SPAN_TYPES


# ------------------------------------------------------------ the servers
def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("X-MST-Request-Id"), data


def _timelines(jgen, tgen):
    """One streamed request through each server; each request's trace
    export (or the status of the miss) and the dump."""
    srvs = [japi.make_server(_jax_provider(jgen), "127.0.0.1", 0),
            tapi.make_server(tapi.ModelProvider(tgen, ByteTokenizer(), model_name="tiny"),
                             "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    try:
        out = []
        for srv in srvs:
            port = srv.server_address[1]
            status, rid, _ = _request(port, "POST", "/v1/completions", BODY)
            assert status == 200 and rid.startswith("cmpl-")
            status, _, data = _request(port, "GET", f"/admin/trace/{rid}")
            dump = json.loads(_request(port, "GET", "/admin/trace/dump")[2])
            out.append((status, json.loads(data), dump))
        return out
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)


def _names(export, ph):
    return [e["name"] for e in export["traceEvents"] if e["ph"] == ph]


def test_batcher_request_timeline_matches_jax(weights):
    """``--trace on``: the scheduler's spans in the same order, as many SSE
    writes, the same marks, and the dump holding the request."""
    jm, params, tm, jeng = weights
    jtracing.configure("on")
    tracing.configure("on")
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off")
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3,
                           async_sched="off")
    try:
        (js, jexp, jdump), (ts, texp, tdump) = _timelines(jb, tb)
    finally:
        jb.close()
        tb.close()
    assert ts == js == 200
    jspans, tspans = _names(jexp, "X"), _names(texp, "X")
    assert ([n for n in tspans if n in SCHEDULER_SPANS]
            == [n for n in jspans if n in SCHEDULER_SPANS])
    assert tspans.count("sse_write") == jspans.count("sse_write") > 0
    assert set(tspans) == set(jspans) == {*SCHEDULER_SPANS, "sse_write"}
    assert _names(texp, "i") == _names(jexp, "i") == ["submit", "first_token", "finish"]
    assert [e["name"] for e in texp["traceEvents"] if e["ph"] == "M"] == \
        [e["name"] for e in jexp["traceEvents"] if e["ph"] == "M"]
    assert tdump["snapshots"] == jdump["snapshots"] == []
    assert tracing.get_tracer().stats()["ring"] == 1


def test_single_stream_is_not_traced_in_either(weights):
    """Neither package's single-stream generator takes a timeline: the
    request's trace is a 404 in both, and the recorder stays empty."""
    jm, params, tm, _ = weights
    jtracing.configure("on")
    tracing.configure("on")
    (js, jexp, _), (ts, texp, _) = _timelines(
        JGenerator(jm, params, max_seq=64, cache_dtype=jnp.float32, prefill_chunk=8),
        Generator(tm, max_seq=64, prefill_chunk=8))
    assert ts == js == 404 and texp == jexp | {"error": texp["error"]}
    assert tracing.get_tracer().stats()["begun"] == 0


def test_trace_off_allocates_nothing_and_404s(weights, monkeypatch):
    """``--trace off`` (the default): a served request creates no trace
    object, and ``/admin/trace`` answers JAX's 404."""
    _, _, tm, _ = weights
    tracing.configure("off")
    monkeypatch.setattr(tracing, "RequestTrace", None)
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3)
    srv = tapi.make_server(tapi.ModelProvider(tb, ByteTokenizer(), model_name="tiny"),
                           "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        assert _request(port, "POST", "/v1/completions", BODY)[0] == 200
        status, _, data = _request(port, "GET", "/admin/trace/dump")
        assert status == 404 and "--trace sample|on" in json.loads(data)["error"]["message"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        tb.close()
    assert tracing.get_tracer().stats()["begun"] == 0


def test_trace_profile_ranges_land_in_the_profile(weights, tmp_path):
    """``--trace on --trace-profile --profile-dir``: the request's
    ``torch.profiler`` trace holds one ``mst.decode_block`` range per
    dispatched decode block (ticks run on the scheduler thread)."""
    _, _, tm, _ = weights
    tracing.configure("on", profile=True)
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3,
                           async_sched="off")
    assert tb._trace_profile
    srv = tapi.make_server(tapi.ModelProvider(tb, ByteTokenizer(), model_name="tiny"),
                           "127.0.0.1", 0, profile_dir=str(tmp_path))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        blocks = tb.decode_steps
        assert _request(srv.server_address[1], "POST", "/v1/completions", BODY)[0] == 200
        blocks = (tb.decode_steps - blocks) // tb.decode_block
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        tb.close()
    (path,) = glob.glob(str(tmp_path / "trace-*.json"))
    events = json.load(open(path))["traceEvents"]
    ranges = [e for e in events if e.get("name") == "mst.decode_block"]
    assert blocks >= 2 and len(ranges) == blocks


def test_wedge_snapshot_keeps_the_timelines(weights):
    """A close that a wedged tick outlives freezes the recorder under
    ``wedge:scheduler``, as JAX's does."""
    _, _, tm, _ = weights
    tracing.configure("on")
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3)
    list(tb.generate_step([1, 2, 3], max_tokens=4))
    gate, parked = threading.Event(), threading.Event()

    def wedged_tick():
        parked.set()
        gate.wait()

    tb.run_tick = wedged_tick
    assert parked.wait(15)
    tb.close(timeout=0.2)
    gate.set()
    tb._thread.join(timeout=20)
    (snap,) = tracing.get_tracer().snapshots()
    assert snap["reason"] == "wedge:scheduler" and len(snap["traces"]) == 1
