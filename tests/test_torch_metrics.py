"""``GET /metrics`` of the port's server against the JAX server's: the same
requests through both, over the same f32 weights (the tiny config of
``tests/test_torch_scheduler.py``: 2 layers, hidden 32, Hq 4 / Hkv 2,
chunk 8, page 8), and then the sets of family names equal (less the
families of later slices, listed below), every counter equal, and the
bucket bounds of every histogram equal. Batchers run sync ticks, so that
the decode blocks each dispatches, and so the analytic KV-read counters,
are the same run for run."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.utils import observability as tobs
from tests.test_tokenizer_utils import ByteTokenizer

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
#: the JAX families whose sources come with later slices (ROADMAP.md files
#: each under its slice): the resource ledger (slice 11); the rest (pod,
#: handoff, brownout) appear only when their source exists, in neither
#: server here. The fault harness and the weight store render in both
#: always; a paged batcher's ``spill_stats`` (KV spill, migration and
#: prefetch, and the re-prefill counter), a replica set's families and the
#: KV share map's render in both when their source exists.
LATER_SLICE_FAMILIES = {"mst_ledger_anomalies_total"}


#: counters of each package's own process-wide state, compared by name and
#: type only: the fault harness's parse failures count every
#: ``MST_FAULTS`` spec any test of the worker's process gave that package
PROCESS_COUNTERS = {"mst_faults_malformed_total"}


def _later_slice(family: str) -> bool:
    return family in LATER_SLICE_FAMILIES
# a chat turn re-sends its history (prefix hits), then a long request that
# the overcommitted pool of 10 pages must grow for
REQUESTS = [
    ("/v1/completions", {"prompt": "the quick brown fox jumps", "max_tokens": 9}),
    ("/v1/completions", {"prompt": "the quick brown fox jumps over the lazy dog",
                         "max_tokens": 7, "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello there"}],
                              "role_mapping": {"user": "U: ", "assistant": "A: "},
                              "max_tokens": 6}),
    ("/v1/completions", {"prompt": "0123456789", "max_tokens": 5, "logprobs": 3}),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _jax_provider(generator):
    """A JAX ``ModelProvider`` around a built generator (the JAX class loads
    from a path only), serving it as ``tiny`` with a byte tokenizer."""
    prov = japi.ModelProvider.__new__(japi.ModelProvider)
    prov.default_model = "tiny"
    prov.trust_remote_paths = False
    prov._key = None
    prov._load_lock = threading.Lock()
    prov._set("tiny", generator, ByteTokenizer())
    return prov


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    assert resp.status == 200


def _scrape(port) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/plain; version=0.0.4"
    return body


def _served(jgen, tgen):
    """Serve ``REQUESTS`` one at a time through both servers; their
    scrapes."""
    srvs = [japi.make_server(_jax_provider(jgen), "127.0.0.1", 0),
            tapi.make_server(tapi.ModelProvider(tgen, ByteTokenizer(), model_name="tiny"),
                             "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    try:
        out = []
        for srv in srvs:
            for path, body in REQUESTS:
                _post(srv.server_address[1], path, body)
            out.append(_scrape(srv.server_address[1]))
        return out
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)


def _parse(text):
    """(families {name: type}, samples {name{labels}: value}, HELP'd set)."""
    types, samples, helped = {}, {}, set()
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            types[name] = kind
        elif ln.startswith("# HELP "):
            helped.add(ln.split()[2])
        elif ln:
            key, value = ln.rsplit(" ", 1)
            samples[key] = float(value)
    return types, samples, helped


def _histogram_bounds(samples, family):
    return [k for k in samples if k.startswith(family + "_bucket")]


def _compare(jtext, ttext, counters_equal=True):
    jt, js, jh = _parse(jtext)
    tt, ts, th = _parse(ttext)
    assert set(tt) == {f for f in jt if not _later_slice(f)}
    assert {k: tt[k] for k in tt} == {k: jt[k] for k in tt}  # the same types
    assert th == set(tt)  # every family carries HELP and TYPE
    for fam, kind in tt.items():
        if kind == "histogram":
            assert _histogram_bounds(ts, fam) == _histogram_bounds(js, fam), fam
            assert ts[fam + "_count"] == js[fam + "_count"], fam
        elif kind == "counter" and counters_equal and fam not in PROCESS_COUNTERS:
            for key in (k for k in ts if k.split("{")[0] == fam):
                assert ts[key] == js[key], key
    return ts, js


def test_batcher_metrics_match_jax(weights):
    """A paged batcher with the prefix cache, overcommit and a queue bound:
    the slot, pool, KV-read, bytes-a-token, latency, tick, resilience and
    prefix families, with the same counters."""
    jm, params, tm = weights
    kw = dict(decode_block=3, async_sched="off", prefix_cache=True, overcommit=True,
              max_queue=4)
    jb = jscheduler.ContinuousBatcher(
        JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                        paged_attention="ragged", **ENGINE), **kw)
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), **kw)
    try:
        jtext, ttext = _served(jb, tb)
    finally:
        jb.close()
        tb.close()
    ts, js = _compare(jtext, ttext)
    assert ts["mst_requests_total"] == len(REQUESTS)
    assert ts["mst_prefix_cache_hits_total"] >= 1 and ts["mst_kv_bytes_read_total"] > 0
    assert ts["mst_generation_tokens_total"] == js["mst_generation_tokens_total"] > 0
    # every emitted token after each request's first is one inter-token gap
    assert ts["mst_itl_seconds_count"] == ts["mst_generation_tokens_total"] - len(REQUESTS)
    assert ts["mst_queue_wait_seconds_count"] == len(REQUESTS)
    for key in ("mst_batch_slots", "mst_kv_pool_pages", "mst_paged_attention_ragged",
                "mst_max_queue", "mst_scheduler_thread_live", "mst_sched_async",
                "mst_kv_bytes_read_last_tick", 'mst_decode_hbm_bytes_per_token{kind="kv"}',
                'mst_decode_hbm_bytes_per_token{kind="weights"}'):
        assert ts[key] == js[key], key


def test_single_stream_metrics_match_jax(weights):
    """The single-stream generator renders only the server's own families."""
    jm, params, tm = weights
    jtext, ttext = _served(
        JGenerator(jm, params, max_seq=64, cache_dtype=jnp.float32, prefill_chunk=8),
        Generator(tm, max_seq=64, prefill_chunk=8))
    ts, _ = _compare(jtext, ttext)
    assert "mst_batch_slots" not in ts and ts["mst_requests_total"] == len(REQUESTS)


def test_histogram_and_finalize_match_jax():
    """The exposition helpers on the same inputs: bucket placement, the
    rendered block, and HELP/TYPE synthesized for an untyped sample."""
    from mlx_sharding_tpu.utils import observability as jobs

    values = [0.0004, 0.001, 0.003, 0.2, 7.0, 99.0]
    jh, th = jobs.Histogram(jobs.LATENCY_BUCKETS_S), tobs.Histogram(tobs.LATENCY_BUCKETS_S)
    for v in values:
        jh.observe(v)
        th.observe(v)
    assert th.to_dict() == jh.to_dict()
    jl, tl = [], []
    jobs.Histogram.render_into(jl, "mst_x_seconds", jh.to_dict(), "x")
    tobs.Histogram.render_into(tl, "mst_x_seconds", th.to_dict(), "x")
    assert tl == jl
    lines = ["mst_untyped_gauge 3", "# TYPE mst_requests_total counter", "mst_requests_total 1"]
    assert tobs._finalize(list(lines)) == jobs._finalize(list(lines))
    assert tobs.ITL_BUCKETS_S == jobs.ITL_BUCKETS_S
