"""The batcher's health (``health()``, ``scheduler_thread_live()``,
``thread_wedged``) and the server's ``/health`` against the JAX package's,
the two cases of ``tests/test_resilience.py`` mirrored: a clean close
answers ``draining`` (503), a close whose join a wedged tick outlives
answers ``degraded`` with the thread marked wedged and the live gauge at 0.

Both batchers run one slot over dense caches of the tiny config of
``tests/test_resilience.py`` (2 layers, hidden 32, Hq 4 / Hkv 2, capacity
64, chunk 8, decode blocks of 4, f32). JAX's tick is wedged by its fault
harness (a gate at ``scheduler.tick``); the port has no fault harness yet,
so its tick is wedged by a gate put in place of ``run_tick``."""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu.testing import faults
from mlx_sharding_tpu.utils.observability import ServingMetrics as JServingMetrics
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.utils.observability import ServingMetrics
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import _jax_provider

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(microbatches=1, max_seq=64, prefill_chunk=8)
# the JAX server's /health blocks of later slices; the port renders the
# rest (the prefix_store and kv_compress blocks with their sources,
# tests/test_torch_kv_server.py; kv_share with a share map and the replica
# set's, tests/test_torch_fleet_server.py). The weight store's block is
# always there, its numbers each process's own store's.
LATER_SLICE_KEYS = {"pod", "multihost"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    """One JAX engine for the module (its compiled programs serve every
    batcher built on it) and the port's weights."""
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    jeng = JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, **ENGINE)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jeng, tm


def _batchers(engines):
    jeng, tm = engines
    return (jscheduler.ContinuousBatcher(jeng, decode_block=4),
            ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=4))


def _wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, json.loads(body)


def _serve(jb, tb):
    """Both batchers behind their servers; yields the two ports."""
    srvs = [japi.make_server(_jax_provider(jb), "127.0.0.1", 0),
            tapi.make_server(tapi.ModelProvider(tb, ByteTokenizer(), model_name="tiny"),
                             "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    return srvs, threads


def _health_both(ports):
    """(status, payload) of each server, the JAX payload without the
    blocks of later slices."""
    (js, jp), (ts, tp) = (_get(p, "/health") for p in ports)
    jw, tw = jp.pop("weight_store"), tp.pop("weight_store")
    assert tw.keys() == jw.keys() and tw["shared_weights"] == jw["shared_weights"] is False
    return (js, {k: v for k, v in jp.items() if k not in LATER_SLICE_KEYS}), (ts, tp)


def test_healthy_close_and_health_states(engines):
    """Never started: ok. Serving: ok, 200, the thread live. Closed
    cleanly: draining, 503, the thread still counted live (not a wedge)."""
    jb, tb = _batchers(engines)
    srvs, threads = _serve(jb, tb)
    ports = [s.server_address[1] for s in srvs]
    try:
        assert tb.health()["status"] == jb.health()["status"] == "ok"
        for b in (jb, tb):
            list(b.generate_step([1, 2], max_tokens=3))
        assert tb.health() == jb.health() == {
            "status": "ok", "serving": True, "scheduler_thread_live": True}
        j, t = _health_both(ports)
        assert t == j == (200, {"status": "ok", "scheduler_thread_live": True})
        for b in (jb, tb):
            b.close()
        assert tb.health() == jb.health()
        assert tb.health()["status"] == "draining" and not tb.health()["serving"]
        assert tb.scheduler_thread_live() and jb.scheduler_thread_live()
        assert not tb.thread_wedged and not jb.thread_wedged
        j, t = _health_both(ports)
        assert t == j == (503, {"status": "draining", "scheduler_thread_live": True})
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)


def test_close_reports_wedged_scheduler_thread(engines):
    """A tick parked on a gate outlives ``close(timeout=0.3)``: both mark
    the thread wedged, report it not live, answer degraded (503), and the
    metrics gauge reads 0. Released, the tick sees the stop and exits."""
    jb, tb = _batchers(engines)
    gate = threading.Event()
    parked = threading.Event()
    real_tick = tb.run_tick

    def wedged_tick():
        if not gate.is_set():
            parked.set()
            gate.wait()
        real_tick()

    srvs, threads = _serve(jb, tb)
    ports = [s.server_address[1] for s in srvs]
    try:
        for b in (jb, tb):
            list(b.generate_step([1, 2], max_tokens=4))  # start and warm the thread
        f = faults.arm("scheduler.tick", gate=gate)
        tb.run_tick = wedged_tick
        _wait_for(lambda: f.fired >= 1 and parked.is_set(), msg="both ticks to park")
        for b in (jb, tb):
            b.close(timeout=0.3)
            assert b.thread_wedged and not b.scheduler_thread_live()
        assert tb.health() == jb.health() == {
            "status": "degraded", "serving": False, "scheduler_thread_live": False}
        j, t = _health_both(ports)
        assert t == j == (503, {"status": "degraded", "scheduler_thread_live": False})
        assert "mst_scheduler_thread_live 0" in ServingMetrics(batcher_fn=lambda: tb).render()
        assert "mst_scheduler_thread_live 0" in JServingMetrics(batcher_fn=lambda: jb).render()
    finally:
        gate.set()
        faults.disarm()
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
        for b in (jb, tb):
            if b._thread is not None:
                b._thread.join(timeout=20)
                assert not b._thread.is_alive()


def test_single_stream_health_is_ok_in_both():
    """A generator without ``health()`` answers 200 ok in both servers."""

    class Plain:
        def generate_step(self, prompt, **kw):
            yield from ()

    srvs, threads = _serve(Plain(), Plain())
    try:
        j, t = _health_both([s.server_address[1] for s in srvs])
        assert t == j == (200, {"status": "ok"})
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
