"""The port's OpenAI server over continuous batching on the CPU: ``--concurrent
2 --paged-pool 10 --device cpu`` answers concurrent HTTP requests with what
the same requests get one at a time, a concurrent generator is served
without the generation lock, and the server's flags keep the JAX parser's
checks. Beside the JAX server over a JAX batcher with the same weights (8
slots, a 16-page pool): a ``"ttft_timeout": 0.001`` request answers 504
(the port used to accept the field under a batcher and answer 200), and
past ``--max-queue`` a request answers 429 with the same ``Retry-After``."""

import concurrent.futures
import http.client
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import pytest

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_scheduler import ENGINE, _engine, models  # noqa: F401
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["the quick brown fox", "hello world, this is", "pipelines run on meshes; stages"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("paged_server_ckpt"))


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _bodies():
    out = [("/v1/completions", {"prompt": p, "max_tokens": 8 + 2 * i, "seed": i})
           for i, p in enumerate(PROMPTS)]
    out.append(("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello world"}], "max_tokens": 6}))
    return out


def _answers(port, concurrently):
    """The texts and usages of ``_bodies()``, all at once or one by one."""
    def one(item):
        status, data = _post(port, *item)
        assert status == 200, data
        body = json.loads(data)
        choice = body["choices"][0]
        return choice.get("text", choice.get("message", {}).get("content")), body["usage"]

    if not concurrently:
        return [one(item) for item in _bodies()]
    with concurrent.futures.ThreadPoolExecutor(len(_bodies())) as pool:
        return list(pool.map(one, _bodies()))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_concurrent_server_on_the_cpu_answers_concurrent_requests(ckpt, tmp_path):
    """The entry point as a user starts it; concurrent answers equal the
    sequential ones (greedy, same slots' arithmetic)."""
    port = _free_port()
    log = tmp_path / "server.log"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlx_sharding_tpu_torch.server.openai_api", "--model",
             str(ckpt), "--concurrent", "2", "--paged-pool", "10", "--device", "cpu",
             "--port", str(port)],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
        )
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log.read_text()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/health")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.2)
        together = _answers(port, concurrently=True)
        assert _answers(port, concurrently=False) == together
        # greedy runs may end early on the checkpoint's EOS
        assert all(0 < u["completion_tokens"] <= m and u["prompt_tokens"] > 0
                   for (_, u), m in zip(together, (8, 10, 12, 6)))
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_concurrent_generator_is_served_without_the_lock(ckpt):
    """With the generation lock held elsewhere, a request to a server whose
    generator is a ContinuousBatcher still completes."""
    provider = tapi.ModelProvider.from_checkpoint(
        str(ckpt), device="cpu", concurrent=2, paged_pool=10, admission_policy="first_fit")
    batcher = provider.generator
    assert isinstance(batcher, ContinuousBatcher) and batcher.concurrent
    assert batcher.decode_block == 8 and batcher.policy == "first_fit"
    assert batcher.engine.pool_pages == 10 and batcher.engine.microbatches == 2
    srv = tapi.make_server(provider, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with srv.RequestHandlerClass.gen_lock:
            status, data = _post(srv.server_address[1], "/v1/completions",
                                 {"prompt": PROMPTS[0], "max_tokens": 5})
        assert status == 200, data
        assert json.loads(data)["usage"]["completion_tokens"] <= 5
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        batcher.close()


@pytest.mark.parametrize("argv,message", [
    (["--paged-pool", "10"], "--paged-pool requires --concurrent N (N > 1)"),
    (["--page-size", "256"], "--page-size requires --paged-pool"),
    (["--paged-attention", "ragged"], "--paged-attention requires --paged-pool"),
    (["--kv-dtype", "int8"], "--kv-dtype requires --paged-pool"),
    (["--admission-policy", "first_fit"], "--admission-policy requires --paged-pool"),
    (["--overcommit"], "--overcommit requires --paged-pool"),
    (["--async-sched", "off"], "--async-sched requires --concurrent N (N > 1)"),
    (["--concurrent", "2", "--paged-pool", "4", "--async-sched", "sometimes"],
     "invalid choice: 'sometimes'"),
    (["--max-queue", "4"], "--max-queue requires --concurrent N (N > 1)"),
    (["--concurrent", "2", "--paged-pool", "4", "--max-queue", "0"],
     "--max-queue must be a positive integer"),
    (["--prompt-cache", "--draft-model", "d"],
     "--prompt-cache applies to the single-chip full-model generator path"),
    (["--concurrent", "2", "--prompt-cache"],
     "--prompt-cache with --concurrent requires --paged-pool (prefix sharing is page-granular)"),
    (["--ttft-timeout", "0"], "--ttft-timeout must be a positive number of seconds"),
    (["--request-timeout", "-1"], "--request-timeout must be a positive number of seconds"),
])
def test_flag_checks(argv, message, capsys):
    with pytest.raises(SystemExit) as info:
        tapi.main(["--model", "unused", "--device", "cpu", *argv])
    assert info.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv,path", [
    (["--concurrent", "2"], "dense"),
    (["--concurrent", "2", "--paged-pool", "4", "--paged-attention", "gather"], "gather"),
], ids=["dense", "gather"])
def test_dense_and_gather_flags_reach_the_engine(ckpt, monkeypatch, argv, path):
    """``--concurrent N`` without a pool serves from dense slot caches, and
    ``--paged-attention gather`` takes the contiguous-view path; either
    batcher answers a request."""
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep_provider(provider, host, port, **deadlines):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep_provider)
    tapi.main(["--model", str(ckpt), "--device", "cpu", *argv])
    batcher = built["p"].generator
    try:
        assert isinstance(batcher, ContinuousBatcher)
        assert batcher.engine.decode_path == path and batcher.paged is (path != "dense")
        out = list(batcher.generate_step(list(range(3, 12)), max_tokens=4))
        assert 0 < len(out) <= 4
    finally:
        batcher.close()


@pytest.mark.parametrize("argv,overcommit,is_async", [
    (["--overcommit"], True, True),
    (["--async-sched", "off"], False, False),
    (["--overcommit", "--async-sched", "on"], True, True),
], ids=["overcommit", "sync", "overcommit-async"])
def test_batcher_flags_on_the_cpu(ckpt, monkeypatch, argv, overcommit, is_async):
    """``--overcommit`` and ``--async-sched`` from the command line reach the
    batcher the server builds with ``--device cpu``, and it answers
    concurrent requests with what it answers one at a time."""
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep_provider(provider, host, port, **deadlines):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep_provider)
    tapi.main(["--model", str(ckpt), "--device", "cpu", "--concurrent", "2", "--paged-pool", "3",
               *argv])
    batcher = built["p"].generator
    assert isinstance(batcher, ContinuousBatcher)
    assert batcher.overcommit is overcommit and batcher._async is is_async
    assert batcher.tick_timing_stats()["path"] == ("async" if is_async else "sync")
    monkeypatch.undo()
    srv = tapi.make_server(built["p"], "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        together = _answers(port, concurrently=True)
        assert _answers(port, concurrently=False) == together
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        batcher.close()


def test_flags_reach_the_batcher_and_the_handler(ckpt, monkeypatch):
    """``--prompt-cache --max-queue`` reach the batcher, the deadline flags
    the server's handler defaults."""
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep(provider, host, port, **deadlines):
        built.update(provider=provider, **deadlines)
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep)
    tapi.main(["--model", str(ckpt), "--device", "cpu", "--concurrent", "2", "--paged-pool", "4",
               "--prompt-cache", "--max-queue", "8", "--request-timeout", "30",
               "--ttft-timeout", "5"])
    batcher = built["provider"].generator
    assert batcher.prefix_cache and batcher.max_queue == 8 and batcher.prefix_stats() is not None
    assert (built["request_timeout"], built["ttft_timeout"]) == (30.0, 5.0)
    batcher.close()


# ------------------------------------------ against the JAX server, 8 slots
SERVER_ENGINE = {**ENGINE, "microbatches": 8, "pool_pages": 16}


def _batcher_servers(models, **kw):
    """The JAX and the port server, each over its package's batcher of the
    same weights; the servers run on threads, the batchers' schedulers run
    as requests come unless ``kw`` stops them."""
    jm, params, _ = models
    jb = jscheduler.ContinuousBatcher(JPipelineEngine(
        jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, paged_attention="ragged",
        **SERVER_ENGINE), decode_block=3, **kw)
    tb = ContinuousBatcher(_engine(models, **SERVER_ENGINE), decode_block=3, **kw)
    jprov = japi.ModelProvider.__new__(japi.ModelProvider)
    jprov.default_model = "tiny"
    jprov.trust_remote_paths = False
    jprov._key = None
    jprov._load_lock = threading.Lock()
    jprov._set("tiny", jb, ByteTokenizer())
    tprov = tapi.ModelProvider(tb, ByteTokenizer(), model_name="tiny")
    out = []
    for srv in (japi.make_server(jprov, "127.0.0.1", 0), tapi.make_server(tprov, "127.0.0.1", 0)):
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        out.append((srv, thread))
    return (jb, tb), out


def _close(batchers, servers):
    for srv, thread in servers:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for b in batchers:
        b.close()


def _post_full(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Retry-After"), json.loads(data) if data else None


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_ttft_timeout_answers_504_as_jax_does(models, stream):
    """Fault 4: ``--concurrent 8 --paged-pool 16`` and a request whose
    ``ttft_timeout`` is 1 ms. Both servers answer 504 with a timeout error
    before any token (streamed too: the first token is awaited before the
    200), and the port's scheduler then frees the request's pages."""
    batchers, servers = _batcher_servers(models)
    try:
        body = {"prompt": "the quick brown fox jumps", "max_tokens": 8, "ttft_timeout": 0.001,
                "stream": stream}
        got = [_post_full(srv.server_address[1], body) for srv, _ in servers]
        for status, _, payload in got:
            assert status == 504 and payload["error"]["type"] == "timeout_error", payload
            assert payload["error"]["message"].startswith("request deadline expired (")
        port_batcher = batchers[1]
        deadline = time.monotonic() + 30
        while port_batcher.page_stats()[1] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert port_batcher.page_stats()[1] == 0
        stats = port_batcher.resilience_stats()
        assert stats["timeouts"] + stats["shed_deadline"] >= 1
        # a request without a deadline is still served
        status, _, payload = _post_full(servers[1][0].server_address[1],
                                        {"prompt": "the quick brown fox", "max_tokens": 4})
        assert status == 200 and payload["usage"]["completion_tokens"] == 4
    finally:
        _close(batchers, servers)


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_full_queue_answers_429_with_jax_retry_after(models, stream):
    """``--max-queue 1`` with the schedulers held: one request waits in the
    queue, the next is shed with 429, an overload error and the JAX
    server's ``Retry-After`` (no completions yet: the 30 s ceiling). The
    waiting request then answers 504 on its TTFT budget."""
    batchers, servers = _batcher_servers(models, max_queue=1)
    for b in batchers:
        b._ensure_running = lambda: None
    try:
        waiting, shed = [], []
        for (srv, _), b in zip(servers, batchers):
            port = srv.server_address[1]
            t = threading.Thread(target=lambda port=port: waiting.append(_post_full(
                port, {"prompt": "hello", "max_tokens": 4, "ttft_timeout": 1.0})))
            t.start()
            deadline = time.monotonic() + 30
            while b._submit.qsize() < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            shed.append(_post_full(port, {"prompt": "hi", "max_tokens": 4, "stream": stream}))
            t.join(timeout=30)
        (js, jra, jpay), (ts, tra, tpay) = shed
        assert js == ts == 429
        assert tra == jra == "30"
        assert tpay["error"]["type"] == jpay["error"]["type"] == "overloaded_error"
        assert tpay["error"]["message"] == jpay["error"]["message"]
        assert [w[0] for w in waiting] == [504, 504]
        assert batchers[1].resilience_stats()["shed_queue_full"] == 1
    finally:
        _close(batchers, servers)
