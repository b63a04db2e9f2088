"""The port's OpenAI server over continuous batching on the CPU: ``--concurrent
2 --paged-pool 10 --device cpu`` answers concurrent HTTP requests with what
the same requests get one at a time, a concurrent generator is served
without the generation lock, and the server's flags keep the JAX parser's
checks."""

import concurrent.futures
import http.client
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi

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
    (["--concurrent", "2"], "not yet ported: pass --paged-pool"),
    (["--paged-pool", "10"], "--paged-pool requires --concurrent N (N > 1)"),
    (["--page-size", "256"], "--page-size requires --paged-pool"),
    (["--paged-attention", "ragged"], "--paged-attention requires --paged-pool"),
    (["--kv-dtype", "int8"], "--kv-dtype requires --paged-pool"),
    (["--admission-policy", "first_fit"], "--admission-policy requires --paged-pool"),
    (["--concurrent", "2", "--paged-pool", "4", "--paged-attention", "gather"],
     "invalid choice: 'gather'"),
    (["--overcommit"], "--overcommit requires --paged-pool"),
    (["--async-sched", "off"], "--async-sched requires --concurrent N (N > 1)"),
    (["--concurrent", "2", "--paged-pool", "4", "--async-sched", "sometimes"],
     "invalid choice: 'sometimes'"),
])
def test_flag_checks(argv, message, capsys):
    with pytest.raises(SystemExit) as info:
        tapi.main(["--model", "unused", "--device", "cpu", *argv])
    assert info.value.code == 2
    assert message in capsys.readouterr().err


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

    def keep_provider(provider, host, port):
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
