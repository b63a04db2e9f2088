"""The port's server over two processes on the CPU (the cases of
``tests/test_multihost.py``): rank 0 serves HTTP and drives rank 1 over the
control plane on gloo, 4 pipeline stages, 2 on each rank (JAX's layout),
each rank holding only its own layers of the tiny checkpoint
(``tests/make_tiny_checkpoint.py``), loaded in f32.

- A greedy completion equals JAX's single-process 4-stage server's on the
  same checkpoint (in f32, token-identical texts); a seeded sampled one and
  a greedy one with logprobs equal the port's single-process 4-stage
  server's; a second request passes through the same workers.
- A step failing on the head rank alone (the ``multihost.sample`` fault),
  single stream and batcher: a 5xx at once, the workers resync and the next
  request equals the one-process server's; a logit_bias id outside the
  vocabulary gets a 400 before anything is broadcast.
- A SIGKILLed worker (JAX's ``test_worker_death_fails_cleanly_not_hang``,
  with a 10 s liveness budget): the next request gets a 5xx, ``/health``
  answers 503 ``degraded`` with ``workers_responsive`` false, a later
  request fails in under 30 s, and rank 0 stays alive.

Every rank is a subprocess with one torch thread, a timeout, and a kill in
``finally``; its log tail is shown when it fails."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
LAYOUT = ["--device", "cpu", "--num-stages", "4", "--max-seq", "128", "--prefill-chunk", "16"]
# a rank of the port's server, its load in f32
LAUNCH = ("import sys, torch; torch.set_num_threads(1); "
          "from mlx_sharding_tpu_torch.server.openai_api import main; "
          "main(sys.argv[1:], dtype=torch.float32)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port, body, path="/v1/completions", timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def get(port, path, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def metric(port, name):
    for line in get(port, "/metrics")[1].splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


class Deployment:
    """Two ranks of the port's server over gloo on this machine; ``port``
    is rank 0's HTTP port (``ports`` every rank's). ``stop()`` sends rank 0
    SIGTERM (which shuts the worker down; under ``--pod`` every host gets
    one) and kills whatever is left."""

    def __init__(self, ckpt, extra, tmp_path, env_extra=None, ranks=2):
        self.ports, coord = [free_port() for _ in range(ranks)], f"127.0.0.1:{free_port()}"
        self.port = self.ports[0]
        self.pod = "--pod" in extra
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.update(env_extra or {})
        self.logs = [tmp_path / f"rank{r}.log" for r in range(ranks)]
        self.procs = []
        for r in reversed(range(ranks)):
            argv = ["--model", str(ckpt), "--host", "127.0.0.1", "--port", str(self.ports[r]),
                    *extra,
                    "--coordinator", coord, "--num-processes", str(ranks), "--process-id",
                    str(r)]
            with open(self.logs[r], "w") as log:
                self.procs.insert(0, subprocess.Popen(
                    [sys.executable, "-c", LAUNCH, *argv], env=env, cwd=str(REPO), stdout=log,
                    stderr=subprocess.STDOUT))

    def tails(self) -> str:
        return "\n".join(f"--- rank {r}\n" + Path(p).read_text()[-3000:]
                         for r, p in enumerate(self.logs))

    def wait_healthy(self, timeout=180):
        deadline = time.time() + timeout
        waiting = list(self.ports if self.pod else self.ports[:1])
        while time.time() < deadline:
            for p in self.procs:
                if p.poll() is not None:
                    raise AssertionError(f"a rank exited rc={p.returncode}\n{self.tails()}")
            try:
                if get(waiting[0], "/health", timeout=5)[0] == 200:
                    waiting.pop(0)
                    if not waiting:
                        return
                    continue
            except OSError:
                pass
            time.sleep(0.5)
        raise AssertionError(f"the deployment did not become healthy\n{self.tails()}")

    def stop(self):
        for p in self.procs if self.pod else self.procs[:1]:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return str(make_tiny_checkpoint(tmp_path_factory.mktemp("mh_ckpt")))


def serve_in_process(provider, make_server):
    srv = make_server(provider, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def stop_in_process(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def port_reference(ckpt, extra: dict, requests: list) -> list:
    """The port's single-process server (4 stages unless ``extra`` says
    otherwise, f32) over ``requests``."""
    import torch

    from mlx_sharding_tpu_torch.server import openai_api as tapi

    prov = tapi.ModelProvider.from_checkpoint(
        ckpt, device="cpu", max_seq=128, prefill_chunk=16, dtype=torch.float32,
        **{"num_stages": 4, **extra})
    srv, thread = serve_in_process(prov, tapi.make_server)
    try:
        return [requests_fn(srv.server_address[1]) for requests_fn in requests]
    finally:
        stop_in_process(srv, thread)
        gen = prov.generator
        if getattr(gen, "concurrent", False):
            gen.close()


GREEDY = {"prompt": "the quick brown fox", "max_tokens": 8, "seed": 5}
SAMPLED = {"prompt": "hello world", "max_tokens": 8, "seed": 7, "temperature": 0.8,
           "top_p": 0.9}
LOGPROBS = {"prompt": "pipelines run on meshes", "max_tokens": 5, "logprobs": 3}
SECOND = {"prompt": "hello world", "max_tokens": 5, "seed": 7}


def _text(port, body):
    status, data = post(port, body)
    assert status == 200, data
    return data["choices"][0]["text"], data["choices"][0]["logprobs"]


def test_two_process_serving_matches_one_process_and_jax(ckpt, tmp_path):
    import jax.numpy as jnp

    from mlx_sharding_tpu.server import openai_api as japi

    bodies = (GREEDY, SAMPLED, LOGPROBS)
    ref = port_reference(ckpt, {}, [lambda port, b=b: _text(port, b) for b in bodies])
    jprov = japi.ModelProvider(ckpt, num_stages=4, max_seq=128, prefill_chunk=16,
                               cache_dtype=jnp.float32)
    srv, thread = serve_in_process(jprov, japi.make_server)
    try:
        jax_greedy = _text(srv.server_address[1], GREEDY)[0]
    finally:
        stop_in_process(srv, thread)
    dep = Deployment(ckpt, LAYOUT, tmp_path)
    try:
        dep.wait_healthy()
        got = [_text(dep.port, b) for b in bodies]
        assert got[0][0] == jax_greedy, dep.tails()
        assert got == ref, dep.tails()
        # a second request through the same workers: the protocol went back
        # to its idle loop after the STOP
        text, _ = _text(dep.port, SECOND)
        assert isinstance(text, str)
        status, health = get(dep.port, "/health")
        health = json.loads(health)
        assert status == 200 and health["multihost"]["workers_responsive"] is True
    finally:
        dep.stop()
    assert [p.returncode for p in dep.procs] == [0, 0], dep.tails()


def test_worker_death_fails_cleanly_not_hang(ckpt, tmp_path):
    """SIGKILL rank 1 of a live deployment: the next request gets a 5xx
    within the liveness budget (not a hang of rank 0 in a collective),
    /health flips to degraded (503, workers_responsive false), later
    requests fail fast off the dead plane, and rank 0 stays alive."""
    dep = Deployment(ckpt, LAYOUT, tmp_path, {"MST_MULTIHOST_TIMEOUT_S": "10"})
    try:
        dep.wait_healthy()
        status, ok = post(dep.port, {"prompt": "the quick", "max_tokens": 4, "seed": 3})
        assert status == 200 and isinstance(ok["choices"][0]["text"], str)

        dep.procs[1].kill()  # SIGKILL: no cleanup, no goodbye
        dep.procs[1].wait(timeout=10)

        status, err = post(dep.port, {"prompt": "hello", "max_tokens": 4}, timeout=60)
        assert status >= 500 and "error" in err

        status, body = get(dep.port, "/health")
        health = json.loads(body)
        assert status == 503
        assert health["status"] == "degraded"
        assert health["multihost"]["workers_responsive"] is False

        t0 = time.time()
        status2, err2 = post(dep.port, {"prompt": "again", "max_tokens": 4}, timeout=60)
        assert status2 >= 500 and "error" in err2
        assert time.time() - t0 < 30
        assert dep.procs[0].poll() is None  # rank 0 never wedged or died
    finally:
        dep.stop()


@pytest.mark.parametrize("extra,reference,after", [
    # the single stream: the fourth sampling, inside the first decode block
    ([], {}, 3),
    # the mirror batcher: the first token, sampled after the prefill
    (["--concurrent", "2", "--paged-pool", "12", "--page-size", "16"],
     dict(concurrent=2, paged_pool=12, page_size=16), 0),
], ids=["stream", "concurrent"])
def test_a_step_failing_on_the_head_rank_fails_every_rank(ckpt, tmp_path, extra, reference,
                                                           after):
    """Rank 1 holds the head and samples alone; its sampling raises once
    (the ``multihost.sample`` fault). The token broadcast still completes,
    with its status set, so rank 0 raises in the same step: the request
    gets a 5xx at once, not after the 20 s liveness budget, and the plane
    stays up. The workers resync (the drain to STOP; OP_B_FAIL), and the
    next request equals the one-process server's. A logit_bias id outside
    the vocabulary, which only the head rank would meet, is refused with a
    400 before anything is broadcast."""
    (ref,) = port_reference(ckpt, reference, [lambda port: _text(port, GREEDY)])
    dep = Deployment(ckpt, [*LAYOUT, *extra], tmp_path,
                     {"MST_FAULTS": f"multihost.sample:exc=runtime:times=1:after={after}",
                      "MST_MULTIHOST_TIMEOUT_S": "20"})
    try:
        dep.wait_healthy()
        t0 = time.time()
        status, err = post(dep.port, GREEDY, timeout=60)
        assert status >= 500 and "error" in err, (status, err, dep.tails())
        assert time.time() - t0 < 15, dep.tails()
        assert "share of this step failed" in Path(dep.logs[0]).read_text(), dep.tails()
        status, err = post(dep.port, {**GREEDY, "logit_bias": {"1000000": 5.0}})
        assert status == 400 and "logit_bias token ids" in err["error"]["message"], err
        assert _text(dep.port, GREEDY) == ref, dep.tails()
        status, health = get(dep.port, "/health")
        assert status == 200 and json.loads(health)["multihost"]["workers_responsive"] is True
    finally:
        dep.stop()
    assert [p.returncode for p in dep.procs] == [0, 0], dep.tails()


def test_two_process_tp_shards_stay_in_process(ckpt, tmp_path):
    """``--tp 2`` over two processes: each rank runs its two stages as two
    shards in process (``mesh.run_shards``), and a greedy completion equals
    the port's single-process 4-stage tp = 2 server's."""
    (ref,) = port_reference(ckpt, dict(tp=2), [lambda port: _text(port, GREEDY)])
    dep = Deployment(ckpt, [*LAYOUT, "--tp", "2"], tmp_path)
    try:
        dep.wait_healthy()
        assert _text(dep.port, GREEDY) == ref, dep.tails()
    finally:
        dep.stop()
    assert [p.returncode for p in dep.procs] == [0, 0], dep.tails()


def test_a_rank_loads_and_places_only_its_stages(ckpt):
    """Rank 1 of 2 over 4 stages (no deployment needed to build it): its
    model holds layers 2-3, the final norm and the head, not the embedding;
    its engine runs stages 2-3, with the caches of rank 0's stages on the
    ``meta`` device (nothing allocated) and half the tiny model's layer
    bytes."""
    import torch

    from mlx_sharding_tpu_torch.cache import stage_caches
    from mlx_sharding_tpu_torch.loading import load_model, load_rank_model
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel.mesh import process_layout
    from mlx_sharding_tpu_torch.weights import model_weight_bytes

    layout = process_layout(4, rank=1, size=2)
    bounds = [(0, 1), (1, 2), (2, 3), (3, 4)]
    model, cfg = load_rank_model(ckpt, bounds, layout, dtype=torch.float32, device="cpu")
    full, _ = load_model(ckpt, dtype=torch.float32, device="cpu")
    assert (cfg.start_layer, cfg.end_layer) == (0, 4) and len(model.layers) == 4
    assert not hasattr(model, "embed_tokens") and hasattr(model, "lm_head")
    assert [len(list(m.parameters())) > 0 for m in model.layers] == [False, False, True, True]
    for i in (2, 3):
        for (n, p), (_, q) in zip(model.layers[i].named_parameters(),
                                  full.layers[i].named_parameters()):
            assert torch.equal(p, q), n
    engine = PipelineEngine(model, stage_bounds=bounds, max_seq=64, prefill_chunk=16,
                            device="cpu", processes=layout)
    assert engine.local_stages == [2, 3] and engine.device == torch.device("cpu")
    caches = stage_caches(engine.init_cache())
    assert [c.k.device.type for c in caches] == ["meta", "meta", "cpu", "cpu"]
    layer_bytes = sum(model_weight_bytes(full.layers[i]) for i in range(4))
    assert model_weight_bytes(model) == (layer_bytes // 2 + model_weight_bytes(full.lm_head)
                                         + full.final_norm.numel() * 4)
