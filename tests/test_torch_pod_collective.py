"""The pod over its collective transport on the CPU: two processes over
gloo, each a pod host with its own fleet (``pod.CollectiveTransport`` over
``parallel.multihost.PodControlPlane``).

- The pod's own two-process self-test (``python -m
  mlx_sharding_tpu_torch.pod``, JAX's ``test_gloo_two_process_acceptance``
  contract): one weight tree per host aliased by two batchers, a
  cross-host handoff whose greedy stream is bit-identical to a monolithic
  batcher's (its bytes counted), an injected ``pod.handoff`` fault and a
  host death mid-relay both served locally with their fallbacks counted
  and no dropped stream.
- The server's ``--pod``: two hosts of the tiny checkpoint, each a
  one-batcher fleet; each answers as one batcher does, and each host's
  ``/health`` shows both hosts alive in its ``pod`` block.

Every process has one torch thread, a timeout and a kill in ``finally``."""

import json
import os
import subprocess
import sys
import time

from tests.test_torch_multihost import (  # noqa: F401
    LAYOUT,
    REPO,
    Deployment,
    ckpt,
    free_port,
    get,
    port_reference,
    post,
)


def test_gloo_two_process_acceptance():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")

    def spawn(rank):
        return subprocess.Popen(
            [sys.executable, "-m", "mlx_sharding_tpu_torch.pod", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(rank),
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=str(REPO))

    r1 = spawn(1)
    r0 = spawn(0)
    try:
        out = r0.communicate(timeout=180)[0].decode()
    finally:
        r0.kill()
        r1.kill()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert lines, f"rank 0 printed no report:\n{out[-3000:]}"
    report = json.loads(lines[-1])
    assert report["ok"] is True, report
    assert r0.returncode == 0
    for host in ("0", "1"):
        w = report["hosts"][host]["weights"]
        assert w["trees"] == 1 and w["refs"] >= 2
    assert report["handoff"]["match"] and report["handoff"]["shipped"] >= 1
    assert report["handoff"]["bytes_shipped"] > 0
    assert report["fault_sweep"]["fallbacks"]["handoff_fault"] == 1
    assert report["host_death"]["match"]
    assert report["host_death"]["dropped_streams"] == 0


def test_pod_hosts_serve_from_the_server_flag(ckpt, tmp_path):  # noqa: F811
    body = {"prompt": "the quick brown fox", "max_tokens": 8, "seed": 5}
    layout = ["--device", "cpu", "--max-seq", "128", "--prefill-chunk", "16",
              "--concurrent", "2", "--paged-pool", "12", "--page-size", "16"]
    (ref,) = port_reference(ckpt, dict(concurrent=2, paged_pool=12, page_size=16, num_stages=1),
                            [lambda port: post(port, body)[1]["choices"][0]["text"]])
    dep = Deployment(ckpt, [*layout, "--pod"], tmp_path)
    try:
        dep.wait_healthy()
        for port in dep.ports:
            status, data = post(port, body)
            assert status == 200 and data["choices"][0]["text"] == ref, dep.tails()
        for port in dep.ports:
            deadline = time.time() + 30
            while True:
                pod = json.loads(get(port, "/health")[1]).get("pod") or {}
                hosts = pod.get("hosts", {})
                if set(hosts) == {"0", "1"} and all(h["alive"] for h in hosts.values()):
                    break
                assert time.time() < deadline, (pod, dep.tails())
                time.sleep(0.5)
    finally:
        dep.stop()
