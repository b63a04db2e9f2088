"""The port's continuous batching over two processes on the CPU (the case of
``tests/test_multihost_concurrent.py``): ``--concurrent 2 --paged-pool 12
--page-size 16 --prompt-cache`` under ``--coordinator``, 4 stages over 2
ranks in f32. Rank 0 runs the real scheduler and broadcasts each device op;
rank 1 mirrors them on an identical batcher. JAX's request battery (a stop
sequence that cancels a slot mid-stream, greedy, seeded sampling, a
multi-chunk prefill, two interleaved requests, a shared prefix) answers
exactly as the port's single-process batcher does, and the deployment's
prefix cache hits (``mst_prefix_cache_hits_total >= 1``): the mirrors kept
identical page tables."""

from tests.test_multihost_concurrent import _forced_token, _run_requests
from tests.test_torch_multihost import LAYOUT, Deployment, ckpt, metric, port_reference  # noqa: F401

CONCURRENT = ["--concurrent", "2", "--paged-pool", "12", "--page-size", "16", "--prompt-cache"]


def test_two_process_concurrent_matches_one_process(ckpt, tmp_path):  # noqa: F811
    forced = _forced_token(ckpt)
    (ref,) = port_reference(
        ckpt, dict(concurrent=2, paged_pool=12, page_size=16, prompt_cache=True),
        [lambda port: _run_requests(port, forced)])
    dep = Deployment(ckpt, [*LAYOUT, *CONCURRENT], tmp_path)
    try:
        dep.wait_healthy()
        got = _run_requests(dep.port, forced)
        assert got == ref, dep.tails()
        hits = metric(dep.port, "mst_prefix_cache_hits_total")
        assert hits is not None and hits >= 1
    finally:
        dep.stop()
    assert [p.returncode for p in dep.procs] == [0, 0], dep.tails()
