"""The port's multi-host wire and collectives (``mlx_sharding_tpu_torch/
parallel/multihost.py``, ``pod.CollectiveTransport``) against the JAX
package's (``mlx_sharding_tpu/parallel/multihost.py``, ``pod.py``):

- the wire helpers, which are pure numpy in both packages: ``_request_msg``,
  ``_assign_msg``, ``_pack_seed`` / ``_unpack_seed``, ``_pack_bias`` /
  ``_unpack_bias`` and ``_req_from_msg`` give arrays bit-equal to JAX's on
  the same seeded requests, and the pod transport's framed blob (a
  fragmented block too) is byte-equal to JAX's and delivers the same
  messages either way;
- the process layout over pp (stage s on rank ``s // (S / P)``) and its
  refusals, and the device grid of one rank;
- two ranks over real gloo (two subprocesses, one torch thread each, each
  with a timeout and killed in ``finally``): ``ControlPlane.exchange``
  (bit-equal messages on the worker), ``PodControlPlane.pod_exchange``,
  the stage hop and the token broadcast, a step failed on one rank (a
  failed hop, the head's sampling raising: every rank raises in that
  call and the next goes through), the injected ``multihost.exchange``
  drop (``WorkerTimeoutError``, the plane dead, the next exchange failing at
  once), and a peer that exits (rank 0's next exchange and hop fail within
  the budget and leave the plane dead)."""

import json
import os
import socket
import subprocess
import sys
import uuid
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mlx_sharding_tpu import pod as jpod
from mlx_sharding_tpu.parallel import multihost as jmh
from mlx_sharding_tpu_torch import pod as tpod
from mlx_sharding_tpu_torch.parallel import mesh as tmesh
from mlx_sharding_tpu_torch.parallel import multihost as tmh

REPO = Path(__file__).resolve().parent.parent


def _requests(n=6, seed=0):
    """Seeded requests as both packages' wire helpers read them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bias = ({int(k): float(v) for k, v in zip(rng.integers(0, 300, 3 + i),
                                                     rng.normal(size=3 + i))}
                if i % 2 else None)
        out.append(SimpleNamespace(
            prompt=rng.integers(0, 300, int(rng.integers(1, 40))).astype(np.int64),
            temperature=float(rng.choice([0.0, 0.7, 1.3])), top_p=float(rng.uniform(0.5, 1.0)),
            repetition_penalty=None if i % 3 == 0 else (0.0 if i == 4 else 1.2),
            rep_context=int(rng.integers(1, 64)), logit_bias=bias,
            seed=int(rng.integers(0, 1 << 62)), max_tokens=int(rng.integers(1, 100)),
            want_logprobs=bool(i % 2)))
    return out


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("i", range(6))
def test_request_and_assign_messages_are_jax_bit_for_bit(i):
    r = _requests()[i]
    args = (r.prompt, r.temperature, r.top_p, r.repetition_penalty, r.rep_context,
            r.logit_bias, r.seed, r.max_tokens)
    _same(tmh._request_msg(*args), jmh._request_msg(*args))
    _same(tmh._assign_msg(r, 3), jmh._assign_msg(r, 3))
    # the port carries want_logprobs in JAX's reserved float: nothing else moves
    with_lp = tmh._request_msg(*args, want_logprobs=True)
    assert with_lp["floats"][3] == 1.0
    _same({k: v for k, v in with_lp.items() if k != "floats"},
          {k: v for k, v in jmh._request_msg(*args).items() if k != "floats"})


def test_seed_and_bias_packing_round_trip_as_jax():
    for seed in (0, 1, (1 << 31) - 1, 1 << 31, (1 << 62) - 1, 123456789012345):
        assert tmh._pack_seed(seed) == jmh._pack_seed(seed)
        assert tmh._unpack_seed(*tmh._pack_seed(seed)) == seed
    for r in _requests():
        t, j = tmh._pack_bias(r.logit_bias), jmh._pack_bias(r.logit_bias)
        assert t[2] == j[2]
        assert t[0].tobytes() == j[0].tobytes() and t[1].tobytes() == j[1].tobytes()
        assert tmh._unpack_bias(*t) == jmh._unpack_bias(*j)
    big = {i: 1.0 for i in range(tmh._BIAS_SLOTS + 1)}
    for pkg in (tmh, jmh):
        with pytest.raises(ValueError, match="exceeds the multi-host control-plane width"):
            pkg._pack_bias(big)


def test_a_worker_rebuilds_the_request_jax_does():
    for r in _requests():
        msg = jmh._assign_msg(r, 1)
        t, j = tmh._req_from_msg(msg), jmh._req_from_msg(msg)
        assert t.prompt.tolist() == np.asarray(j.prompt).tolist() == r.prompt.tolist()
        assert (t.seed, t.max_tokens, t.rep_context, t.want_logprobs) == (
            j.seed, j.max_tokens, j.rep_context, j.want_logprobs)
        assert float(t.sp.temperature) == pytest.approx(float(j.sp.temperature))
        assert float(t.sp.top_p) == pytest.approx(float(j.sp.top_p))


class _Plane:
    """A pod plane that only has a width (the framing reads nothing else)."""

    blob_bytes = 4096
    dead = False


def _transports(monkeypatch):
    fixed = uuid.UUID(int=0x1234)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    return (tpod.CollectiveTransport(plane=_Plane()), jpod.CollectiveTransport(plane=_Plane()))


def test_pod_blob_framing_is_jax_byte_for_byte(monkeypatch):
    """The first tick's blob (the heartbeat and the small messages) is
    JAX's byte for byte. A block over one blob then ships in whole
    fragments: JAX sizes a fragment to leave 64 bytes of the blob for the
    heartbeat, which a gossiped info outgrows, so its outbox never drains
    (a fault of the reference); the port sends such a fragment alone, and
    the receiver reassembles the block."""
    tt, jt = _transports(monkeypatch)
    big = bytes(np.random.default_rng(1).integers(0, 256, 9000, dtype=np.uint8))
    for t in (tt, jt):
        t.publish({"fleet": {"pressure": 0.5}, "weights": {"trees": 1}})
        t.send(1, "handoff.block", b"abc")
        t.send(-1, "registry.teardown", b"")
        t.send(1, "block", big)  # three fragments over a 4096-byte blob
    first = tt._drain_outbox()
    assert first == jt._drain_outbox() and first[1] == 3
    ticks = [first[0]]
    for _ in range(3):
        assert jt._drain_outbox()[1] == 1 and len(jt._outbox) == 3  # JAX: heartbeats only
        ticks.append(tt._drain_outbox()[0])
    assert not tt._outbox
    # each package delivers the port's blobs as the same messages
    seen = {"port": [], "jax": []}
    rx = {"port": tpod.CollectiveTransport(plane=_Plane()),
          "jax": jpod.CollectiveTransport(plane=_Plane())}
    for name, t in rx.items():
        t.host_id = 1
        t.set_handler(lambda src, kind, payload, name=name: seen[name].append(
            (src, kind, bytes(payload))))
        for blob in ticks:
            t._deliver(0, blob)
    assert seen["port"] == seen["jax"]
    assert [k for _, k, _ in seen["port"]] == ["handoff.block", "registry.teardown", "block"]
    assert seen["port"][2][2] == big
    assert rx["port"].peers()[0]["info"] == {"fleet": {"pressure": 0.5}, "weights": {"trees": 1}}


@pytest.mark.parametrize("stages,size,want", [
    (4, 2, (0, 0, 1, 1)), (2, 2, (0, 1)), (6, 3, (0, 0, 1, 1, 2, 2)), (4, 1, None)])
def test_stages_split_evenly_over_the_processes(stages, size, want):
    layout = tmesh.process_layout(stages, rank=1 % size, size=size)
    assert (layout.stage_ranks if layout is not None else None) == want
    if layout is not None:
        assert layout.local_stages == [s for s, r in enumerate(want) if r == 1 % size]
        assert layout.head_rank == size - 1


def test_a_split_that_cuts_stages_or_groups_is_refused():
    with pytest.raises(ValueError, match="do not split evenly over 2 processes"):
        tmesh.process_layout(3, rank=0, size=2)
    for kw in (dict(tp=2), dict(ep=2), dict(sp=2)):
        with pytest.raises(NotImplementedError, match="spanning processes"):
            tmesh.process_layout(1, rank=0, size=2, **kw)


def test_a_rank_holds_only_its_own_stages_on_its_devices():
    layout = tmesh.process_layout(4, rank=1, size=2)
    grid = tmesh.device_grid(pp=4, tp=2, device="cpu", procs=layout)
    assert [str(d) for d in grid[:, 0, 0, :].flat] == ["meta"] * 4 + ["cpu"] * 4
    assert [str(d) for d in tmesh.stage_devices(4, "cpu", layout)] == ["meta", "meta", "cpu",
                                                                       "cpu"]


# ------------------------------------------------------------- two ranks
RANK = r'''
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from mlx_sharding_tpu_torch.parallel import multihost as mh
from mlx_sharding_tpu_torch.testing import faults

rank, port, msgs = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
mh.init_process(f"127.0.0.1:{port}", 2, rank)
out = {}
ctrl = mh.ControlPlane(max_prompt=64, timeout_s=30)
for m in msgs:
    got = ctrl.exchange({k: np.asarray(v[0], v[1]) for k, v in m.items()} if rank == 0 else None)
    out.setdefault("exchanged", []).append({k: v.tobytes().hex() for k, v in got.items()})
pod = mh.PodControlPlane(blob_bytes=4096, timeout_s=30)
hdr, blob = pod.pod_exchange(np.arange(8) + 10 * rank, np.full(100 + rank, rank + 1, np.uint8))
out["pod"] = [hdr.tolist(), [int(blob[h, :110].sum()) for h in range(2)], list(blob.shape)]
x = torch.arange(24, dtype=torch.float32).reshape(1, 3, 8).to(torch.bfloat16) * 0.37
if rank == 0:
    mh.send_hidden(x, 1)
else:
    out["hop_equal"] = bool(torch.equal(mh.recv_hidden((1, 3, 8), torch.bfloat16, 0, "cpu"), x))
def run():
    tok = torch.tensor([5, 7])
    lp = (torch.tensor([-0.5, -1.5]), torch.arange(20.0).reshape(2, 10) * -0.25,
          torch.arange(20).reshape(2, 10))
    return tok, lp
tok, lp = mh.share_tokens(run if rank == 1 else None, 2, True, 1, "cpu")
out["tokens"] = [tok.tolist(), lp[0].tolist(), lp[1].tolist(), lp[2].tolist()]
tok, lp = mh.share_tokens((lambda: (torch.tensor([9]), None)) if rank == 1 else None,
                          1, False, 1, "cpu")
out["greedy_tokens"] = [tok.tolist(), lp]
# a failed step: rank 0 sends a failed share down the hop; the head's
# sampling raises; the head's share failed before the sampling
if rank == 0:
    mh.send_hidden(None, 1, shape=(1, 3, 8), dtype=torch.bfloat16)
else:
    try:
        mh.recv_hidden((1, 3, 8), torch.bfloat16, 0, "cpu")
        out["failed_hop"] = "ok"
    except mh.PeerStepError as e:
        out["failed_hop"] = type(e).__name__
def boom():
    raise ValueError("the head's sampling failed")
for run, error in ((boom, None), (run, RuntimeError("the head's stages failed"))):
    try:
        mh.share_tokens(run if rank == 1 else None, 2, True, 1, "cpu",
                        error=error if rank == 1 else None)
        out.setdefault("failed_steps", []).append("ok")
    except Exception as e:
        out.setdefault("failed_steps", []).append(type(e).__name__)
tok, _ = mh.share_tokens((lambda: (torch.tensor([3]), None)) if rank == 1 else None,
                         1, False, 1, "cpu")
out["after_failures"] = [tok.tolist(), mh.hop_failed()]
if rank == 1:
    print(json.dumps(out), flush=True)
    os._exit(0)  # the peer leaves without a goodbye
# rank 0: an injected drop on a plane of its own ...
faults.arm("multihost.exchange", exc=faults.DropExchange, times=1)
drop = mh.ControlPlane(max_prompt=64, timeout_s=30)
kinds = []
for _ in range(2):
    try:
        drop.exchange({"header": np.asarray([mh.OP_DECODE], np.int32)})
        kinds.append("ok")
    except mh.WorkerTimeoutError as e:
        kinds.append(str(e).split(" — ")[0])
out["drop"] = [kinds, drop.dead]
faults.disarm()
# ... then the exited peer: the exchange and the hop fail within the budget
time.sleep(1.0)
t0 = time.monotonic()
try:
    ctrl.exchange({"header": np.asarray([mh.OP_DECODE], np.int32)})
    out["dead_exchange"] = "ok"
except mh.WorkerTimeoutError:
    out["dead_exchange"] = "WorkerTimeoutError"
fresh = mh.ControlPlane(max_prompt=64, timeout_s=30)
try:
    mh.send_hidden(torch.zeros(1 << 20), 1)
    mh.recv_hidden((4,), torch.float32, 1, "cpu")
    out["dead_hop"] = "ok"
except mh.WorkerTimeoutError:
    out["dead_hop"] = "WorkerTimeoutError"
out["dead_s"] = time.monotonic() - t0
out["planes_dead"] = [ctrl.dead, fresh.dead, mh.hop_failed()]
print(json.dumps(out), flush=True)
os._exit(0)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                MST_MULTIHOST_TIMEOUT_S="20")


def test_two_ranks_over_gloo():
    reqs = _requests(3, seed=5)
    msgs = [tmh._request_msg(r.prompt, r.temperature, r.top_p, r.repetition_penalty,
                             r.rep_context, r.logit_bias, r.seed, r.max_tokens)
            for r in reqs]
    wire = json.dumps([{k: (v.tolist(), str(v.dtype)) for k, v in m.items()} for m in msgs])
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(rank), str(port), wire],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
                              cwd=str(REPO)) for rank in (1, 0)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    reports = []
    for text in outs:
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        assert lines, text[-3000:]
        reports.append(json.loads(lines[-1]))
    r1, r0 = reports
    # the worker received rank 0's messages bit for bit (padded to the plane)
    plane = tmh.ControlPlane(max_prompt=64)
    for m, got in zip(msgs, r1["exchanged"]):
        want = plane._zeros()
        for k, v in m.items():
            want[k][: v.size] = v
        assert got == {k: v.tobytes().hex() for k, v in want.items()}
    assert r0["exchanged"] == r1["exchanged"]
    # the pod plane: both headers and both blobs, stacked by rank, everywhere
    assert r0["pod"] == r1["pod"] == [[list(range(10, 18)) if h else list(range(8))
                                       for h in (0, 1)], [100, 202], [2, 4096]]
    assert r1["hop_equal"]
    assert r0["tokens"] == r1["tokens"]
    assert r0["tokens"][0] == [5, 7] and r0["tokens"][3][1] == list(range(10, 20))
    assert r0["greedy_tokens"] == [[9], None]
    # a failed share reaches the next rank as PeerStepError; a failed head
    # raises its own error after the broadcast and every other rank
    # PeerStepError in the same call; the lockstep holds and the hop is up
    assert r1["failed_hop"] == "PeerStepError"
    assert r1["failed_steps"] == ["ValueError", "RuntimeError"]
    assert r0["failed_steps"] == ["PeerStepError", "PeerStepError"]
    assert r0["after_failures"] == r1["after_failures"] == [[3], False]
    assert r0["drop"] == [["multi-host collective dropped (injected fault)",
                           "multi-host control plane is down (a peer rank previously failed "
                           "to respond)"], True]
    assert r0["dead_exchange"] == r0["dead_hop"] == "WorkerTimeoutError"
    assert r0["dead_s"] < 60
    assert r0["planes_dead"] == [True, True, True]
