"""Multi-host serving over ``torch.distributed`` (port of
``mlx_sharding_tpu/parallel/multihost.py``).

One shard process per machine, driven by a primary: rank 0 owns the
tokenizer, the HTTP server and the decode loop; ranks > 0 serve no HTTP and
mirror rank 0's step sequence (:func:`serve_worker`,
:func:`serve_worker_batched`). What differs from JAX, by design:

- JAX runs the model as one SPMD program over a global mesh: every process
  executes the same jitted step and activations cross processes inside XLA
  collectives. Here each rank holds only its own pipeline stages (stage s
  belongs to rank ``s // (S / P)``, ``parallel.mesh.process_layout``) and
  runs only them: where the next stage lies on another rank, the stage
  boundary's hidden state is sent to it (:func:`send_hidden` /
  :func:`recv_hidden`), staged through host memory.
- JAX samples redundantly on every process (the same key chain everywhere).
  Here the rank that holds the last stage applies the head and samples, and
  broadcasts the tokens to every rank, with each row's logprob summary
  where it was asked for (:func:`share_tokens`): every mirror then emits
  the same tokens, so its max-tokens finishes and page frees match rank
  0's. JAX's failures are alike on every process because every process
  runs the whole step; here a rank's share of a step can fail alone, so
  the hop and the token broadcast carry a status and every rank raises in
  the same step (:class:`PeerStepError`).
- The wire: the control plane's fixed-shape int32 / float32 host buffers
  (JAX's layout exactly: :func:`_request_msg`, :func:`_assign_msg`) go out
  in one ``broadcast`` from rank 0 (:func:`broadcast_one_to_all`); the
  pod's plane is an ``all_gather`` (:func:`process_allgather`).

Backend: gloo, whatever the device. NCCL refuses two ranks of one
communicator on one card, which is how ranks share a one-card host, so
every collective here takes CPU tensors; a hop over NCCL between distinct
cards is not written (ROADMAP queue 1). Three threads issue collectives on a
serving rank: the control plane's daemon thread (its broadcasts), the
scheduler or request thread (the hops and the token broadcasts) and the pod
transport's thread (its allgather). Collectives of two threads on one group
can interleave differently on each rank and hang, so each has a group of
its own, made in the same order on every rank by :func:`init_process`.

The numpy wire helpers (:func:`_pack_seed`, :func:`_pack_bias`,
:func:`_request_msg`, :func:`_assign_msg` and their inverses) are copied
from the JAX module.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue as _q
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.sample import make_sampler_params
from mlx_sharding_tpu_torch.testing.faults import inject
from mlx_sharding_tpu_torch.utils.clock import MONOTONIC, Clock
from mlx_sharding_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)


class WorkerTimeoutError(RuntimeError):
    """A control-plane collective did not complete in time — a peer rank is
    dead or wedged. The plane is marked down: every later exchange fails
    fast instead of stranding another thread in the collective, so rank 0
    keeps answering (5xx + degraded /health) and can be restarted."""


class PeerStepError(RuntimeError):
    """Another rank's share of this step failed (its stages, its head or
    its sampling). Every rank raises in the same step (the hop's status
    byte and the token broadcast's status column carry the failure), so
    the lockstep holds: rank 0 fails the request and the workers resync
    as they do after a failure of their own. The plane stays up."""


# control ops
OP_IDLE = 0
OP_REQUEST = 1
OP_DECODE = 2
OP_STOP_REQUEST = 3
OP_SHUTDOWN = 4
# continuous-batching ops (the batched protocol below)
OP_B_ASSIGN = 10
OP_B_PREFILL = 11
OP_B_DECODE = 12
OP_B_CANCEL = 13
OP_B_FAIL = 14

# matches the scheduler's per-slot width and the HTTP layer's validation cap,
# so a request that works on one host never fails on several
_BIAS_SLOTS = 512

#: the collectives' backend (the module docstring says why)
BACKEND = "gloo"


# ------------------------------------------------------------ process layer
# the process's deployment (torch.distributed's own state is the
# process's): the three groups of the serving threads once init_process
# ran, and whether a hop has failed (the lockstep is then broken)
_STATE: dict = {"groups": None, "hop_failed": False}


def hop_counters() -> dict:
    """Zeroed counters of a rank's hop (an engine's ``hop_stats``): hidden
    states sent and received (count, bytes, seconds in the call: a
    receive's seconds include its wait for the peer's stages, a send's the
    host copy, which waits for the stage's work) and the token
    broadcasts."""
    return {"sent": 0, "received": 0, "bytes_sent": 0, "bytes_received": 0, "send_s": 0.0,
            "recv_s": 0.0, "token_broadcasts": 0, "token_bytes": 0, "token_s": 0.0}


def _timeout_s() -> float:
    try:
        return float(os.environ.get("MST_MULTIHOST_TIMEOUT_S", "600"))
    except ValueError:
        return 600.0


def init_process(coordinator: str, num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> None:
    """Join the deployment (JAX ``jax.distributed.initialize``): a
    ``torch.distributed`` process group over ``tcp://coordinator`` (rank 0
    listens there) of ``num_processes`` ranks, this one ``process_id``,
    and the groups of the control plane, the hop and the pod, made in that
    order on every rank. The hop's group times out after the liveness
    budget (``MST_MULTIHOST_TIMEOUT_S``), so a wedged peer cannot hold a
    step forever. Nothing is detected from the environment: without
    ``num_processes`` the deployment is this one process (rank 0), and
    with more than one every process names its rank."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = 1
    if process_id is None and num_processes == 1:
        process_id = 0
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes!r}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), got {process_id!r}")
    if dist.is_initialized():
        raise RuntimeError("this process already joined a deployment")
    logger.info("torch.distributed backend %s: NCCL refuses two ranks on one card, so every "
                "collective runs on host buffers (the hop stages through host memory)", BACKEND)
    budget = _timeout_s()
    long = datetime.timedelta(seconds=max(budget, 1800.0))
    dist.init_process_group(BACKEND, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=long)
    hop_timeout = datetime.timedelta(seconds=budget if budget > 0 else 1800.0)
    _STATE["groups"] = {
        "ctrl": dist.new_group(backend=BACKEND, timeout=long),
        "hop": dist.new_group(backend=BACKEND, timeout=hop_timeout),
        "pod": dist.new_group(backend=BACKEND, timeout=long),
    }
    _STATE["hop_failed"] = False


def shutdown_process() -> None:
    """Leave the deployment (tests that join and leave in one process)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["groups"] = None


def process_index() -> int:
    """This process's rank (0 without a deployment)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The ranks of the deployment (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _group(name: str):
    groups = _STATE["groups"]
    if groups is None:
        raise RuntimeError("no deployment: call init_process first")
    return groups[name]


def _pack(tree: dict) -> torch.Tensor:
    """A dict of host arrays as one uint8 tensor, in key order."""
    return torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(tree[k]).view(np.uint8).reshape(-1) for k in tree]))


def _unpack(flat: np.ndarray, template: dict) -> dict:
    out, at = {}, 0
    for k, v in template.items():
        n = v.nbytes
        out[k] = flat[at : at + n].view(v.dtype).reshape(v.shape).copy()
        at += n
    return out


def broadcast_one_to_all(tree: dict) -> dict:
    """``multihost_utils.broadcast_one_to_all`` over host arrays: every rank
    passes a dict of fixed-shape arrays and gets rank 0's back (the other
    ranks' values are ignored), in one broadcast of the control plane's
    group."""
    import torch.distributed as dist

    buf = _pack(tree)
    dist.broadcast(buf, src=0, group=_group("ctrl"))
    return _unpack(buf.numpy(), tree)


def process_allgather(tree: dict) -> dict:
    """``multihost_utils.process_allgather`` over host arrays: every rank
    contributes a dict of fixed-shape arrays and gets everyone's, stacked
    on a leading rank axis, in one all_gather of the pod's group."""
    import torch.distributed as dist

    buf = _pack(tree)
    parts = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(parts, buf, group=_group("pod"))
    rows = [_unpack(p.numpy(), tree) for p in parts]
    return {k: np.stack([r[k] for r in rows]) for k in tree}


# ------------------------------------------------------------------- the hop
def hop_failed() -> bool:
    """Whether a hop or token broadcast has failed: a peer rank died or
    wedged mid-step, so the deployment's lockstep is broken."""
    return bool(_STATE["hop_failed"])


def _hop_call(fn, what: str):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — a failed peer collective breaks the lockstep
        _STATE["hop_failed"] = True
        raise WorkerTimeoutError(
            f"multi-host {what} failed — a peer rank is dead, wedged or unreachable; marking "
            "the control plane down (restart the deployment)") from e


def _hop_bytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def send_hidden(x: Optional[torch.Tensor], dst: int, counters: Optional[dict] = None,
                shape=None, dtype: Optional[torch.dtype] = None) -> None:
    """Send a stage boundary's hidden state to rank ``dst``: its bytes,
    copied to the host (one device sync a boundary a step), then a status
    byte. ``x`` None sends a failed step's (``shape`` and ``dtype`` give
    its size, status 1): the receiver raises :class:`PeerStepError`.
    Counted in ``counters`` (:func:`hop_counters`)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    n = _hop_bytes(shape if x is None else x.shape, dtype if x is None else x.dtype)
    host = torch.empty(n + 1, dtype=torch.uint8)
    if x is None:
        host.fill_(1)
    else:
        host[:n].view(x.dtype).view(x.shape).copy_(x.detach())
        host[n] = 0
    _hop_call(lambda: dist.send(host, dst=dst, group=_group("hop")), "stage hop (send)")
    if counters is not None:
        counters["sent"] += 1
        counters["bytes_sent"] += host.numel()
        counters["send_s"] += time.perf_counter() - t0


def recv_hidden(shape, dtype: torch.dtype, src: int, device,
                counters: Optional[dict] = None) -> torch.Tensor:
    """The hidden state of ``shape`` and ``dtype`` that rank ``src`` sent
    (:func:`send_hidden`), on ``device``; :class:`PeerStepError` where
    ``src`` sent a failed step's."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    n = _hop_bytes(shape, dtype)
    host = torch.empty(n + 1, dtype=torch.uint8)
    _hop_call(lambda: dist.recv(host, src=src, group=_group("hop")), "stage hop (recv)")
    if counters is not None:
        counters["received"] += 1
        counters["bytes_received"] += host.numel()
        counters["recv_s"] += time.perf_counter() - t0
    if host[n]:
        raise PeerStepError(f"rank {src}'s share of this step failed")
    return host[:n].view(dtype).reshape(shape).to(device)


def share_tokens(run: Optional[Callable], rows: int, want_lp: bool, src: int, device,
                 counters: Optional[dict] = None, error: Optional[BaseException] = None):
    """The tokens of one sampling, on every rank: rank ``src`` (the one
    holding the head) calls ``run() -> (tokens (rows,) int64, the logprob
    summary (chosen (rows,), top values (rows, K), top indices (rows, K))
    or None)`` and broadcasts them, the summary when ``want_lp``; every
    other rank passes ``run=None`` and gets them on ``device``.

    Column 0 is the step's status. ``error``: this rank's share of the
    step failed before the sampling (its stages, its head, or a failure a
    hop brought). Where ``src``'s failed (``error`` there, or ``run``
    raising), it broadcasts status 1 all the same and raises its error
    after the collective; every other rank then raises its own ``error``
    or :class:`PeerStepError`. So each rank fails in this step and none is
    left waiting in it."""
    import torch.distributed as dist

    from mlx_sharding_tpu_torch.generate import LOGPROB_TOPK

    t0 = time.perf_counter()
    k = LOGPROB_TOPK
    width = 3 + 2 * k if want_lp else 2
    buf = torch.zeros((rows, width), dtype=torch.float64)
    if run is not None:
        if error is None:
            try:
                inject("multihost.sample")
                tok, lp = run()
                parts = [tok.reshape(rows, 1).double()]
                if want_lp:
                    chosen, top_v, top_i = lp
                    parts += [chosen.reshape(rows, 1).double(), top_v.double(), top_i.double()]
                buf[:, 1:] = torch.cat(parts, dim=1).cpu()
            except Exception as e:  # noqa: BLE001 — every rank must fail in this step
                error = e
        if error is not None:
            buf[:, 0] = 1
    _hop_call(lambda: dist.broadcast(buf, src=src, group=_group("hop")), "token broadcast")
    if counters is not None:
        counters["token_broadcasts"] += 1
        counters["token_bytes"] += buf.numel() * buf.element_size()
        counters["token_s"] += time.perf_counter() - t0
    if error is not None:
        raise error
    if buf[0, 0]:
        raise PeerStepError(f"rank {src}'s share of this step failed")
    if run is not None:
        return tok, lp
    buf = buf.to(device)
    tok = buf[:, 1].long()
    if not want_lp:
        return tok, None
    return tok, (buf[:, 2].float(), buf[:, 3 : 3 + k].float(), buf[:, 3 + k :].long())


# ------------------------------------------------------------------ the wire
# Shared wire encoding: the single-stream protocol (_request_msg /
# _start_request) and the batched one (_assign_msg / _req_from_msg) must
# never drift apart on these.

def _pack_seed(seed: int) -> tuple[int, int]:
    """62-bit seed into two int32-safe halves: a full user seed round-trips,
    so several processes reproduce one process's stream for the same
    request."""
    return seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF


def _unpack_seed(lo, hi) -> int:
    return int(lo) | (int(hi) << 31)


def _pack_bias(logit_bias) -> tuple[np.ndarray, np.ndarray, int]:
    bias_idx = np.zeros((_BIAS_SLOTS,), np.int32)
    bias_val = np.zeros((_BIAS_SLOTS,), np.float32)
    n_bias = 0
    if logit_bias:
        if len(logit_bias) > _BIAS_SLOTS:
            # silent truncation would make the deployment's output diverge
            # from the same request served by one process
            raise ValueError(
                f"logit_bias with {len(logit_bias)} entries exceeds the "
                f"multi-host control-plane width {_BIAS_SLOTS}"
            )
        items = list(logit_bias.items())
        n_bias = len(items)
        bias_idx[:n_bias] = [int(k) for k, _ in items]
        bias_val[:n_bias] = [float(v) for _, v in items]
    return bias_idx, bias_val, n_bias


def _check_request(engine, seed, logit_bias) -> None:
    """Refuse, before anything is broadcast, what would fail on one rank
    only: a seed over 62 bits (the wire's), and a logit_bias token id
    outside the vocabulary (only the head rank applies the bias)."""
    if seed is not None and not 0 <= int(seed) < (1 << 62):
        raise ValueError("seed must fit in 62 bits for multi-host serving")
    vocab = engine.model.config.vocab_size
    bad = sorted(k for k in (logit_bias or {}) if not 0 <= int(k) < vocab)
    if bad:
        raise ValueError(f"logit_bias token ids must be in [0, {vocab}): got {bad[:8]}")


def _unpack_bias(bias_idx, bias_val, n_bias: int):
    return {
        int(i): float(v)
        for i, v in zip(bias_idx[:n_bias], bias_val[:n_bias])
    } or None


class ControlPlane:
    """Fixed-shape broadcast buffers; rank 0 publishes, every rank receives
    the same dict (:func:`broadcast_one_to_all` ignores the other ranks'
    inputs).

    Liveness (rank 0 only): a collective completes only when every rank
    arrives, so a SIGKILLed worker would block rank 0 in the broadcast
    forever, invisible to /health. Rank 0 therefore runs each exchange on a
    dedicated daemon thread and bounds the wait (``MST_MULTIHOST_TIMEOUT_S``,
    default 600 s; 0 disables). On timeout, or when the collective itself
    fails (gloo raises on a connection reset), the plane is marked
    :attr:`dead`: the request in flight errors to its client, later
    exchanges fail fast, and /health flips to degraded. A failed hop or
    token broadcast (:func:`hop_failed`) marks it dead too. Workers wait
    unbounded: an idle deployment broadcasts nothing, and their liveness is
    rank 0's concern."""

    header_size = 8

    def __init__(self, max_prompt: int, timeout_s: Optional[float] = None,
                 clock: Clock = MONOTONIC):
        self.max_prompt = max_prompt
        self.clock = clock  # liveness stamps read the injectable source
        if timeout_s is None:
            timeout_s = _timeout_s()
        if process_index() != 0 or timeout_s <= 0:
            timeout_s = None  # workers (and 0 = disabled) wait unbounded
        self.timeout_s = timeout_s
        self._dead = False
        self.last_ok: Optional[float] = None  # stamp of the last completed
        # collective: proof every rank was alive at that moment
        self._thread = None  # lazy daemon worker (timed exchanges only)
        # serializes the timed path: two callers racing the lazy init would
        # spawn duplicate broadcast threads, and interleaved queue traffic
        # could hand one caller the other's reply
        self._lock = make_lock("ControlPlane._lock")

    @property
    def dead(self) -> bool:
        return self._dead or hop_failed()

    @dead.setter
    def dead(self, value: bool) -> None:
        self._dead = value

    @staticmethod
    def _broadcast(buf):
        return broadcast_one_to_all(buf)

    def _zeros(self):
        return {
            "header": np.zeros((self.header_size,), np.int32),
            "floats": np.zeros((4,), np.float32),
            "tokens": np.zeros((self.max_prompt,), np.int32),
            "bias_idx": np.zeros((_BIAS_SLOTS,), np.int32),
            "bias_val": np.zeros((_BIAS_SLOTS,), np.float32),
        }

    def exchange(self, msg: Optional[dict] = None) -> dict:
        """Collective: rank 0 passes ``msg`` (padded in), workers pass None.
        Everyone gets rank 0's message back as host numpy. Raises
        :class:`WorkerTimeoutError` (rank 0) when a peer does not show up
        within the liveness budget, and at once when the plane is dead."""
        try:
            # the fault harness: a raise here simulates a collective whose
            # peer never arrives (faults.DropExchange), detected at once
            inject("multihost.exchange")
        except Exception as e:  # noqa: BLE001 — any injected failure means
            # the plane can no longer be trusted; normalize like a timeout
            with self._lock:
                self._dead = True
            raise WorkerTimeoutError(
                "multi-host collective dropped (injected fault) — marking "
                "the control plane down (restart the deployment)"
            ) from e
        buf = self._zeros()
        if msg is not None:
            for k, v in msg.items():
                arr = np.asarray(v).reshape(-1)
                buf[k][: arr.size] = arr
        if self.timeout_s is None:
            out = self._broadcast(buf)
        else:
            # the whole timed path holds the lock: dead-check, lazy init,
            # submit and reply are one unit, or a concurrent caller could
            # collect this caller's broadcast result
            with self._lock:
                if self.dead:
                    raise WorkerTimeoutError(
                        "multi-host control plane is down (a peer rank "
                        "previously failed to respond) — restart the deployment"
                    )
                if self._thread is None:
                    # one daemon thread issuing collectives in program
                    # order: a timed-out broadcast stays blocked in it, and
                    # a daemon is abandoned at interpreter exit, never joined
                    self._work: _q.Queue = _q.Queue()
                    self._out: _q.Queue = _q.Queue()

                    def run():
                        while True:
                            b = self._work.get()
                            try:
                                self._out.put(("ok", self._broadcast(b)))
                            except BaseException as e:  # noqa: BLE001
                                self._out.put(("err", e))

                    self._thread = threading.Thread(target=run, name="mst-ctrl", daemon=True)
                    self._thread.start()
                self._work.put(buf)
                try:
                    kind, val = self._out.get(timeout=self.timeout_s)
                except _q.Empty:
                    self._dead = True  # the broadcast thread stays stuck in
                    # the collective; a daemon, it is abandoned
                    raise WorkerTimeoutError(
                        f"multi-host collective did not complete within "
                        f"{self.timeout_s:.0f}s — a worker rank is dead or "
                        "wedged; failing the request and marking the control "
                        "plane down (restart the deployment)"
                    ) from None
                if kind == "err":
                    # the process group noticed the dead peer and failed the
                    # collective: the same conclusion, sooner
                    self._dead = True
                    raise WorkerTimeoutError(
                        "multi-host collective failed — the distributed "
                        "runtime reported a dead or unreachable peer rank; "
                        "marking the control plane down (restart the "
                        "deployment)"
                    ) from val
                out = val
        self.last_ok = self.clock()
        return {k: np.asarray(v) for k, v in out.items()}


def _request_msg(prompt, temperature, top_p, repetition_penalty,
                 repetition_context_size, logit_bias, seed, max_tokens,
                 want_logprobs: bool = False):
    """The OP_REQUEST message (JAX's layout). The port carries
    ``want_logprobs`` in the fourth float, which JAX leaves 0: the rank
    holding the head must know whether to broadcast the logprob rows."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    bias_idx, bias_val, n_bias = _pack_bias(logit_bias)
    seed_lo, seed_hi = _pack_seed(seed)
    return {
        "header": np.asarray(
            [OP_REQUEST, prompt.size, max_tokens, seed_lo,
             repetition_context_size,
             0 if repetition_penalty is None else 1, n_bias, seed_hi],
            np.int32,
        ),
        "floats": np.asarray(
            # None-ness rides only in the has_pen header flag: `or 1.0`
            # would mangle an explicit penalty of 0.0 on the wire
            [temperature, top_p,
             1.0 if repetition_penalty is None else repetition_penalty,
             1.0 if want_logprobs else 0.0],
            np.float32,
        ),
        "tokens": prompt,
        "bias_idx": bias_idx,
        "bias_val": bias_val,
    }


def _start_request(gen, msg) -> dict:
    """Identical on every rank: prefill the broadcast prompt and sample the
    first token through the engine's single stream ``gen`` (a
    ``StagedGenerator``). Returns the request's decode state: the first
    token and its logprob summary, the window, the sampler branch and
    whether logprobs ride the blocks."""
    hdr = msg["header"]
    n_prompt = int(hdr[1])
    seed = _unpack_seed(hdr[3], hdr[7])
    temperature, top_p, rep_pen, want = (float(x) for x in msg["floats"][:4])
    bias = _unpack_bias(msg["bias_idx"], msg["bias_val"], int(hdr[6]))
    tok, lp, window, sampled = gen.begin(
        np.asarray(msg["tokens"][:n_prompt], np.int64), temperature=temperature, top_p=top_p,
        repetition_penalty=rep_pen if hdr[5] else None, repetition_context_size=int(hdr[4]),
        logit_bias=bias, seed=seed, max_tokens=int(hdr[2]), want_logprobs=bool(want))
    return dict(tok=tok, lp=lp, window=window, sampled=sampled, want_lp=bool(want))


def _decode_block(gen, state):
    """One decode block of the engine's single stream from the request's
    state: identical on every rank (one OP_DECODE)."""
    return gen.run_block(gen.decode_block, state["window"], state["sampled"], state["want_lp"])


class MultiHostPipeline:
    """Rank 0's driver with the ``generate_step`` contract over an engine
    whose stages span the ranks. Each OP_DECODE broadcast is one decode
    block of the engine's single stream (``decode_block`` steps, each with
    its hops and its token broadcast), run by every rank in lockstep;
    JAX's broadcasts one per token."""

    concurrent = False  # requests serialize through the server's gen lock

    def __init__(self, engine):
        self.engine = engine
        self.gen = engine.stream()
        self.ctrl = ControlPlane(max_prompt=engine.max_seq)

    def warm_up(self, *args, **kwargs) -> dict:
        return self.engine.warm_up(*args, **kwargs)

    def generate_step(
        self,
        prompt_tokens,
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        repetition_penalty: Optional[float] = None,
        repetition_context_size: int = 20,
        logit_bias: Optional[dict[int, float]] = None,
        seed: Optional[int] = None,
        max_tokens: int = 256,
        want_logprobs: bool = False,
    ):
        from mlx_sharding_tpu_torch.generate import blocked_token_stream

        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if prompt.size + max_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_tokens ({max_tokens}) exceeds "
                f"KV capacity {self.engine.max_seq}"
            )
        _check_request(self.engine, seed, logit_bias)
        msg = _request_msg(
            prompt, temperature, top_p, repetition_penalty,
            repetition_context_size, logit_bias,
            (time.time_ns() & ((1 << 62) - 1) if seed is None else int(seed)),
            max_tokens, want_logprobs,
        )
        self.ctrl.exchange(msg)
        # everything after the OP_REQUEST broadcast sits inside the try: if
        # prefill raises on rank 0, the finally still broadcasts STOP, so
        # workers leave the request loop instead of hanging the collective
        try:
            state = _start_request(self.gen, msg)
            yield state["tok"], state["lp"]
            if max_tokens > 1:
                def dispatch():
                    self.ctrl.exchange({"header": np.asarray([OP_DECODE], np.int32)})
                    return _decode_block(self.gen, state)

                yield from blocked_token_stream(dispatch, max_tokens - 1, self.gen.decode_block,
                                                state["want_lp"])
        finally:
            # exactly one STOP per request, whether it ran to max_tokens or
            # the consumer closed early (stop sequence, disconnect). A dead
            # control plane must not let this raise over the original
            # error: there is no one left to resync.
            try:
                self.ctrl.exchange({"header": np.asarray([OP_STOP_REQUEST], np.int32)})
            except WorkerTimeoutError:
                pass

    def shutdown(self):
        try:
            self.ctrl.exchange({"header": np.asarray([OP_SHUTDOWN], np.int32)})
        except WorkerTimeoutError:
            pass  # nobody is listening; the plane is already down

    close = shutdown


def _drain_to_stop(ctrl) -> bool:
    """After a local step failure, consume broadcasts until rank 0's
    per-request STOP (its generator ``finally`` always sends exactly one),
    so the protocol stays aligned. Returns True on OP_SHUTDOWN."""
    while True:
        step = ctrl.exchange()
        op = int(step["header"][0])
        if op == OP_STOP_REQUEST:
            return False
        if op == OP_SHUTDOWN:
            return True
        if op != OP_DECODE:
            raise RuntimeError(f"worker protocol desync while draining: op {op}")


# --------------------------------------------------------------------------
# Continuous batching over the control plane.
#
# The scheduler's host decisions (which request gets which slot, when a
# prefill chunk runs, when a decode block runs, when a consumer cancels) are
# the only inputs the workers cannot derive; downstream of the op stream
# everything is deterministic: page allocation pops a mirrored free list,
# max_tokens finishes count mirrored emit loops, and every rank takes the
# same tokens from the head's broadcast. So rank 0 runs the real
# ContinuousBatcher and broadcasts one small op message before each device
# op; every worker applies the same op to an identical mirror batcher and
# stays in lockstep.


class BatchControlPlane(ControlPlane):
    """ControlPlane with room for the batched ops' header fields."""

    header_size = 12


def _assign_msg(req, slot: int) -> dict:
    """OP_B_ASSIGN message: the request verbatim, so a worker rebuilds an
    identical request (sampler params, seed chain, page need)."""
    prompt = np.asarray(req.prompt, np.int32).reshape(-1)
    bias_idx, bias_val, n_bias = _pack_bias(req.logit_bias)
    seed_lo, seed_hi = _pack_seed(int(req.seed))
    return {
        "header": np.asarray(
            [OP_B_ASSIGN, slot, prompt.size, req.max_tokens,
             seed_lo, seed_hi, req.rep_context,
             0 if req.repetition_penalty is None else 1, n_bias,
             1 if req.want_logprobs else 0, 0, 0],
            np.int32,
        ),
        "floats": np.asarray(
            # see _request_msg: None-ness rides only in the has_pen flag
            [req.temperature, req.top_p,
             1.0 if req.repetition_penalty is None
             else req.repetition_penalty, 0.0],
            np.float32,
        ),
        "tokens": prompt,
        "bias_idx": bias_idx,
        "bias_val": bias_val,
    }


class _DiscardQueue:
    """A worker's request output: only rank 0 has consumers, so the tokens
    every rank takes are dropped here."""

    def put(self, item):
        pass


def _req_from_msg(msg):
    """The worker's copy of the request of an OP_B_ASSIGN message."""
    from mlx_sharding_tpu_torch.scheduler import _Request

    hdr = msg["header"]
    n_prompt, max_tokens = int(hdr[2]), int(hdr[3])
    seed = _unpack_seed(hdr[4], hdr[5])
    rep_ctx, has_pen, n_bias = int(hdr[6]), int(hdr[7]), int(hdr[8])
    temperature, top_p, rep_pen = (float(x) for x in msg["floats"][:3])
    bias = _unpack_bias(msg["bias_idx"], msg["bias_val"], n_bias)
    return _Request(
        prompt=np.asarray(msg["tokens"][:n_prompt], np.int64),
        sp=make_sampler_params(temperature, top_p, rep_pen if has_pen else None, bias,
                               device="cpu"),
        seed=seed,
        max_tokens=max_tokens,
        rep_context=rep_ctx,
        want_logprobs=bool(hdr[9]),
        out=_DiscardQueue(),
    )


def _make_multihost_batcher():
    """The rank-0 batcher class, made on first use: the scheduler's import
    stays out of this module's import time."""
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    class MultiHostBatcher(ContinuousBatcher):
        """Rank 0's continuous batcher: it broadcasts each device op before
        applying it, so the workers' mirrors (:func:`serve_worker_batched`)
        stay in lockstep. ``--concurrent N`` under ``--coordinator`` builds
        it."""

        def __init__(self, engine, **kw):
            super().__init__(engine, **kw)
            self.ctrl = BatchControlPlane(max_prompt=engine.max_seq)
            self._shut = False

        def generate_step(self, prompt_tokens, *, seed=None, logit_bias=None, **kw):
            _check_request(self.engine, seed, logit_bias)
            return super().generate_step(prompt_tokens, seed=seed, logit_bias=logit_bias, **kw)

        def _bcast(self, *header):
            self.ctrl.exchange({"header": np.asarray(header, np.int32)})

        def _assign_slot(self, req, slot):
            try:
                self.ctrl.exchange(_assign_msg(req, slot))
            except BaseException:
                # admission popped it from the line and no slot holds it
                # yet: back in the line, the failed tick ends its stream
                # with the rest instead of stranding its consumer
                self._waiting.insert(0, req)
                raise
            super()._assign_slot(req, slot)

        def _prefill_one_chunk(self, req):
            self._bcast(OP_B_PREFILL, req.slot)
            super()._prefill_one_chunk(req)

        def _decode_once(self):
            self._bcast(OP_B_DECODE)
            super()._decode_once()

        def _reap_cancelled(self):
            # a cancellation is the one finish the workers cannot derive
            # (max_tokens finishes they count themselves)
            for req in list(self._slots):
                if req is not None and req.cancelled:
                    self._bcast(OP_B_CANCEL, req.slot)
                    self._finish(req)

        def _fail_all(self, exc):
            try:
                self._bcast(OP_B_FAIL)
            except Exception:  # noqa: BLE001
                logger.exception("failed to broadcast scheduler failure")
            super()._fail_all(exc)

        def close(self, timeout: float = 10.0):
            super().close(timeout)  # joins the scheduler thread first: no
            # broadcast can race the shutdown one
            if self._thread is not None and self._thread.is_alive():
                # the join timed out (a wedged tick): the scheduler thread
                # may still broadcast ops, and a SHUTDOWN from here would
                # interleave with them; process teardown is the backstop
                return
            if not self._shut:
                self._shut = True  # workers exit on the first SHUTDOWN; a
                # second broadcast would hang awaiting departed peers
                try:
                    self._bcast(OP_SHUTDOWN)
                except WorkerTimeoutError:
                    pass  # plane already down; nothing to shut down

        shutdown = close

    return MultiHostBatcher


def make_multihost_batcher(engine, **kw):
    """Build the rank-0 batcher for multi-host continuous batching."""
    return _make_multihost_batcher()(engine, **kw)


def serve_worker_batched(engine, *, decode_block: int = 8, repetition_window: int = 64,
                         prefix_cache: bool = False,
                         on_idle: Optional[Callable[[], None]] = None) -> None:
    """A worker's loop under continuous batching: apply rank 0's op stream
    to a mirror ``ContinuousBatcher`` over ``engine`` (or ``engine`` itself
    when it is such a mirror, built and warmed up by its caller).
    ``decode_block`` and ``prefix_cache`` must match rank 0's (the block
    sets a decode op's steps; the cache changes the page-allocation
    sequence). The mirror warms up as rank 0's batcher does (its stage
    programs are captured over the same hops).

    Prefix caching mirrors deterministically: every index mutation lives
    inside a mirrored op (registration in OP_B_PREFILL, eviction and
    move-to-end in OP_B_ASSIGN, releases in the counted max_tokens finishes
    and OP_B_CANCEL) and rank 0's admission polls are read-only, so
    identical op streams give identical page tables on every rank.

    Failure discipline: a device op fails on every rank in the same step
    (a rank's own failure reaches the others through the hop's status and
    the token broadcast's, ``PeerStepError``), so rank 0 fails its
    consumers and broadcasts OP_B_FAIL, which resets this mirror too. An
    op code outside the protocol is a desync and raises.
    ``on_idle``: called after an op that leaves no request in a slot."""
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    batcher = engine
    if not isinstance(batcher, ContinuousBatcher):
        batcher = ContinuousBatcher(engine, decode_block=decode_block,
                                    repetition_window=repetition_window,
                                    prefix_cache=prefix_cache)
        batcher.warm_up()
    ctrl = BatchControlPlane(max_prompt=batcher.engine.max_seq)
    with torch.no_grad():
        while True:
            msg = ctrl.exchange()
            hdr = msg["header"]
            op = int(hdr[0])
            if op == OP_SHUTDOWN:
                return
            if op == OP_B_FAIL:
                batcher._fail_all(RuntimeError("rank 0 scheduler failure"))
                continue
            if op not in (OP_B_ASSIGN, OP_B_PREFILL, OP_B_DECODE, OP_B_CANCEL):
                raise RuntimeError(f"worker protocol desync: unexpected op {op}")
            try:
                if op == OP_B_ASSIGN:
                    batcher._assign_slot(_req_from_msg(msg), int(hdr[1]))
                elif op == OP_B_PREFILL:
                    batcher._prefill_one_chunk(batcher._slots[int(hdr[1])])
                elif op == OP_B_DECODE:
                    batcher._decode_once()
                else:  # OP_B_CANCEL
                    req = batcher._slots[int(hdr[1])]
                    if req is not None:
                        batcher._finish(req)
            except WorkerTimeoutError:
                raise  # a broken lockstep cannot be resynced
            except Exception:  # noqa: BLE001
                # the op failed on every rank in the same step (PeerStepError
                # where another rank's share failed): OP_B_FAIL arrives next
                # to reset this mirror
                logger.exception("worker batched op %d failed", op)
            if on_idle is not None and not any(batcher._slots):
                on_idle()


def serve_worker(engine, on_idle: Optional[Callable[[], None]] = None) -> None:
    """A worker's loop on the single stream: the reference's shard-server
    process with its RPC surface replaced by the control plane. Blocks
    until rank 0 publishes OP_SHUTDOWN.

    Failure discipline: a step fails on every rank in the same step (a
    rank's own failure reaches the others through the hop's status and the
    token broadcast's, ``PeerStepError``), so when a step raises here this
    worker logs it and drains to the request's STOP instead of dying; rank
    0 raises to the client and its ``finally`` broadcasts that STOP.
    Failures of rank 0 before any step reach the worker as a bare STOP. A
    broken lockstep (a dead peer) and an op outside the protocol raise.
    ``on_idle``: called after each request's STOP."""
    gen = engine.stream()
    ctrl = ControlPlane(max_prompt=engine.max_seq)
    with torch.no_grad():
        while True:
            msg = ctrl.exchange()
            op = int(msg["header"][0])
            if op == OP_SHUTDOWN:
                return
            if op == OP_STOP_REQUEST:
                # rank 0's request failed after OP_REQUEST but before any
                # step: its unconditional STOP resyncs us
                continue
            if op != OP_REQUEST:
                raise RuntimeError(f"worker protocol desync: unexpected op {op}")
            try:
                state = _start_request(gen, msg)
            except WorkerTimeoutError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("worker prefill failed; draining to STOP")
                if _drain_to_stop(ctrl):
                    return
                continue
            while True:
                step = ctrl.exchange()
                op = int(step["header"][0])
                if op == OP_DECODE:
                    try:
                        _decode_block(gen, state)
                    except WorkerTimeoutError:
                        raise
                    except Exception:  # noqa: BLE001
                        logger.exception("worker decode failed; draining to STOP")
                        if _drain_to_stop(ctrl):
                            return
                        break
                elif op == OP_STOP_REQUEST:
                    if on_idle is not None:
                        on_idle()
                    break
                elif op == OP_SHUTDOWN:
                    return
                else:
                    raise RuntimeError(f"worker protocol desync: unexpected op {op} mid-request")


# --------------------------------------------------------------------------
# Pod control plane: the symmetric (every host publishes) variant of the
# exchange, for the pod fleet (pod.py). Where ControlPlane is rank 0
# publishes / workers mirror, the pod plane stitches N independent host
# fleets together: each host contributes its own fixed-shape buffer every
# pod tick and receives everyone's (heartbeats, weight registrations,
# autoscaler pressure and chunked KV-block shipments ride one allgather).

# pod header slots (int32[POD_HEADER]): [seq, host_id, n_msgs, blob_used,
# epoch, flags, reserved, reserved]
POD_HEADER = 8


class PodControlPlane:
    """Fixed-shape symmetric exchange over :func:`process_allgather`.

    Every pod tick, every host calls :meth:`pod_exchange` with its header
    and message blob; the collective returns all hosts' buffers. A
    collective completes only when every rank arrives, so each host bounds
    the wait with ControlPlane's timed daemon-thread discipline
    (``MST_POD_TIMEOUT_S``, default 60 s): a SIGKILLed peer turns into a
    :class:`WorkerTimeoutError`, which the pod transport surfaces as "all
    peers dead", so the local fleet degrades to single-host serving.

    The blob is an opaque uint8 payload (default 256 KiB,
    ``MST_POD_BLOB_BYTES``); framing and fragmentation are the transport's
    job (``pod.CollectiveTransport``)."""

    def __init__(self, blob_bytes: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 clock: Clock = MONOTONIC):
        if blob_bytes is None:
            try:
                blob_bytes = int(os.environ.get("MST_POD_BLOB_BYTES", str(256 << 10)))
            except ValueError:
                blob_bytes = 256 << 10
        self.blob_bytes = max(4096, int(blob_bytes))
        self.clock = clock
        if timeout_s is None:
            try:
                timeout_s = float(os.environ.get("MST_POD_TIMEOUT_S", "60"))
            except ValueError:
                timeout_s = 60.0
        # unlike ControlPlane, every host times its collectives: each drives
        # its own pod tick loop, so each must detect dead peers
        self.timeout_s = timeout_s if timeout_s > 0 else None
        self.dead = False
        self.last_ok: Optional[float] = None
        self._thread = None
        self._lock = make_lock("PodControlPlane._lock")

    @staticmethod
    def _allgather(buf):
        return process_allgather(buf)

    def pod_exchange(self, header: np.ndarray, blob: np.ndarray) -> tuple:
        """One pod tick's collective: contribute ``(header, blob)``, get
        back ``(headers, blobs)`` stacked over hosts (shape ``[n_hosts,
        ...]``). Raises :class:`WorkerTimeoutError` when a peer does not
        arrive within the budget, and at once when the plane is dead."""
        try:
            # the SPMD plane's site: a dropped pod collective and a dropped
            # broadcast mean the same for liveness
            inject("multihost.exchange", plane="pod")
        except Exception as e:  # noqa: BLE001 — injected drop == dead plane
            with self._lock:
                self.dead = True
            raise WorkerTimeoutError(
                "pod collective dropped (injected fault) — marking the pod "
                "control plane down"
            ) from e
        hdr = np.zeros((POD_HEADER,), np.int32)
        hdr[: min(POD_HEADER, np.asarray(header).size)] = \
            np.asarray(header, np.int32).reshape(-1)[:POD_HEADER]
        buf = np.zeros((self.blob_bytes,), np.uint8)
        b = np.asarray(blob, np.uint8).reshape(-1)
        if b.size > self.blob_bytes:
            raise ValueError(
                f"pod blob of {b.size} bytes exceeds the plane width "
                f"{self.blob_bytes} — chunk it (transport bug)"
            )
        buf[: b.size] = b
        tree = {"header": hdr, "blob": buf}
        if self.timeout_s is None:
            out = self._allgather(tree)
        else:
            with self._lock:
                if self.dead:
                    raise WorkerTimeoutError(
                        "pod control plane is down (a peer host previously "
                        "failed to respond)"
                    )
                if self._thread is None:
                    # as ControlPlane: one daemon thread issuing collectives
                    # in program order; a timed-out allgather strands the
                    # thread, not the pod loop
                    self._work: _q.Queue = _q.Queue()
                    self._out: _q.Queue = _q.Queue()

                    def run():
                        while True:
                            t = self._work.get()
                            try:
                                self._out.put(("ok", self._allgather(t)))
                            except BaseException as e:  # noqa: BLE001
                                self._out.put(("err", e))

                    self._thread = threading.Thread(target=run, name="mst-pod-ctrl",
                                                    daemon=True)
                    self._thread.start()
                self._work.put(tree)
                try:
                    kind, val = self._out.get(timeout=self.timeout_s)
                except _q.Empty:
                    self.dead = True
                    raise WorkerTimeoutError(
                        f"pod collective did not complete within "
                        f"{self.timeout_s:.0f}s — a peer host is dead or "
                        "wedged; marking the pod control plane down"
                    ) from None
                if kind == "err":
                    self.dead = True
                    raise WorkerTimeoutError(
                        "pod collective failed — the distributed runtime "
                        "reported a dead or unreachable peer host"
                    ) from val
                out = val
        self.last_ok = self.clock()
        return np.asarray(out["header"]), np.asarray(out["blob"])
