"""Captured step programs on the card: the port's counterpart of the JAX
package's jit caches (``Generator._prefill`` / ``_decode_block``,
``PipelineEngine._decode_blocks``).

JAX compiles a prefill chunk, or a whole decode block of K steps with its
sampling, into one program. On the card that program is a captured
``torch.cuda.CUDAGraph``: the step function is recorded once per key (what
fixes its shapes and its host-known branches) and replayed as one launch,
so the host no longer issues every operation of every step.

- A step function reads its inputs from static buffers that its owner
  keeps (the caller copies new inputs in before :meth:`StepGraphs.run`) and
  updates its carries (the KV cache, the position, the last token, the
  repetition window) in place. ``run`` returns the graph's static outputs,
  as views: the next replay of the same graph overwrites them, so a caller
  clones what it keeps.
- The first ``run`` of a key warms the step up on a side stream, eagerly
  and under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside
  the step, an ``.item()``, a ``.cpu()``, ``nonzero``, raises there) unless
  another batcher is open (:func:`open_worker`): the mode is the process's,
  and the other batcher's scheduler thread syncs on its harvests; it puts
  back the carries and generator states the warm-up moved, and captures the
  step on that stream into the memory pool shared by the model's graphs.
  The warm-up's K/V writes are left: the replay writes the same rows.
- Generators the step draws from are registered with its graph, so each
  replay draws fresh numbers from the generator's state at that time, and a
  reseed between replays takes effect.
- The kernels' launch counters (``flash_attention.launches`` and the
  others) are bumped by Python when a wrapper is called
  (:func:`count_launch`), which a replay does not do: while a thread
  captures, its wrappers' counts go to the capture's own tally (the capture
  launches nothing), and every replay adds the tally to the counters and to
  its ``StepGraphs.launches``. Other threads keep counting meanwhile: the
  replicas of a ``--replicas`` server replay and capture from their own
  scheduler threads on one card, each batcher with its own graphs, stream
  and memory pool.
- A capture or replay that fails raises. There is no eager fallback.
- A pipeline whose stages are on distinct devices cannot put a step into
  one graph: :class:`StageGraphs` keeps one ``StepGraphs`` per stage, on
  its device, and each stage's share of a step is captured and replayed
  alone over static copies of its inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter
from typing import Callable

import torch

# the launch counters are bumped from every scheduler thread
_LAUNCH_LOCK = threading.Lock()
# per thread: the tally of the capture it is running, or None
_CAPTURE = threading.local()
# batchers open on the card, each serving from a scheduler thread of its own
_WORKERS = 0


def open_worker() -> None:
    """A batcher opened on the card (its scheduler thread may sync on the
    card at any time); :func:`close_worker` when it closes."""
    global _WORKERS
    with _LAUNCH_LOCK:
        _WORKERS += 1


def close_worker() -> None:
    global _WORKERS
    with _LAUNCH_LOCK:
        _WORKERS -= 1


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: into the tally of the
    capture this thread is running (a capture launches nothing), or into
    ``wrapper.launches``."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[wrapper] += 1
        return
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def counted_wrappers() -> tuple:
    """The kernel wrappers whose ``launches`` counts a replay must bump."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    return (fa.flash_attention, fa.flash_decode, pa.paged_attention, qm.quant_gemv,
            qm.quant_matmul, qm.quant_gemv_experts)


def model_pool(model) -> tuple:
    """The graph memory pool of ``model``'s captured steps, made on first
    use: the single-stream generators over one model share it (their replays
    are ordered on one stream, so one graph's temporaries may reuse
    another's). A batcher's graphs take a pool of their own
    (``torch.cuda.graph_pool_handle()``): batchers over one model run on
    their own threads, and a retired one must give its pool back."""
    pool = getattr(model, "_graph_pool", None)
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
        model._graph_pool = pool
    return pool


def note_eager_forward(counter_owner, x: torch.Tensor) -> None:
    """Count a forward that runs eagerly on the card (not under capture) in
    ``counter_owner.eager_forwards``: a warm-up counts, a replay runs no
    Python and does not."""
    if x.is_cuda and not torch.cuda.is_current_stream_capturing():
        counter_owner.eager_forwards += 1


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    outputs: object  # what the captured step returned: its static outputs
    launches: list  # [(wrapper, launches one replay makes)]


class StepGraphs:
    """The captured steps of one generator, keyed by what fixes their
    shapes and branches, in the memory pool ``pool``. ``captures``,
    ``replays`` and ``capture_seconds`` count what it did, ``launches``
    (wrapper name -> count) the kernel launches its replays made."""

    def __init__(self, device, pool):
        self.device = torch.device(device)
        self.pool = pool
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.launches: Counter = Counter()

    def run(self, key, step: Callable[[], object], *, state=(), generators=()):
        """Replay the graph of ``key``, capturing ``step`` first if the key
        is new. ``state``: the tensors ``step`` updates in place that the
        warm-up must leave as it found them (carries); ``generators``: the
        ``torch.Generator``\\ s it draws from. Returns the static outputs."""
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(step, state, generators)
            self._graphs[key] = entry
        entry.graph.replay()
        with _LAUNCH_LOCK:
            for wrapper, n in entry.launches:
                wrapper.launches += n
        for wrapper, n in entry.launches:
            self.launches[wrapper.__name__] += n
        self.replays += 1
        return entry.outputs

    def _capture(self, step, state, generators) -> _Captured:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in state]
        rng = [g.get_state() for g in generators]
        self.stream.wait_stream(current)
        with _LAUNCH_LOCK:
            alone = _WORKERS <= 1
        with torch.cuda.stream(self.stream):
            mode = torch.cuda.get_sync_debug_mode()
            if alone:  # the debug mode is the process's: no other batcher's syncs raise
                torch.cuda.set_sync_debug_mode("error")
            try:
                step()  # the warm-up: per-stream buffers and libraries come to exist here
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            for t, s in zip(state, saved):
                t.copy_(s)
        current.wait_stream(self.stream)
        for g, s in zip(generators, rng):
            g.set_state(s)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        _CAPTURE.tally = Counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = step()
            # the capture recorded the launches and ran none
            launches = list(_CAPTURE.tally.items())
        finally:
            _CAPTURE.tally = None
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(graph, outputs, launches)

    def pool_bytes(self) -> int:
        """Device memory held by this pool's segments (shared with the other
        graphs of the model), from the caching allocator's snapshot."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)


class StageGraphs:
    """One :class:`StepGraphs` per pipeline stage, each on its stage's
    device and in a memory pool of its own (``enabled``; else :meth:`run`
    calls the program as it is). :meth:`run` copies the stage's inputs into
    that stage's static buffers for the key (made at the first call), then
    replays the stage's program over them, capturing it first; the outputs
    are the graph's static ones, which the key's next replay overwrites."""

    def __init__(self, devices, enabled: bool):
        self.devices = [torch.device(d) for d in devices]
        self.graphs = None
        if enabled:
            self.graphs = []
            for dev in self.devices:
                with torch.cuda.device(dev):
                    self.graphs.append(StepGraphs(dev, torch.cuda.graph_pool_handle()))
        self._inputs: dict = {}

    def run(self, stage: int, key, fn: Callable, *inputs):
        """``fn(*inputs)`` as stage ``stage``'s program of ``key``."""
        if self.graphs is None:
            return fn(*inputs)
        static = self._inputs.get((stage, key))
        if static is None:
            static = self._inputs[(stage, key)] = [x.clone() for x in inputs]
        else:
            for buf, x in zip(static, inputs):
                buf.copy_(x)
        dev = self.devices[stage]
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            return self.graphs[stage].run(key, lambda: fn(*static))

    def stats(self) -> dict:
        """The graphs captured, their capture seconds and the pools' bytes,
        over every stage (``{}`` when off)."""
        if self.graphs is None:
            return {}
        return {"graphs": sum(g.captures for g in self.graphs),
                "seconds": sum(g.capture_seconds for g in self.graphs),
                "pool_bytes": sum(g.pool_bytes() for g in self.graphs)}
