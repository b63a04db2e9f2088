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
  the step, an ``.item()``, a ``.cpu()``, ``nonzero``, raises there), puts
  back the carries and generator states the warm-up moved, and captures the
  step on that stream into the memory pool shared by the model's graphs.
  The warm-up's K/V writes are left: the replay writes the same rows.
- Generators the step draws from are registered with its graph, so each
  replay draws fresh numbers from the generator's state at that time, and a
  reseed between replays takes effect.
- The kernels' launch counters (``flash_attention.launches`` and the
  others) are bumped by Python when a wrapper is called, which a replay
  does not do: a capture records what its step counted, takes it back (the
  capture launched nothing), and every replay adds it.
- A capture or replay that fails raises. There is no eager fallback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch


def counted_wrappers() -> tuple:
    """The kernel wrappers whose ``launches`` counts a replay must bump."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    return (fa.flash_attention, pa.paged_attention, qm.quant_gemv, qm.quant_matmul)


def model_pool(model) -> tuple:
    """The graph memory pool of ``model``'s captured steps, made on first
    use: every generator over one model shares it (their replays are
    ordered on one stream, so one graph's temporaries may reuse another's)."""
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
    shapes and branches, in the memory pool ``pool`` (``model_pool``).
    ``captures``, ``replays`` and ``capture_seconds`` count what it did."""

    def __init__(self, device, pool):
        self.device = torch.device(device)
        self.pool = pool
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

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
        for wrapper, n in entry.launches:
            wrapper.launches += n
        self.replays += 1
        return entry.outputs

    def _capture(self, step, state, generators) -> _Captured:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in state]
        rng = [g.get_state() for g in generators]
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            mode = torch.cuda.get_sync_debug_mode()
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
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            outputs = step()
        launches = []
        for w, b in zip(wrappers, before):
            n = w.launches - b
            w.launches = b  # the capture recorded the launches and ran none
            if n:
                launches.append((w, n))
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(graph, outputs, launches)

    def pool_bytes(self) -> int:
        """Device memory held by this pool's segments (shared with the other
        graphs of the model), from the caching allocator's snapshot."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
