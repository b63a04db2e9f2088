"""Device placement and the in-process collectives (port of
``mlx_sharding_tpu/parallel/mesh.py``).

JAX lays a ``Mesh`` with the axes (dp, pp, sp, ep, tp), outermost first,
over ``jax.devices()``, and one process drives every device. Here a mesh is
a grid of ``torch.device`` over (pp, sp, ep, tp) in that order
(:func:`device_grid`), and one process drives every shard: a shard is one
cell of the grid. Without a device the grid takes the first pp·sp·ep·tp
CUDA devices, and fewer visible devices raise as ``make_mesh`` does. With an
explicit device (``cuda:0``, or ``cpu`` in the tests) every shard goes on
that device: the shards are then slices of one model on one card, the hops
between them are no-ops, and the weight bytes do not grow with the axes.

The collectives JAX's SPMD bodies call (``lax.psum``, ``pmax``,
``ppermute``) become functions over the list of one axis's shards
(:func:`psum`, :func:`pmax`, :func:`ppermute`): each reduces in rank order
on the first shard's device, in the values' dtype (XLA's all-reduce sums in
it; for two shards that is also one f32 sum rounded once), and hands each
shard its copy on its own device. ``lax.axis_index`` is a shard program's
:attr:`ShardAxis.index`.

Over several processes (``parallel/multihost.py``) a process axis splits
the pp stages (:func:`process_layout`): stage s belongs to rank ``s // (S /
P)``, a rank's tp, ep and sp shards stay in its process, and the grid's
cells of another rank's stages are ``meta`` devices, of which nothing is
held here. A split that would cut a tp, ep or sp group across processes
raises ``NotImplementedError``.

Code written as JAX writes an SPMD body, a shard's program with its psums
inline, runs here as a generator: where JAX calls ``psum(x, axis)`` it
writes ``x = yield from reduce(x, axis)``, and :func:`run_shards` advances
every shard's generator to its next reduction, reduces the values of each
group of the axis and sends each shard its result. Without an axis nothing
is yielded, and :func:`run_local` runs the body as a plain function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.device import resolve_device

# the names of the axes the shard programs reduce over
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_TP = "tp"

#: what the port does not run: a tp, ep or sp group over several processes
DEFER_PROCESS_GROUPS = ("a tp, ep or sp group spanning processes is not ported (ROADMAP queue "
                        "1, \"tp, ep and sp groups across processes\"): give each process "
                        "whole pipeline stages")

# reductions run by psum / pmax (one a group of an axis); a captured
# step's replays run none
_reductions = [0]


def reductions() -> int:
    """The in-process reductions run so far (:func:`psum` and :func:`pmax`
    calls); read it before and after a step to count a step's."""
    return _reductions[0]


@dataclasses.dataclass(frozen=True)
class ProcessLayout:
    """Which rank of a deployment runs each pipeline stage (the process
    axis over pp): stage s belongs to rank ``s // (S / P)``. This rank runs
    only its own stages; the hidden state crosses to the next rank where a
    stage boundary does (``parallel.multihost.send_hidden``)."""

    rank: int
    size: int
    stage_ranks: tuple  # the rank of each stage

    def owns(self, s: int) -> bool:
        return self.stage_ranks[s] == self.rank

    @property
    def local_stages(self) -> list:
        return [s for s, r in enumerate(self.stage_ranks) if r == self.rank]

    @property
    def head_rank(self) -> int:
        """The rank of the last stage: it applies the head and samples."""
        return self.stage_ranks[-1]


def process_layout(num_stages: int, sp: int = 1, ep: int = 1, tp: int = 1, *,
                   rank: Optional[int] = None, size: Optional[int] = None):
    """The :class:`ProcessLayout` of ``num_stages`` stages over the
    deployment's processes (this process's rank and the count from
    ``parallel.multihost`` unless given), or None in one process. The
    stages must split evenly over the processes (JAX's ``make_mesh``
    refuses a mesh that does not divide the devices); a split that would
    cut a tp, ep or sp group across processes raises
    ``NotImplementedError``."""
    if rank is None or size is None:
        from mlx_sharding_tpu_torch.parallel.multihost import process_count, process_index

        rank, size = process_index(), process_count()
    if size <= 1:
        return None
    if num_stages % size:
        if (num_stages * sp * ep * tp) % size == 0:
            raise NotImplementedError(DEFER_PROCESS_GROUPS)
        raise ValueError(f"{num_stages} pipeline stages do not split evenly over {size} "
                         f"processes: each process runs whole stages")
    per = num_stages // size
    return ProcessLayout(rank, size, tuple(s // per for s in range(num_stages)))


def device_grid(pp: int = 1, sp: int = 1, ep: int = 1, tp: int = 1, device=None,
                procs: Optional[ProcessLayout] = None) -> np.ndarray:
    """The (pp, sp, ep, tp) grid of devices (JAX ``make_mesh`` with dp = 1):
    the first pp·sp·ep·tp CUDA devices in axis order, or ``device`` in
    every cell. Over several processes (``procs``) the cells of another
    rank's stages are ``meta`` (nothing of them is held here) and this
    rank's stages take its own first CUDA devices, or ``device``."""
    sizes = dict(pp=pp, sp=sp, ep=ep, tp=tp)
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name} needs at least one device, got {n}")
    if procs is not None:
        local = procs.local_stages
        sub = device_grid(len(local), sp, ep, tp, device)
        grid = np.empty((pp, sp, ep, tp), dtype=object)
        grid.fill(torch.device("meta"))
        for j, s in enumerate(local):
            grid[s] = sub[j]
        return grid
    n = pp * sp * ep * tp
    grid = np.empty(n, dtype=object)
    if device is not None:
        dev = resolve_device(device)
        for i in range(n):
            grid[i] = dev
    else:
        resolve_device(None)  # raises without a card
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"mesh dp=1 pp={pp} sp={sp} ep={ep} tp={tp} needs {n} devices, "
                             f"have {have}")
        for i in range(n):
            grid[i] = torch.device("cuda", i)
    return grid.reshape(pp, sp, ep, tp)


def stage_devices(num_stages: int, device=None, procs: Optional[ProcessLayout] = None
                  ) -> list[torch.device]:
    """The device of each of ``num_stages`` stages: the first S CUDA devices
    (JAX's ``make_mesh(pp=S)`` over ``jax.devices()``), or ``device`` for
    every stage (``meta`` for another rank's, with ``procs``)."""
    if num_stages < 1:
        raise ValueError(f"a pipeline needs at least one stage, got {num_stages}")
    return list(device_grid(pp=num_stages, device=device, procs=procs)[:, 0, 0, 0])


def mesh_fingerprint(devices) -> str:
    """Stable identity of a placement (JAX ``mesh_fingerprint``): the axis
    sizes and every shard's device, in grid order; the placement half of a
    ``weights.WeightKey``. ``devices``: a (pp, sp, ep, tp) grid, or the
    list of stage devices of a placement at tp = ep = 1."""
    if isinstance(devices, np.ndarray):
        pp, sp, ep, tp = devices.shape
        flat = list(devices.flat)
    else:
        flat = list(devices)
        pp, sp, ep, tp = len(flat), 1, 1, 1
    axes = f"pp={pp}" + (f",sp={sp},ep={ep},tp={tp}" if (sp, ep, tp) != (1, 1, 1) else "")
    return f"{axes}|" + ",".join(str(d) for d in flat)


def same_mesh_devices(a, b) -> bool:
    """True when two placements span identical grids (the same shape, the
    same devices, in order), the condition for one resident model to serve
    both."""
    shape = lambda g: g.shape if isinstance(g, np.ndarray) else (len(g),)  # noqa: E731
    return (shape(a) == shape(b)
            and [str(d) for d in np.asarray(a, dtype=object).flat]
            == [str(d) for d in np.asarray(b, dtype=object).flat])


# ------------------------------------------------------------- collectives
def hop(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` handed to ``device`` (a stage's hidden state, a shard's value):
    the receiving stream waits on an event of the sending one, then the copy
    is enqueued without a host wait. ``x`` itself when it is there
    already."""
    if x.device == device:
        return x
    if x.is_cuda and device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(device).wait_event(done)
    return x.to(device, non_blocking=True)


def _spread(total: torch.Tensor, xs: list) -> list:
    """``total`` handed to every shard's device (the same tensor where it
    is there already)."""
    return [hop(total, x.device) for x in xs]


def psum(xs: list) -> list:
    """``lax.psum`` over one axis: the sum of the shards' values ``xs`` in
    rank order on the first shard's device, in their dtype, handed back to
    each shard."""
    _reductions[0] += 1
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + hop(x, dev)
    return _spread(total, xs)


def pmax(xs: list) -> list:
    """``lax.pmax`` over one axis, as :func:`psum` reduces."""
    _reductions[0] += 1
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = torch.maximum(total, hop(x, dev))
    return _spread(total, xs)


def ppermute(xs: list, shift: int = 1) -> list:
    """``lax.ppermute`` with the ring's pairs ``(i, (i + shift) % n)``:
    shard i's value moves to shard i + shift, on that shard's device."""
    n = len(xs)
    return [hop(xs[(i - shift) % n], xs[i].device) for i in range(n)]


# --------------------------------------------------------- shard programs
@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """One shard's view of a mesh axis inside its program: the axis's name,
    the shard's rank along it (``lax.axis_index``) and its size."""

    name: str
    index: int
    size: int


def reduce(x: torch.Tensor, axis: Optional[ShardAxis], op: str = "sum"):
    """Inside a shard's program (a generator): ``lax.psum`` (``op="sum"``)
    or ``pmax`` (``"max"``) of ``x`` over ``axis``, written ``x = yield from
    reduce(x, axis)``. Without an axis (or over a size-1 axis) ``x``
    itself, nothing yielded."""
    if axis is None or axis.size == 1:
        return x
    return (yield (axis.name, op, x))


def run_local(program):
    """The value a shard program (a generator) returns when it yields
    nothing: every axis it was given is absent or of size 1."""
    try:
        next(program)
    except StopIteration as done:
        return done.value
    raise RuntimeError("a shard program reduced over an axis that run_local does not run")


def run_shards(programs: list, groups: dict) -> list:
    """Run one program a shard to its end (JAX's SPMD body over the
    shards): each step advances every program to its next reduction, then
    reduces the values of each group of the named axis (``groups[axis]``:
    lists of ranks, each one group of shards that reduce together, in rank
    order) and sends every shard its group's result. Returns each
    program's value."""
    n = len(programs)
    sends: list = [None] * n
    while True:
        msgs, done = [], []
        for prog, send in zip(programs, sends):
            try:
                msgs.append(prog.send(send))
            except StopIteration as stop:
                done.append(stop.value)
        if len(done) == n:
            return done
        if done:
            raise RuntimeError("shard programs diverged: some ended while others reduce")
        axis, op = msgs[0][0], msgs[0][1]
        if any(m[0] != axis or m[1] != op for m in msgs):
            raise RuntimeError(f"shard programs diverged at a {op} over {axis}")
        fn = psum if op == "sum" else pmax
        for group in groups[axis]:
            for r, v in zip(group, fn([msgs[r][2] for r in group])):
                sends[r] = v
