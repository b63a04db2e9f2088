"""Stage placement (port of the pipeline axis of
``mlx_sharding_tpu/parallel/mesh.py``): a pipeline's stages as a list of
devices, one per stage.

JAX lays the ``pp`` axis of a ``Mesh`` over ``jax.devices()``; here a stage
is a ``torch.device``. Without a device the stages take the first S CUDA
devices, and fewer visible devices raise as ``make_mesh`` does. With an
explicit device (``cuda:0``, or ``cpu`` in the tests) every stage goes on
that device: the stages are then slices of one model on one card, the hop
between them is a no-op, and the weight bytes do not grow with S.
"""

from __future__ import annotations

import torch

from mlx_sharding_tpu_torch.device import resolve_device


def stage_devices(num_stages: int, device=None) -> list[torch.device]:
    """The device of each of ``num_stages`` stages: the first S CUDA devices
    (JAX's ``make_mesh(pp=S)`` over ``jax.devices()``), or ``device`` for
    every stage."""
    if num_stages < 1:
        raise ValueError(f"a pipeline needs at least one stage, got {num_stages}")
    if device is not None:
        return [resolve_device(device)] * num_stages
    resolve_device(None)  # raises without a card
    n = torch.cuda.device_count()
    if num_stages > n:
        raise ValueError(f"mesh dp=1 pp={num_stages} sp=1 ep=1 tp=1 needs {num_stages} "
                         f"devices, have {n}")
    return [torch.device("cuda", i) for i in range(num_stages)]


def mesh_fingerprint(devices) -> str:
    """Stable identity of a placement (JAX ``mesh_fingerprint``): the stage
    count and the device of every stage, in order; the placement half of a
    ``weights.WeightKey``."""
    devices = list(devices)
    return f"pp={len(devices)}|" + ",".join(str(d) for d in devices)


def same_mesh_devices(a, b) -> bool:
    """True when two placements put the same stages on the same devices,
    the condition for one resident model to serve both."""
    return [str(d) for d in a] == [str(d) for d in b]
