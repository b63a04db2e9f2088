"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU; a
machine without a card raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent.
    A CUDA device comes back with its index (``cuda`` is the current
    device), as a tensor on it reports its device, so that an engine can
    compare it with its model's."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(array: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy that does not make the host wait for the
    card: from pinned memory, asynchronously, on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_into(dst: torch.Tensor, array: np.ndarray) -> None:
    """Copy ``array`` into the front of the persistent buffer ``dst`` in one
    upload that does not make the host wait: from pinned memory,
    asynchronously, on a CUDA device (a captured step that reads ``dst`` is
    enqueued after the copy on the same stream)."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    view = dst[: src.numel()].view(src.shape)
    if dst.device.type == "cuda":
        view.copy_(src.pin_memory(), non_blocking=True)
    else:
        view.copy_(src)
