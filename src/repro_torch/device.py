"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return a concrete ``torch.device`` for ``device``.

    ``"cuda"`` resolves to the current CUDA device and raises when there is
    none: the port never falls back to the CPU behind the caller's back.
    The CPU is used only when asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' "
                         f"or 'cpu'")
    return dev


def stage(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh device tensor holding a copy of the host buffer ``buf``,
    enqueued without waiting on the device.

    On CUDA the bytes go through a fresh pinned buffer copied with
    ``non_blocking=True``: a copy from pageable memory synchronises with
    the stream, so it would wait for whatever is still running there (a
    decode horizon in flight).  PyTorch's pinned-memory cache keeps that
    buffer until the copy has run, and nothing else holds it, so the
    host may refill ``buf`` as soon as this returns.  On the CPU, a
    plain copy."""
    src = torch.from_numpy(np.ascontiguousarray(buf))
    if device.type != "cuda":
        return src.clone()
    return src.pin_memory().to(device, non_blocking=True)
