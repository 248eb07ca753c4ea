"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

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
