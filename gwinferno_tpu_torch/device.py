"""Device selection for the port's entry points, and the way back to the
host."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "host_array"]


def resolve_device(device=None):
    """``torch.device`` for an entry point: CUDA unless the caller names
    another device.

    Raises when CUDA is asked for (explicitly or by default) and is absent:
    the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def host_array(v):
    """A tensor on any device (detached, copied to the host), or anything
    numpy takes, as a numpy array."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
