"""Per-phase wall-clock timing.

Counterpart of ``gwinferno_tpu/utils/prof.py``'s ``Timer``: named phase
timers with a report.  Where the JAX package waits on
``block_until_ready``, a phase here waits on ``torch.cuda.synchronize`` for
the CUDA tensors it is given, so a phase's time includes its device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["Timer"]


def _synchronize(tensors):
    """Wait for the devices of the CUDA tensors among ``tensors`` (a tensor,
    or a nested list, tuple or dict of them)."""
    if isinstance(tensors, torch.Tensor):
        if tensors.is_cuda:
            torch.cuda.synchronize(tensors.device)
    elif isinstance(tensors, dict):
        for v in tensors.values():
            _synchronize(v)
    elif isinstance(tensors, (list, tuple)):
        for v in tensors:
            _synchronize(v)


class Timer:
    """Accumulating named phase timer.

    >>> timer = Timer()
    >>> with timer("warmup"): ...
    >>> with timer("sampling", block_until_ready_on=samples): ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name, block_until_ready_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(block_until_ready_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, print_fn=print):
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            print_fn(f"{name:>24}: {t:9.3f}s  ({n}x, {t / max(n, 1):8.4f}s each, {100 * t / max(total, 1e-12):5.1f}%)")
        print_fn(f"{'total':>24}: {total:9.3f}s")

