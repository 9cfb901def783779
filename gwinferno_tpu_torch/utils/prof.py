"""Per-phase wall-clock timing and profiler traces.

Counterpart of ``gwinferno_tpu/utils/prof.py``: named phase timers with a
report, a one-shot timer, and trace capture around a code region.  Where the
JAX package waits on ``block_until_ready``, a phase here waits on
``torch.cuda.synchronize`` for the CUDA tensors it is given, so a phase's
time includes its device work.  Traces come from ``torch.profiler`` where
the JAX package starts ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["Timer", "timed", "trace_capture"]


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



@contextlib.contextmanager
def timed(name, print_fn=print):
    """One-shot timer: ``with timed("compile"): ...`` prints ``[compile]
    1.234s``."""
    t0 = time.perf_counter()
    yield
    print_fn(f"[{name}] {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def trace_capture(logdir, enabled=True):
    """Profile a code region with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace
    ``trace_{time}_{pid}.json`` into ``logdir`` (made if missing); view it in
    Perfetto or ``chrome://tracing``.  No-op when ``enabled=False``, so call
    sites can leave it in place."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
