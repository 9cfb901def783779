"""Bijections between constrained supports and unconstrained space.

Counterpart of ``gwinferno_tpu/ppl/transforms.py`` for the supports on the
port's path (real, positive, interval).  ``__call__`` maps unconstrained ->
constrained; ``log_abs_det_jacobian(x, y)`` is the log Jacobian of that
forward map, elementwise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Transform", "IdentityTransform", "ExpTransform", "IntervalTransform"]


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


class Transform:
    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def inv(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


class ExpTransform(Transform):
    """R -> (0, inf) via exp."""

    def __call__(self, x):
        return torch.exp(x)

    def inv(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y):
        return x


class IntervalTransform(Transform):
    """R -> (low, high) via a scaled sigmoid."""

    def __init__(self, low, high):
        self.low, self.high = low, high

    def __call__(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inv(self, y):
        u = ((y - self.low) / (self.high - self.low)).clamp(1e-15, 1.0 - 1e-15)
        return torch.log(u) - torch.log1p(-u)

    def log_abs_det_jacobian(self, x, y):
        return _log(self.high - self.low) + F.logsigmoid(x) + F.logsigmoid(-x)
