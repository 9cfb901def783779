"""Bijections between constrained supports and unconstrained space.

Counterpart of ``gwinferno_tpu/ppl/transforms.py``.  ``__call__`` maps
unconstrained -> constrained; ``log_abs_det_jacobian(x, y)`` is the log
Jacobian of that forward map, summed over the transform's event dimensions
(the last axis for the vector transforms, elementwise otherwise);
``unconstrained_shape`` maps a constrained value's shape to the shape of its
unconstrained coordinates (a simplex of K values has K - 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "Transform",
    "IdentityTransform",
    "ExpTransform",
    "SigmoidTransform",
    "AffineTransform",
    "IntervalTransform",
    "OrderedTransform",
    "StickBreakingTransform",
    "SoftplusTransform",
    "ComposeTransform",
]


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


class Transform:
    event_dims = 0  # event ndim of the constrained output

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError

    def unconstrained_shape(self, constrained_shape):
        return tuple(constrained_shape)


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


class SigmoidTransform(Transform):
    """R -> (0, 1) via the logistic function."""

    def __call__(self, x):
        return torch.sigmoid(x)

    def inv(self, y):
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        return F.logsigmoid(x) + F.logsigmoid(-x)


class AffineTransform(Transform):
    """``loc + scale * x``."""

    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def __call__(self, x):
        return self.loc + self.scale * x

    def inv(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y):
        scale = torch.as_tensor(self.scale, dtype=x.dtype, device=x.device)
        return torch.log(torch.abs(scale)).expand(x.shape)


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


class OrderedTransform(Transform):
    """R^n -> increasing vectors: the first element free, the increments
    ``exp`` of the rest."""

    event_dims = 1

    def __call__(self, x):
        return torch.cumsum(torch.cat([x[..., :1], torch.exp(x[..., 1:])], dim=-1), dim=-1)

    def inv(self, y):
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], dim=-1)

    def log_abs_det_jacobian(self, x, y):
        return x[..., 1:].sum(-1)


def _stick_offsets(n, like):
    """``log(n-1), ..., log(1)``: the offsets that map 0 to the uniform
    simplex."""
    return torch.log(torch.arange(n - 1, 0, -1, dtype=like.dtype, device=like.device))


class StickBreakingTransform(Transform):
    """R^(n-1) -> the open simplex in R^n by stick breaking."""

    event_dims = 1

    def __call__(self, x):
        n = x.shape[-1] + 1
        z = torch.sigmoid(x - _stick_offsets(n, x))
        remainder = torch.cumprod(1.0 - z, dim=-1)
        pad = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        return torch.cat([z, pad], dim=-1) * torch.cat([pad, remainder], dim=-1)

    def inv(self, y):
        n = y.shape[-1]
        rev_cum = torch.flip(torch.cumsum(torch.flip(y, [-1]), -1), [-1])
        z = (y[..., :-1] / rev_cum[..., :-1].clamp_min(1e-30)).clamp(1e-15, 1 - 1e-15)
        return torch.log(z) - torch.log1p(-z) + _stick_offsets(n, y)

    def log_abs_det_jacobian(self, x, y):
        # y_i = z_i r_i with r_i the remaining stick and z_i = sigmoid(t_i):
        # the Jacobian is triangular, |det| = prod_i y_i (1 - z_i)
        t = x - _stick_offsets(x.shape[-1] + 1, x)
        return (torch.log(y[..., :-1].clamp_min(1e-300)) + F.logsigmoid(-t)).sum(-1)

    def unconstrained_shape(self, constrained_shape):
        shape = tuple(constrained_shape)
        return shape[:-1] + (shape[-1] - 1,)


class SoftplusTransform(Transform):
    """R -> (0, inf) via softplus."""

    def __call__(self, x):
        return F.softplus(x)

    def inv(self, y):
        return y + torch.log(-torch.expm1(-y))

    def log_abs_det_jacobian(self, x, y):
        return F.logsigmoid(x)


class ComposeTransform(Transform):
    """``parts`` applied in order; the log Jacobians add up."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.event_dims = max((p.event_dims for p in self.parts), default=0)

    def __call__(self, x):
        for p in self.parts:
            x = p(x)
        return x

    def inv(self, y):
        for p in reversed(self.parts):
            y = p.inv(y)
        return y

    def log_abs_det_jacobian(self, x, y):
        result = 0.0
        for p in self.parts:
            y_mid = p(x)
            result = result + p.log_abs_det_jacobian(x, y_mid)
            x = y_mid
        return result

    def unconstrained_shape(self, constrained_shape):
        for p in reversed(self.parts):
            constrained_shape = p.unconstrained_shape(constrained_shape)
        return tuple(constrained_shape)
