"""Probability distributions for the PPL layer.

Counterpart of ``gwinferno_tpu/ppl/distributions.py`` for the sites on the
port's path: ``Normal``, ``HalfNormal``, ``Uniform`` and ``Gamma`` (the
bench model's hyperpriors and the rate prior), plus ``Unit`` for
``factor``.  Parameters are Python numbers or tensors; ``log_prob`` is
elementwise and gives ``-inf`` (through ``where`` guards, never NaN) outside
the support.  Malformed numeric parameters raise at construction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constraints

__all__ = ["Distribution", "Normal", "HalfNormal", "Uniform", "Gamma", "Unit"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


class Distribution:
    """Base distribution: ``batch_shape`` broadcasts over the parameters;
    ``support`` is a :mod:`constraints` descriptor.  ``arg_constraints`` maps
    a parameter name to ``(predicate, description)``, checked for numeric
    (non-tensor) parameters at construction."""

    support = constraints.real
    arg_constraints = {}

    def __init__(self, batch_shape=(), event_shape=()):
        self.batch_shape = tuple(batch_shape)
        self.event_shape = tuple(event_shape)
        for name, (pred, desc) in self.arg_constraints.items():
            val = getattr(self, name)
            if not isinstance(val, torch.Tensor) and not np.all(pred(np.asarray(val))):
                raise ValueError(f"{type(self).__name__}: argument '{name}' must be {desc}, got {val!r}")

    @property
    def shape(self):
        return self.batch_shape + self.event_shape

    def sample(self, generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


def _randn(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.get_default_dtype())


class Normal(Distribution):
    support = constraints.real
    arg_constraints = {"scale": (lambda v: v > 0, "positive")}

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        super().__init__(torch.broadcast_shapes(_shape(loc), _shape(scale)))

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * _randn(generator, tuple(sample_shape) + self.batch_shape)

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - _LOG_SQRT_2PI


class HalfNormal(Distribution):
    support = constraints.positive
    arg_constraints = {"scale": (lambda v: v > 0, "positive")}

    def __init__(self, scale=1.0):
        self.scale = scale
        super().__init__(_shape(scale))

    def sample(self, generator, sample_shape=()):
        return torch.abs(_randn(generator, tuple(sample_shape) + self.batch_shape)) * self.scale

    def log_prob(self, value):
        z = value / self.scale
        lp = math.log(2.0) - 0.5 * z * z - _log(self.scale) - _LOG_SQRT_2PI
        return torch.where(value >= 0, lp, -torch.inf)


class Uniform(Distribution):
    arg_constraints = {"_width": (lambda v: v > 0, "high > low")}

    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high
        self._width = high - low
        super().__init__(torch.broadcast_shapes(_shape(low), _shape(high)))
        self.support = constraints.interval(low, high)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.get_default_dtype())
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inb = (value >= self.low) & (value <= self.high)
        return torch.where(inb, torch.zeros_like(value) - _log(self.high - self.low), -torch.inf)


class Gamma(Distribution):
    support = constraints.positive
    arg_constraints = {"concentration": (lambda v: v > 0, "positive"), "rate": (lambda v: v > 0, "positive")}

    def __init__(self, concentration, rate=1.0):
        self.concentration, self.rate = concentration, rate
        super().__init__(torch.broadcast_shapes(_shape(concentration), _shape(rate)))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        conc = torch.as_tensor(self.concentration, dtype=torch.get_default_dtype(), device=generator.device)
        return torch._standard_gamma(conc.expand(shape), generator=generator) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        lgamma_a = torch.lgamma(a) if isinstance(a, torch.Tensor) else math.lgamma(a)
        safe = torch.where(value > 0, value, 1.0)
        lp = torch.special.xlogy(a - 1.0, safe) - b * safe + a * _log(b) - lgamma_a
        return torch.where(value > 0, lp, -torch.inf)


class Unit(Distribution):
    """Trivial distribution carrying a log factor (used by ``factor``)."""

    def __init__(self, log_factor):
        self.log_factor = log_factor
        super().__init__()

    def sample(self, generator, sample_shape=()):
        return torch.zeros(tuple(sample_shape))

    def log_prob(self, value):
        return self.log_factor
