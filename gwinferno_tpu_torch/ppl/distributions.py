"""Probability distributions for the PPL layer.

Counterpart of ``gwinferno_tpu/ppl/distributions.py``: ``Normal``,
``HalfNormal``, ``LogNormal``, ``Uniform``, ``Gamma``, ``Exponential``,
``Beta``, ``Dirichlet``, ``Categorical``, ``MixtureGeneral``,
``TruncatedNormal``, ``Delta`` and ``ImproperUniform``, plus ``Unit`` for
``factor``.  Parameters are Python numbers or tensors; ``log_prob`` broadcasts
them against the value and gives ``-inf`` (through ``where`` guards, never
NaN) outside the support.  Malformed parameters raise at construction when
they are numbers or CPU tensors that need no gradient (checking a CUDA
tensor would cost a host sync per construction).  Samplers draw from an
explicit ``torch.Generator``.

A distribution used as a population model evaluates the data with its
parameters' chain axis in front: :func:`population_log_prob` gives
``batch_shape + value.shape`` for any of these classes, and
:class:`MixtureGeneral` does so itself (``chain_outer``), like every class
of :mod:`gwinferno_tpu_torch.population_distributions`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constraints

__all__ = [
    "Distribution",
    "Normal",
    "HalfNormal",
    "LogNormal",
    "Uniform",
    "Gamma",
    "Exponential",
    "Beta",
    "Dirichlet",
    "Categorical",
    "MixtureGeneral",
    "TruncatedNormal",
    "Delta",
    "ImproperUniform",
    "Unit",
    "population_log_prob",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _ndtr(z):
    """The standard normal cdf, ``0.5 (1 + erf(z / sqrt 2))``."""
    if isinstance(z, torch.Tensor):
        return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def _checkable(v):
    """A host value of ``v`` to validate, or None for a tensor that is on
    the card or needs a gradient."""
    if isinstance(v, torch.Tensor):
        return None if (v.device.type != "cpu" or v.requires_grad) else v.numpy()
    return np.asarray(v)


def _uniform(generator, shape, dtype=None):
    dtype = dtype or torch.get_default_dtype()
    return torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)


def _randn(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.get_default_dtype())


def _gamma(generator, concentration, shape):
    conc = torch.as_tensor(concentration, dtype=torch.get_default_dtype(), device=generator.device)
    return torch._standard_gamma(conc.expand(shape).contiguous(), generator=generator)


class Distribution:
    """Base distribution: ``batch_shape`` broadcasts over the parameters;
    ``support`` is a :mod:`constraints` descriptor.  ``arg_constraints`` maps
    a parameter name to ``(predicate, description)``."""

    support = constraints.real
    event_ndim = 0
    chain_outer = False
    arg_constraints = {}

    def __init__(self, batch_shape=(), event_shape=()):
        self.batch_shape = tuple(batch_shape)
        self.event_shape = tuple(event_shape)
        for name, (pred, desc) in self.arg_constraints.items():
            val = _checkable(getattr(self, name))
            if val is not None and not np.all(pred(val)):
                raise ValueError(f"{type(self).__name__}: argument '{name}' must be {desc}, got {getattr(self, name)!r}")

    @property
    def shape(self):
        return self.batch_shape + self.event_shape

    def sample(self, generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def expand_shapes(self, sample_shape=()):
        """The shape of a draw of ``sample_shape``: ``sample_shape +
        batch_shape + event_shape``."""
        return tuple(sample_shape) + self.shape


def population_log_prob(d, value):
    """``d.log_prob`` of data ``value`` with ``d``'s batch (chain) axes in
    front: ``batch_shape + value.shape``.

    Population distributions and :class:`MixtureGeneral` (``chain_outer``)
    do this themselves; for the other distributions, whose ``log_prob``
    broadcasts the parameters against the value's trailing axes, the value
    gets trailing unit axes for the batch and the result's batch axes move
    to the front.
    """
    if d.chain_outer or not d.batch_shape:
        return d.log_prob(value)
    if d.event_shape:
        raise ValueError(f"{type(d).__name__} with event shape {d.event_shape} cannot be a population model")
    nb = len(d.batch_shape)
    lp = d.log_prob(value.reshape(tuple(value.shape) + (1,) * nb))
    return lp.movedim(tuple(range(value.ndim, value.ndim + nb)), tuple(range(nb)))


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

    def cdf(self, value):
        return _ndtr((value - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)


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


class LogNormal(Distribution):
    support = constraints.positive
    arg_constraints = {"scale": (lambda v: v > 0, "positive")}

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        super().__init__(torch.broadcast_shapes(_shape(loc), _shape(scale)))

    def sample(self, generator, sample_shape=()):
        return torch.exp(self.loc + self.scale * _randn(generator, tuple(sample_shape) + self.batch_shape))

    def log_prob(self, value):
        safe = torch.where(value > 0, value, 1.0)
        z = (torch.log(safe) - self.loc) / self.scale
        lp = -0.5 * z * z - torch.log(safe) - _log(self.scale) - _LOG_SQRT_2PI
        return torch.where(value > 0, lp, -torch.inf)


class Uniform(Distribution):
    arg_constraints = {"_width": (lambda v: v > 0, "high > low")}

    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high
        self._width = high - low
        super().__init__(torch.broadcast_shapes(_shape(low), _shape(high)))
        self.support = constraints.interval(low, high)

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, tuple(sample_shape) + self.batch_shape)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inb = (value >= self.low) & (value <= self.high)
        return torch.where(inb, torch.zeros_like(value) - _log(self.high - self.low), -torch.inf)

    def cdf(self, value):
        return torch.clamp((value - self.low) / (self.high - self.low), 0.0, 1.0)

    def icdf(self, q):
        return self.low + q * (self.high - self.low)


class Gamma(Distribution):
    support = constraints.positive
    arg_constraints = {"concentration": (lambda v: v > 0, "positive"), "rate": (lambda v: v > 0, "positive")}

    def __init__(self, concentration, rate=1.0):
        self.concentration, self.rate = concentration, rate
        super().__init__(torch.broadcast_shapes(_shape(concentration), _shape(rate)))

    def sample(self, generator, sample_shape=()):
        return _gamma(generator, self.concentration, tuple(sample_shape) + self.batch_shape) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        safe = torch.where(value > 0, value, 1.0)
        lp = torch.special.xlogy(a - 1.0, safe) - b * safe + a * _log(b) - _lgamma(a)
        return torch.where(value > 0, lp, -torch.inf)


class Exponential(Distribution):
    support = constraints.positive
    arg_constraints = {"rate": (lambda v: v > 0, "positive")}

    def __init__(self, rate=1.0):
        self.rate = rate
        super().__init__(_shape(rate))

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, tuple(sample_shape) + self.batch_shape)
        return -torch.log1p(-u) / self.rate

    def log_prob(self, value):
        lp = _log(self.rate) - self.rate * value
        return torch.where(value >= 0, lp, -torch.inf)


class Beta(Distribution):
    support = constraints.unit_interval
    arg_constraints = {"concentration1": (lambda v: v > 0, "positive"), "concentration0": (lambda v: v > 0, "positive")}

    def __init__(self, concentration1, concentration0):
        self.concentration1, self.concentration0 = concentration1, concentration0
        super().__init__(torch.broadcast_shapes(_shape(concentration1), _shape(concentration0)))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        x, y = _gamma(generator, self.concentration1, shape), _gamma(generator, self.concentration0, shape)
        return x / (x + y)

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        safe = torch.clamp(value, 1e-38, 1.0 - 1e-7)
        betaln = _lgamma(a) + _lgamma(b) - _lgamma(a + b)
        lp = torch.special.xlogy(a - 1.0, safe) + torch.special.xlogy(b - 1.0, 1.0 - safe) - betaln
        return torch.where((value >= 0) & (value <= 1), lp, -torch.inf)


class Dirichlet(Distribution):
    support = constraints.simplex
    event_ndim = 1
    arg_constraints = {"concentration": (lambda v: v > 0, "positive")}

    def __init__(self, concentration):
        self.concentration = torch.as_tensor(concentration)
        super().__init__(self.concentration.shape[:-1], self.concentration.shape[-1:])

    def sample(self, generator, sample_shape=()):
        g = _gamma(generator, self.concentration, tuple(sample_shape) + self.shape)
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        a = self.concentration
        norm = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
        return torch.special.xlogy(a - 1.0, value.clamp_min(1e-38)).sum(-1) - norm


class Categorical(Distribution):
    """A categorical over the last axis of ``probs`` or ``logits``."""

    support = constraints.integer

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("provide exactly one of probs / logits")
        if probs is not None:
            logits = torch.log(torch.as_tensor(probs).clamp_min(1e-38))
        else:
            logits = torch.as_tensor(logits)
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return torch.exp(self.logits)

    def sample(self, generator, sample_shape=()):
        """Gumbel-max draws of shape ``sample_shape + batch_shape``."""
        shape = tuple(sample_shape) + self.logits.shape
        u = _uniform(generator, shape, self.logits.dtype).clamp_min(torch.finfo(self.logits.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.logits.device).long()
        batch = torch.broadcast_shapes(value.shape, self.batch_shape)
        logits = self.logits.expand(batch + self.logits.shape[-1:])
        return torch.gather(logits, -1, value.expand(batch)[..., None])[..., 0]


class MixtureGeneral(Distribution):
    """A finite mixture: a :class:`Categorical` mixing distribution over a
    list of component distributions.

    ``log_prob(value)`` is ``batch_shape + value.shape``: each component's
    :func:`population_log_prob`, stacked on a trailing component axis, plus
    the mixing logits with their batch axes in front, reduced by
    ``logsumexp`` over that axis (so a chain-batched hyperparameter never
    meets the component axis).  For parameters without a batch axis this is
    the ordinary mixture density.  ``support`` is the first component's.
    """

    chain_outer = True

    def __init__(self, mixing_distribution, component_distributions):
        if not isinstance(mixing_distribution, Categorical):
            raise ValueError("mixing_distribution must be a Categorical")
        if len(component_distributions) != mixing_distribution.logits.shape[-1]:
            raise ValueError(
                f"{len(component_distributions)} components vs {mixing_distribution.logits.shape[-1]} mixing weights"
            )
        self.mixing_distribution = mixing_distribution
        self.component_distributions = list(component_distributions)
        batch = torch.broadcast_shapes(mixing_distribution.batch_shape,
                                       *(tuple(c.batch_shape) for c in self.component_distributions))
        super().__init__(batch)
        self.support = self.component_distributions[0].support

    def log_prob(self, value):
        comp_lp = torch.stack(
            torch.broadcast_tensors(*(population_log_prob(c, value) for c in self.component_distributions)), dim=-1
        )
        logits = self.mixing_distribution.logits
        logits = logits.reshape(logits.shape[:-1] + (1,) * value.ndim + logits.shape[-1:])
        return torch.logsumexp(comp_lp + logits, dim=-1)

    def sample(self, generator, sample_shape=()):
        """Draws of shape ``sample_shape + batch_shape`` for components
        without an event shape."""
        shape = tuple(sample_shape) + self.batch_shape
        draws = torch.stack([c.sample(generator, sample_shape).expand(shape) for c in self.component_distributions], -1)
        idx = self.mixing_distribution.sample(generator, sample_shape).expand(shape)
        return torch.gather(draws, -1, idx[..., None])[..., 0]


class TruncatedNormal(Distribution):
    arg_constraints = {"scale": (lambda v: v > 0, "positive"), "_width": (lambda v: v > 0, "high > low")}

    def __init__(self, loc=0.0, scale=1.0, low=-math.inf, high=math.inf):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high
        self._width = high - low
        super().__init__(torch.broadcast_shapes(_shape(loc), _shape(scale), _shape(low), _shape(high)))
        self.support = constraints.interval(low, high)
        self._lcdf = _ndtr((low - loc) / scale)
        self._ucdf = _ndtr((high - loc) / scale)

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, tuple(sample_shape) + self.batch_shape)
        q = torch.clamp(self._lcdf + u * (self._ucdf - self._lcdf), 1e-15, 1 - 1e-15)
        return self.loc + self.scale * math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        lp = -0.5 * z * z - _log(self.scale) - _LOG_SQRT_2PI - _log(self._ucdf - self._lcdf)
        return torch.where((value >= self.low) & (value <= self.high), lp, -torch.inf)


class Delta(Distribution):
    """A point mass at ``value``; the last ``event_ndim`` axes are the event."""

    def __init__(self, value=0.0, event_ndim=0):
        self.value = torch.as_tensor(value)
        self.event_ndim = event_ndim
        shape = tuple(self.value.shape)
        split = len(shape) - event_ndim
        super().__init__(shape[:split], shape[split:])

    def sample(self, generator, sample_shape=()):
        return self.value.expand(tuple(sample_shape) + self.shape)

    def log_prob(self, value):
        lp = torch.where(value == self.value, 0.0, -torch.inf)
        return lp.sum(tuple(range(-self.event_ndim, 0))) if self.event_ndim else lp


class ImproperUniform(Distribution):
    """A flat (improper) density over ``support``: log density 0."""

    def __init__(self, support=constraints.real, batch_shape=(), event_shape=()):
        self.support = support
        super().__init__(batch_shape, event_shape)

    def sample(self, generator, sample_shape=()):
        return _randn(generator, tuple(sample_shape) + self.shape)  # an arbitrary starting draw

    def log_prob(self, value):
        lp = torch.zeros_like(torch.as_tensor(value))
        ndim = self.support.event_dims
        return lp.sum(tuple(range(-ndim, 0))) if ndim else lp


class Unit(Distribution):
    """Trivial distribution carrying a log factor (used by ``factor``)."""

    def __init__(self, log_factor):
        self.log_factor = log_factor
        super().__init__()

    def sample(self, generator, sample_shape=()):
        return torch.zeros(tuple(sample_shape))

    def log_prob(self, value):
        return self.log_factor
