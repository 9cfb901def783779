"""Stochastic variational inference: the SVI loop, two autoguides, the
ELBO, Adam and ``find_map``.

Counterpart of ``gwinferno_tpu/infer/svi.py``.  A guide works on the
model's :class:`~gwinferno_tpu_torch.ppl.ModelPotential`: its variational
parameters are site-shaped unconstrained tensors ``{site: tensor}`` (the
JAX package's layout), raveled into the potential's flat ``(C, D)`` points
when the loss is evaluated.  ``AutoNormal``'s particles are one
chain-batched potential call with ``C = num_particles``.  ``Adam`` is
``torch.optim.Adam``, whose update is optax's ``adam`` (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, both bias corrections).  The optimization
is a Python loop whose losses stay on the device (no host read per step).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ppl.infer_util import ModelPotential

__all__ = ["SVI", "SVIRunResult", "AutoDelta", "AutoNormal", "Trace_ELBO", "Adam", "find_map"]


class SVIRunResult(NamedTuple):
    params: dict
    state: object  # the torch optimizer, holding its moment estimates
    losses: torch.Tensor  # (num_steps,), each step's loss before its update


class Trace_ELBO:
    """Negative evidence lower bound.  ``num_particles`` Monte Carlo draws
    for stochastic guides; AutoDelta needs none."""

    def __init__(self, num_particles=1):
        self.num_particles = num_particles


class Adam:
    """``numpyro.optim.Adam(step_size)``: ``torch.optim.Adam(lr=step_size)``
    over the guide's parameters."""

    def __init__(self, step_size):
        self.step_size = step_size

    def to_torch(self, params):
        return torch.optim.Adam(params, lr=self.step_size, betas=(0.9, 0.999), eps=1e-8)


class _Guide:
    """What both guides share: the model's potential, built by
    :meth:`init_params`, and the site transforms."""

    def _build(self, model_args, model_kwargs, device, dtype):
        self._potential = ModelPotential(self.model, model_args, model_kwargs, device=device, dtype=dtype)
        return self._potential

    def _constrain(self, name, v):
        """Site-shaped unconstrained ``v`` (with any leading axes) ->
        constrained, through the site's transform."""
        pot = self._potential
        lead = v.shape[: v.ndim - len(pot.unconstrained_shapes[name])]
        y = pot.transforms[name](v.reshape((-1,) + pot.unconstrained_shapes[name]))
        return y.reshape(lead + pot.shapes[name])

    def _randn(self, generator, shape):
        pot = self._potential
        return torch.randn(shape, generator=generator, dtype=pot.dtype, device=pot.device)

    def _init_locs(self, generator):
        """Unconstrained starting values: ``init_values`` (constrained)
        mapped through each site's inverse transform, the other sites
        ``init_scale``-scaled normal draws."""
        pot = self._potential
        locs = {}
        for name in pot.names:
            if name in self.init_values:
                v = torch.as_tensor(self.init_values[name], dtype=pot.dtype, device=pot.device)
                locs[name] = pot.transforms[name].inv(v[None])[0]
            else:
                locs[name] = self.init_scale * self._randn(generator, pot.unconstrained_shapes[name])
        return locs


class AutoDelta(_Guide):
    """MAP point-mass guide: the variational parameters are the
    unconstrained site values, and the negative ELBO is the potential energy
    (joint density and Jacobian)."""

    def __init__(self, model, init_scale=0.1, init_values=None):
        """``init_values``: optional ``{site: constrained value}`` to start
        from (numpyro's ``init_to_value``); the other sites start at
        ``init_scale``-scaled normal draws in unconstrained space."""
        self.model = model
        self.init_scale = init_scale
        self.init_values = init_values or {}

    def init_params(self, generator, model_args=(), model_kwargs=None, device=None, dtype=torch.float32):
        self._build(model_args, model_kwargs, device, dtype)
        return self._init_locs(generator)

    def neg_elbo(self, generator, params, num_particles=1):
        pot = self._potential
        return pot(pot.ravel({k: v[None] for k, v in params.items()}))[0]

    def median(self, params):
        """The constrained point estimate, site-shaped."""
        return {k: self._constrain(k, v) for k, v in params.items()}


class AutoNormal(_Guide):
    """Mean-field Gaussian guide in unconstrained space (reparameterized),
    of scale ``init_scale`` at the start; its locations start as
    :class:`AutoDelta`'s values do (``init_values``, else draws)."""

    def __init__(self, model, init_scale=0.1, init_values=None):
        self.model = model
        self.init_scale = init_scale
        self.init_values = init_values or {}

    def init_params(self, generator, model_args=(), model_kwargs=None, device=None, dtype=torch.float32):
        pot = self._build(model_args, model_kwargs, device, dtype)
        log_scales = {name: torch.full(pot.unconstrained_shapes[name], math.log(self.init_scale), dtype=dtype,
                                       device=pot.device) for name in pot.names}
        return {"loc": self._init_locs(generator), "log_scale": log_scales}

    def neg_elbo(self, generator, params, num_particles=1):
        """The potential averaged over ``num_particles`` reparameterized
        draws (one batched call), less the guide's exact entropy."""
        pot = self._potential
        loc = pot.ravel({k: v[None] for k, v in params["loc"].items()})
        log_scale = pot.ravel({k: v[None] for k, v in params["log_scale"].items()})
        z = loc + torch.exp(log_scale) * self._randn(generator, (num_particles, pot.dim))
        entropy = log_scale.sum() + pot.dim * 0.5 * math.log(2 * math.pi * math.e)
        return pot(z).mean() - entropy

    def median(self, params):
        return {k: self._constrain(k, v) for k, v in params["loc"].items()}

    def sample_posterior(self, rng_seed, params, sample_shape=()):
        """Constrained draws ``{site: sample_shape + shape}`` from the guide,
        from a generator seeded with ``rng_seed``."""
        gen = torch.Generator(device=self._potential.device).manual_seed(int(rng_seed))
        out = {}
        for k, loc in params["loc"].items():
            eps = self._randn(gen, tuple(sample_shape) + tuple(loc.shape))
            out[k] = self._constrain(k, loc + torch.exp(params["log_scale"][k]) * eps)
        return out


class SVI:
    """``SVI(model, guide, optim, loss).run(rng_seed, num_steps, *args)``.

    ``optim`` is :class:`Adam`.  The run is on ``device`` (CUDA unless
    asked otherwise) in ``dtype``, and draws every random number from one
    ``torch.Generator`` seeded with ``rng_seed``."""

    def __init__(self, model, guide, optim, loss, *, device=None, dtype=torch.float32):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.loss = loss
        self.device = resolve_device(device)
        self.dtype = dtype

    def run(self, rng_seed, num_steps, *model_args, **model_kwargs):
        gen = torch.Generator(device=self.device).manual_seed(int(rng_seed))
        params = self.guide.init_params(gen, model_args, model_kwargs, device=self.device, dtype=self.dtype)
        leaves = params.values() if isinstance(self.guide, AutoDelta) else [
            v for group in params.values() for v in group.values()]
        leaves = [v.requires_grad_(True) for v in leaves]
        opt = self.optim.to_torch(leaves)
        num_particles = getattr(self.loss, "num_particles", 1)
        losses = torch.empty(int(num_steps), dtype=self.dtype, device=self.device)
        for i in range(int(num_steps)):
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = self.guide.neg_elbo(gen, params, num_particles)
                loss.backward()
            opt.step()
            losses[i] = loss.detach()
        for v in leaves:
            v.requires_grad_(False)
        return SVIRunResult(params=params, state=opt, losses=losses)


def find_map(rng_key, model, *model_args, Niter=100, lr=0.01, init_values=None, device=None,
             dtype=torch.float32, **model_kwargs):
    """MAP estimate by SVI with an AutoDelta guide and Adam on the ELBO.

    Returns the **constrained** site values, site-shaped.  ``rng_key`` is a
    seed; ``init_values`` (constrained site values) starts the guide there,
    as ``AutoDelta(init_values=...)`` does.
    """
    guide = AutoDelta(model, init_values=init_values)
    svi = SVI(model, guide, Adam(lr), Trace_ELBO(), device=device, dtype=dtype)
    result = svi.run(rng_key, Niter, *model_args, **model_kwargs)
    with torch.no_grad():
        return guide.median(result.params)
