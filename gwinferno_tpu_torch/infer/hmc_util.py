"""HMC building blocks over a leading chain axis: mass matrices, the
leapfrog integrator, Welford covariance estimation, Nesterov dual averaging,
the Stan warmup windows and the initial step-size search.

Counterpart of ``gwinferno_tpu/infer/hmc_util.py``.  Where the JAX functions
act on one chain's ``(dim,)`` vector and are ``vmap``-ed upstream, these take
``(C, dim)`` positions, ``(C,)`` scalars and per-chain mass matrices
(``(C, dim)`` diagonal or ``(C, dim, dim)`` dense).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "MassMatrix",
    "mass_matrix_from_inverse",
    "identity_mass_matrix",
    "velocity",
    "kinetic_energy",
    "ChainRows",
    "chain_draw",
    "sample_momentum",
    "momentum_from_normal",
    "value_and_grad",
    "leapfrog",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_pool",
    "welford_covariance",
    "DAState",
    "da_init",
    "da_update",
    "build_warmup_schedule",
    "find_reasonable_step_size",
]


class MassMatrix(NamedTuple):
    """Per-chain inverse mass matrix and the Cholesky factor of the mass
    matrix (``mass_chol @ mass_chol.T = inverse^-1``), used to draw momenta
    ``r = mass_chol @ eps``."""

    inverse: torch.Tensor
    mass_chol: torch.Tensor

    @property
    def is_dense(self):
        return self.inverse.ndim == 3


def mass_matrix_from_inverse(inverse):
    if inverse.ndim == 2:
        return MassMatrix(inverse, torch.sqrt(1.0 / inverse))
    inv_chol = torch.linalg.cholesky(inverse)
    eye = torch.eye(inverse.shape[-1], dtype=inverse.dtype, device=inverse.device).expand_as(inverse)
    # M^(1/2) = L^-T where inverse = L L^T  (cov(L^-T eps) = inverse^-1)
    mass_chol = torch.linalg.solve_triangular(inv_chol.mT, eye, upper=True)
    return MassMatrix(inverse, mass_chol)


def identity_mass_matrix(num_chains, dim, dense=False, dtype=torch.float32, device=None):
    if dense:
        inv = torch.eye(dim, dtype=dtype, device=device).expand(num_chains, dim, dim).contiguous()
    else:
        inv = torch.ones(num_chains, dim, dtype=dtype, device=device)
    return mass_matrix_from_inverse(inv)


def _matvec(mat, r, dense):
    """Per-chain ``mat @ r`` for ``r`` of shape ``(C, ..., dim)``."""
    if dense:
        return torch.einsum("cij,c...j->c...i", mat, r)
    return mat.reshape(mat.shape[:1] + (1,) * (r.ndim - 2) + mat.shape[1:]) * r


def velocity(mm: MassMatrix, r):
    return _matvec(mm.inverse, r, mm.is_dense)


def kinetic_energy(mm: MassMatrix, r):
    return 0.5 * (r * velocity(mm, r)).sum(-1)


def momentum_from_normal(mm: MassMatrix, eps):
    """Momenta ``mass_chol @ eps`` from unit normals ``eps``."""
    return _matvec(mm.mass_chol, eps, mm.is_dense)


class ChainRows(NamedTuple):
    """A generator whose draws are made for all ``total`` chains of a run,
    of which a rank keeps its block ``rows``: a chain-sharded run then
    consumes the generator as the unsharded run does, and chain ``c`` sees
    row ``c`` of every draw (``MCMC`` and ``SMC`` over a mesh)."""

    generator: torch.Generator
    rows: slice
    total: int


def chain_draw(fn, shape, generator, dtype, device):
    """``fn(shape, generator=, dtype=, device=)`` (``torch.randn``,
    ``torch.rand``) with a leading chain axis; a :class:`ChainRows`
    generator draws ``total`` rows and returns its own."""
    if isinstance(generator, ChainRows):
        full = fn((generator.total,) + tuple(shape[1:]), generator=generator.generator, dtype=dtype, device=device)
        return full[generator.rows]
    return fn(shape, generator=generator, dtype=dtype, device=device)


def sample_momentum(mm: MassMatrix, generator, like):
    eps = chain_draw(torch.randn, like.shape, generator, like.dtype, like.device)
    return momentum_from_normal(mm, eps)


def value_and_grad(potential_fn, z):
    """``potential_fn(z)`` ``(C,)`` and its gradient ``(C, dim)``; the
    potential's own ``value_and_grad`` where it has one
    (:class:`~gwinferno_tpu_torch.ppl.ModelPotential`)."""
    if hasattr(potential_fn, "value_and_grad"):
        return potential_fn.value_and_grad(z)
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        pe = potential_fn(zz)
        (grad,) = torch.autograd.grad(pe.sum(), zz)
    return pe.detach(), grad


def leapfrog(potential_fn):
    """One velocity-Verlet step per chain: returns ``step(z, r, grad,
    step_size, mm) -> (z, r, pe, grad)`` with one gradient evaluation;
    ``step_size`` is ``(C,)`` (signed: negative integrates backward)."""

    def step(z, r, grad, step_size, mm: MassMatrix):
        eps = step_size[:, None]
        r_half = r - 0.5 * eps * grad
        z_new = z + eps * velocity(mm, r_half)
        pe_new, grad_new = value_and_grad(potential_fn, z_new)
        r_new = r_half - 0.5 * eps * grad_new
        return z_new, r_new, pe_new, grad_new

    return step


# ---------------------------------------------------------------- Welford


class WelfordState(NamedTuple):
    mean: torch.Tensor  # (C, dim)
    m2: torch.Tensor  # (C, dim) or (C, dim, dim)
    count: torch.Tensor  # (C,)


def welford_init(num_chains, dim, dense=False, dtype=torch.float32, device=None):
    m2_shape = (num_chains, dim, dim) if dense else (num_chains, dim)
    z = dict(dtype=dtype, device=device)
    return WelfordState(torch.zeros(num_chains, dim, **z), torch.zeros(m2_shape, **z), torch.zeros(num_chains, **z))


def welford_update(state: WelfordState, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    delta2 = x - mean
    if state.m2.ndim == 3:
        m2 = state.m2 + delta[:, :, None] * delta2[:, None, :]
    else:
        m2 = state.m2 + delta * delta2
    return WelfordState(mean, m2, count)


def welford_pool(wf: WelfordState):
    """Pool the chains' states into one (Chan et al.'s exact combine,
    between-chain dispersion included); returns a one-chain state."""
    c = wf.count
    tot = c.sum()
    mean = (wf.mean * c[:, None]).sum(0) / tot.clamp_min(1.0)
    dev = wf.mean - mean
    if wf.m2.ndim == 3:
        between = torch.einsum("c,ci,cj->ij", c, dev, dev)
    else:
        between = (c[:, None] * dev * dev).sum(0)
    return WelfordState(mean[None], (wf.m2.sum(0) + between)[None], tot[None])


def welford_covariance(state: WelfordState, regularize=True):
    """Sample (co)variance per chain with Stan's shrinkage toward the unit
    matrix."""
    n = state.count.clamp_min(2.0)
    shape = (-1,) + (1,) * (state.m2.ndim - 1)
    cov = state.m2 / (n - 1.0).reshape(shape)
    if regularize:
        scale = (n / (n + 5.0)).reshape(shape)
        shrink = (1e-3 * (5.0 / (n + 5.0))).reshape(shape)
        if cov.ndim == 3:
            cov = scale * cov + shrink * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        else:
            cov = scale * cov + shrink
    return cov


# ---------------------------------------------------------------- dual averaging


class DAState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    prox_center: torch.Tensor


def da_init(step_size):
    log_step = torch.log(step_size)
    zeros = torch.zeros_like(log_step)
    return DAState(log_step, zeros, zeros, zeros, math.log(10.0) + log_step)


def da_update(state: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1.0
    g = target - accept_prob
    grad_avg = (1.0 - 1.0 / (t + t0)) * state.grad_avg + g / (t + t0)
    log_step = state.prox_center - torch.sqrt(t) / gamma * grad_avg
    weight = t ** (-kappa)
    log_step_avg = weight * log_step + (1.0 - weight) * state.log_step_avg
    return DAState(log_step, log_step_avg, grad_avg, t, state.prox_center)


# ---------------------------------------------------------------- warmup schedule


def build_warmup_schedule(num_warmup, adapt_mass_matrix=True):
    """Stan-style warmup windows as numpy bool arrays of length
    ``num_warmup``: ``(window_end, in_slow_window)``.

    A 75-step fast initial buffer (step size only), doubling slow windows
    from 25 steps (mass matrix + step size), a 50-step fast terminal buffer;
    short warmups scale the buffers down proportionally.
    """
    init_buffer, base_window, term_buffer = 75, 25, 50
    if num_warmup < init_buffer + base_window + term_buffer:
        scale = num_warmup / (init_buffer + base_window + term_buffer)
        init_buffer = max(1, int(round(init_buffer * scale)))
        term_buffer = max(1, int(round(term_buffer * scale)))
        base_window = max(1, num_warmup - init_buffer - term_buffer)

    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if adapt_mass_matrix and num_warmup > 0:
        start = init_buffer
        size = base_window
        while start < num_warmup - term_buffer:
            end = start + size
            if end + 2 * size > num_warmup - term_buffer:
                end = num_warmup - term_buffer  # absorb the remainder
            end = min(end, num_warmup - term_buffer)
            in_slow[start:end] = True
            window_end[end - 1] = True
            start = end
            size *= 2
    return window_end, in_slow


# ---------------------------------------------------------------- init step size


def find_reasonable_step_size(potential_fn, mm: MassMatrix, z, generator, init_step_size=1.0, target=0.8, pe_grad=None):
    """Per chain, double or halve the step size until the one-leapfrog
    acceptance probability crosses ``target`` (the Stan / numpyro
    heuristic); stops one doubling past the crossing.  Chains that have
    stopped keep their step size while the others go on."""
    step = leapfrog(potential_fn)
    pe0, grad0 = value_and_grad(potential_fn, z) if pe_grad is None else pe_grad
    C = z.shape[0]
    step_size = torch.full((C,), float(init_step_size), dtype=z.dtype, device=z.device)
    direction = torch.zeros(C, dtype=torch.int64, device=z.device)
    last = torch.zeros_like(direction)
    log_target = math.log(target)
    while True:
        active = (step_size < 1e7) & (step_size > 1e-17) & ((last == 0) | (direction == last))
        if not bool(active.any()):
            break
        new_step = step_size * torch.pow(2.0, direction.to(z.dtype))
        r = sample_momentum(mm, generator, z)
        h0 = pe0 + kinetic_energy(mm, r)
        _, r1, pe1, _ = step(z, r, grad0, new_step, mm)
        alog = h0 - (pe1 + kinetic_energy(mm, r1))
        alog = torch.where(torch.isnan(alog), -torch.inf, alog)
        new_dir = torch.where(alog > log_target, 1, -1)
        step_size = torch.where(active, new_step, step_size)
        last = torch.where(active, direction, last)
        direction = torch.where(active, new_dir, direction)
    return step_size.clamp(1e-17, 1e7)
