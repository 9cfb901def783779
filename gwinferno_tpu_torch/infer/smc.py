"""Sequential Monte Carlo with adaptive tempering.

Counterpart of ``gwinferno_tpu/infer/smc.py``: anneals from a broad base
distribution ``q0 = N(0, base_scale)`` in unconstrained space to the
posterior, ``pi_beta ∝ q0^(1-beta) pi^beta``, choosing each temperature by
bisection on the effective sample size, with systematic resampling and
random-walk Metropolis mutation preconditioned on the particle covariance.

The particle axis is the chain axis of the model's potential: the particles
are evaluated in one chain-batched call without gradient.  The JAX
``while_loop`` and ``scan`` become Python loops; the bisection reads one
ESS comparison per step on the host.

Over a mesh (``mesh=``, ``parallel/``) each rank holds its block of the
particles, drawn from rows of the same draws the unsharded run makes
(:class:`~gwinferno_tpu_torch.infer.hmc_util.ChainRows`).  The ESS and the
evidence take a sharded logsumexp of the incremental weights, the particle
covariance is an all-reduce of moment sums, and systematic resampling
gathers every weight, computes the same indices on every rank, gathers the
particles and keeps its own block; the banks shard over the data axis as
under ``MCMC``.  At the end every rank gathers all particles in rank order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..parallel.mesh import Mesh
from ..parallel.mesh import use_mesh
from ..parallel.sharding import gather_chains
from ..parallel.sharding import group_size
from ..parallel.sharding import sharded_logsumexp
from ..parallel.sharding import sum_over
from ..ppl.infer_util import ModelPotential
from .hmc_util import ChainRows
from .hmc_util import chain_draw

__all__ = ["SMC", "SMCResult"]

_BISECT_TOL = 1e-5
_COV_JITTER = 1e-8


class SMCResult(NamedTuple):
    particles: dict  # constrained site values, leading axis = particles
    log_weights: torch.Tensor
    log_evidence: torch.Tensor
    num_stages: int
    final_acceptance: torch.Tensor


def _systematic_resample(u, log_weights):
    """Systematic resampling with the uniform ``u``: one stratified comb
    ``(u + i) / n`` over the weights' CDF; indices clipped to ``n - 1``."""
    n = log_weights.shape[0]
    cdf = torch.cumsum(torch.softmax(log_weights, 0), 0)
    comb = (u + torch.arange(n, dtype=log_weights.dtype, device=log_weights.device)) / n
    return torch.searchsorted(cdf, comb, right=True).clamp(0, n - 1)


def _lse(x, group=None):
    """logsumexp over the particle axis, sharded over ``group`` (None:
    whole)."""
    return torch.logsumexp(x, 0) if group is None else sharded_logsumexp(x, group, axis=0)


def _ess(log_weights, group=None):
    """Effective sample size ``1 / sum(w^2)`` of normalized weights."""
    lw = log_weights - _lse(log_weights, group)
    return torch.exp(-_lse(2.0 * lw, group))


def _incremental_logw(beta_new, beta_old, pe_post, pe_base):
    """``log [pi_new / pi_old]`` at the particles: a particle of infinite
    potential gets ``-inf`` once beta rises."""
    return (beta_old - beta_new) * pe_post + (beta_new - beta_old) * pe_base


def _temper_pe(beta, pe_post, pe_base):
    return beta * pe_post + (1.0 - beta) * pe_base


def _choose_beta(beta_old, pe_post, pe_base, target_ess, group=None):
    """The largest ``beta_new <= 1`` with ESS at least ``target_ess``: 1 if
    the full step keeps it, else bisection on ``(beta_old, 1]`` to within
    1e-5, returning the bracket's lower end (whose ESS meets the target)."""
    def ok(b):
        return bool(_ess(_incremental_logw(b, beta_old, pe_post, pe_base), group) >= target_ess)

    if ok(1.0):
        return 1.0
    lo, hi = beta_old, 1.0
    while hi - lo > _BISECT_TOL:
        mid = 0.5 * (lo + hi)
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _particle_cov(z):
    """Particle covariance as moment sums over the particle axis."""
    centered = z - z.mean(0)
    return centered.T @ centered / (z.shape[0] - 1.0)


def _sharded_particle_cov(z, group):
    """:func:`_particle_cov` of particles sharded over ``group``: each
    moment sum an all-reduce."""
    n = z.shape[0] * group_size(group)
    centered = z - sum_over(z.sum(0), group) / n
    return sum_over(centered.T @ centered, group) / (n - 1.0)


def _cholesky_or_nan(a):
    """Cholesky factor of ``a``; where ``a`` is not positive definite, a
    lower triangle of NaN (what ``jnp.linalg.cholesky`` returns, where
    ``torch.linalg.cholesky`` raises): proposals made with it are NaN and
    rejected."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.full_like(chol, torch.nan).tril())


def _mutate(z, pe_post, pe_base, beta, scale, num_steps, neg_log_post, neg_log_base, generator, group=None):
    """``num_steps`` sweeps of random-walk Metropolis at ``pi_beta``, the
    steps drawn through the Cholesky factor of the particle covariance
    (``1e-8 I`` added).  Returns the particles, their two potentials and
    the mean acceptance over the sweeps (over every rank's particles when
    they are sharded over ``group``)."""
    n, dim = z.shape
    eye = torch.eye(dim, dtype=z.dtype, device=z.device)
    cov = _particle_cov(z) if group is None else _sharded_particle_cov(z, group)
    cov_chol = _cholesky_or_nan(cov + _COV_JITTER * eye)
    n_acc = torch.zeros((), dtype=z.dtype, device=z.device)
    for _ in range(num_steps):
        eps = chain_draw(torch.randn, (n, dim), generator, z.dtype, z.device)
        prop = z + scale * (eps @ cov_chol.T)
        prop_post, prop_base = neg_log_post(prop), neg_log_base(prop)
        log_alpha = _temper_pe(beta, pe_post, pe_base) - _temper_pe(beta, prop_post, prop_base)
        log_u = torch.log(chain_draw(torch.rand, (n,), generator, z.dtype, z.device))
        accept = log_u < log_alpha  # False where log_alpha is NaN
        z = torch.where(accept[:, None], prop, z)
        pe_post = torch.where(accept, prop_post, pe_post)
        pe_base = torch.where(accept, prop_base, pe_base)
        if group is None:
            n_acc = n_acc + accept.to(z.dtype).mean()
        else:
            n_acc = n_acc + sum_over(accept.to(z.dtype).sum(), group) / (n * group_size(group))
    return z, pe_post, pe_base, n_acc / num_steps


class SMC:
    """Adaptive-tempering SMC over a model's unconstrained posterior.

    Args:
        model: PPL model callable.
        num_particles: particle count.
        num_mutation_steps: RWM mutation sweeps per temperature stage.
        target_ess_frac: relative ESS target selecting each delta-beta.
        base_scale: standard deviation of the ``N(0, scale)`` base ``q0``.
        max_stages: bound on temperature stages.
        rwm_scale: the RWM step's scale on the particles' Cholesky factor
            (``2.38 / sqrt(dim)`` when None).
        mesh, particle_axis: a :class:`~gwinferno_tpu_torch.parallel.Mesh`
            and its axis the particles shard over (see the module
            docstring); every rank of the mesh runs ``run`` with the same
            arguments.
        device, dtype: where the particles live (CUDA unless asked
            otherwise) and their dtype.

    After a run, ``betas`` holds the temperature each stage reached.
    """

    def __init__(self, model, num_particles=1024, num_mutation_steps=5, target_ess_frac=0.5, base_scale=2.0,
                 max_stages=100, rwm_scale=None, mesh=None, particle_axis="chain", *, device=None,
                 dtype=torch.float32):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.create_mesh), got {type(mesh).__name__}")
        self.model = model
        self.num_particles = int(num_particles)
        self.num_mutation_steps = int(num_mutation_steps)
        self.target_ess_frac = float(target_ess_frac)
        self.base_scale = float(base_scale)
        self.max_stages = int(max_stages)
        self.rwm_scale = rwm_scale
        self.mesh = mesh
        self.particle_axis = particle_axis
        self.device = resolve_device(device)
        self.dtype = dtype
        self.betas = []

    def run(self, rng_seed, *model_args, **model_kwargs):
        with use_mesh(self.mesh):
            return self._run(rng_seed, model_args, model_kwargs)

    def _run(self, rng_seed, model_args, model_kwargs):
        dev, dtype, n = self.device, self.dtype, self.num_particles
        rep_gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
        mesh = self.mesh
        group = None if mesh is None else mesh.group(self.particle_axis)
        rows, gen = slice(None), rep_gen  # gen: the particles' draws; rep_gen: the replicated ones
        if group is not None:
            rows = mesh.rows(self.particle_axis, n)
            gen = ChainRows(rep_gen, rows, n)
        pot = ModelPotential(self.model, model_args, model_kwargs, device=dev, dtype=dtype)
        dim, s0 = pot.dim, self.base_scale

        def neg_log_post(z):
            pe = pot(z)
            return torch.where(torch.isnan(pe), torch.inf, pe)

        def neg_log_base(z):
            return 0.5 * ((z / s0) ** 2).sum(-1) + dim * math.log(s0)

        scale = self.rwm_scale if self.rwm_scale is not None else 2.38 / math.sqrt(dim)
        target_ess = self.target_ess_frac * n

        with torch.no_grad():
            z = s0 * chain_draw(torch.randn, (n, dim), gen, dtype, dev)
            pe_post, pe_base = neg_log_post(z), neg_log_base(z)
            beta, stages = 0.0, 0
            self.betas = []
            log_evid = torch.zeros((), dtype=dtype, device=dev)
            acc = torch.zeros((), dtype=dtype, device=dev)
            while beta < 1.0 and stages < self.max_stages:
                beta_new = _choose_beta(beta, pe_post, pe_base, target_ess, group)
                logw = _incremental_logw(beta_new, beta, pe_post, pe_base)
                log_evid = log_evid + _lse(logw, group) - math.log(n)
                u = torch.rand((), generator=rep_gen, dtype=dtype, device=dev)
                if group is None:
                    idx = _systematic_resample(u, logw)
                    z, pe_post, pe_base = z[idx], pe_post[idx], pe_base[idx]
                else:
                    # every rank: the same indices from all the weights, then
                    # its own block of the resampled particles
                    idx = _systematic_resample(u, gather_chains(mesh, logw, self.particle_axis))[rows]
                    z, pe_post, pe_base = (x[idx] for x in gather_chains(mesh, (z, pe_post, pe_base),
                                                                          self.particle_axis))
                z, pe_post, pe_base, acc = _mutate(z, pe_post, pe_base, beta_new, scale, self.num_mutation_steps,
                                                   neg_log_post, neg_log_base, gen, group)
                beta, stages = beta_new, stages + 1
                self.betas.append(beta)
            if group is not None:
                z = gather_chains(mesh, z, self.particle_axis)
            particles = pot.constrain(z)
        return SMCResult(
            particles=particles,
            log_weights=torch.zeros(n, dtype=dtype, device=dev),
            log_evidence=log_evid,
            num_stages=stages,
            final_acceptance=acc,
        )
