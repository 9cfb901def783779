"""Plain HMC: a fixed trajectory length, Metropolis-corrected, batched over
chains.

Counterpart of ``gwinferno_tpu/infer/hmc.py``.  Each chain takes
``clip(ceil(trajectory_length / step_size), 1, max_num_steps)`` leapfrogs
with its own step size, so chains take different numbers of steps.  As the
JAX ``vmap`` of a ``while_loop`` does, all chains are stepped together for
the largest count and a chain is frozen (its step masked out) once it has
taken its own: one host read per transition (that count), none per leapfrog.

The transition is split into its draws (momentum, accept uniform;
:func:`hmc_draws`) and a deterministic body (:func:`hmc_body`) that takes
them, so a test can hand the JAX engine's draws to the body.  The state is
the :class:`~gwinferno_tpu_torch.infer.nuts.NUTSState` the MCMC engine uses
for both kernels.
"""

from __future__ import annotations

import math

import torch

from .hmc_util import MassMatrix
from .hmc_util import chain_draw
from .hmc_util import kinetic_energy
from .hmc_util import leapfrog
from .hmc_util import sample_momentum
from .nuts import NUTSState
from .nuts import nuts_init

__all__ = ["HMC", "hmc_draws", "hmc_body", "hmc_transition", "num_leapfrog_steps"]


def num_leapfrog_steps(trajectory_length, step_size, max_num_steps=1023):
    """Leapfrogs per chain, ``(C,)`` int64: ``ceil(L / eps)`` clipped to
    ``[1, max_num_steps]`` (clipped before the cast, so a tiny step size
    cannot overflow the integer)."""
    n = torch.ceil(trajectory_length / step_size)
    return torch.clamp(torch.nan_to_num(n, nan=1.0), 1, max_num_steps).to(torch.int64)


def hmc_draws(state: NUTSState, mm: MassMatrix, generator):
    """A transition's randomness: momenta ``(C, dim)`` and one accept
    uniform per chain ``(C,)``, in that order from ``generator``."""
    z = state.z
    r0 = sample_momentum(mm, generator, z)
    u = chain_draw(torch.rand, (z.shape[0],), generator, z.dtype, z.device)
    return r0, u


def hmc_body(potential_fn, state: NUTSState, mm: MassMatrix, step_size, r0, u,
             trajectory_length=2.0 * math.pi, max_num_steps=1023, on_read=None):
    """One HMC transition from the draws ``r0`` and ``u``: every chain
    leapfrogs for its own number of steps, then accepts with probability
    ``min(1, exp(-delta))`` (a NaN ``delta`` counts as ``+inf``);
    ``diverging`` is ``delta > 1000``.  The largest step count is read to the
    host once (``on_read()`` is called for it)."""
    step = leapfrog(potential_fn)
    step_size = torch.as_tensor(step_size, dtype=state.z.dtype, device=state.z.device).expand(state.z.shape[0])
    h0 = state.pe + kinetic_energy(mm, r0)
    num_steps = num_leapfrog_steps(trajectory_length, step_size, max_num_steps)
    z, r, pe, grad = state.z, r0, state.pe, state.grad
    rounds = int(num_steps.max())
    if on_read is not None:
        on_read()
    for i in range(rounds):
        z1, r1, pe1, grad1 = step(z, r, grad, step_size, mm)
        live = i < num_steps
        col = live[:, None]
        z, r, grad = torch.where(col, z1, z), torch.where(col, r1, r), torch.where(col, grad1, grad)
        pe = torch.where(live, pe1, pe)

    delta = pe + kinetic_energy(mm, r) - h0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    accept_prob = torch.clamp_max(torch.exp(-delta), 1.0)
    accept = u < accept_prob
    col = accept[:, None]
    return NUTSState(
        z=torch.where(col, z, state.z),
        pe=torch.where(accept, pe, state.pe),
        grad=torch.where(col, grad, state.grad),
        energy=h0,
        accept_prob=accept_prob,
        num_steps=num_steps,
        diverging=delta > 1000.0,
        tree_depth=torch.zeros_like(num_steps),
    )


def hmc_transition(potential_fn, state: NUTSState, mm: MassMatrix, step_size, generator,
                   trajectory_length=2.0 * math.pi, max_num_steps=1023, on_read=None):
    """One HMC transition for every chain (:func:`hmc_draws`, then
    :func:`hmc_body`)."""
    r0, u = hmc_draws(state, mm, generator)
    return hmc_body(potential_fn, state, mm, step_size, r0, u, trajectory_length, max_num_steps, on_read)


class HMC:
    """HMC kernel configuration, consumed by :class:`~gwinferno_tpu_torch.infer.MCMC`
    (``numpyro.infer.HMC``'s surface).  ``init_strategy`` is accepted and
    unused, as in the JAX package."""

    def __init__(
        self,
        model,
        step_size=1.0,
        trajectory_length=2.0 * math.pi,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        init_strategy=None,
    ):
        self.model = model
        self.step_size = step_size
        self.trajectory_length = trajectory_length
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.dense_mass = dense_mass
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy

    def make_transition(self, potential_fn, on_read=None):
        def transition(state, mm, step_size, generator):
            return hmc_transition(potential_fn, state, mm, step_size, generator,
                                  trajectory_length=self.trajectory_length, on_read=on_read)

        return transition

    def make_init(self, potential_fn):
        return lambda z: nuts_init(potential_fn, z)
