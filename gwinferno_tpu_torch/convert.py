"""Carrying sampler inputs across from the JAX package.

The two engines draw different random streams, so "the same inputs" for a
parity check means the same constrained site values and the same adapted
step size and inverse mass matrix.  The JAX engine flattens its site dict in
sorted name order (``ravel_pytree``) and so does the port's
:class:`~gwinferno_tpu_torch.ppl.ModelPotential`, so flat vectors and mass
matrices carry over without a permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .infer.hmc_util import mass_matrix_from_inverse
from .ppl.infer_util import ModelPotential

__all__ = ["params_from_jax", "mcmc_state_from_jax"]


def params_from_jax(params_np, model, model_args=(), model_kwargs=None, device=None, dtype=torch.float32):
    """``{site: (C, *shape) constrained numpy}`` (one row per chain) -> the
    port's unconstrained ``(C, D)`` tensor for ``model``."""
    potential = ModelPotential(model, model_args, model_kwargs, device=device, dtype=dtype)
    num_chains = {np.shape(params_np[k])[0] for k in potential.names}
    if len(num_chains) != 1:
        raise ValueError(f"sites disagree on the number of chains: {sorted(num_chains)}")
    return potential.unconstrain(params_np, num_chains.pop())


def mcmc_state_from_jax(step_size, inverse_mass_matrix, device=None, dtype=torch.float32):
    """The JAX engine's per-chain step size ``(C,)`` and inverse mass matrix
    ``(C, D)`` or ``(C, D, D)`` (numpy) -> ``(MassMatrix, step_size)``."""
    dev = resolve_device(device)
    inv = torch.as_tensor(np.asarray(inverse_mass_matrix), dtype=dtype, device=dev)
    ss = torch.as_tensor(np.asarray(step_size), dtype=dtype, device=dev)
    return mass_matrix_from_inverse(inv), ss
