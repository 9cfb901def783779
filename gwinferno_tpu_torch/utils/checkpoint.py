"""Chain-state checkpoint and resume.

Counterpart of ``gwinferno_tpu/utils/checkpoint.py``, with the same npz
keys: ``state_<field>`` for the eight state fields (``z``, ``pe``, ``grad``,
``energy``, ``accept_prob``, ``num_steps``, ``diverging``, ``tree_depth``),
``inverse_mass_matrix``, ``mass_chol``, ``step_size`` and ``rng_key``.
``MCMC.run(seed, ..., post_warmup_state=load_checkpoint(path))`` skips
warmup and continues from the saved positions, mass matrix and step size.

``rng_key`` holds the port's ``torch.Generator`` state (a uint8 array), so a
run resumed from the port's own checkpoint continues its random stream.  A
checkpoint written by the JAX package holds a JAX PRNG key there instead; it
loads all the same, and the resumed run then draws from its own
``rng_seed``.
"""

from __future__ import annotations

import numpy as np

from ..device import host_array

__all__ = ["save_checkpoint", "load_checkpoint"]

_STATE_FIELDS = ["z", "pe", "grad", "energy", "accept_prob", "num_steps", "diverging", "tree_depth"]


def save_checkpoint(path, mcmc):
    """Write ``mcmc.post_warmup_state`` (set by a completed ``run``) to an npz."""
    st = mcmc.post_warmup_state
    arrays = {f"state_{name}": host_array(v) for name, v in zip(_STATE_FIELDS, st["state"])}
    for key in ("inverse_mass_matrix", "mass_chol", "step_size", "rng_key"):
        arrays[key] = host_array(st[key])
    np.savez(path, **arrays)


def load_checkpoint(path):
    """Read a checkpoint (the port's or the JAX package's) into the dict
    ``MCMC.run(post_warmup_state=...)`` takes, as numpy arrays."""
    with np.load(path) as f:
        state = tuple(f[f"state_{name}"] for name in _STATE_FIELDS)
        return {
            "state": state,
            "inverse_mass_matrix": f["inverse_mass_matrix"],
            "mass_chol": f["mass_chol"],
            "step_size": f["step_size"],
            "rng_key": f["rng_key"],
        }
