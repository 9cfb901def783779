"""Parameter conversions: effective spins and the Beta moment maps.

Counterpart of ``gwinferno_tpu/preprocess/conversions.py``.  Every function
takes numpy arrays or torch tensors (on any device) alike.  The reference's
``math=`` namespace keyword takes ``np`` or ``torch``; left at None it is
``torch`` when an input is a tensor and ``np`` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "chieff_from_q_component_spins",
    "chip_from_q_component_spins",
    "mu_var_from_alpha_beta",
    "alpha_beta_from_mu_var",
]


def chieff_from_q_component_spins(q, a1, a2, ct1, ct2):
    r"""chi_eff = (a1 ct1 + q a2 ct2) / (1 + q)."""
    return (a1 * ct1 + q * a2 * ct2) / (1.0 + q)


def chip_from_q_component_spins(q, a1, a2, ct1, ct2, math=None):
    r"""chi_p = max(a1 sin t1, (3+4q)/(4+3q) q a2 sin t2)."""
    if math is None:
        math = torch if any(isinstance(x, torch.Tensor) for x in (q, a1, a2, ct1, ct2)) else np
    sint1 = math.sqrt(1.0 - ct1**2)
    sint2 = math.sqrt(1.0 - ct2**2)
    return math.maximum(a1 * sint1, ((3.0 + 4.0 * q) / (4.0 + 3.0 * q)) * q * a2 * sint2)


def mu_var_from_alpha_beta(alpha, beta, xmax=1):
    """Beta-distribution shape params -> (mean, variance) on [0, xmax]."""
    mu = alpha / (alpha + beta) * xmax
    var = alpha * beta / ((alpha + beta) ** 2 * (alpha + beta + 1)) * xmax**2
    return mu, var


def alpha_beta_from_mu_var(mu, var, xmax=1):
    """(mean, variance) on [0, xmax] -> Beta-distribution shape params."""
    mu = mu / xmax
    var = var / xmax**2
    alpha = (mu**2 * (1 - mu) - mu * var) / var
    beta = (mu * (1 - mu) ** 2 - (1 - mu) * var) / var
    return alpha, beta
