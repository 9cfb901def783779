"""P-spline smoothing priors: difference penalties on spline coefficients.

Counterpart of ``gwinferno_tpu/models/bsplines/smoothing.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_difference_prior", "prior_precision_cholesky"]


def apply_difference_prior(coefs, inv_var, degree=1):
    """Gaussian random-walk penalty ``-0.5 * inv_var * ||Delta^degree c||^2``
    over the last axis of ``coefs`` ``(C, n)``: ``(C,)``."""
    delta = torch.diff(coefs, n=degree, dim=-1)
    return -0.5 * inv_var * (delta * delta).sum(-1)


def prior_precision_cholesky(n, sig, tau, degree=1, drop_first=False):
    """Lower Cholesky factor ``L`` (host float64) of the coefficient prior's
    precision ``I / sig^2 + tau D^T D``, ``D`` the order-``degree``
    difference operator on ``n`` coefficients; ``drop_first`` gives the
    precision of the free coefficients when the first is pinned to zero.
    The whitened parameterization samples ``u ~ N(0, I)`` and sets
    ``c = L^{-T} u``, which has exactly this prior."""
    D = np.eye(n)
    for _ in range(degree):
        D = D[1:] - D[:-1]
    P = D.T @ D
    if drop_first:
        P = P[1:, 1:]
    lam = np.eye(P.shape[0]) / float(sig) ** 2 + float(tau) * P
    return np.linalg.cholesky(lam)
