"""Fiducial PE-prior densities in effective-spin coordinates.

Counterpart of ``gwinferno_tpu/preprocess/priors.py``, host numpy and scipy
as there: the analytic conditional priors p(chi_eff | q) and p(chi_p | q)
for uniform-magnitude isotropic (or aligned) component spins (the
closed-form piecewise results of Callister, arXiv:2104.09508), and the
KDE-based conditional p(chi_p | chi_eff, q).  They run once a catalog, in
preprocessing, never in a gradient.  The isotropic chi_eff prior is written
in complex arithmetic (scipy's ``spence`` of a complex argument; torch has
no dilogarithm) and its real part is taken at the end.

The expressions are written with the substitutions ``xe = (1+q) chi_eff`` and
``xq = q a_max`` which make the published case formulas compact.
"""

from __future__ import annotations

import numpy as np
from scipy.special import spence
from scipy.stats import gaussian_kde

from .conversions import chip_from_q_component_spins

__all__ = [
    "Di",
    "chi_effective_prior_from_aligned_spins",
    "chi_effective_prior_from_isotropic_spins",
    "chi_p_prior_from_isotropic_spins",
    "chi_p_prior_given_chi_eff_q",
    "joint_prior_from_isotropic_spins",
]


def Di(z):
    """Dilogarithm PolyLog[2, z] in the Mathematica convention (scipy's
    ``spence`` evaluates at 1 - z)."""
    return spence(1.0 - z + 0j)


def chi_effective_prior_from_aligned_spins(chi_eff, q, a_max=1.0):
    """p(chi_eff | q) for uniform *aligned* component spins: a symmetric
    trapezoid in chi_eff (parity: priors.py:38-76)."""
    chi_eff = np.atleast_1d(chi_eff)
    corner = a_max * (1.0 - q) / (1.0 + q)
    wing_hi = (chi_eff > corner) & (chi_eff <= a_max)
    wing_lo = (chi_eff < -corner) & (chi_eff >= -a_max)
    plateau = (chi_eff >= -corner) & (chi_eff <= corner)
    return np.select(
        [wing_hi, wing_lo, plateau],
        [
            (1.0 + q) ** 2 * (a_max - chi_eff) / (4.0 * q * a_max**2),
            (1.0 + q) ** 2 * (a_max + chi_eff) / (4.0 * q * a_max**2),
            (1.0 + q) / (2.0 * a_max),
        ],
    )


def chi_effective_prior_from_isotropic_spins(chi_eff, q, a_max=1.0):
    """p(chi_eff | q) for uniform-magnitude *isotropic* component spins: the
    6-case piecewise closed form with dilogarithms (parity: priors.py:79-196,
    including the boundary-averaging fallback)."""
    chi = np.abs(np.atleast_1d(chi_eff))
    a = a_max
    xe = (1.0 + q) * chi  # scaled |chi_eff|
    xq = q * a  # secondary max contribution
    pref = (1.0 + q) / (4.0 * q * a**2)

    case_zero = chi == 0
    case_a = (chi > 0) & (chi < a * (1.0 - q) / (1.0 + q)) & (chi < xq / (1.0 + q))
    case_b = (chi < a * (1.0 - q) / (1.0 + q)) & (chi > xq / (1.0 + q))
    case_c = (chi > a * (1.0 - q) / (1.0 + q)) & (chi < xq / (1.0 + q))
    case_d = (chi > a * (1.0 - q) / (1.0 + q)) & (chi < a / (1.0 + q)) & (chi >= xq / (1.0 + q))
    case_e = (chi > a * (1.0 - q) / (1.0 + q)) & (chi > a / (1.0 + q)) & (chi < a)
    case_f = chi >= a

    with np.errstate(invalid="ignore", divide="ignore"):
        dilog_in = Di(-xq / xe) - Di(xq / xe)
        dilog_out = Di(1.0 - a / xe) - Di(xq / xe)

        p_zero = (1.0 + q) / (2.0 * a) * (2.0 - np.log(q))

        p_a = pref * (
            xq * (4.0 + 2.0 * np.log(a) - np.log(xq**2 - xe**2))
            - 2.0 * xe * np.arctanh(xe / xq)
            + xe * dilog_in
        )

        p_b = pref * (
            4.0 * xq
            + 2.0 * xq * np.log(a)
            - 2.0 * xe * np.arctanh(xq / xe)
            - xq * np.log(xe**2 - xq**2)
            + xe * dilog_in
        )

        p_c = pref * (
            2.0 * (1.0 + q) * (a - chi)
            - xe * np.log(a) ** 2
            + (a + xe * np.log(xe)) * np.log(xq / (a - xe))
            - xe * np.log(a) * (2.0 + np.log(q) - np.log(a - xe))
            + xq * np.log(a / (xq - xe))
            + xe * np.log((a - xe) * (xq - xe) / q)
            + xe * dilog_out
        )

        p_d = pref * (
            -chi * np.log(a) ** 2
            + 2.0 * (1.0 + q) * (a - chi)
            + xq * np.log(a / (xe - xq))
            + a * np.log(xq / (a - xe))
            - chi * np.log(a) * (2.0 * (1.0 + q) - np.log(xe) - q * np.log(xe / a))
            + xe * np.log((xe - xq) * (a - xe) / q)
            + xe * np.log(a / xe) * np.log((a - xe) / q)
            + xe * dilog_out
        )

        p_e = pref * (
            2.0 * (1.0 + q) * (a - chi)
            - xe * np.log(a) ** 2
            + np.log(a) * (a - 2.0 * xe - xe * np.log(q / (xe - a)))
            - a * np.log((xe - a) / q)
            + xe * np.log((xe - a) * (xe - xq) / q)
            + xe * np.log(xe) * np.log(xq / (xe - a))
            - xq * np.log((xe - xq) / a)
            + xe * dilog_out
        )

    # values exactly on a case boundary: average the two-sided limits
    cases = [case_zero, case_a, case_b, case_c, case_d, case_e, case_f]
    fallback = np.zeros_like(chi)
    on_boundary = ~np.any(cases, axis=0)
    if np.any(on_boundary):
        fallback[on_boundary] = 0.5 * (
            chi_effective_prior_from_isotropic_spins(chi[on_boundary] + 1e-6, q, a_max=a_max)
            + chi_effective_prior_from_isotropic_spins(chi[on_boundary] - 1e-6, q, a_max=a_max)
        )

    pdfs = np.select(cases, [p_zero, p_a, p_b, p_c, p_d, p_e, 0.0], default=fallback)
    return np.real(pdfs)


def chi_p_prior_from_isotropic_spins(chi_p, q, a_max=1.0):
    """p(chi_p | q) for uniform-magnitude isotropic component spins
    (parity: priors.py:199-244)."""
    chi_p = np.atleast_1d(chi_p)
    r = (3.0 + 4.0 * q) / (4.0 + 3.0 * q)  # secondary-spin weighting
    knee = q * a_max * r
    below = chi_p < knee
    above = (chi_p >= knee) & (chi_p < a_max)

    with np.errstate(invalid="ignore"):
        p_below = (1.0 / (a_max**2 * q * r)) * (
            np.arccos(chi_p / (knee))
            * (a_max - np.sqrt(a_max**2 - chi_p**2) + chi_p * np.arccos(chi_p / a_max))
            + np.arccos(chi_p / a_max)
            * (knee - np.sqrt(knee**2 - chi_p**2) + chi_p * np.arccos(chi_p / knee))
        )
    p_above = (1.0 / a_max) * np.arccos(chi_p / a_max)
    return np.select([below, above], [p_below, p_above])


def chi_p_prior_given_chi_eff_q(chi_p, chi_eff, q, a_max=1.0, ndraws=10000, bw_method="scott"):
    """p(chi_p | chi_eff, q) via rejection MC + weighted Gaussian KDE + grid
    interpolation (parity: priors.py:247-333)."""
    rng = np.random
    a1 = rng.random(ndraws) * a_max
    a2 = rng.random(ndraws) * a_max
    cost2 = 2.0 * rng.random(ndraws) - 1.0
    cost1 = (chi_eff * (1.0 + q) - q * a2 * cost2) / a1
    while np.any(cost1 < -1) or np.any(cost1 > 1):
        bad = np.where((cost1 < -1) | (cost1 > 1))[0]
        a1[bad] = rng.random(bad.size) * a_max
        a2[bad] = rng.random(bad.size) * a_max
        cost2[bad] = 2.0 * rng.random(bad.size) - 1.0
        cost1 = (chi_eff * (1.0 + q) - q * a2 * cost2) / a1

    chi_p_draws = chip_from_q_component_spins(q, a1, a2, cost1, cost2)
    jacobian_weights = (1.0 + q) / a1
    kde = gaussian_kde(chi_p_draws, weights=jacobian_weights, bw_method=bw_method)

    if (1.0 + q) * np.abs(chi_eff) / q < a_max:
        max_chi_p = a_max
    else:
        max_chi_p = np.sqrt(a_max**2 - ((1.0 + q) * np.abs(chi_eff) - q) ** 2)

    grid = np.linspace(0.05 * max_chi_p, 0.95 * max_chi_p, 50)
    vals = kde(grid)
    grid = np.concatenate([[0], grid, [max_chi_p]])
    vals = np.concatenate([[0], vals, [0]])
    norm = np.trapezoid(vals, grid)
    return np.interp(chi_p, grid, vals / norm)


def joint_prior_from_isotropic_spins(chi_p, chi_eff, q, a_max=1.0, **kwargs):
    """p(chi_eff, chi_p | q) = p(chi_p | chi_eff, q) p(chi_eff | q)
    (parity: priors.py:336-379)."""
    chi_p = np.atleast_1d(chi_p)
    chi_eff = np.atleast_1d(chi_eff)
    cond_vectorized = np.vectorize(chi_p_prior_given_chi_eff_q, excluded=["a_max", "ndraws", "bw_method"])
    p_chi_eff = chi_effective_prior_from_isotropic_spins(chi_eff, q, a_max=a_max)
    p_chi_p = cond_vectorized(chi_p, chi_eff, q, a_max=a_max, **kwargs)
    return p_chi_eff * p_chi_p
