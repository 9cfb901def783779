"""Parametric population models: masses, spins, redshift.

Counterpart of ``gwinferno_tpu/models/parametric/parametric.py``, the
log-space forms and the linear ones.  Hyperparameters broadcast against the
sample banks: a chain axis is the caller's leading axis, e.g. ``(C, 1)``
against a bank ``(N,)`` or ``(C, 1, 1)`` against ``(E, S)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...cosmology import PLANCK_2015_LVK_Cosmology as Planck15
from ...device import resolve_device
from ...distributions import betadist
from ...distributions import log_betadist
from ...distributions import log_powerlaw_pdf
from ...distributions import log_truncnorm_pdf
from ...distributions import powerlaw_logit_pdf
from ...distributions import powerlaw_pdf
from ...distributions import safe_logaddexp
from ...distributions import smooth
from ...distributions import truncnorm_pdf

__all__ = [
    "powerlaw_primary_ratio_pdf",
    "powerlaw_primary_ratio_falloff_pdf",
    "plpeak_primary_pdf",
    "plpeak_primary_ratio_pdf",
    "log_plpeak_primary_ratio_pdf",
    "beta_spin_magnitude",
    "iid_spin_magnitude",
    "independent_spin_magnitude_beta_dist",
    "log_independent_spin_magnitude_beta_dist",
    "mixture_isoalign_spin_tilt",
    "log_mixture_isoalign_spin_tilt",
    "iid_spin_tilt",
    "independent_spin_tilt",
    "log_independent_spin_tilt",
    "default_spin_tilt",
    "PowerlawRedshiftModel",
]

# ---------------------------------------------------------------- mass models


def powerlaw_primary_ratio_pdf(m1, q, alpha, beta, mmin, mmax):
    """p(m1, q) = PL(m1; alpha, [mmin, mmax]) PL(q; beta, [mmin/m1, 1])."""
    p_q = powerlaw_pdf(q, beta, mmin / m1, 1.0)
    p_m1 = powerlaw_pdf(m1, alpha, mmin, mmax)
    return p_q * p_m1


def powerlaw_primary_ratio_falloff_pdf(m1, q, alpha, beta, mmin, mmax, fall_off):
    """Powerlaw primary with soft (logistic) truncations, powerlaw ratio."""
    p_q = powerlaw_pdf(q, beta, mmin / m1, 1.0)
    p_m1 = powerlaw_logit_pdf(m1, alpha, mmin, mmax, fall_off)
    return p_q * p_m1


def plpeak_primary_pdf(m1, alpha, mmin, mmax, mpp, sigpp, lam, delta=None):
    """Powerlaw + truncated Gaussian peak primary-mass pdf on [mmin, mmax],
    with the low-mass smoothing window of width ``delta`` on the powerlaw."""
    pl = powerlaw_pdf(m1, alpha, mmin, mmax)
    peak = truncnorm_pdf(m1, mpp, sigpp, mmin, mmax)
    if delta is None:
        return (1.0 - lam) * pl + lam * peak
    return (1.0 - lam) * pl * smooth(delta, m1, mmin) + lam * peak


def plpeak_primary_ratio_pdf(m1, q, alpha, beta, mmin, mmax, mpp, sigpp, lam, delta=None):
    """Joint (m1, q) powerlaw+peak pdf; with ``delta`` the smoothing window
    also applies to m2 = q m1."""
    p_q = powerlaw_pdf(q, beta, mmin / m1, 1.0)
    p_m1 = plpeak_primary_pdf(m1, alpha, mmin, mmax, mpp, sigpp, lam, delta=delta)
    if delta is None:
        return p_q * p_m1
    return p_q * smooth(delta, q * m1, mmin) * p_m1


def log_plpeak_primary_ratio_pdf(m1, q, alpha, beta, mmin, mmax, mpp, sigpp, lam):
    """Log of the powerlaw+peak joint ``(m1, q)`` pdf: a powerlaw in ``q`` on
    ``[mmin/m1, 1]`` times a mixture of a powerlaw and a truncated Gaussian
    peak in ``m1`` on ``[mmin, mmax]``, composed with ``logaddexp``."""
    log_p_q = log_powerlaw_pdf(q, beta, mmin / m1, 1.0)
    log_pl = log_powerlaw_pdf(m1, alpha, mmin, mmax)
    log_peak = log_truncnorm_pdf(m1, mpp, sigpp, mmin, mmax)
    log_p_m1 = safe_logaddexp(torch.log1p(-lam) + log_pl, torch.log(lam) + log_peak)
    return log_p_q + log_p_m1


# ---------------------------------------------------------------- spin models


def beta_spin_magnitude(a, alpha, beta, amax=1):
    return betadist(a, alpha, beta, scale=amax)


def iid_spin_magnitude(a1, a2, alpha_mag, beta_mag, amax=1):
    return betadist(a1, alpha_mag, beta_mag, scale=amax) * betadist(a2, alpha_mag, beta_mag, scale=amax)


def independent_spin_magnitude_beta_dist(a1, a2, alpha_mag1, beta_mag1, alpha_mag2, beta_mag2, amax1=1, amax2=1):
    return betadist(a1, alpha_mag1, beta_mag1, scale=amax1) * betadist(a2, alpha_mag2, beta_mag2, scale=amax2)


def mixture_isoalign_spin_tilt(ct, xi_tilt, sigma_tilt):
    """Isotropic (uniform on [-1, 1]) + aligned (Gaussian at 1, truncated to
    [-1, 1]) tilt mixture."""
    in_support = torch.where((ct > 1) | (ct < -1), 0.0, 1.0)
    return in_support * (1.0 - xi_tilt) / 2.0 + xi_tilt * truncnorm_pdf(ct, 1.0, sigma_tilt, -1.0, 1.0)


def iid_spin_tilt(ct1, ct2, xi_tilt, sigma_tilt):
    return mixture_isoalign_spin_tilt(ct1, xi_tilt, sigma_tilt) * mixture_isoalign_spin_tilt(ct2, xi_tilt, sigma_tilt)


def independent_spin_tilt(ct1, ct2, xi_tilt_1, xi_tilt_2, sigma_tilt1, sigma_tilt2):
    return mixture_isoalign_spin_tilt(ct1, xi_tilt_1, sigma_tilt1) * mixture_isoalign_spin_tilt(
        ct2, xi_tilt_2, sigma_tilt2
    )


def default_spin_tilt(ct1, ct2, xi_tilt, sigma_tilt):
    """The LVK default tilt model: the mixture applied to the pair jointly."""
    iso1 = torch.where((ct1 > 1) | (ct1 < -1), 0.0, 0.5)
    iso2 = torch.where((ct2 > 1) | (ct2 < -1), 0.0, 0.5)
    ali1 = truncnorm_pdf(ct1, 1.0, sigma_tilt, -1.0, 1.0)
    ali2 = truncnorm_pdf(ct2, 1.0, sigma_tilt, -1.0, 1.0)
    return (1.0 - xi_tilt) * iso1 * iso2 + xi_tilt * ali1 * ali2


def log_independent_spin_magnitude_beta_dist(a1, a2, alpha_mag1, beta_mag1, alpha_mag2, beta_mag2, amax1=1, amax2=1):
    return log_betadist(a1, alpha_mag1, beta_mag1, scale=amax1) + log_betadist(a2, alpha_mag2, beta_mag2, scale=amax2)


def log_mixture_isoalign_spin_tilt(ct, xi_tilt, sigma_tilt):
    """Log of the isotropic (uniform on [-1, 1]) + aligned (Gaussian at 1,
    truncated to [-1, 1]) tilt mixture."""
    oob = (ct > 1) | (ct < -1)
    log_iso = torch.where(oob, -math.inf, torch.log1p(-xi_tilt) - math.log(2.0))
    log_ali = torch.log(xi_tilt) + log_truncnorm_pdf(ct, 1.0, sigma_tilt, -1.0, 1.0)
    return safe_logaddexp(log_iso, log_ali)


def log_independent_spin_tilt(ct1, ct2, xi_tilt_1, xi_tilt_2, sigma_tilt1, sigma_tilt2):
    return log_mixture_isoalign_spin_tilt(ct1, xi_tilt_1, sigma_tilt1) + log_mixture_isoalign_spin_tilt(
        ct2, xi_tilt_2, sigma_tilt2
    )


# ---------------------------------------------------------------- redshift model


class PowerlawRedshiftModel(torch.nn.Module):
    """p(z) proportional to dVc/dz (1+z)^(lambda-1) on [zmin, zmax].

    dVc/dz at the injection and PE banks is cached on the host at
    construction (``dVdzs = [injections, PE]``, as in the reference: a 1-D
    input is the injection bank, a 2-D input the PE bank).  The 1000-point
    normalization grid lives on ``device``; ``normalization`` is its
    trapezoid integral, which doubles as the surveyed hypervolume.
    """

    def __init__(self, z_pe, z_inj, cosmology=Planck15, grid_points=1000, device=None, dtype=torch.float32):
        super().__init__()
        z_pe, z_inj = np.asarray(z_pe, dtype=np.float64), np.asarray(z_inj, dtype=np.float64)
        dev = resolve_device(device)
        self.zmin = max(float(z_pe.min()), float(z_inj.min()))
        self.zmax = min(float(z_pe.max()), float(z_inj.max()))
        zs = np.linspace(self.zmin, self.zmax, grid_points)
        self.dVdzs = [cosmology.dVcdz(z_inj), cosmology.dVcdz(z_pe)]
        self.register_buffer("zs", torch.as_tensor(zs, dtype=dtype, device=dev))
        self.register_buffer("dVdz_", torch.as_tensor(cosmology.dVcdz(zs), dtype=dtype, device=dev))

    def prob(self, z, dVdz, lamb):
        """dVc/dz (1+z)^(lamb-1), unnormalized; ``lamb`` broadcasts against
        ``z``."""
        return dVdz * torch.pow(1.0 + z, lamb - 1.0)

    def normalization(self, lamb):
        """Trapezoid integral of dVc/dz (1+z)^(lamb-1) over the grid; the
        result has ``lamb``'s shape."""
        prob = self.dVdz_ * torch.pow(1.0 + self.zs, lamb[..., None] - 1.0)
        return torch.trapezoid(prob, self.zs, dim=-1)

    def log_prob(self, z, lamb):
        """log p(z | lamb) at a sample bank ``z`` (1-D: injections, 2-D: PE);
        ``lamb`` broadcasts against ``z``."""
        dVdz = torch.as_tensor(self.dVdzs[z.ndim - 1], dtype=z.dtype, device=z.device)
        return torch.where(
            z <= self.zmax,
            torch.log(dVdz) + (lamb - 1.0) * torch.log1p(z) - torch.log(self.normalization(lamb)),
            torch.finfo(z.dtype).min,
        )

    def __call__(self, z, lamb):
        """p(z | lamb) at a sample bank ``z`` (1-D: injections, 2-D: PE), 0
        above ``zmax``; ``lamb`` broadcasts against ``z``."""
        dVdz = torch.as_tensor(self.dVdzs[z.ndim - 1], dtype=z.dtype, device=z.device)
        return torch.where(z <= self.zmax, self.prob(z, dVdz, lamb) / self.normalization(lamb), 0.0)
