"""Parametric population models on the powerlaw+peak main path.

Counterpart of ``gwinferno_tpu/models/parametric/parametric.py`` (the
log-space forms).  Hyperparameters broadcast against the sample banks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...cosmology import PLANCK_2015_LVK_Cosmology as Planck15
from ...device import resolve_device
from ...distributions import log_betadist
from ...distributions import log_powerlaw_pdf
from ...distributions import log_truncnorm_pdf
from ...distributions import safe_logaddexp

__all__ = [
    "log_plpeak_primary_ratio_pdf",
    "log_independent_spin_magnitude_beta_dist",
    "log_mixture_isoalign_spin_tilt",
    "log_independent_spin_tilt",
    "PowerlawRedshiftModel",
]


def log_plpeak_primary_ratio_pdf(m1, q, alpha, beta, mmin, mmax, mpp, sigpp, lam):
    """Log of the powerlaw+peak joint ``(m1, q)`` pdf: a powerlaw in ``q`` on
    ``[mmin/m1, 1]`` times a mixture of a powerlaw and a truncated Gaussian
    peak in ``m1`` on ``[mmin, mmax]``, composed with ``logaddexp``."""
    log_p_q = log_powerlaw_pdf(q, beta, mmin / m1, 1.0)
    log_pl = log_powerlaw_pdf(m1, alpha, mmin, mmax)
    log_peak = log_truncnorm_pdf(m1, mpp, sigpp, mmin, mmax)
    log_p_m1 = safe_logaddexp(torch.log1p(-lam) + log_pl, torch.log(lam) + log_peak)
    return log_p_q + log_p_m1


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
