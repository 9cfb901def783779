"""Flat-LambdaCDM cosmology on fixed redshift grids (host numpy, float64).

Counterpart of ``gwinferno_tpu/cosmology.py``.  The comoving-distance and
comoving-volume tables are built once on the host with vectorized cumulative
trapezoid sums; queries are ``np.interp`` lookups.  The port only needs these
tables at construction time (dVc/dz at the sample banks and on the redshift
model's normalization grid), so this module is numpy only.

Constants: the Planck-2015-LVK cosmology, the one the population models use.
"""

from __future__ import annotations

import numpy as np

C_SI = 299792458.0  # m/s

PLANCK_2015_LVK_Ho = 67.90 / 1e-3  # (km/s/Mpc) / (km/m) = m/s/Mpc
PLANCK_2015_LVK_OmegaMatter = 0.3065
PLANCK_2015_LVK_OmegaLambda = 1.0 - PLANCK_2015_LVK_OmegaMatter
PLANCK_2015_LVK_OmegaRadiation = 0.0

DEFAULT_DZ = 1e-3


def _cumtrapz0(y, dx):
    """Cumulative trapezoid with a leading zero (numpy f64)."""
    out = np.empty_like(y)
    out[0] = 0.0
    np.cumsum(0.5 * (y[1:] + y[:-1]) * dx, out=out[1:])
    return out


class Cosmology:
    """Flat-LambdaCDM distance measures from tabulated comoving integrals.
    Distances are in Mpc."""

    def __init__(self, Ho, omega_matter, omega_radiation, omega_lambda, max_z=10.0, dz=DEFAULT_DZ):
        self.Ho = Ho
        self.c_over_Ho = C_SI / Ho
        self.OmegaMatter = omega_matter
        self.OmegaRadiation = omega_radiation
        self.OmegaLambda = omega_lambda
        self.OmegaKappa = 1.0 - (omega_matter + omega_radiation + omega_lambda)
        if abs(self.OmegaKappa) > 1e-12:
            raise ValueError("only flat cosmologies are implemented: OmegaKappa must be 0")
        z = np.arange(0.0, max_z, dz, dtype=np.float64)
        dDcdz = self.c_over_Ho / self.z2E(z)
        Dc = _cumtrapz0(dDcdz, dz)
        dVcdz = 4.0 * np.pi * Dc**2 * dDcdz
        self.z = z
        self.Dc = Dc
        self.Vc = _cumtrapz0(dVcdz, dz)

    @property
    def DL(self):
        return self.Dc * (1.0 + self.z)

    def z2E(self, z):
        """E(z) = sqrt(OmL + OmK (1+z)^2 + OmM (1+z)^3 + OmR (1+z)^4)."""
        opz = 1.0 + np.asarray(z)
        return np.sqrt(
            self.OmegaLambda
            + self.OmegaKappa * opz**2
            + self.OmegaMatter * opz**3
            + self.OmegaRadiation * opz**4
        )

    def dDcdz(self, z):
        """(c/Ho)/E(z)."""
        return self.c_over_Ho / self.z2E(z)

    def z2Dc(self, z):
        """Comoving distance by table interpolation."""
        return np.interp(z, self.z, self.Dc)

    def dVcdz(self, z, Dc=None):
        """Differential comoving volume dVc/dz = 4 pi Dc(z)^2 dDc/dz."""
        if Dc is None:
            Dc = self.z2Dc(z)
        return 4.0 * np.pi * Dc**2 * self.dDcdz(z)

    def logdVcdz(self, z, Dc=None):
        """log dVc/dz, overflow-free."""
        if Dc is None:
            Dc = self.z2Dc(z)
        return np.log(4.0 * np.pi) + 2.0 * np.log(Dc) + np.log(self.dDcdz(z))

    def z2DL(self, z):
        """Luminosity distance DL(z) = (1+z) Dc(z)."""
        return np.interp(z, self.z, self.DL)


PLANCK_2015_LVK_Cosmology = Cosmology(
    PLANCK_2015_LVK_Ho,
    PLANCK_2015_LVK_OmegaMatter,
    PLANCK_2015_LVK_OmegaRadiation,
    PLANCK_2015_LVK_OmegaLambda,
)
