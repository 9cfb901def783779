"""A powerlaw-in-(1+z) redshift model times the exponential of a B-spline.

Counterpart of ``PowerlawSplineRedshiftModel`` in
``gwinferno_tpu/models/spline_perturbation.py``, the B-spline production
model's redshift model.  The spline's design matrices over the PE bank, the
injection bank and the normalization grid are built once in float64 numpy
and held on the device; coefficients and ``lamb`` carry a leading chain axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interpolation import LogXBSpline
from .parametric.parametric import PowerlawRedshiftModel

__all__ = ["PowerlawSplineRedshiftModel"]


class PowerlawSplineRedshiftModel(PowerlawRedshiftModel):
    """p(z) proportional to dVc/dz (1+z)^(lamb-1) exp(spline(z)) on
    [zmin, zmax].

    As in the parent, a 1-D bank is the injections and a 2-D bank the PE
    samples; dVc/dz at both banks is also held on the device here.
    """

    def __init__(self, n_splines, z_pe, z_inj, basis=LogXBSpline, device=None, dtype=torch.float32, **kwargs):
        super().__init__(z_pe, z_inj, device=device, dtype=dtype, **kwargs)
        dev = self.zs.device
        self.n_splines = n_splines
        self.interpolator = basis(n_splines, xrange=(self.zmin, self.zmax), k=4, normalize=False,
                                  device=dev, dtype=dtype)
        zs_host = np.linspace(self.zmin, self.zmax, self.zs.shape[0])

        def to_dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.pe_design_matrix = to_dev(self.interpolator.bases(z_pe))
        self.inj_design_matrix = to_dev(self.interpolator.bases(z_inj))
        self.dmats = [self.inj_design_matrix, self.pe_design_matrix]
        self.norm_design_matrix = to_dev(self.interpolator.bases(zs_host))
        self.dVdzs_t = [to_dev(v) for v in self.dVdzs]

    @staticmethod
    def _per_chain(v, ndim):
        """``(C,)`` -> ``(C, 1, ...)`` against a bank of ``ndim`` axes."""
        return v.reshape(v.shape + (1,) * ndim)

    def normalization(self, lamb, cs):
        """Trapezoid of dVc/dz (1+z)^(lamb-1) exp(spline) over the grid:
        ``(C,)`` for ``lamb (C,)`` and ``cs (C, n_splines)``."""
        pz = self.dVdz_ * torch.pow(1.0 + self.zs, self._per_chain(lamb, 1) - 1.0)
        pz = pz * torch.exp(self.interpolator.project(self.norm_design_matrix, cs))
        return torch.trapezoid(pz, self.zs, dim=-1)

    def prob(self, z, dVdz, lamb, cs):
        lamb = self._per_chain(lamb, z.ndim)
        return dVdz * torch.pow(1.0 + z, lamb - 1.0) * torch.exp(self.interpolator.project(self.dmats[z.ndim - 1], cs))

    def log_prob(self, z, lamb, cs):
        """log p(z) at a bank ``z`` on the device: ``(C, *z.shape)``."""
        dVdz = self.dVdzs_t[z.ndim - 1]
        norm = self._per_chain(torch.log(self.normalization(lamb, cs)), z.ndim)
        return torch.where(
            z <= self.zmax,
            torch.log(dVdz)
            + (self._per_chain(lamb, z.ndim) - 1.0) * torch.log1p(z)
            + self.interpolator.project(self.dmats[z.ndim - 1], cs)
            - norm,
            torch.finfo(z.dtype).min,
        )

    def __call__(self, z, lamb, cs):
        """p(z) at a bank ``z`` on the device: ``(C, *z.shape)``."""
        dVdz = self.dVdzs_t[z.ndim - 1]
        norm = self._per_chain(self.normalization(lamb, cs), z.ndim)
        return torch.where(z <= self.zmax, self.prob(z, dVdz, lamb, cs) / norm, 0.0)
