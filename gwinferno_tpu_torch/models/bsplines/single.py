"""1-D B-spline population models with design matrices cached on the device.

Counterpart of ``gwinferno_tpu/models/bsplines/single.py``.  The basis is
evaluated once, at construction, over the PE bank ``(E, S)`` and the
injection bank ``(N,)`` in float64 numpy; the design matrices keep the full
bank shape with out-of-range entries zeroed (``_finite_design``) and move to
the device once.  A call projects the chains' coefficients ``(C, K)`` on a
cached matrix and masks the pdf to 0 outside the spline's domain: ``(C, E,
S)`` or ``(C, N)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...cosmology import PLANCK_2015_LVK_Cosmology as Planck15
from ...device import resolve_device
from ...interpolation import BSpline
from ...interpolation import LogXBSpline
from ...interpolation import LogXLogYBSpline
from ...interpolation import LogYBSpline
from ...interpolation import _contract

__all__ = [
    "Base1DBSplineModel",
    "BSplineSpinMagnitude",
    "BSplineSpinTilt",
    "BSplineChiEffective",
    "BSplineSymmetricChiEffective",
    "BSplineChiPrecess",
    "BSplineRatio",
    "BSplineMass",
    "BSplineRedshift",
]


def _finite_design(dm):
    """Zero the non-finite (out-of-range sentinel) entries of a host design
    matrix."""
    return np.where(np.isfinite(dm), dm, 0.0)


class Base1DBSplineModel:
    """Cached full-shape design matrices and the masked projection.

    ``device`` (CUDA unless asked otherwise) and ``dtype`` are where the
    design matrices, the validity masks and the basis's normalization terms
    live.
    """

    def __init__(self, n_splines, xx, xx_inj, xrange=(0.0, 1.0), degree=3, basis=BSpline,
                 device=None, dtype=torch.float32, **kwargs):
        dev = resolve_device(device)
        self.n_splines = n_splines
        self.xmin, self.xmax = xrange
        self.degree = degree
        self.interpolator = basis(n_splines, xrange=xrange, k=degree + 1, device=dev, dtype=dtype, **kwargs)
        xx, xx_inj = np.asarray(xx, dtype=np.float64), np.asarray(xx_inj, dtype=np.float64)
        self._valid_xx = torch.as_tensor((xx >= self.xmin) & (xx <= self.xmax), device=dev)
        self._valid_xx_inj = torch.as_tensor((xx_inj >= self.xmin) & (xx_inj <= self.xmax), device=dev)
        self.pe_design_matrix = torch.as_tensor(_finite_design(self.interpolator.bases(xx)), dtype=dtype, device=dev)
        self.inj_design_matrix = torch.as_tensor(
            _finite_design(self.interpolator.bases(xx_inj)), dtype=dtype, device=dev
        )
        self.funcs = [self.inj_pdf, self.pe_pdf]

    def eval_spline(self, bases, coefs):
        """Project the coefficients ``(C, K)`` onto a design matrix
        (normalized)."""
        return self.interpolator.project(bases, coefs)

    def pe_pdf(self, coefs):
        """pdf at the PE bank ``(C, E, S)``; exactly 0 outside the domain."""
        return torch.where(self._valid_xx, self.eval_spline(self.pe_design_matrix, coefs), 0.0)

    def inj_pdf(self, coefs):
        """pdf at the injection bank ``(C, N)``; exactly 0 outside the domain."""
        return torch.where(self._valid_xx_inj, self.eval_spline(self.inj_design_matrix, coefs), 0.0)

    def __call__(self, coefs, pe_samples=True):
        return self.funcs[1](coefs) if pe_samples else self.funcs[0](coefs)


class BSplineSpinMagnitude(Base1DBSplineModel):
    """Spin-magnitude spline on [0, 1]."""

    def __init__(self, n_splines, a, a_inj, basis=LogYBSpline, **kwargs):
        xrange = kwargs.pop("xrange", (0.0, 1.0))
        super().__init__(n_splines, a, a_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineSpinTilt(Base1DBSplineModel):
    """cos-tilt spline on [-1, 1]."""

    def __init__(self, n_splines, ct, ct_inj, basis=LogYBSpline, **kwargs):
        xrange = kwargs.pop("xrange", (-1.0, 1.0))
        super().__init__(n_splines, ct, ct_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineChiEffective(Base1DBSplineModel):
    """chi_eff spline on [-1, 1]."""

    def __init__(self, n_splines, chieff, chieff_inj, basis=BSpline, **kwargs):
        xrange = kwargs.pop("xrange", (-1.0, 1.0))
        super().__init__(n_splines, chieff, chieff_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineSymmetricChiEffective(Base1DBSplineModel):
    """Symmetric chi_eff: a spline in |chi_eff| on [0, 1], its density
    halved."""

    def __init__(self, n_splines, chieff, chieff_inj, basis=BSpline, **kwargs):
        xrange = kwargs.pop("xrange", (0.0, 1.0))
        super().__init__(n_splines, np.abs(np.asarray(chieff, dtype=np.float64)),
                         np.abs(np.asarray(chieff_inj, dtype=np.float64)), basis=basis, xrange=xrange, **kwargs)

    def __call__(self, coefs, pe_samples=True):
        return 0.5 * self.funcs[1](coefs) if pe_samples else 0.5 * self.funcs[0](coefs)


class BSplineChiPrecess(Base1DBSplineModel):
    """chi_p spline on [0, 1]."""

    def __init__(self, n_splines, chip, chip_inj, basis=BSpline, **kwargs):
        xrange = kwargs.pop("xrange", (0.0, 1.0))
        super().__init__(n_splines, chip, chip_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineRatio(Base1DBSplineModel):
    """Mass-ratio spline on [qmin, 1]."""

    def __init__(self, n_splines, q, q_inj, qmin=0, basis=LogYBSpline, **kwargs):
        xrange = kwargs.pop("xrange", (qmin, 1))
        super().__init__(n_splines, q, q_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineMass(Base1DBSplineModel):
    """Component-mass spline on [mmin, mmax], log-log basis by default."""

    def __init__(self, n_splines, m, m_inj, mmin=2, mmax=100, basis=LogXLogYBSpline, **kwargs):
        xrange = kwargs.pop("xrange", (mmin, mmax))
        super().__init__(n_splines, m, m_inj, basis=basis, xrange=xrange, **kwargs)


class BSplineRedshift(Base1DBSplineModel):
    """Redshift spline defining the rate density ``exp(spline(z)) dVc/dz /
    (1+z) / normalization``; the normalization is a trapezoid over 1000
    points of the banks' common redshift range, with the Planck-2015-LVK
    dVc/dz.  ``dVdc`` and ``dVdc_inj`` are dVc/dz at the PE and injection
    banks."""

    def __init__(self, n_splines, z, z_inj, dVdc, dVdc_inj, zmax=2.3, basis=LogXBSpline, **kwargs):
        xrange = kwargs.pop("xrange", (1e-4, zmax))
        super().__init__(n_splines, z, z_inj, xrange=xrange, basis=basis, **kwargs)
        dev, dtype = self.pe_design_matrix.device, self.pe_design_matrix.dtype
        z, z_inj = np.asarray(z, dtype=np.float64), np.asarray(z_inj, dtype=np.float64)
        self.zmin = max(float(z.min()), float(z_inj.min()))
        self.zmax = min(float(z.max()), float(z_inj.max()))
        zgrid = np.linspace(self.zmin, self.zmax, 1000)

        def to_dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)

        self.zgrid = to_dev(zgrid)
        self.dVcdzgrid = to_dev(Planck15.dVcdz(zgrid))
        self.grid_bases = to_dev(_finite_design(self.interpolator.bases(zgrid)))
        self.differential_comov_vols = [to_dev(dVdc_inj), to_dev(dVdc)]
        self.zs = [to_dev(z_inj), to_dev(z)]

    def normalization(self, cs):
        """Trapezoid of exp(spline) dVc/dz / (1+z) over the grid: ``(C,)``."""
        return torch.trapezoid(
            self.dVcdzgrid / (1.0 + self.zgrid) * torch.exp(_contract(cs, self.grid_bases)), self.zgrid, dim=-1
        )

    def __call__(self, coefs, pe_samples=True):
        idx = 1 if pe_samples else 0
        norm = self.normalization(coefs)
        return (
            torch.exp(self.funcs[idx](coefs))
            * self.differential_comov_vols[idx]
            / (1.0 + self.zs[idx])
            / norm.reshape((-1,) + (1,) * self.zs[idx].ndim)
        )
