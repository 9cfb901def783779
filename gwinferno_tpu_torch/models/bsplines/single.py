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

from ...device import resolve_device
from ...interpolation import BSpline
from ...interpolation import LogXLogYBSpline
from ...interpolation import LogYBSpline

__all__ = [
    "Base1DBSplineModel",
    "BSplineSpinMagnitude",
    "BSplineSpinTilt",
    "BSplineRatio",
    "BSplineMass",
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
