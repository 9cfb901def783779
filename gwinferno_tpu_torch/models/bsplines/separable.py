"""Separable 2-D population models built from 1-D B-splines.

Counterpart of ``gwinferno_tpu/models/bsplines/separable.py`` for the
production model's pieces: the IID spin pairs and the B-spline primary mass
times B-spline mass ratio.  Coefficients carry a leading chain axis.
"""

from __future__ import annotations

from .single import BSplineMass
from .single import BSplineRatio
from .single import BSplineSpinMagnitude
from .single import BSplineSpinTilt

__all__ = ["BSplineIIDSpinMagnitudes", "BSplineIIDSpinTilts", "BSplinePrimaryBSplineRatio"]


class _IIDPair:
    """IID product of one 1-D model class over a parameter pair (shared
    coefficients)."""

    _model_cls = None

    def __init__(self, n_splines, x1, x2, x1_inj, x2_inj, **kwargs):
        self.primary_model = self._model_cls(n_splines, x1, x1_inj, **kwargs)
        self.secondary_model = self._model_cls(n_splines, x2, x2_inj, **kwargs)

    def __call__(self, coefs, pe_samples=True):
        return self.primary_model(coefs, pe_samples=pe_samples) * self.secondary_model(coefs, pe_samples=pe_samples)


class BSplineIIDSpinMagnitudes(_IIDPair):
    """p(a1, a2 | c) = p(a1 | c) p(a2 | c)."""

    _model_cls = BSplineSpinMagnitude


class BSplineIIDSpinTilts(_IIDPair):
    """p(ct1, ct2 | c) = p(ct1 | c) p(ct2 | c)."""

    _model_cls = BSplineSpinTilt


class BSplinePrimaryBSplineRatio:
    """B-spline primary mass times B-spline mass ratio on [m2min/mmax, 1]."""

    def __init__(self, n_splines_m, n_splines_q, m1, m1_inj, q, q_inj, mmax=100.0, m1min=3.0, m2min=3.0,
                 kwargs_m=None, kwargs_q=None, **kwargs):
        self.primary_model = BSplineMass(n_splines_m, m1, m1_inj, mmin=m1min, mmax=mmax, **(kwargs_m or {}), **kwargs)
        self.ratio_model = BSplineRatio(n_splines_q, q, q_inj, qmin=m2min / mmax, **(kwargs_q or {}), **kwargs)

    def __call__(self, mcoefs, qcoefs, pe_samples=True):
        return self.ratio_model(qcoefs, pe_samples=pe_samples) * self.primary_model(mcoefs, pe_samples=pe_samples)
