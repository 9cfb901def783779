"""Separable 2-D population models built from 1-D B-splines.

Counterpart of ``gwinferno_tpu/models/bsplines/separable.py``, class for
class with the same constructor and ``__call__`` signatures, plus the
port's ``device`` and ``dtype`` (passed on to the 1-D models).  Coefficients
carry a leading chain axis ``(C, K)``; a hyperparameter is a number or a
``(C,)`` tensor, one value per chain.
"""

from __future__ import annotations

import numpy as np
import torch

from ...distributions import per_chain
from ...distributions import powerlaw_pdf
from ..parametric.parametric import plpeak_primary_pdf
from .single import BSplineChiEffective
from .single import BSplineChiPrecess
from .single import BSplineMass
from .single import BSplineRatio
from .single import BSplineSpinMagnitude
from .single import BSplineSpinTilt

__all__ = [
    "BSplineIIDSpinMagnitudes",
    "BSplineIndependentSpinMagnitudes",
    "BSplineIIDSpinTilts",
    "BSplineIndependentSpinTilts",
    "BSplinePrimaryPowerlawRatio",
    "PLPeakPrimaryBSplineRatio",
    "BSplinePrimaryBSplineRatio",
    "BSplineIIDComponentMasses",
    "BSplineIndependentComponentMasses",
    "BSplineEffectiveSpinDims",
]


class _IIDPair:
    """IID product of one 1-D model class over a parameter pair (shared
    coefficients)."""

    _model_cls = None

    def __init__(self, n_splines, x1, x2, x1_inj, x2_inj, **kwargs):
        self.primary_model = self._model_cls(n_splines, x1, x1_inj, **kwargs)
        self.secondary_model = self._model_cls(n_splines, x2, x2_inj, **kwargs)

    def __call__(self, coefs, pe_samples=True):
        return self.primary_model(coefs, pe_samples=pe_samples) * self.secondary_model(coefs, pe_samples=pe_samples)


class _IndependentPair:
    """Independent product: separate knots and coefficients per component."""

    _model_cls = None

    def __init__(self, n_splines1, n_splines2, x1, x2, x1_inj, x2_inj, kwargs1=None, kwargs2=None, **kwargs):
        self.primary_model = self._model_cls(n_splines1, x1, x1_inj, **(kwargs1 or {}), **kwargs)
        self.secondary_model = self._model_cls(n_splines2, x2, x2_inj, **(kwargs2 or {}), **kwargs)

    def __call__(self, pcoefs, scoefs, pe_samples=True):
        return self.primary_model(pcoefs, pe_samples=pe_samples) * self.secondary_model(scoefs, pe_samples=pe_samples)


class BSplineIIDSpinMagnitudes(_IIDPair):
    """p(a1, a2 | c) = p(a1 | c) p(a2 | c)."""

    _model_cls = BSplineSpinMagnitude


class BSplineIndependentSpinMagnitudes(_IndependentPair):
    """p(a1, a2 | c1, c2) = p(a1 | c1) p(a2 | c2)."""

    _model_cls = BSplineSpinMagnitude


class BSplineIIDSpinTilts(_IIDPair):
    """p(ct1, ct2 | c) = p(ct1 | c) p(ct2 | c)."""

    _model_cls = BSplineSpinTilt


class BSplineIndependentSpinTilts(_IndependentPair):
    """p(ct1, ct2 | c1, c2) = p(ct1 | c1) p(ct2 | c2)."""

    _model_cls = BSplineSpinTilt


class BSplinePrimaryPowerlawRatio:
    """B-spline primary mass times a powerlaw mass ratio on [mmin/m1, 1]."""

    def __init__(self, n_splines, m1, m1_inj, mmin=2, mmax=100, **kwargs):
        self.primary_model = BSplineMass(n_splines, m1, m1_inj, mmin=mmin, mmax=mmax, **kwargs)

    def __call__(self, m1, q, beta, mmin, coefs, pe_samples=True):
        """``m1``, ``q``: the bank on the model's device; ``beta``, ``mmin``:
        numbers or ``(C,)``."""
        p_m1 = self.primary_model(coefs, pe_samples=pe_samples)
        p_q = powerlaw_pdf(q, per_chain(beta, q.ndim), per_chain(mmin, q.ndim) / m1, 1.0)
        return p_m1 * p_q


class PLPeakPrimaryBSplineRatio:
    """Powerlaw + peak primary mass times a B-spline mass ratio."""

    def __init__(self, n_splines, q, q_inj, **kwargs):
        self.ratio_model = BSplineRatio(n_splines, q, q_inj, **kwargs)

    def __call__(self, m1, alpha, mmin, mmax, peak_mean, peak_sd, peak_frac, coefs, pe_samples=True):
        """``m1``: the bank on the model's device; the hyperparameters:
        numbers or ``(C,)``."""
        p_q = self.ratio_model(coefs, pe_samples=pe_samples)
        hp = [per_chain(v, m1.ndim) for v in (alpha, mmin, mmax, peak_mean, peak_sd, peak_frac)]
        return plpeak_primary_pdf(m1, *hp) * p_q


class BSplinePrimaryBSplineRatio:
    """B-spline primary mass times B-spline mass ratio on [m2min/mmax, 1]."""

    def __init__(self, n_splines_m, n_splines_q, m1, m1_inj, q, q_inj, mmax=100.0, m1min=3.0, m2min=3.0,
                 kwargs_m=None, kwargs_q=None, **kwargs):
        self.primary_model = BSplineMass(n_splines_m, m1, m1_inj, mmin=m1min, mmax=mmax, **(kwargs_m or {}), **kwargs)
        self.ratio_model = BSplineRatio(n_splines_q, q, q_inj, qmin=m2min / mmax, **(kwargs_q or {}), **kwargs)

    def __call__(self, mcoefs, qcoefs, pe_samples=True):
        return self.ratio_model(qcoefs, pe_samples=pe_samples) * self.primary_model(mcoefs, pe_samples=pe_samples)


def _mass_ratios(model, m1, m2, m1_inj, m2_inj):
    """``[m2_inj / m1_inj, m2 / m1]`` on ``model``'s device and dtype."""
    ref = model.pe_design_matrix
    return [torch.as_tensor(np.asarray(b, dtype=np.float64) / np.asarray(a, dtype=np.float64), dtype=ref.dtype,
                            device=ref.device) for a, b in ((m1_inj, m2_inj), (m1, m2))]


class BSplineIIDComponentMasses:
    """IID component-mass splines (shared coefficients) with the pairing
    ``(m2/m1)^beta``; 0 where ``m2/m1`` is outside [0, 1]."""

    def __init__(self, n_splines, m1, m2, m1_inj, m2_inj, mmin=2, mmax=100, **kwargs):
        self.primary_model = BSplineMass(n_splines, m1, m1_inj, mmin=mmin, mmax=mmax, **kwargs)
        self.secondary_model = BSplineMass(n_splines, m2, m2_inj, mmin=mmin, mmax=mmax, **kwargs)
        self.qs = _mass_ratios(self.primary_model, m1, m2, m1_inj, m2_inj)

    def __call__(self, coefs, beta=0, pe_samples=True):
        p_m1 = self.primary_model(coefs, pe_samples=pe_samples)
        p_m2 = self.secondary_model(coefs, pe_samples=pe_samples)
        q = self.qs[1 if pe_samples else 0]
        return torch.where((q < 0) | (q > 1), 0.0, p_m1 * p_m2) * torch.pow(q, per_chain(beta, q.ndim))


class BSplineIndependentComponentMasses:
    """Independent component-mass splines with the pairing ``(m2/m1)^beta``."""

    def __init__(self, n_splines1, n_splines2, m1, m2, m1_inj, m2_inj, mmin1=2, mmax1=100, mmin2=2, mmax2=100,
                 kwargs1=None, kwargs2=None, **kwargs):
        self.primary_model = BSplineMass(n_splines1, m1, m1_inj, mmin=mmin1, mmax=mmax1, **(kwargs1 or {}), **kwargs)
        self.secondary_model = BSplineMass(n_splines2, m2, m2_inj, mmin=mmin2, mmax=mmax2, **(kwargs2 or {}), **kwargs)
        self.qs = _mass_ratios(self.primary_model, m1, m2, m1_inj, m2_inj)

    def __call__(self, pcoefs, scoefs, beta=0, pe_samples=True):
        p_m1 = self.primary_model(pcoefs, pe_samples=pe_samples)
        p_m2 = self.secondary_model(scoefs, pe_samples=pe_samples)
        q = self.qs[1 if pe_samples else 0]
        return p_m1 * p_m2 * torch.pow(q, per_chain(beta, q.ndim))


class BSplineEffectiveSpinDims:
    """chi_eff spline times chi_p spline."""

    def __init__(self, n_splines_e, n_splines_p, chieff, chip, chieff_inj, chip_inj, kwargs_e=None, kwargs_p=None,
                 **kwargs):
        self.chi_eff_model = BSplineChiEffective(n_splines_e, chieff, chieff_inj, **(kwargs_e or {}), **kwargs)
        self.chi_p_model = BSplineChiPrecess(n_splines_p, chip, chip_inj, **(kwargs_p or {}), **kwargs)

    def __call__(self, ecoefs, pcoefs, pe_samples=True):
        return self.chi_eff_model(ecoefs, pe_samples=pe_samples) * self.chi_p_model(pcoefs, pe_samples=pe_samples)
