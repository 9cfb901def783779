"""Parametric population models times the exponential of a B-spline
perturbation, normalized on a fixed grid.

Counterpart of ``gwinferno_tpu/models/spline_perturbation.py``: the
powerlaw primary mass with a spline perturbation (and a powerlaw ratio, or
a perturbed powerlaw ratio normalized on a 2-D grid), and the
powerlaw-in-(1+z) redshift model with one, the B-spline production model's
redshift model.  The spline's design matrices over the PE bank, the
injection bank and the normalization grids are built once in float64 numpy
and held on the device; coefficients carry a leading chain axis ``(C, K)``,
and a hyperparameter is a number or ``(C,)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributions import per_chain
from ..distributions import powerlaw_pdf
from ..interpolation import BSpline
from ..interpolation import LogXBSpline
from .parametric.parametric import PowerlawRedshiftModel

__all__ = [
    "PowerlawBasisSplinePrimaryPowerlawRatio",
    "PowerlawBasisSplinePrimaryRatio",
    "PowerlawSplineRedshiftModel",
]


def _clamped_knot_layout(lo, hi, n_df, k):
    """Interior knots on [lo, hi] with ``k - 1`` exterior knots at the same
    spacing on each side."""
    interior = np.linspace(lo, hi, n_df - k + 2)
    dx = interior[1] - interior[0]
    knots = np.concatenate([lo - dx * np.arange(1, k)[::-1], interior, hi + dx * np.arange(1, k)])
    return knots, interior


def _to_dev(a, device, dtype):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)


class PowerlawBasisSplinePrimaryPowerlawRatio:
    """Powerlaw primary mass times ``exp(spline(log m1))``, normalized over
    1000 masses on [mmin, mmax], and a powerlaw mass ratio on [m2min/m1, 1].
    As in the JAX package, the powerlaw takes ``alpha = -alpha``."""

    def __init__(self, n_splines_m, m1pe, m1inj, mmin=3.0, m2min=3.0, mmax=100.0, k=4, basis=BSpline,
                 device=None, dtype=torch.float32, **kwargs):
        dev = resolve_device(device)
        self.m2min = m2min
        self.n_splines_m = self.n_splines = n_splines_m
        self.mmin, self.mmax = mmin, mmax
        ms = np.linspace(mmin, mmax, 1000)
        self.ms = _to_dev(ms, dev, dtype)
        self.knots, interior = _clamped_knot_layout(np.log(mmin), np.log(mmax), n_splines_m, k)
        self.interpolator = basis(n_splines_m, knots=self.knots, interior_knots=interior,
                                  xrange=(np.log(mmin), np.log(mmax)), k=k, device=dev, dtype=dtype, **kwargs)
        self.pe_design_matrix = _to_dev(self.interpolator.bases(np.log(m1pe)), dev, dtype)
        self.inj_design_matrix = _to_dev(self.interpolator.bases(np.log(m1inj)), dev, dtype)
        self.dmats = [self.inj_design_matrix, self.pe_design_matrix]
        self.norm_design_matrix = _to_dev(self.interpolator.bases(np.log(ms)), dev, dtype)

    @staticmethod
    def smoothing(ms, mmin, delta_m):
        """Low-mass Planck-taper window: 0 up to ``mmin``, rising over
        ``delta_m``, 1 above."""
        sm = ms - mmin
        in_window = (sm > 0) & (sm < delta_m)
        safe_sm = torch.where(in_window, sm, 0.5 * delta_m)
        window = torch.where(in_window, 1.0 / (torch.exp(delta_m / safe_sm + delta_m / (safe_sm - delta_m)) + 1.0), 1.0)
        return torch.where(ms <= mmin, 0.0, window)

    def norm_p_m1(self, alpha, mmin, mmax, cs):
        """Trapezoid of the perturbed powerlaw over the mass grid: ``(C,)``."""
        p_m = powerlaw_pdf(self.ms, -per_chain(alpha, 1), per_chain(mmin, 1), per_chain(mmax, 1))
        perturbation = torch.exp(self.interpolator.project(self.norm_design_matrix, cs))
        return torch.trapezoid(p_m * perturbation, self.ms, dim=-1)

    def p_m1(self, m1, alpha, mmin, mmax, cs):
        nd = m1.ndim
        p_m = powerlaw_pdf(m1, -per_chain(alpha, nd), per_chain(mmin, nd), per_chain(mmax, nd))
        perturbation = torch.exp(self.interpolator.project(self.dmats[nd - 1], cs))
        return p_m * perturbation / per_chain(self.norm_p_m1(alpha=alpha, mmin=mmin, mmax=mmax, cs=cs), nd)

    def p_q(self, q, m1, beta):
        return powerlaw_pdf(q, per_chain(beta, q.ndim), self.m2min / m1, 1.0)

    def __call__(self, m1, q, **kwargs):
        """p(m1, q) at a bank on the model's device; ``kwargs``: ``alpha``,
        ``mmin``, ``mmax``, ``cs`` ``(C, K)`` and ``beta``."""
        beta = kwargs.pop("beta")
        return self.p_m1(m1, **kwargs) * self.p_q(q, m1, beta=beta)


class PowerlawBasisSplinePrimaryRatio:
    """Powerlaw times a spline perturbation in both m1 (in log m1) and q,
    normalized jointly by a 2-D trapezoid over 1000 masses x 500 ratios."""

    def __init__(self, n_splines_m, n_splines_q, m1pe, qpe, m1inj, qinj, mmin=2.0, mmax=100.0, k=4,
                 device=None, dtype=torch.float32):
        dev = resolve_device(device)
        self.n_splines_m, self.n_splines_q = n_splines_m, n_splines_q
        self.mmin, self.mmax = mmin, mmax
        ms, qs = np.linspace(mmin, mmax, 1000), np.linspace(mmin / mmax, 1, 500)
        mm, qq = np.meshgrid(ms, qs)
        self.ms, self.qs, self.mm, self.qq = (_to_dev(a, dev, dtype) for a in (ms, qs, mm, qq))
        self.knotsm, interior_m = _clamped_knot_layout(np.log(mmin), np.log(mmax), n_splines_m, k)
        knotsq, interior_q = _clamped_knot_layout(0.0, 1.0, n_splines_q, k)
        self.knotsq = self.qknots = knotsq
        kw = dict(k=k, device=dev, dtype=dtype)
        self.interpolator = BSpline(n_splines_m, knots=self.knotsm, interior_knots=interior_m,
                                    xrange=(np.log(mmin), np.log(mmax)), **kw)
        self.qinterpolator = BSpline(n_splines_q, knots=knotsq, interior_knots=interior_q, xrange=(0, 1), **kw)
        self.pe_design_matrix = _to_dev(self.interpolator.bases(np.log(m1pe)), dev, dtype)
        self.inj_design_matrix = _to_dev(self.interpolator.bases(np.log(m1inj)), dev, dtype)
        self.dmats = [self.inj_design_matrix, self.pe_design_matrix]
        self.qpe_design_matrix = _to_dev(self.qinterpolator.bases(qpe), dev, dtype)
        self.qinj_design_matrix = _to_dev(self.qinterpolator.bases(qinj), dev, dtype)
        self.qdmats = [self.qinj_design_matrix, self.qpe_design_matrix]
        self.norm_design_matrix = _to_dev(self.interpolator.bases(np.log(mm)), dev, dtype)
        self.qnorm_design_matrix = _to_dev(self.qinterpolator.bases(qq), dev, dtype)

    def p_m1(self, m1, alpha, mmin, mmax, cs):
        nd = m1.ndim
        p_m = powerlaw_pdf(m1, -per_chain(alpha, nd), per_chain(mmin, nd), per_chain(mmax, nd))
        return p_m * torch.exp(self.interpolator.project(self.dmats[nd - 1], cs))

    def p_q(self, q, m1, beta, mmin, vs):
        nd = q.ndim
        p_q = powerlaw_pdf(q, per_chain(beta, nd), per_chain(mmin, nd) / m1, 1.0)
        return p_q * torch.exp(self.qinterpolator.project(self.qdmats[nd - 1], vs))

    def norm_pm1q(self, alpha, mmin, mmax, cs, beta, vs):
        """2-D trapezoid of the perturbed joint pdf over the grid: ``(C,)``."""
        alpha, mmin, mmax, beta = (per_chain(v, 2) for v in (alpha, mmin, mmax, beta))
        p_m = powerlaw_pdf(self.mm, -alpha, mmin, mmax)
        perturbation = torch.exp(self.interpolator.project(self.norm_design_matrix, cs))
        p_q = powerlaw_pdf(self.qq, beta, mmin / self.mm, 1.0)
        qperturbation = torch.exp(self.qinterpolator.project(self.qnorm_design_matrix, vs))
        p_mq = p_m * perturbation * p_q * qperturbation
        return torch.trapezoid(torch.trapezoid(p_mq, self.qs, dim=-2), self.ms, dim=-1)

    def __call__(self, m1, q, **kwargs):
        """p(m1, q) at a bank on the model's device; ``kwargs``: ``alpha``,
        ``mmax``, ``cs`` ``(C, Km)``, ``beta``, ``vs`` ``(C, Kq)`` and
        optionally ``mmin`` (the constructor's by default)."""
        beta = kwargs.pop("beta")
        mmin = kwargs.pop("mmin", self.mmin)
        vs = kwargs.pop("vs")
        p_m1 = self.p_m1(m1, mmin=mmin, **kwargs)
        p_q = self.p_q(q, m1, beta=beta, mmin=mmin, vs=vs)
        norm = self.norm_pm1q(beta=beta, mmin=mmin, vs=vs, **kwargs)
        return p_m1 * p_q / per_chain(norm, m1.ndim)


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

    def normalization(self, lamb, cs):
        """Trapezoid of dVc/dz (1+z)^(lamb-1) exp(spline) over the grid:
        ``(C,)`` for ``lamb (C,)`` and ``cs (C, n_splines)``."""
        pz = self.dVdz_ * torch.pow(1.0 + self.zs, per_chain(lamb, 1) - 1.0)
        pz = pz * torch.exp(self.interpolator.project(self.norm_design_matrix, cs))
        return torch.trapezoid(pz, self.zs, dim=-1)

    def prob(self, z, dVdz, lamb, cs):
        lamb = per_chain(lamb, z.ndim)
        return dVdz * torch.pow(1.0 + z, lamb - 1.0) * torch.exp(self.interpolator.project(self.dmats[z.ndim - 1], cs))

    def log_prob(self, z, lamb, cs):
        """log p(z) at a bank ``z`` on the device: ``(C, *z.shape)``."""
        dVdz = self.dVdzs_t[z.ndim - 1]
        norm = per_chain(torch.log(self.normalization(lamb, cs)), z.ndim)
        return torch.where(
            z <= self.zmax,
            torch.log(dVdz)
            + (per_chain(lamb, z.ndim) - 1.0) * torch.log1p(z)
            + self.interpolator.project(self.dmats[z.ndim - 1], cs)
            - norm,
            torch.finfo(z.dtype).min,
        )

    def __call__(self, z, lamb, cs):
        """p(z) at a bank ``z`` on the device: ``(C, *z.shape)``."""
        dVdz = self.dVdzs_t[z.ndim - 1]
        norm = per_chain(self.normalization(lamb, cs), z.ndim)
        return torch.where(z <= self.zmax, self.prob(z, dVdz, lamb, cs) / norm, 0.0)
