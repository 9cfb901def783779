"""Posterior-predictive distributions (PPDs) on fixed grids.

Counterpart of ``gwinferno_tpu/postprocess/calculations.py``: for each
posterior draw, the population pdf on a grid of ``GRID_N`` points per
parameter, normalized by a trapezoid (and scaled by the draw's rate and
subpopulation fraction when given).  The draws are evaluated as a chain
axis, 128 at a time, on ``device`` (CUDA unless asked otherwise; the
redshift PPDs run on the redshift model's device); the results are numpy
arrays, ``(n_draws, GRID_N)`` per pdf, with the grids beside them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributions import betadist
from ..distributions import truncnorm_pdf
from ..interpolation import LogYBSpline
from ..models.bsplines.separable import BSplineIIDSpinMagnitudes
from ..models.bsplines.separable import BSplineIIDSpinTilts
from ..models.bsplines.separable import BSplineIndependentSpinMagnitudes
from ..models.bsplines.separable import BSplineIndependentSpinTilts
from ..models.bsplines.separable import BSplinePrimaryBSplineRatio
from ..models.bsplines.single import BSplineRatio
from ..models.parametric.parametric import mixture_isoalign_spin_tilt
from ..models.parametric.parametric import plpeak_primary_ratio_pdf

__all__ = [
    "calculate_bspline_mass_ppds",
    "calculate_powerlaw_peak_mass_ppds",
    "calculate_peak_logm1_bspline_q_ppds",
    "calculate_beta_spin_mag",
    "calculate_mixture_iso_aligned_spin_tilt",
    "calculate_bspline_spin_ppds",
    "calculate_powerlaw_rate_of_z_ppds",
    "calculate_powerlaw_spline_rate_of_z_ppds",
]

GRID_N = 800
BATCH = 128


def _batched(fn, *draw_args, device, dtype, batch_size=BATCH):
    """``fn`` over the leading draw axis of ``draw_args``, ``batch_size``
    draws at a time as a chain axis on ``device``; each output of ``fn`` is
    concatenated over the batches into a numpy array."""
    args = [torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device) for a in draw_args]
    outs = []
    with torch.no_grad():
        for s in range(0, args[0].shape[0], batch_size):
            out = fn(*[a[s:s + batch_size] for a in args])
            outs.append([o.cpu().numpy() for o in (out if isinstance(out, tuple) else (out,))])
    cat = [np.concatenate(parts, axis=0) for parts in zip(*outs)]
    return tuple(cat) if len(cat) > 1 else cat[0]


def _scales(n, rate, pop_frac):
    """The rate and the subpopulation fraction per draw (1 when not given)."""
    return (np.ones(n) if rate is None else np.asarray(rate), np.ones(n) if pop_frac is None else np.asarray(pop_frac))


def _col(v):
    """A ``(B,)`` batch of per-draw values against a grid's last axis."""
    return v[:, None]


def _trapz(y, x):
    return torch.trapezoid(y, x, dim=-1)


def _mass_grid(mmin, mmax, device, dtype):
    """The mass and ratio grids, host and device, and their meshgrid ``(q, m)``
    on the device."""
    ms = np.linspace(mmin, mmax, GRID_N)
    qs = np.linspace(mmin / mmax, 1, GRID_N)
    M, Q = np.meshgrid(ms, qs)
    dev = [torch.as_tensor(a, dtype=dtype, device=device) for a in (ms, qs, M, Q)]
    return (ms, qs, M, Q), dev


def _marginal_mass_pdfs(p_MQ, M, Q, ms, qs, mmin, r, frac):
    """The m1 and q marginals of ``p_MQ`` ``(B, q, m)`` (zero where ``q <
    mmin/m``), each normalized and scaled by ``r * frac`` ``(B,)``."""
    p_mq = torch.where(Q > mmin / M, p_MQ, 0.0)
    p_m = torch.trapezoid(p_mq, qs, dim=-2)
    p_q = _trapz(p_mq, ms)
    P_m = _col(r * frac) * p_m / _col(_trapz(p_m, ms))
    P_q = _col(r * frac) * p_q / _col(_trapz(p_q, qs))
    return P_m, P_q


def calculate_bspline_mass_ppds(m_cs, q_cs, nspline_dict, mmin, mmax, rate=None, pop_frac=None, device=None,
                                dtype=torch.float32):
    """Primary-mass and mass-ratio PPDs of the B-spline mass model
    (``nspline_dict["m1"]``, ``["q"]`` knots) at the draws ``m_cs`` ``(n,
    Km)``, ``q_cs`` ``(n, Kq)``.  Returns ``(mpdfs, ms, qpdfs, qs)``."""
    dev = resolve_device(device)
    (ms, qs, M, Q), (ms_t, qs_t, M_t, Q_t) = _mass_grid(mmin, mmax, dev, dtype)
    rate, pop_frac = _scales(np.shape(m_cs)[0], rate, pop_frac)
    model = BSplinePrimaryBSplineRatio(nspline_dict["m1"], nspline_dict["q"], M, ms, Q, qs, m1min=mmin, m2min=mmin,
                                       mmax=mmax, device=dev, dtype=dtype)

    def batch(m_c, q_c, r, f):
        return _marginal_mass_pdfs(model(m_c, q_c, pe_samples=True), M_t, Q_t, ms_t, qs_t, mmin, r, f)

    mpdfs, qpdfs = _batched(batch, m_cs, q_cs, rate, pop_frac, device=dev, dtype=dtype)
    return mpdfs, ms, qpdfs, qs


def calculate_powerlaw_peak_mass_ppds(alpha, beta, mu_peak, sig_peak, lamb, mmin, mmax, rate=None, pop_frac=None,
                                      device=None, dtype=torch.float32):
    """Primary-mass and mass-ratio PPDs of the powerlaw + peak model at the
    draws of its five hyperparameters (each ``(n,)``).  Returns ``(mpdfs,
    ms, qpdfs, qs)``."""
    dev = resolve_device(device)
    (ms, qs, _, _), (ms_t, qs_t, M_t, Q_t) = _mass_grid(mmin, mmax, dev, dtype)
    rate, pop_frac = _scales(np.shape(alpha)[0], rate, pop_frac)

    def batch(a, b, mp, sp, lam, r, f):
        hp = [v[:, None, None] for v in (a, b)]
        p_MQ = plpeak_primary_ratio_pdf(M_t, Q_t, *hp, mmin, mmax, *[v[:, None, None] for v in (mp, sp, lam)])
        return _marginal_mass_pdfs(p_MQ, M_t, Q_t, ms_t, qs_t, mmin, r, f)

    mpdfs, qpdfs = _batched(batch, alpha, beta, mu_peak, sig_peak, lamb, rate, pop_frac, device=dev, dtype=dtype)
    return mpdfs, ms, qpdfs, qs


def calculate_peak_logm1_bspline_q_ppds(logmp, logsigp, q_cs, nspline_dict, mmin, mmax, rate=None, pop_frac=None,
                                        device=None, dtype=torch.float32):
    """PPDs of a truncated lognormal primary mass (``logmp``, ``logsigp``)
    times a B-spline mass ratio (``q_cs``, ``nspline_dict["q"]`` knots).
    Returns ``(mpdfs, ms, qpdfs, qs)``."""
    dev = resolve_device(device)
    (ms, qs, M, Q), (ms_t, qs_t, M_t, Q_t) = _mass_grid(mmin, mmax, dev, dtype)
    rate, pop_frac = _scales(np.shape(q_cs)[0], rate, pop_frac)
    q_model = BSplineRatio(nspline_dict["q"], Q, qs, mmin / mmax, basis=LogYBSpline, device=dev, dtype=dtype)

    def batch(lmp, lsp, q_c, r, f):
        p_mq = q_model(q_c, pe_samples=True) * truncnorm_pdf(M_t, lmp[:, None, None], lsp[:, None, None], mmin, mmax,
                                                             log=True)
        p_mq = torch.where((M_t < mmin) | (M_t * Q_t < mmin), 0.0, p_mq)
        p_m = torch.trapezoid(p_mq, qs_t, dim=-2)
        p_q = _trapz(p_mq, ms_t)
        return _col(r * f) * p_m / _col(_trapz(p_m, ms_t)), _col(r * f) * p_q / _col(_trapz(p_q, qs_t))

    mpdfs, qpdfs = _batched(batch, logmp, logsigp, q_cs, rate, pop_frac, device=dev, dtype=dtype)
    return mpdfs, ms, qpdfs, qs


def calculate_beta_spin_mag(alpha_a, beta_a, amax=1, rate=None, pop_frac=None, device=None, dtype=torch.float32):
    """Beta spin-magnitude PPDs on [0, amax].  Returns ``(pdfs, aa)``."""
    dev = resolve_device(device)
    aa = np.linspace(0, amax, GRID_N)
    aa_t = torch.as_tensor(aa, dtype=dtype, device=dev)
    rate, pop_frac = _scales(np.shape(alpha_a)[0], rate, pop_frac)

    def batch(a, b, r, f):
        p = betadist(aa_t, _col(a), _col(b), scale=amax)
        return _col(r * f) * p / _col(_trapz(p, aa_t))

    return _batched(batch, alpha_a, beta_a, rate, pop_frac, device=dev, dtype=dtype), aa


def calculate_mixture_iso_aligned_spin_tilt(sig_ct, lambda_ct, rate=None, pop_frac=None, device=None,
                                            dtype=torch.float32):
    """Isotropic + aligned tilt-mixture PPDs on [-1, 1].  Returns ``(pdfs,
    ct)``."""
    dev = resolve_device(device)
    ct = np.linspace(-1, 1, GRID_N)
    ct_t = torch.as_tensor(ct, dtype=dtype, device=dev)
    rate, pop_frac = _scales(np.shape(sig_ct)[0], rate, pop_frac)

    def batch(s, lam, r, f):
        p = mixture_isoalign_spin_tilt(ct_t, _col(lam), _col(s))
        return _col(r * f) * p / _col(_trapz(p, ct_t))

    return _batched(batch, sig_ct, lambda_ct, rate, pop_frac, device=dev, dtype=dtype), ct


def calculate_bspline_spin_ppds(a1_cs, tilt1_cs, nspline_dict, a2_cs=None, tilt2_cs=None, rate=None, pop_frac=None,
                                device=None, dtype=torch.float32):
    """B-spline spin-magnitude and tilt PPDs.  IID (no ``a2_cs``; knots
    ``nspline_dict["a"]``, ``["tilt"]``): returns ``(apdfs, aa, ctpdfs,
    cc)``; independent (knots ``["a1"]``, ``["a2"]``, ``["tilt1"]``,
    ``["tilt2"]``): returns ``(a1pdfs, a2pdfs, aa, ct1pdfs, ct2pdfs, cc)``."""
    dev = resolve_device(device)
    aa, cc = np.linspace(0, 1, GRID_N), np.linspace(-1, 1, GRID_N)
    aa_t, cc_t = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (aa, cc))
    rate, pop_frac = _scales(np.shape(a1_cs)[0], rate, pop_frac)
    kw = dict(normalize=True, device=dev, dtype=dtype)

    def norm(p, grid, r, f):
        return _col(r * f) * p / _col(_trapz(p, grid))

    if a2_cs is None:
        mag = BSplineIIDSpinMagnitudes(nspline_dict["a"], aa, aa, aa, aa, basis=LogYBSpline, **kw).primary_model
        tilt = BSplineIIDSpinTilts(nspline_dict["tilt"], cc, cc, cc, cc, basis=LogYBSpline, **kw).primary_model

        def batch(a_cs, ct_cs, r, f):
            return norm(mag(a_cs), aa_t, r, f), norm(tilt(ct_cs), cc_t, r, f)

        apdfs, ctpdfs = _batched(batch, a1_cs, tilt1_cs, rate, pop_frac, device=dev, dtype=dtype)
        return apdfs, aa, ctpdfs, cc

    mag = BSplineIndependentSpinMagnitudes(nspline_dict["a1"], nspline_dict["a2"], aa, aa, aa, aa, **kw)
    tilt = BSplineIndependentSpinTilts(nspline_dict["tilt1"], nspline_dict["tilt2"], cc, cc, cc, cc, **kw)

    def batch(a1c, ct1c, a2c, ct2c, r, f):
        return (norm(mag.primary_model(a1c), aa_t, r, f), norm(tilt.primary_model(ct1c), cc_t, r, f),
                norm(mag.secondary_model(a2c), aa_t, r, f), norm(tilt.secondary_model(ct2c), cc_t, r, f))

    a1p, ct1p, a2p, ct2p = _batched(batch, a1_cs, tilt1_cs, a2_cs, tilt2_cs, rate, pop_frac, device=dev, dtype=dtype)
    return a1p, a2p, aa, ct1p, ct2p, cc


def calculate_powerlaw_rate_of_z_ppds(lamb, rate, z_model, pop_frac=None):
    """R(z) = rate (1+z)^lamb on the redshift model's grid ``z_model.zs``.
    Returns ``(rates, zs)``."""
    zs = z_model.zs
    _, pop_frac = _scales(np.shape(lamb)[0], None, pop_frac)

    def batch(la, r, f):
        return _col(r * f) * torch.pow(1.0 + zs, _col(la))

    return _batched(batch, lamb, rate, pop_frac, device=zs.device, dtype=zs.dtype), zs.cpu().numpy()


def calculate_powerlaw_spline_rate_of_z_ppds(lamb, z_cs, rate, z_model, pop_frac=None):
    """R(z) = rate (1+z)^lamb exp(spline(z)) on the redshift model's grid, the
    pinned zero prepended to the free coefficients ``z_cs`` ``(n, K - 1)``.
    Returns ``(rates, zs)``."""
    zs = z_model.zs
    _, pop_frac = _scales(np.shape(z_cs)[0], None, pop_frac)

    def batch(cs, la, r, f):
        cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
        spline = z_model.interpolator.project(z_model.norm_design_matrix, cs)
        return _col(r * f) * torch.pow(1.0 + zs, _col(la)) * torch.exp(spline)

    return _batched(batch, z_cs, lamb, rate, pop_frac, device=zs.device, dtype=zs.dtype), zs.cpu().numpy()
