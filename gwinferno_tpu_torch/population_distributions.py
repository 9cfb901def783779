"""Population distributions for config-driven models.

Counterpart of ``gwinferno_tpu/population_distributions.py`` (class for
class): the source-parameter population models the YAML pipeline builds by
dotted path, with ``log_prob``, ``cdf``, ``icdf`` and inverse-cdf sampling.

Chain axis: a hyperparameter is a number (pinned by the config) or a tensor
whose leading axes are the chains, ``(C,)`` for a scalar hyperparameter.
``log_prob``, ``cdf`` and ``icdf`` of a value of shape ``V`` return
``batch_shape + V``: the hyperparameters broadcast over the data's trailing
axes, so one distribution evaluates a PE bank ``(E, S)`` and an injection
bank ``(N,)`` for every chain at once.  Tables over a grid (the redshift and
B-spline densities) carry the grid on a new last axis, ``(C, G)``, and
:func:`interp` reads them per chain.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .cosmology import PLANCK_2015_LVK_Cosmology
from .distributions import safe_log
from .models.bsplines.smoothing import apply_difference_prior
from .ppl import constraints
from .ppl.distributions import Distribution

_LOG2 = math.log(2.0)

__all__ = [
    "cumtrapz",
    "interp",
    "Sine",
    "Cosine",
    "Powerlaw",
    "PowerlawRedshift",
    "PowerlawSmoothedPowerlaw",
    "BSplineDistribution",
    "PSplineCoeficientPrior",
]


def cumtrapz(y, x):
    """Cumulative trapezoid over the last axis, with a leading 0."""
    heights = 0.5 * (y[..., 1:] + y[..., :-1]) * torch.diff(x, dim=-1)
    return torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(heights, dim=-1)], dim=-1)


def _trapezoid(y, x):
    return 0.5 * (torch.diff(x, dim=-1) * (y[..., 1:] + y[..., :-1])).sum(-1)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` batched over leading axes of the tables.

    ``xp`` and ``fp`` hold ``G`` points on their last axis; their leading
    axes ``B`` (if any) are per-chain tables.  With a shared ``xp`` of shape
    ``(G,)`` the result is ``fp``'s ``B`` plus ``x.shape``; with a per-chain
    ``xp`` of shape ``B + (G,)``, ``x`` must lead with ``B`` and the result
    has ``x``'s shape.  Values outside ``xp`` take the end values of ``fp``,
    and a zero-width interval gives its left value, as ``jnp.interp`` does.
    """
    G = xp.shape[-1]
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    if xp.ndim == 1:
        i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, G - 1)
        x0, x1, f0, f1 = xp[i - 1], xp[i], fp[..., i - 1], fp[..., i]
        tail = (1,) * x.ndim
        lo, hi = xp[0], xp[-1]
        f_lo = fp[..., 0].reshape(fp.shape[:-1] + tail)
        f_hi = fp[..., -1].reshape(fp.shape[:-1] + tail)
        shape = None
    else:
        B = xp.shape[:-1]
        shape = x.shape
        xf = x.reshape(int(np.prod(B)), -1).contiguous()
        xpf = xp.reshape(-1, G).contiguous()
        fpf = fp.expand(B + (G,)).reshape(-1, G)
        i = torch.searchsorted(xpf, xf, right=True).clamp(1, G - 1)
        x0, x1 = torch.gather(xpf, 1, i - 1), torch.gather(xpf, 1, i)
        f0, f1 = torch.gather(fpf, 1, i - 1), torch.gather(fpf, 1, i)
        lo, hi, f_lo, f_hi = xpf[:, :1], xpf[:, -1:], fpf[:, :1], fpf[:, -1:]
        x = xf
    dx = x1 - x0
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < lo, f_lo, f)
    f = torch.where(x > hi, f_hi, f)
    return f if shape is None else f.reshape(shape)


def _as_tensors(*params):
    """The parameters as tensors on the first tensor parameter's device and
    in its dtype (numbers become 0-d tensors made there, with no host to
    device copy); float64 on the CPU when none is a tensor."""
    ref = next((p for p in params if isinstance(p, torch.Tensor)), None)
    if ref is None:
        return [torch.tensor(float(p), dtype=torch.float64) for p in params]
    return [p.to(ref.device) if isinstance(p, torch.Tensor)
            else torch.full((), float(p), dtype=ref.dtype, device=ref.device) for p in params]


def _shape(p):
    return tuple(p.shape) if isinstance(p, torch.Tensor) else np.shape(p)


def _at(p, nd, like=None):
    """A chain-batched tensor parameter with ``nd`` trailing unit axes, so it
    broadcasts over a value's ``nd`` axes (and on ``like``'s device);
    numbers and 0-d tensors as they are."""
    if isinstance(p, torch.Tensor):
        if like is not None and p.device != like.device:
            p = p.to(like.device)
        if p.ndim:
            return p.reshape(tuple(p.shape) + (1,) * nd)
    return p


def _cos(p):
    return torch.cos(p) if isinstance(p, torch.Tensor) else math.cos(p)


def _sin(p):
    return torch.sin(p) if isinstance(p, torch.Tensor) else math.sin(p)


class _PopulationDistribution(Distribution):
    """Chain-outer evaluation (``batch_shape + value.shape``) and
    inverse-cdf sampling through ``_icdf(q, nd)``, which reads ``q``'s last
    ``nd`` axes as the value's."""

    chain_outer = True

    def icdf(self, q):
        return self._icdf(q, q.ndim)

    def sample(self, generator, sample_shape=()):
        """Draws of shape ``sample_shape + batch_shape`` (the PPL's order)."""
        S, nb = tuple(sample_shape), len(self.batch_shape)
        u = torch.rand(self.batch_shape + S, generator=generator, device=generator.device,
                       dtype=torch.get_default_dtype())
        x = self._icdf(u, len(S))
        return x.movedim(tuple(range(nb)), tuple(range(len(S), len(S) + nb)))


class Sine(_PopulationDistribution):
    """p(x) proportional to sin(x) on ``[minimum, maximum]``; the cdf lerps
    between the endpoint cosines."""

    def __init__(self, minimum=0.0, maximum=math.pi):
        self.minimum, self.maximum = minimum, maximum
        super().__init__(torch.broadcast_shapes(_shape(minimum), _shape(maximum)))
        self.support = constraints.interval(minimum, maximum)
        self._c0, self._c1 = _cos(minimum), _cos(maximum)

    def log_prob(self, value):
        return (safe_log(torch.sin(value)) - _LOG2).expand(self.batch_shape + tuple(value.shape))

    def cdf(self, value):
        nd = value.ndim
        c0, c1 = _at(self._c0, nd), _at(self._c1, nd)
        raw = (c0 - torch.cos(value)) / (c0 - c1)
        out = torch.where(value < _at(self.minimum, nd), 0.0, torch.where(value > _at(self.maximum, nd), 1.0, raw))
        return torch.atleast_1d(out)

    def _icdf(self, q, nd):
        c0, c1 = _at(self._c0, nd), _at(self._c1, nd)
        return torch.arccos(c0 + q * (c1 - c0))


class Cosine(_PopulationDistribution):
    """p(x) proportional to cos(x) on ``[minimum, maximum]``; the cdf lerps
    between the endpoint sines."""

    def __init__(self, minimum=-math.pi / 2.0, maximum=math.pi / 2.0):
        self.minimum, self.maximum = minimum, maximum
        super().__init__(torch.broadcast_shapes(_shape(minimum), _shape(maximum)))
        self.support = constraints.interval(minimum, maximum)
        self._s0, self._s1 = _sin(minimum), _sin(maximum)

    def log_prob(self, value):
        return (safe_log(torch.cos(value)) - _LOG2).expand(self.batch_shape + tuple(value.shape))

    def cdf(self, value):
        nd = value.ndim
        s0, s1 = _at(self._s0, nd), _at(self._s1, nd)
        raw = (torch.sin(value) - s0) / (s1 - s0)
        out = torch.where(value < _at(self.minimum, nd), 0.0, torch.where(value > _at(self.maximum, nd), 1.0, raw))
        return torch.atleast_1d(out)

    def _icdf(self, q, nd):
        s0, s1 = _at(self._s0, nd), _at(self._s1, nd)
        return torch.arcsin(s0 + q * (s1 - s0))


class Powerlaw(_PopulationDistribution):
    """Truncated powerlaw on ``[minimum, maximum]`` with the ``alpha == -1``
    (log-uniform) branch: there the normalization is ``log(max/min)``, the
    cdf lerps ``log x`` and the icdf interpolates geometrically."""

    def __init__(self, alpha, minimum=0.0, maximum=1.0, low=0.0, high=1.0):
        self.alpha, self.minimum, self.maximum = _as_tensors(alpha, minimum, maximum)
        super().__init__(torch.broadcast_shapes(_shape(minimum), _shape(maximum), _shape(alpha)))
        self.support = constraints.interval(low, high)

    def _params(self, nd, like):
        return _at(self.alpha, nd, like), _at(self.minimum, nd, like), _at(self.maximum, nd, like)

    def _log_norm(self, nd, like):
        alpha, lo, hi = self._params(nd, like)
        ap1 = 1.0 + alpha
        generic = torch.log(torch.abs(hi**ap1 - lo**ap1)) - torch.log(torch.abs(ap1))
        return torch.where(alpha == -1.0, torch.log(torch.log(hi) - torch.log(lo)), generic)

    def log_prob(self, value):
        nd = value.ndim
        alpha, lo, hi = self._params(nd, value)
        logx = torch.log(value)
        shape = torch.where(alpha == -1.0, -logx, alpha * logx)
        in_support = (value >= lo) & (value <= hi)
        return torch.where(in_support, shape - self._log_norm(nd, value), torch.finfo(value.dtype).min)

    def cdf(self, value):
        alpha, lo, hi = self._params(value.ndim, value)
        ap1 = 1.0 + alpha
        generic = (value**ap1 - lo**ap1) / (hi**ap1 - lo**ap1)
        log_frac = (torch.log(value) - torch.log(lo)) / (torch.log(hi) - torch.log(lo))
        return torch.clamp(torch.atleast_1d(torch.where(alpha == -1.0, log_frac, generic)), 0.0, 1.0)

    def _icdf(self, q, nd):
        alpha, lo, hi = self._params(nd, q)
        ap1 = 1.0 + alpha
        generic = (lo**ap1 + q * (hi**ap1 - lo**ap1)) ** (1.0 / ap1)
        geometric = torch.exp(torch.log(lo) + q * (torch.log(hi) - torch.log(lo)))
        return torch.where(alpha == -1.0, geometric, generic)


class _TabulatedDensity(_PopulationDistribution):
    """A density tabulated on a 1-D grid: the trapezoid normalization
    (``norm``, batch-shaped) and a cumulative table ``(..., G)`` that serve
    cdf and icdf by linear interpolation.  The normalized and cumulative
    tables are made at first use: ``log_prob`` needs neither, so a gradient
    never builds them (as the JAX package's compiled gradient drops them)."""

    def _build_grid_tables(self, grid, unnorm_pdf):
        self.grid = grid
        self._unnorm_pdf = unnorm_pdf
        self.norm = _trapezoid(unnorm_pdf, grid)

    @functools.cached_property
    def pdfs(self):
        return self._unnorm_pdf / self.norm[..., None]

    @functools.cached_property
    def cdfgrid(self):
        cum = cumtrapz(self.pdfs, self.grid)
        # cum[..., -1] is the quadrature of `norm` again, 1 up to rounding;
        # dividing through keeps the table monotone with unit total
        return cum / cum[..., -1:]

    def cdf(self, value):
        return interp(value, self.grid, self.cdfgrid)

    def _icdf(self, q, nd):
        B = self.cdfgrid.shape[:-1]
        if B:
            q = q.expand(B + tuple(q.shape[q.ndim - nd:]))
        return interp(q, self.cdfgrid, self.grid)


class PowerlawRedshift(_TabulatedDensity):
    """p(z) proportional to dVc/dz (1+z)^(lamb-1) on a grid up to
    ``maximum``; ``norm`` (the surveyed hypervolume, ``(C,)``) feeds the
    rate reconstruction.

    ``dVcdz`` (dVc/dz on the grid) and, in :meth:`log_prob`, ``dVdc`` (dVc/dz
    at the values) are data-only: a caller that evaluates the same grid or
    data at every gradient passes them in, made once.
    """

    def __init__(self, lamb, maximum, grid=None, zgrid=None, dVcdz=None, low=0.0, high=1000.0):
        self.lamb, self.maximum = lamb, maximum
        super().__init__(torch.broadcast_shapes(_shape(maximum), _shape(lamb)))
        self.support = constraints.interval(low, high)
        if zgrid is None:
            zgrid = grid if grid is not None else torch.linspace(1e-9, maximum, 1000, dtype=torch.float64)
        if isinstance(lamb, torch.Tensor):
            zgrid = zgrid.to(dtype=lamb.dtype, device=lamb.device)
        self.zs = zgrid
        if dVcdz is None:
            dVcdz = torch.as_tensor(PLANCK_2015_LVK_Cosmology.dVcdz(zgrid.detach().cpu().double().numpy()),
                                    dtype=zgrid.dtype, device=zgrid.device)
        self.dVcdz_grid = dVcdz
        lamb_g = lamb[..., None] if isinstance(lamb, torch.Tensor) and lamb.ndim else lamb
        self._build_grid_tables(zgrid, dVcdz * torch.pow(1.0 + zgrid, lamb_g - 1.0))

    def log_prob(self, value, dVdc=None):
        nd = value.ndim
        dv = interp(value, self.zs, self.dVcdz_grid) if dVdc is None else dVdc
        lp = safe_log(dv) + (_at(self.lamb, nd) - 1.0) * torch.log1p(value) - torch.log(_at(self.norm, nd))
        return torch.where(value <= _at(self.maximum, nd), lp, torch.finfo(lp.dtype).min)


def _log_powerlaw_integral(p, log_lo, log_hi):
    """``log((hi^p - lo^p) / p)`` for ``hi > lo`` in log space, with the
    ``p -> 0`` limit ``log(log(hi/lo))`` (double ``where``: the gradient
    stays finite at the removable singularity)."""
    singular = torch.abs(p) < 1e-12
    p_safe = torch.where(singular, 1.0, p)
    a, b = p_safe * log_hi, p_safe * log_lo
    big, small = torch.maximum(a, b), torch.minimum(a, b)
    diff = big + torch.log1p(-torch.exp(small - big)) - torch.log(torch.abs(p_safe))
    return torch.where(singular, torch.log(log_hi - log_lo), diff)


class PowerlawSmoothedPowerlaw(_PopulationDistribution):
    """Three-segment broken powerlaw on ``[low, high]``: slope ``alpha_min``
    below ``minimum``, ``alpha`` between the breaks, ``-alpha_max`` above
    ``maximum``, continuous at the breaks and normalized exactly.  The
    continuity constants are kept in log space (``log_k1``, ``log_k2``,
    ``log_k3``; ``k1``, ``k2``, ``k3`` are their exponentials), so float32
    never forms ``maximum ** (alpha + alpha_max)``.
    ``sample`` returns ones, as in the JAX package."""

    def __init__(self, alpha, minimum, maximum, alpha_max, alpha_min, low, high):
        shapes = [_shape(v) for v in (maximum, minimum, alpha, alpha_max, alpha_min)]
        alpha, minimum, maximum, alpha_max, alpha_min, low, high = _as_tensors(
            alpha, minimum, maximum, alpha_max, alpha_min, low, high)
        self.minimum, self.maximum, self.alpha = minimum, maximum, alpha
        self.alpha_max, self.alpha_min = -alpha_max, alpha_min
        self.low, self.high = low, high
        super().__init__(torch.broadcast_shapes(*shapes))
        self.support = constraints.interval(low, high)
        log_min, log_max = torch.log(minimum), torch.log(maximum)
        log_r_mid = (self.alpha_min - alpha) * log_min
        log_r_high = (alpha - self.alpha_max) * log_max
        log_seg_low = _log_powerlaw_integral(self.alpha_min + 1.0, torch.log(low), log_min)
        log_seg_mid = _log_powerlaw_integral(alpha + 1.0, log_min, log_max)
        log_seg_high = _log_powerlaw_integral(self.alpha_max + 1.0, log_max, torch.log(high))
        self.log_k1 = -torch.logsumexp(
            torch.stack(torch.broadcast_tensors(log_seg_low, log_r_mid + log_seg_mid,
                                                log_r_mid + log_r_high + log_seg_high)), dim=0)
        self.log_k2 = self.log_k1 + log_r_mid
        self.log_k3 = self.log_k2 + log_r_high

    @property
    def k1(self):
        return torch.exp(self.log_k1)

    @property
    def k2(self):
        return torch.exp(self.log_k2)

    @property
    def k3(self):
        return torch.exp(self.log_k3)

    def sample(self, generator, sample_shape=()):
        return torch.ones(tuple(sample_shape) + self.batch_shape, dtype=self.alpha.dtype, device=self.alpha.device)

    def log_prob(self, value):
        nd = value.ndim

        def at(p):
            return _at(p, nd, value)

        logx = torch.log(value)
        return torch.where(
            value < at(self.minimum),
            at(self.log_k1) + at(self.alpha_min) * logx,
            torch.where(value > at(self.maximum), at(self.log_k3) + at(self.alpha_max) * logx,
                        at(self.log_k2) + at(self.alpha) * logx),
        )


class BSplineDistribution(_TabulatedDensity):
    """A 1-D pdf from spline coefficients ``cs`` (``(n,)`` or ``(C, n)``)
    and a design matrix on a grid, ``grid_dmat`` ``(n, G)``: the log-pdf
    table ``cs @ grid_dmat`` (grid points outside the basis support, NaN
    there, tabulate as zero density), its trapezoid norm and cdf."""

    def __init__(self, minimum, maximum, cs, grid, grid_dmat):
        self.minimum, self.maximum, self.cs = minimum, maximum, cs
        super().__init__(torch.broadcast_shapes(_shape(maximum), _shape(minimum), tuple(cs.shape[:-1])))
        self.support = constraints.interval(minimum, maximum)
        proj = cs @ grid_dmat
        self.lpdfs = torch.where(torch.isnan(proj), -torch.inf, proj)
        self._build_grid_tables(grid, torch.exp(self.lpdfs))

    def log_prob(self, value):
        return interp(value, self.grid, self.lpdfs) - torch.log(_at(self.norm, value.ndim))


class PSplineCoeficientPrior(Distribution):
    """A prior on ``N`` spline coefficients (event shape ``(N,)``) whose log
    density is the P-spline difference penalty of order ``diff_order``.  It
    is a hyperprior, so ``inv_var`` broadcasts against the value's leading
    (chain) axes as any PPL distribution's parameters do.  ``sample`` returns
    ones, as in the JAX package."""

    support = constraints.real_vector
    event_ndim = 1

    def __init__(self, N, inv_var, diff_order=2):
        self.inv_var = inv_var
        self.diff_order = diff_order
        self.N = N
        super().__init__(_shape(inv_var), (N,))

    def sample(self, generator, sample_shape=()):
        return torch.ones(tuple(sample_shape) + self.batch_shape + (self.N,), device=generator.device)

    def log_prob(self, value):
        return apply_difference_prior(value, self.inv_var, self.diff_order)
