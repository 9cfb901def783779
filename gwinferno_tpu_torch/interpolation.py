"""B-spline and M-spline bases with cached design matrices, the natural
cubic interpolating spline, and the 2-D tensor-product basis.

Counterpart of ``gwinferno_tpu/interpolation.py``.  Design
matrices are built once, at construction, in float64 numpy by the vectorized
Cox-de Boor ladder and moved to the device once; the sampled hot path is
only ``project``, a ``(C, K) @ (K, n)`` product of the chains' coefficients
with a cached design matrix.

Shapes: ``bases(xs)`` is host numpy ``(K, *xs.shape)``; ``project(bases,
coefs)`` takes a device design tensor ``(K, ...)`` and coefficients
``(C, K)`` and returns ``(C, ...)``; ``norm(coefs)`` returns ``(C,)`` (or
the number 1 when the basis is not normalized).

Out-of-range semantics follow the reference: plain splines are 0 outside
``xrange``; the log-range variants put ``-inf`` in the design matrix there
and ``_project`` maps any non-finite log value (``0 * -inf = nan``,
``-inf * c < 0 = +inf``) to ``-inf`` before the ``exp``, so the density is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = [
    "mspline_design_matrix",
    "bspline_design_matrix",
    "NaturalCubicUnivariateSpline",
    "BasisSpline",
    "BSpline",
    "LogXBSpline",
    "LogYBSpline",
    "LogXLogYBSpline",
    "RectBivariateBasisSpline",
]

_DEGENERATE_KNOT_TOL = 1e-6


def mspline_design_matrix(xs, knots, order):
    """Every M-spline basis function of ``order`` at ``xs`` (host float64):
    the Cox-de Boor ladder run over all basis indices at once,

        M_{i,1}(x) = 1/(t_{i+1}-t_i) on [t_i, t_{i+1})
        M_{i,m}(x) = m [(x-t_i) M_{i,m-1} + (t_{i+m}-x) M_{i+1,m-1}] / ((m-1)(t_{i+m}-t_i)),

    with spans under 1e-6 giving zero rows.  Returns ``(len(knots) - order,
    *xs.shape)``."""
    t = np.asarray(knots, dtype=np.float64)
    xs = np.asarray(xs, dtype=np.float64)
    x = xs.reshape(-1)[None, :]
    tl, tr = t[:-1, None], t[1:, None]
    span1 = tr - tl
    B = np.where(
        (x >= tl) & (x < tr) & (span1 >= _DEGENERATE_KNOT_TOL),
        1.0 / np.where(span1 >= _DEGENERATE_KNOT_TOL, span1, 1.0),
        0.0,
    )
    for m in range(2, order + 1):
        span = t[m:, None] - t[:-m, None]
        num = (x - t[:-m, None]) * B[:-1] + (t[m:, None] - x) * B[1:]
        B = np.where(
            span >= _DEGENERATE_KNOT_TOL,
            m * num / ((m - 1) * np.where(span >= _DEGENERATE_KNOT_TOL, span, 1.0)),
            0.0,
        )
    return B.reshape((t.shape[0] - order,) + xs.shape)


def bspline_design_matrix(xs, knots, order):
    """B-spline design matrix: M-splines rescaled by ``(t_{i+k} - t_i) / k``."""
    t = np.asarray(knots, dtype=np.float64)
    M = mspline_design_matrix(xs, t, order)
    scale = (t[order:] - t[: t.shape[0] - order]) / order
    return M * scale.reshape((-1,) + (1,) * (M.ndim - 1))


class NaturalCubicUnivariateSpline:
    """Natural cubic interpolating spline through ``(x, y)`` (1-D tensors),
    as scipy's ``CubicSpline(bc_type="natural")``: the second-derivative
    coefficients solve the tridiagonal system with natural end conditions.
    ``coefficients`` may be given to skip the solve.  Calls work on any
    device and shape of points; outside the knots the end pieces
    extrapolate."""

    def __init__(self, x, y, coefficients=None):
        x, y = torch.atleast_1d(torch.as_tensor(x)), torch.atleast_1d(torch.as_tensor(y))
        if coefficients is None:
            h = torch.diff(x)
            p = torch.diff(y)
            one, zero = x.new_ones(1), x.new_zeros(1)
            main = torch.cat([one, 2.0 * (h[:-1] + h[1:]), one])
            up = torch.cat([zero, h[1:]])
            lo = torch.cat([h[:-1], -one])
            A = torch.diag(main) + torch.diag(up, 1) + torch.diag(lo, -1)
            rhs = torch.cat([zero, 3.0 * (p[1:] / h[1:] - p[:-1] / h[:-1]), zero])
            coefficients = torch.linalg.solve(A, rhs)
        self.k = 3
        self._x, self._y, self._coefficients = x, y, coefficients

    def __call__(self, x):
        knots, y, c = self._x, self._y, self._coefficients
        # jnp.digitize(x, knots): bins[i-1] <= x < bins[i], i.e. right=True
        ind = torch.clamp(torch.bucketize(x, knots, right=True) - 1, 0, knots.shape[0] - 2)
        t = x - knots[ind]
        h = torch.diff(knots)[ind]
        ci, c1 = c[ind], c[ind + 1]
        a, a1 = y[ind], y[ind + 1]
        b = (a1 - a) / h - (2.0 * ci + c1) * h / 3.0
        d = (c1 - ci) / (3.0 * h)
        return a + b * t + ci * t**2 + d * t**3


def _default_knots(n_df, order, xrange, interior_knots=None):
    """Uniform knots with ``order - 1`` exterior knots at the same spacing on
    each side."""
    if interior_knots is None:
        interior_knots = np.linspace(xrange[0], xrange[1], n_df - order + 2)
    interior_knots = np.asarray(interior_knots)
    dx = interior_knots[1] - interior_knots[0]
    knots = np.linspace(
        xrange[0] - dx * (order - 1),
        xrange[1] + dx * (order - 1),
        len(interior_knots) + (order - 1) * 2,
    )
    return knots, interior_knots


def _contract(coefs, bases):
    """``einsum("ck,k...->c...")``: ``(C, K) @ (K, ...)`` -> ``(C, ...)``."""
    K = bases.shape[0]
    return (coefs @ bases.reshape(K, -1)).reshape((coefs.shape[0],) + tuple(bases.shape[1:]))


class BasisSpline:
    """M-spline basis, normalized through the per-basis volumes.

    ``device`` and ``dtype`` are where the cached normalization terms live
    (CUDA unless asked otherwise); design matrices from :meth:`bases` are host
    numpy until the caller moves them.
    """

    def __init__(self, n_df, knots=None, interior_knots=None, xrange=(0, 1), k=4, normalize=True,
                 device=None, dtype=torch.float32):
        self.order = k
        self.N = n_df
        self.xrange = tuple(xrange)
        self.device = resolve_device(device)
        self.dtype = dtype
        if knots is None:
            knots, interior_knots = _default_knots(n_df, k, xrange, interior_knots)
        self.knots = np.asarray(knots)
        self.interior_knots = interior_knots
        if self.knots.shape[0] != self.N + self.order:
            raise ValueError(f"{self.knots.shape[0]} knots for {self.N} bases of order {self.order}")
        self.normalize = normalize
        self.basis_vols = np.ones(self.N)
        if normalize:
            self.grid = np.linspace(*self.xrange, 1000)
            self.grid_bases = self.bases(self.grid)
            dx = np.diff(self.grid)
            self.basis_vols = (0.5 * (self.grid_bases[:, 1:] + self.grid_bases[:, :-1]) * dx).sum(-1)
        self._basis_vols_t = self._to_device(self.basis_vols)

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _design(self, xs):
        return mspline_design_matrix(xs, self.knots, self.order)

    def bases(self, xs):
        """Design matrix at ``xs`` (host float64), 0 outside ``xrange``:
        ``(N, *xs.shape)``."""
        xs = np.asarray(xs, dtype=np.float64)
        dm = self._design(xs)
        oob = (xs < self.xrange[0]) | (xs > self.xrange[1])
        return np.where(oob, 0.0, dm)

    def norm(self, coefs):
        """``1 / sum(basis_vols * coefs)`` per chain: ``(C,)``."""
        if not self.normalize:
            return 1.0
        return 1.0 / (self._basis_vols_t * coefs).sum(-1)

    def project(self, bases, coefs):
        """Sum-normalized coefficients projected on ``bases``: ``(C, ...)``."""
        coefs = coefs / coefs.sum(-1, keepdim=True)
        out = _contract(coefs, bases)
        norm = self.norm(coefs)
        if isinstance(norm, torch.Tensor):
            norm = norm.reshape((-1,) + (1,) * (out.ndim - 1))
        return out * norm

    def eval(self, xs, coefs):
        """The curve at ``xs``: :meth:`project` of :meth:`bases` ``(xs)``,
        on the basis' device in its dtype.  ``coefs`` ``(C, N)`` gives ``(C,
        *xs.shape)``; a single ``(N,)`` vector gives ``xs.shape``."""
        coefs = torch.as_tensor(coefs, dtype=self.dtype, device=self.device)
        out = self.project(self._to_device(self.bases(xs)), coefs.reshape(-1, self.N))
        return out[0] if coefs.ndim == 1 else out

    def __call__(self, xs, coefs):
        return self.eval(xs, coefs)

    def get_coefficients(self, xs, ys):
        """Least-squares coefficients of the basis to data ``ys`` at 1-D
        ``xs``, in float64 on the host: ``(alpha (N,), fit (n,), design (n,
        N))``, the fit being ``design @ alpha``."""
        design = torch.as_tensor(self.bases(xs).T, dtype=torch.float64)
        ys = torch.as_tensor(np.asarray(ys, dtype=np.float64))
        alpha = torch.linalg.lstsq(design, ys[:, None]).solution[:, 0]
        return alpha, design @ alpha, design


class BSpline(BasisSpline):
    """B-spline basis (a partition of unity), normalized by the trapezoid of
    the projected curve over a cached grid."""

    def __init__(self, n_df, knots=None, interior_knots=None, xrange=(0, 1), k=4, normalize=False, **kwargs):
        super().__init__(n_df, knots=knots, interior_knots=interior_knots, xrange=xrange, k=k,
                         normalize=normalize, **kwargs)
        self._set_grid_tensors()

    def _set_grid_tensors(self):
        """The normalization grid and its design matrix on the device."""
        if self.normalize:
            self._grid_t = self._to_device(self.grid)
            self._grid_bases_t = self._to_device(self.grid_bases)

    def _design(self, xs):
        return bspline_design_matrix(xs, self.knots, self.order)

    def _project(self, bases, coefs):
        return _contract(coefs, bases)

    def norm(self, coefs):
        """``1 / trapezoid`` of the projected curve over the grid: ``(C,)``."""
        if not self.normalize:
            return 1.0
        return 1.0 / torch.trapezoid(self._project(self._grid_bases_t, coefs), self._grid_t, dim=-1)

    def project(self, bases, coefs):
        out = self._project(bases, coefs)
        norm = self.norm(coefs)
        if isinstance(norm, torch.Tensor):
            norm = norm.reshape((-1,) + (1,) * (out.ndim - 1))
        return out * norm


class LogXBSpline(BSpline):
    """B-spline in ``log x``: knots and evaluation in the log domain, the
    normalization grid linear in ``x`` (the trapezoid measure is dx)."""

    def __init__(self, n_df, knots=None, interior_knots=None, xrange=(0.01, 1), normalize=True, **kwargs):
        knots = None if knots is None else np.log(knots)
        interior_knots = None if interior_knots is None else np.log(interior_knots)
        log_xrange = tuple(np.log(xrange))
        super().__init__(n_df, knots=knots, interior_knots=interior_knots, xrange=log_xrange, normalize=False, **kwargs)
        self.normalize = normalize
        if normalize:
            self.grid = np.linspace(*np.exp(log_xrange), 1000)
            self.grid_bases = self.bases(self.grid)
            self._set_grid_tensors()

    def bases(self, xs):
        return super().bases(np.log(np.asarray(xs, dtype=np.float64)))


class LogYBSpline(BSpline):
    """B-spline whose curve is ``exp(sum c_i B_i)``; ``-inf`` design entries
    outside ``xrange``."""

    def __init__(self, n_df, knots=None, interior_knots=None, xrange=(0, 1), normalize=True, **kwargs):
        super().__init__(n_df, knots=knots, interior_knots=interior_knots, xrange=xrange, normalize=False, **kwargs)
        self.normalize = normalize
        if normalize:
            self.grid = np.linspace(*self.xrange, 1000)
            self.grid_bases = self.bases(self.grid)
            self._set_grid_tensors()

    def _project(self, bases, coefs):
        logvals = torch.nan_to_num(_contract(coefs, bases), nan=-torch.inf, posinf=-torch.inf)
        return torch.exp(logvals)

    def bases(self, xs):
        xs = np.asarray(xs, dtype=np.float64)
        dm = super().bases(xs)
        oob = (xs < self.xrange[0]) | (xs > self.xrange[1])
        return np.where(oob, -np.inf, dm)


class LogXLogYBSpline(LogYBSpline):
    """B-spline in log-log space (the production primary-mass basis):
    log-domain knots, exp-projected curve, a 1500-point grid linear in x."""

    def __init__(self, n_df, knots=None, interior_knots=None, xrange=(0.1, 1), normalize=True, **kwargs):
        knots = None if knots is None else np.log(knots)
        interior_knots = None if interior_knots is None else np.log(interior_knots)
        log_xrange = tuple(np.log(xrange))
        super().__init__(n_df, knots=knots, interior_knots=interior_knots, xrange=log_xrange, normalize=False, **kwargs)
        self.normalize = normalize
        if normalize:
            self.grid = np.linspace(*np.exp(log_xrange), 1500)
            self.grid_bases = self.bases(self.grid)
            self._set_grid_tensors()

    def bases(self, xs):
        logxs = np.log(np.asarray(xs, dtype=np.float64))
        dm = BSpline.bases(self, logxs)
        oob = (logxs < self.xrange[0]) | (logxs > self.xrange[1])
        return np.where(oob, -np.inf, dm)


class RectBivariateBasisSpline:
    """2-D tensor-product basis spline: the surface ``exp(sum_ij c_ij
    Bx_i(x) By_j(y))``, normalized by a 2-D trapezoid over a 750 x 750 grid.

    ``bases(xs, ys)`` is host float64 ``(xdf, ydf, *xs.shape)``;
    ``project(bases, coefs)`` takes coefficients ``(C, xdf, ydf)`` and
    returns ``(C, *xs.shape)``.  The grid's bases, ``(xdf, ydf, 750, 750)``
    (1.15 GB in float64 at 16 x 16), are built on ``device`` at the first
    normalization, not at construction.
    """

    def __init__(self, xdf, ydf, xrange=(0, 1), yrange=(0, 1), kx=4, ky=4, xbasis=BSpline, ybasis=BSpline,
                 normalize=True, device=None, dtype=torch.float32):
        self.xdf, self.ydf = xdf, ydf
        self.device = resolve_device(device)
        self.dtype = dtype
        kw = dict(normalize=False, device=self.device, dtype=dtype)
        self.x_interpolator = xbasis(xdf, xrange=xrange, k=kx, **kw)
        self.y_interpolator = ybasis(ydf, xrange=yrange, k=ky, **kw)
        self.normalize = normalize
        if normalize:
            self.gridx = np.linspace(*xrange, 750)
            self.gridy = np.linspace(*yrange, 750)
            self.gxx, self.gyy = np.meshgrid(self.gridx, self.gridy)
        self._grid = None

    def bases(self, xs, ys):
        """Outer-product design tensor (host float64), ``(xdf, ydf, *xs.shape)``."""
        return np.einsum("i...,j...->ij...", self.x_interpolator.bases(xs), self.y_interpolator.bases(ys))

    def _grid_tensors(self):
        """The normalization grid and its bases on the device, built once."""
        if self._grid is None:
            bx = torch.as_tensor(self.x_interpolator.bases(self.gxx), dtype=self.dtype, device=self.device)
            by = torch.as_tensor(self.y_interpolator.bases(self.gyy), dtype=self.dtype, device=self.device)
            self._grid = (
                torch.einsum("i...,j...->ij...", bx, by),
                torch.as_tensor(self.gridx, dtype=self.dtype, device=self.device),
                torch.as_tensor(self.gridy, dtype=self.dtype, device=self.device),
            )
        return self._grid

    @property
    def grid_bases(self):
        return self._grid_tensors()[0]

    def _project(self, bases, coefs):
        bases = torch.as_tensor(bases, dtype=coefs.dtype, device=coefs.device)
        n = self.xdf * self.ydf
        out = coefs.reshape(coefs.shape[0], n) @ bases.reshape(n, -1)
        return torch.exp(out.reshape((coefs.shape[0],) + tuple(bases.shape[2:])))

    def norm_2d(self, coefs):
        """``1 / (2-D trapezoid of the surface over the grid)``: ``(C,)``."""
        if not self.normalize:
            return 1.0
        grid_bases, gx, gy = self._grid_tensors()
        surface = self._project(grid_bases, coefs)  # (C, y, x)
        return 1.0 / torch.trapezoid(torch.trapezoid(surface, gy, dim=-2), gx, dim=-1)

    def project(self, bases, coefs):
        out = self._project(bases, coefs)
        norm = self.norm_2d(coefs)
        if isinstance(norm, torch.Tensor):
            norm = norm.reshape((-1,) + (1,) * (out.ndim - 1))
        return out * norm
