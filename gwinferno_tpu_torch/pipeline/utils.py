"""Loading the PE + injection catalog, the B-spline model setup and the
B-spline coefficient priors.

Counterpart of ``gwinferno_tpu/pipeline/utils.py``.  The loader returns host
numpy dicts; :func:`to_tensors` moves them to the asked device once.  The
setup helpers build the B-spline models with their design matrices on
``device`` (CUDA unless asked otherwise); the prior functions declare PPL
sites whose values carry a leading chain axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import ppl
from ..device import resolve_device
from ..models.bsplines.smoothing import apply_difference_prior
from ..models.bsplines.smoothing import prior_precision_cholesky
from ..ppl import distributions as dist
from ..utils.dataset import DataArray
from ..utils.dataset import Dataset
from ..utils.dataset import load_groups

__all__ = [
    "load_pe_and_injections_as_dict",
    "to_tensors",
    "setup_bspline_mass_models",
    "setup_bspline_spin_models",
    "setup_powerlaw_spline_redshift_model",
    "bspline_mass_prior",
    "bspline_spin_prior",
    "bspline_redshift_prior",
    "posterior_dict_to_xarray",
]


def load_pe_and_injections_as_dict(file, ignore=None):
    """Load the PE + injection catalog.

    Returns ``(pedict {param: (N_obs, N_samp)}, injdict {param: (N_found,)},
    constants {total_inj, obs_time, nObs}, param_names)``, all host numpy.
    """
    groups = load_groups(file)
    pe, inj = groups["pe_data"], groups["inj_data"]

    pe_arr = pe["posteriors"]
    params = [str(p) for p in pe_arr.coords["param"]]
    events = np.asarray(pe_arr.coords["event"])
    sel = ~np.isin(events, np.asarray(ignore)) if ignore is not None else np.ones(len(events), dtype=bool)
    p_axis = pe_arr.dims.index("param")
    pedict = {
        k: np.ascontiguousarray(np.take(pe_arr.data[sel], i, axis=p_axis)) for i, k in enumerate(params)
    }

    inj_arr = inj["injections"]
    inj_params = [str(p) for p in inj_arr.coords["param"]]
    injdict = {k: np.ascontiguousarray(inj_arr.data[i]) for i, k in enumerate(inj_params)}

    attrs = dict(inj_arr.attrs) or dict(inj.attrs)
    constants = {
        "total_inj": float(attrs["total_generated"]),
        "obs_time": float(attrs["analysis_time"]),
        "nObs": int(sel.sum()),
    }
    return pedict, injdict, constants, params


def to_tensors(arrays, device=None, dtype=torch.float32):
    """``{name: numpy array}`` -> ``{name: tensor}`` on ``device`` (CUDA
    unless asked otherwise) in ``dtype``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=dev) for k, v in arrays.items()}


# ------------------------------------------------------------- model setup


def setup_bspline_mass_models(pedict, injdict, nsplines_m, nsplines_q, mmin, mmax, m2min=None,
                              device=None, dtype=torch.float32):
    """The production mass model: LogXLogY B-spline m1 on [mmin, mmax] times
    LogY B-spline q on [m2min/mmax, 1], design matrices over both banks."""
    from ..models.bsplines.separable import BSplinePrimaryBSplineRatio

    return BSplinePrimaryBSplineRatio(
        nsplines_m,
        nsplines_q,
        pedict["mass_1"],
        injdict["mass_1"],
        pedict["mass_ratio"],
        injdict["mass_ratio"],
        m1min=mmin,
        m2min=m2min if m2min is not None else mmin,
        mmax=mmax,
        device=device,
        dtype=dtype,
    )


def setup_bspline_spin_models(pedict, injdict, nsplines_mag, nsplines_tilt, iid=True, device=None, dtype=torch.float32):
    """B-spline spin magnitude and tilt models: the IID pairs (shared
    coefficients), or with ``iid=False`` the independent pairs (one set of
    coefficients per component, ``nsplines_mag`` / ``nsplines_tilt`` each)."""
    from ..models.bsplines import separable

    kw = dict(device=device, dtype=dtype)
    a = (pedict["a_1"], pedict["a_2"], injdict["a_1"], injdict["a_2"])
    ct = (pedict["cos_tilt_1"], pedict["cos_tilt_2"], injdict["cos_tilt_1"], injdict["cos_tilt_2"])
    if iid:
        return (separable.BSplineIIDSpinMagnitudes(nsplines_mag, *a, **kw),
                separable.BSplineIIDSpinTilts(nsplines_tilt, *ct, **kw))
    return (separable.BSplineIndependentSpinMagnitudes(nsplines_mag, nsplines_mag, *a, **kw),
            separable.BSplineIndependentSpinTilts(nsplines_tilt, nsplines_tilt, *ct, **kw))


def setup_powerlaw_spline_redshift_model(pedict, injdict, nsplines_z, device=None, dtype=torch.float32):
    """Powerlaw times exp(B-spline) redshift model over both banks."""
    from ..models.spline_perturbation import PowerlawSplineRedshiftModel

    return PowerlawSplineRedshiftModel(nsplines_z, pedict["redshift"], injdict["redshift"], device=device, dtype=dtype)


# ------------------------------------------------------------- coefficient priors


@functools.lru_cache(maxsize=64)
def _whitening_factor(n, sig, tau, degree, drop_first, dtype, device):
    """The prior precision's Cholesky factor on ``device``, made once per
    configuration (so no host-to-device copy runs per gradient)."""
    L = prior_precision_cholesky(n, sig, tau, degree=degree, drop_first=drop_first)
    return torch.as_tensor(L, dtype=dtype, device=device)


def _coef_block(site, factor_site, n, sig, tau, degree, reparam, pin_first=False):
    """One B-spline coefficient block ``(C, n - pin_first)``.

    ``centered``: iid ``Normal(0, sig)`` site ``site`` plus the difference
    penalty ``factor_site`` (on the block with a leading zero when
    ``pin_first``).  ``whitened``: ``u ~ N(0, I)`` at ``site + "_white"`` and
    the deterministic site ``site`` holding ``c = L^{-T} u``, ``L`` the
    Cholesky factor of the prior precision ``I/sig^2 + tau D^T D``: exactly
    the centered prior, in isotropic coordinates.
    """
    if reparam == "whitened":
        m = n - int(pin_first)
        u = ppl.sample(site + "_white", dist.Normal(0.0, 1.0), sample_shape=(m,))
        L = _whitening_factor(n, float(sig), float(tau), degree, bool(pin_first), u.dtype, u.device)
        # rows of c solve c L = u, i.e. c = L^{-T} u per chain
        c = torch.linalg.solve_triangular(L, u, upper=False, left=False)
        return ppl.deterministic(site, c)
    if reparam != "centered":
        raise ValueError(f"unknown reparam {reparam!r}: expected 'centered' or 'whitened'")
    cs = ppl.sample(site, dist.Normal(0.0, sig), sample_shape=(n - int(pin_first),))
    padded = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1) if pin_first else cs
    ppl.factor(factor_site, apply_difference_prior(padded, tau, degree=degree))
    return cs


def bspline_mass_prior(m_nsplines=None, q_nsplines=None, m_tau=1, q_tau=1, name=None, m_cs_sig=15, q_cs_sig=5,
                       m_deg=1, q_deg=1, reparam="centered"):
    """Mass and mass-ratio coefficient priors with their smoothing
    penalties (the reference's site names and defaults)."""
    name = "_" + name if name is not None else ""
    mass_cs = q_cs = None
    if m_nsplines is not None:
        mass_cs = _coef_block("mass_cs" + name, "mass_smoothing_prior" + name, m_nsplines, m_cs_sig, m_tau, m_deg, reparam)
    if q_nsplines is not None:
        q_cs = _coef_block("q_cs" + name, "q_smoothing_prior" + name, q_nsplines, q_cs_sig, q_tau, q_deg, reparam)
    if m_nsplines is not None and q_nsplines is None:
        return mass_cs
    if m_nsplines is None and q_nsplines is not None:
        return q_cs
    if m_nsplines is None and q_nsplines is None:
        raise ValueError("number of mass splines or q splines must be specified.")
    return mass_cs, q_cs


def bspline_spin_prior(a_nsplines=None, ct_nsplines=None, a_tau=None, ct_tau=None, name=None, IID=False, a_cs_sig=5,
                       ct_cs_sig=5, a_deg=2, ct_deg=2, reparam="centered"):
    """Spin coefficient priors with their smoothing penalties: ``(a_cs,
    tilt_cs)`` when ``IID``, else ``(a1_cs, tilt1_cs, a2_cs, tilt2_cs)``."""
    name = "_" + name if name is not None else ""
    if IID:
        a_cs = _coef_block("a_cs" + name, "a_smoothing_prior" + name, a_nsplines, a_cs_sig, a_tau, a_deg, reparam)
        ct_cs = _coef_block("tilt_cs" + name, "ct_smoothing_prior" + name, ct_nsplines, ct_cs_sig, ct_tau, ct_deg, reparam)
        return a_cs, ct_cs
    a1_cs = _coef_block("a1_cs" + name, "a1_smoothing_prior" + name, a_nsplines, a_cs_sig, a_tau, a_deg, reparam)
    a2_cs = _coef_block("a2_cs" + name, "a2_smoothing_prior" + name, a_nsplines, a_cs_sig, a_tau, a_deg, reparam)
    ct1_cs = _coef_block("tilt1_cs" + name, "ct1_smoothing_prior" + name, ct_nsplines, ct_cs_sig, ct_tau, ct_deg, reparam)
    ct2_cs = _coef_block("tilt2_cs" + name, "ct2_smoothing_prior" + name, ct_nsplines, ct_cs_sig, ct_tau, ct_deg, reparam)
    return a1_cs, ct1_cs, a2_cs, ct2_cs


def bspline_redshift_prior(z_nsplines=None, z_tau=None, name=None, z_cs_sig=1, z_deg=2, reparam="centered"):
    """Redshift coefficient prior with the first coefficient pinned to 0:
    the site holds the ``n - 1`` free coefficients, the result ``(C, n)``
    has the zero prepended."""
    name = "_" + name if name is not None else ""
    z_cs = _coef_block("z_cs" + name, "z_smoothing_prior" + name, z_nsplines, z_cs_sig, z_tau, z_deg, reparam,
                       pin_first=True)
    return torch.cat([torch.zeros_like(z_cs[..., :1]), z_cs], dim=-1)


# ----------------------------------------------------------- result containers


def posterior_dict_to_xarray(posterior_dict, subpop_names=None):
    """Pack a posterior sample dict ``{name: (draws, ...)}`` (tensors or
    arrays) into a :class:`Dataset` with dims ``("draw", "{name}_dim0",
    ...)`` and a ``draw`` coordinate, the JAX package's layout."""
    variables = {}
    for k, v in posterior_dict.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        dims = ("draw",) + tuple(f"{k}_dim{i}" for i in range(v.ndim - 1))
        variables[k] = DataArray(v, dims, coords={"draw": np.arange(v.shape[0])})
    return Dataset(variables)
