"""CPU float64 parity of the rest of the port's model library with the JAX
package: the natural cubic spline (and scipy's), the 2-D tensor-product
basis, the difference penalty, the remaining 1-D B-spline models, the
separable models and hybrids, the spline-perturbation mass models, the
independent spin setup and priors, the reference-style B-spline model with
independent spins on its linear and log routes, and the production B-spline
log density against the independent scipy/numpy implementation
(``tools/parity/independent_bspline_density.py``).

Data: the first 200 PE samples of each event of
``tests/data/pe_inj_synthetic.h5`` and its found injections, read directly
(never through the conftest fixtures that run the generator).

Tolerances: pdfs rtol 1e-10; model log densities, potentials and gradients
rtol 1e-9 (sums over ~10^4 terms in another order); the independent
density up to one constant, spread below 1e-4 (the JAX package's bound in
``tests/pipeline/test_bspline_density_parity.py``).
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from gwinferno_tpu import interpolation as jinterp
from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.distributions import safe_log as jsafe_log
from gwinferno_tpu.models.bsplines import separable as jsep
from gwinferno_tpu.models.bsplines import single as jsingle
from gwinferno_tpu.models.bsplines import smoothing as jsmoothing
from gwinferno_tpu.models import spline_perturbation as jsp
from gwinferno_tpu.pipeline import analysis as janalysis
from gwinferno_tpu.pipeline import utils as jutils
from gwinferno_tpu.ppl import distributions as jd
from gwinferno_tpu_torch import interpolation
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.cosmology import PLANCK_2015_LVK_Cosmology
from gwinferno_tpu_torch.models import spline_perturbation as tsp
from gwinferno_tpu_torch.models.bsplines import separable as tsep
from gwinferno_tpu_torch.models.bsplines import single as tsingle
from gwinferno_tpu_torch.models.bsplines import smoothing
from gwinferno_tpu_torch.ops import fused
from gwinferno_tpu_torch.pipeline import utils
from gwinferno_tpu_torch.pipeline.bspline_model import BSplineModel
from gwinferno_tpu_torch.pipeline.bspline_model import build_bspline_models
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from tools.parity.independent_bspline_density import IndependentBSplineDensity  # noqa: E402

CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)
PDF_RTOL, MODEL_RTOL = 1e-10, 1e-9
C = 3


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def data():
    """The catalog slice with the derived columns ``mass_2``, ``chi_eff``
    and ``chi_p`` on both banks."""
    pe, inj, const, names = utils.load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:, :200]) for k, v in pe.items()}
    pe.update(chip_smoke.derived_columns(pe))
    inj = dict(inj, **chip_smoke.derived_columns(inj))
    return SimpleNamespace(pe=pe, inj=inj, const=const, names=names)


def _parity(got, want, rtol=PDF_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=1e-300)


# ------------------------------------------------------------------ interpolation


def test_natural_cubic_spline_at_and_between_knots():
    """Against the JAX package at the knots (where ``digitize`` and the
    default ``bucketize`` differ), between them and beyond both ends; and
    against scipy's natural spline as the JAX package's own test holds its
    spline (uniform knots, left of 0.7: the reference's last row sets
    ``c[n-1] = c[n-2]`` where scipy's natural condition sets it to 0)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 10.0, 12))
    y = np.sin(x) + 0.1 * rng.standard_normal(12)
    port = interpolation.NaturalCubicUnivariateSpline(_t(x), _t(y))
    ref = jinterp.NaturalCubicUnivariateSpline(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(port._coefficients.numpy(), np.asarray(ref._coefficients), rtol=1e-12, atol=1e-14)
    pts = np.concatenate([x, 0.5 * (x[1:] + x[:-1]), rng.uniform(x[0], x[-1], 200), [x[0] - 0.3, x[-1] + 0.4]])
    got = port(_t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(pts))), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(port(_t(x)).numpy(), y, rtol=1e-12, atol=1e-13)
    # right=False would take the piece to the left of each knot
    assert not np.allclose(torch.bucketize(_t(x), _t(x)).numpy(), torch.bucketize(_t(x), _t(x), right=True).numpy())
    again = interpolation.NaturalCubicUnivariateSpline(_t(x), _t(y), coefficients=port._coefficients)
    assert torch.equal(again(_t(pts)), port(_t(pts)))
    gr = np.linspace(0, 1, 1000)
    for n in (20, 25, 30):
        xs, ys = np.linspace(0, 1, n), rng.standard_normal(n)
        want = CubicSpline(xs, ys, bc_type="natural")(gr)
        spline = interpolation.NaturalCubicUnivariateSpline(_t(xs), _t(ys))
        assert np.all(np.abs((want - spline(_t(gr)).numpy())[gr < 0.7]) < 5e-4)


def test_rect_bivariate_basis_spline_at_6_by_5():
    rng = np.random.default_rng(1)
    kw = dict(xrange=(0.0, 2.0), yrange=(-1.0, 1.0))
    port = interpolation.RectBivariateBasisSpline(6, 5, **kw, **F64)
    ref = jinterp.RectBivariateBasisSpline(6, 5, **kw)
    assert port._grid is None  # the grid's bases wait for the first normalization
    xs, ys = rng.uniform(0.0, 2.0, (4, 30)), rng.uniform(-1.0, 1.0, (4, 30))
    bases = port.bases(xs, ys)
    assert bases.shape == (6, 5, 4, 30)
    np.testing.assert_allclose(bases, np.asarray(ref.bases(xs, ys)), rtol=1e-12, atol=1e-15)
    coefs = 0.3 * rng.standard_normal((C, 6, 5))
    got = port.project(bases, _t(coefs))
    assert port.grid_bases.shape == (6, 5, 750, 750) and port.grid_bases.device.type == "cpu"
    for c in range(C):
        _parity(got[c], ref.project(jnp.asarray(bases), jnp.asarray(coefs[c])))
        np.testing.assert_allclose(float(port.norm_2d(_t(coefs))[c]), float(ref.norm_2d(jnp.asarray(coefs[c]))),
                                   rtol=PDF_RTOL)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_difference_penalty_matrix(degree):
    np.testing.assert_allclose(smoothing.difference_penalty_matrix(9, degree),
                               np.asarray(jsmoothing.difference_penalty_matrix(9, degree)), rtol=0, atol=0)
    c = np.random.default_rng(2).standard_normal(9)
    P = smoothing.difference_penalty_matrix(9, degree)
    np.testing.assert_allclose(-0.5 * 2.0 * c @ P @ c, float(smoothing.apply_difference_prior(_t(c)[None], 2.0,
                                                                                                  degree)[0]), rtol=1e-12)


# ------------------------------------------------------------------ models, case by case


def _coefs(rng, *sizes, scale=0.4):
    return [scale * rng.standard_normal((C, n)) for n in sizes]


def _case_redshift(d, rng):
    dv, dv_inj = PLANCK_2015_LVK_Cosmology.dVcdz(d.pe["redshift"]), PLANCK_2015_LVK_Cosmology.dVcdz(d.inj["redshift"])
    args = (7, d.pe["redshift"], d.inj["redshift"], dv, dv_inj)
    (cs,) = _coefs(rng, 7)
    return tsingle.BSplineRedshift(*args, **F64), jsingle.BSplineRedshift(*args), [cs], []


def _case_1d(cls_name, key):
    def case(d, rng):
        args = (8, d.pe[key], d.inj[key])
        (cs,) = _coefs(rng, 8)
        return getattr(tsingle, cls_name)(*args, **F64), getattr(jsingle, cls_name)(*args), [cs], []
    return case


def _case_spin_dims(d, rng):
    args = (7, 6, d.pe["chi_eff"], d.pe["chi_p"], d.inj["chi_eff"], d.inj["chi_p"])
    return tsep.BSplineEffectiveSpinDims(*args, **F64), jsep.BSplineEffectiveSpinDims(*args), _coefs(rng, 7, 6), []


def _case_independent(tcls, jcls, keys):
    def case(d, rng):
        args = (7, 6, d.pe[keys[0]], d.pe[keys[1]], d.inj[keys[0]], d.inj[keys[1]])
        return tcls(*args, **F64), jcls(*args), _coefs(rng, 7, 6), []
    return case


def _case_iid_masses(d, rng):
    args = (9, d.pe["mass_1"], d.pe["mass_2"], d.inj["mass_1"], d.inj["mass_2"])
    kw = dict(mmin=3.0, mmax=100.0)
    beta = rng.uniform(-1.0, 2.0, C)
    return (tsep.BSplineIIDComponentMasses(*args, **kw, **F64), jsep.BSplineIIDComponentMasses(*args, **kw),
            _coefs(rng, 9), [("beta", beta)])


def _case_independent_masses(d, rng):
    args = (9, 7, d.pe["mass_1"], d.pe["mass_2"], d.inj["mass_1"], d.inj["mass_2"])
    kw = dict(mmin1=3.0, mmax1=100.0, mmin2=3.0, mmax2=90.0)
    beta = rng.uniform(-1.0, 2.0, C)
    return (tsep.BSplineIndependentComponentMasses(*args, **kw, **F64),
            jsep.BSplineIndependentComponentMasses(*args, **kw), _coefs(rng, 9, 7), [("beta", beta)])


MODEL_CASES = {
    "BSplineRedshift": _case_redshift,
    "BSplineChiEffective": _case_1d("BSplineChiEffective", "chi_eff"),
    "BSplineSymmetricChiEffective": _case_1d("BSplineSymmetricChiEffective", "chi_eff"),
    "BSplineChiPrecess": _case_1d("BSplineChiPrecess", "chi_p"),
    "BSplineEffectiveSpinDims": _case_spin_dims,
    "BSplineIndependentSpinMagnitudes": _case_independent(tsep.BSplineIndependentSpinMagnitudes,
                                                          jsep.BSplineIndependentSpinMagnitudes, ("a_1", "a_2")),
    "BSplineIndependentSpinTilts": _case_independent(tsep.BSplineIndependentSpinTilts, jsep.BSplineIndependentSpinTilts,
                                                     ("cos_tilt_1", "cos_tilt_2")),
    "BSplineIIDComponentMasses": _case_iid_masses,
    "BSplineIndependentComponentMasses": _case_independent_masses,
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_spline_models_match_jax(data, name):
    """Each model's pdf on both banks, per chain, and the gradient of its
    summed log over the PE bank with respect to the coefficients."""
    port, ref, coefs, hyper = MODEL_CASES[name](data, np.random.default_rng(3))
    for pe_samples in (True, False):
        got = port(*[_t(c) for c in coefs], **{k: _t(v) for k, v in hyper}, pe_samples=pe_samples)
        for c in range(C):
            want = ref(*[jnp.asarray(v[c]) for v in coefs], **{k: v[c] for k, v in hyper}, pe_samples=pe_samples)
            _parity(got[c], want)
        assert bool(torch.isfinite(got).all())
    tc = [_t(c).requires_grad_(True) for c in coefs]
    total = _log_sum(port(*tc, **{k: _t(v) for k, v in hyper}))
    grads = torch.autograd.grad(total, tc)
    for c in range(C):
        jg = jax.grad(lambda *cs: _jax_log_sum(ref(*cs, **{k: v[c] for k, v in hyper})),
                      argnums=tuple(range(len(coefs))))(*[jnp.asarray(v[c]) for v in coefs])
        for g, w in zip(grads, jg):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w), rtol=MODEL_RTOL, atol=1e-9 * float(np.abs(w).max()))


def _log_sum(p):
    """Sum of the logs of the positive values (a linear B-spline may go
    negative)."""
    return torch.where(p > 0, torch.log(torch.where(p > 0, p, 1.0)), 0.0).sum()


def _jax_log_sum(p):
    return jnp.sum(jnp.where(p > 0, jnp.log(jnp.where(p > 0, p, 1.0)), 0.0))


def test_hybrid_models_match_jax(data):
    """``BSplinePrimaryPowerlawRatio`` and ``PLPeakPrimaryBSplineRatio`` with
    ``(C,)`` hyperparameters against the JAX package per chain."""
    rng = np.random.default_rng(4)
    d = data
    pm = tsep.BSplinePrimaryPowerlawRatio(9, d.pe["mass_1"], d.inj["mass_1"], mmin=3.0, mmax=100.0, **F64)
    jm = jsep.BSplinePrimaryPowerlawRatio(9, d.pe["mass_1"], d.inj["mass_1"], mmin=3.0, mmax=100.0)
    pq = tsep.PLPeakPrimaryBSplineRatio(7, d.pe["mass_ratio"], d.inj["mass_ratio"], **F64)
    jq = jsep.PLPeakPrimaryBSplineRatio(7, d.pe["mass_ratio"], d.inj["mass_ratio"])
    (mcs,), (qcs,) = _coefs(rng, 9), _coefs(rng, 7)
    beta, mmin = rng.uniform(-1, 2, C), rng.uniform(3.0, 5.0, C)
    hp = dict(alpha=rng.uniform(-3, -1.5, C), mmin=rng.uniform(3.0, 6.0, C), mmax=rng.uniform(80, 100, C),
              peak_mean=rng.uniform(25, 40, C), peak_sd=rng.uniform(2, 8, C), peak_frac=rng.uniform(0.05, 0.5, C))
    for pe_samples, bank in ((True, d.pe), (False, d.inj)):
        m1, q = _t(bank["mass_1"]), _t(bank["mass_ratio"])
        got = pm(m1, q, _t(beta), _t(mmin), _t(mcs), pe_samples=pe_samples)
        got_q = pq(m1, *[_t(v) for v in hp.values()], _t(qcs), pe_samples=pe_samples)
        for c in range(C):
            _parity(got[c], jm(jnp.asarray(bank["mass_1"]), jnp.asarray(bank["mass_ratio"]), beta[c], mmin[c],
                               jnp.asarray(mcs[c]), pe_samples=pe_samples))
            _parity(got_q[c], jq(jnp.asarray(bank["mass_1"]), *[v[c] for v in hp.values()], jnp.asarray(qcs[c]),
                                 pe_samples=pe_samples))
    # numbers for the hyperparameters, as the JAX package's callers pass them
    got = pm(_t(d.pe["mass_1"]), _t(d.pe["mass_ratio"]), 0.5, 4.0, _t(mcs))
    _parity(got[1], jm(jnp.asarray(d.pe["mass_1"]), jnp.asarray(d.pe["mass_ratio"]), 0.5, 4.0, jnp.asarray(mcs[1])))


def test_spline_perturbation_models_match_jax(data):
    rng = np.random.default_rng(5)
    d = data
    pm = tsp.PowerlawBasisSplinePrimaryPowerlawRatio(8, d.pe["mass_1"], d.inj["mass_1"], mmin=3.0, m2min=3.0,
                                                     mmax=100.0, **F64)
    jm = jsp.PowerlawBasisSplinePrimaryPowerlawRatio(8, d.pe["mass_1"], d.inj["mass_1"], mmin=3.0, m2min=3.0,
                                                     mmax=100.0)
    np.testing.assert_allclose(pm.knots, jm.knots, rtol=0, atol=0)
    pr = tsp.PowerlawBasisSplinePrimaryRatio(8, 6, d.pe["mass_1"], d.pe["mass_ratio"], d.inj["mass_1"],
                                             d.inj["mass_ratio"], mmin=3.0, mmax=100.0, **F64)
    jr = jsp.PowerlawBasisSplinePrimaryRatio(8, 6, d.pe["mass_1"], d.pe["mass_ratio"], d.inj["mass_1"],
                                             d.inj["mass_ratio"], mmin=3.0, mmax=100.0)
    np.testing.assert_allclose(pr.qknots, jr.qknots, rtol=0, atol=0)
    (cs,), (vs,) = _coefs(rng, 8, scale=0.3), _coefs(rng, 6, scale=0.3)
    alpha, beta, mmax = rng.uniform(1.5, 3.0, C), rng.uniform(-1, 2, C), rng.uniform(80.0, 100.0, C)
    ms = np.linspace(2.0, 10.0, 50)
    for c in range(C):
        np.testing.assert_allclose(pm.smoothing(_t(ms), 3.0, 4.0).numpy(), np.asarray(jm.smoothing(jnp.asarray(ms), 3.0,
                                                                                                      4.0)), rtol=PDF_RTOL)
    for bank in (d.pe, d.inj):
        m1, q = _t(bank["mass_1"]), _t(bank["mass_ratio"])
        got = pm(m1, q, alpha=_t(alpha), mmin=3.0, mmax=_t(mmax), cs=_t(cs), beta=_t(beta))
        got_r = pr(m1, q, alpha=_t(alpha), mmax=_t(mmax), cs=_t(cs), beta=_t(beta), vs=_t(vs))
        for c in range(C):
            jm1, jq = jnp.asarray(bank["mass_1"]), jnp.asarray(bank["mass_ratio"])
            _parity(got[c], jm(jm1, jq, alpha=alpha[c], mmin=3.0, mmax=mmax[c], cs=jnp.asarray(cs[c]), beta=beta[c]))
            _parity(got_r[c], jr(jm1, jq, alpha=alpha[c], mmax=mmax[c], cs=jnp.asarray(cs[c]), beta=beta[c],
                                 vs=jnp.asarray(vs[c])))
    norm = pr.norm_pm1q(_t(alpha), 3.0, _t(mmax), _t(cs), _t(beta), _t(vs))
    for c in range(C):
        np.testing.assert_allclose(float(norm[c]), float(jr.norm_pm1q(alpha[c], 3.0, mmax[c], jnp.asarray(cs[c]),
                                                                      beta[c], jnp.asarray(vs[c]))), rtol=PDF_RTOL)


# ------------------------------------------------------------------ setup and priors


def test_independent_spin_setup_and_priors_match_jax(data):
    d = data
    port = utils.setup_bspline_spin_models(d.pe, d.inj, 7, 6, iid=False, **F64)
    ref = jutils.setup_bspline_spin_models(d.pe, d.inj, 7, 6, iid=False)
    assert isinstance(port[0], tsep.BSplineIndependentSpinMagnitudes)
    assert isinstance(port[1], tsep.BSplineIndependentSpinTilts)
    rng = np.random.default_rng(6)
    for pm, jm in zip(port, ref):
        c1, c2 = (_coefs(rng, pm.primary_model.n_splines)[0], _coefs(rng, pm.secondary_model.n_splines)[0])
        got = pm(_t(c1), _t(c2))
        for c in range(C):
            _parity(got[c], jm(jnp.asarray(c1[c]), jnp.asarray(c2[c])))
    for reparam in ("centered", "whitened"):
        sfx = "_white" if reparam == "whitened" else ""
        params = {k + sfx: 0.5 * rng.standard_normal((C, n))
                  for k, n in (("a1_cs", 7), ("a2_cs", 7), ("tilt1_cs", 6), ("tilt2_cs", 6))}

        def tmodel():
            utils.bspline_spin_prior(a_nsplines=7, ct_nsplines=6, a_tau=25, ct_tau=25, IID=False, reparam=reparam)

        def jmodel():
            jutils.bspline_spin_prior(a_nsplines=7, ct_nsplines=6, a_tau=25, ct_tau=25, IID=False, reparam=reparam)

        got, tr = ppl.log_density(tmodel, params={k: _t(v) for k, v in params.items()})
        for c in range(C):
            want, jtr = jppl.log_density(jmodel, (), {}, {k: jnp.asarray(v[c]) for k, v in params.items()})
            np.testing.assert_allclose(float(got[c]), float(want), rtol=MODEL_RTOL)
            for k in ("a1_cs", "a2_cs", "tilt1_cs", "tilt2_cs"):
                np.testing.assert_allclose(tr[k]["value"][c].numpy(), np.asarray(jtr[k]["value"]), rtol=MODEL_RTOL)


# ------------------------------------------------------------------ the reference-style model


LIB_KNOTS = dict(m=10, q=6, a=6, ct=5, z=5)


@pytest.fixture(scope="module")
def library(data):
    """Both packages' models at small knots: B-spline m1 x q, independent
    spin pairs, the spline-perturbed redshift model."""
    d = data
    args = (d.pe["mass_1"], d.inj["mass_1"], d.pe["mass_ratio"], d.inj["mass_ratio"])
    mkw = dict(m1min=3.0, m2min=3.0, mmax=100.0)
    spin = lambda setup, **kw: setup(d.pe, d.inj, LIB_KNOTS["a"], LIB_KNOTS["ct"], iid=False, **kw)  # noqa: E731
    tm = {"mass": tsep.BSplinePrimaryBSplineRatio(LIB_KNOTS["m"], LIB_KNOTS["q"], *args, **mkw, **F64),
          "z": utils.setup_powerlaw_spline_redshift_model(d.pe, d.inj, LIB_KNOTS["z"], **F64)}
    tm["mag"], tm["tilt"] = spin(utils.setup_bspline_spin_models, **F64)
    jm = {"mass": jsep.BSplinePrimaryBSplineRatio(LIB_KNOTS["m"], LIB_KNOTS["q"], *args, **mkw),
          "z": jutils.setup_powerlaw_spline_redshift_model(d.pe, d.inj, LIB_KNOTS["z"])}
    jm["mag"], jm["tilt"] = spin(jutils.setup_bspline_spin_models)
    return tm, jm


def _jax_library_model(d, jm, log, reparam, min_neff_cut):
    """The JAX package's reference-style model (its B-spline model test)
    with independent spins added: linear weights at the likelihood's
    default ``log=False``, or per-factor log-weights with ``log=True``."""
    def model():
        mass_cs, q_cs = jutils.bspline_mass_prior(m_nsplines=LIB_KNOTS["m"], q_nsplines=LIB_KNOTS["q"], m_tau=1,
                                                  q_tau=1, reparam=reparam)
        a1, ct1, a2, ct2 = jutils.bspline_spin_prior(a_nsplines=LIB_KNOTS["a"], ct_nsplines=LIB_KNOTS["ct"], a_tau=25,
                                                     ct_tau=25, IID=False, reparam=reparam)
        z_cs = jutils.bspline_redshift_prior(z_nsplines=LIB_KNOTS["z"], z_tau=1, reparam=reparam)
        lamb = jppl.sample("lamb", jd.Normal(0.0, 3.0))

        def weights(bank, pe_samples):
            f = (jm["mass"](mass_cs, q_cs, pe_samples=pe_samples), jm["mag"](a1, a2, pe_samples=pe_samples),
                 jm["tilt"](ct1, ct2, pe_samples=pe_samples), jm["z"](bank["redshift"], lamb, z_cs))
            if log:
                lw = sum(jsafe_log(v) for v in f) - jnp.log(bank["prior"])
                return jnp.where(jnp.isnan(lw), -jnp.inf, lw)
            w = f[0] * f[1] * f[2] * f[3] / bank["prior"]
            return jnp.where(jnp.isnan(w) | jnp.isinf(w), 0.0, w)

        janalysis.hierarchical_likelihood(weights(d.pe, True), weights(d.inj, False), total_inj=d.const["total_inj"],
                                          Nobs=d.const["nObs"], Tobs=d.const["obs_time"],
                                          surveyed_hypervolume=jm["z"].normalization(lamb, z_cs),
                                          min_neff_cut=min_neff_cut, log=log)
    return model


def _library_params(rng, reparam, spread=1.0):
    """Constrained points ``(C, ...)``; ``spread`` scales the coefficients
    (the 200-sample slice puts flat populations off the ``min_neff`` walls
    more often than peaked ones)."""
    sfx = "_white" if reparam == "whitened" else ""
    sizes = {"mass_cs": LIB_KNOTS["m"], "q_cs": LIB_KNOTS["q"], "a1_cs": LIB_KNOTS["a"], "a2_cs": LIB_KNOTS["a"],
             "tilt1_cs": LIB_KNOTS["ct"], "tilt2_cs": LIB_KNOTS["ct"], "z_cs": LIB_KNOTS["z"] - 1}
    scale = spread * (0.5 if reparam == "whitened" else 0.25)
    params = {k + sfx: scale * rng.standard_normal((C, n)) for k, n in sizes.items()}
    params["lamb"] = 1.7 + 0.5 * rng.uniform(-1, 1, C)
    params["unscaled_rate"] = rng.uniform(40.0, 110.0, C)
    return params


def _jax_potential(model, params):
    u = jax.vmap(lambda q: jppl.unconstrain_fn(model, (), {}, q))({k: jnp.asarray(v) for k, v in params.items()})
    val, grad = jax.vmap(jax.value_and_grad(lambda uu: jppl.potential_energy(model, (), {}, uu)))(u)
    return np.asarray(val), np.asarray(jax.vmap(lambda g: jax.flatten_util.ravel_pytree(g)[0])(grad))


@pytest.mark.parametrize("min_neff_cut", [False, True], ids=["reference", "neff_cut"])
@pytest.mark.parametrize("reparam", ["centered", "whitened"])
@pytest.mark.parametrize("route", ["linear", "log"])
def test_reference_style_model_matches_jax(data, library, route, reparam, min_neff_cut):
    """The model's potential and gradient on each route against the JAX
    package's; on the CPU neither route launches K1's kernel."""
    tm, jm = library
    log = route == "log"
    model = chip_smoke.LibraryModel(data.pe, data.inj, data.const, tm, log=log, reparam=reparam,
                                    min_neff_cut=min_neff_cut)
    params = _library_params(np.random.default_rng(7), reparam, spread=0.5 if min_neff_cut else 1.0)
    pot = ModelPotential(model, **F64)
    before = fused.DLSE_KERNEL.launches
    u, g = pot.value_and_grad(params_from_jax(params, model, **F64))
    assert fused.DLSE_KERNEL.launches == before
    want_u, want_g = _jax_potential(_jax_library_model(data, jm, log, reparam, min_neff_cut), params)
    assert bool((u.abs() < 1e30).all()), "the points must sit off the likelihood walls"
    np.testing.assert_allclose(u.numpy(), want_u, rtol=MODEL_RTOL)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=MODEL_RTOL, atol=MODEL_RTOL * float(np.abs(want_g).max()))


def test_linear_and_log_routes_agree(data, library):
    """The two routes of one model give one likelihood: every diagnostic
    site and the potential's gradient."""
    tm, _ = library
    params = {k: _t(v) for k, v in _library_params(np.random.default_rng(8), "whitened").items()}
    traces = []
    for log in (False, True):
        with ppl.trace() as tr, ppl.substitute(data=params):
            chip_smoke.LibraryModel(data.pe, data.inj, data.const, tm, log=log)()
        traces.append(tr.trace)
    for name in ("log_l", "logBFs", "log_nEffs", "log_nEff_inj", "detection_efficiency", "rate",
                 "variance_log_likelihood"):
        torch.testing.assert_close(traces[0][name]["value"], traces[1][name]["value"], rtol=1e-9, atol=0.0)


# ------------------------------------------------------------------ the independent density


N_M, N_Q, N_A, N_CT, N_Z = 20, 12, 8, 8, 10


def test_production_bspline_density_matches_the_independent_implementation():
    """The port's production B-spline model (centered, the unfused route)
    against ``tools/parity/independent_bspline_density.py`` at six random
    points: one additive constant, as the JAX package's own parity test
    holds its model to it (600 PE samples an event)."""
    pe, inj, const, names = utils.load_pe_and_injections_as_dict(CATALOG)
    rng = np.random.default_rng(0)
    idx = rng.choice(pe["mass_1"].shape[1], size=600, replace=False)
    pe = {k: np.ascontiguousarray(v[:, idx]) for k, v in pe.items()}
    args = SimpleNamespace(m_nsplines=N_M, q_nsplines=N_Q, a_nsplines=N_A, tilt_nsplines=N_CT, z_nsplines=N_Z,
                           mmin=3.0, mmax=100.0)
    models = build_bspline_models(pe, inj, args, **F64)
    model = BSplineModel(pe, inj, const, models["mass"], models["mag"], models["tilt"], models["z"], 3.0, 100.0,
                         param_names=names)
    indep = IndependentBSplineDensity(pe, inj, const, n_m=N_M, n_q=N_Q, n_a=N_A, n_ct=N_CT, n_z=N_Z, mmin=3.0,
                                      mmax=100.0)
    points = [{
        "mass_cs": 0.4 * rng.standard_normal(N_M),
        "q_cs": 0.3 * rng.standard_normal(N_Q),
        "a_cs": 0.3 * rng.standard_normal(N_A),
        "tilt_cs": 0.3 * rng.standard_normal(N_CT),
        "z_cs": 0.2 * rng.standard_normal(N_Z - 1),
        "lamb": 1.7 + 0.8 * rng.uniform(-1, 1),
        "unscaled_rate": float(rng.uniform(40.0, 110.0)),
    } for _ in range(6)]
    batch = {k: _t(np.stack([np.asarray(p[k]) for p in points])) for k in points[0]}
    ld, _ = ppl.log_density(model, params=batch)
    deltas = ld.numpy() - np.array([indep(p) for p in points])
    assert np.isfinite(deltas).all(), deltas
    assert float(deltas.max() - deltas.min()) < 1e-4, deltas
