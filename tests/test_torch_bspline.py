"""The port's B-spline production model on the CPU, float64, against the JAX
package: the bases, the smoothing priors, the model pdfs, the coefficient
priors (centered and whitened), ``FusedBSplineLikelihood`` and K3's plain
version, the whole model's potential and gradient on both routes, and
``MCMC.get_deterministic``.

Small knots (m1 12, q 8, a 6, tilt 6, z 6) and the first 200 PE samples of
each event of ``tests/data/pe_inj_synthetic.h5``, read directly (never
through the conftest fixtures that run the generator).

Tolerances: bases, norms and projections rtol 1e-12 (the same float64
arithmetic, sums in another order); pdfs and the prior log densities rtol
1e-10; the fused likelihood rtol 1e-10 (as ``tests/models/test_fused_path.py``);
the potential and its gradient rtol 1e-9 (sums over ~10^4 terms in another
order).
"""

import math
import os
import sys
from types import SimpleNamespace

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import interpolation as jinterp
from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.bsplines import smoothing as jsmoothing
from gwinferno_tpu.models.bsplines.fused_path import FusedBSplineLikelihood as JFused
from gwinferno_tpu.ops import fused as jfused
from gwinferno_tpu.pipeline import utils as jutils
from gwinferno_tpu_torch import interpolation
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.infer import MCMC
from gwinferno_tpu_torch.infer import NUTS
from gwinferno_tpu_torch.models.bsplines import smoothing
from gwinferno_tpu_torch.models.bsplines.fused_path import FusedBSplineLikelihood
from gwinferno_tpu_torch.ops import fused
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline import utils
from gwinferno_tpu_torch.pipeline.bspline_model import BSplineModel
from gwinferno_tpu_torch.pipeline.bspline_model import build_bspline_models
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
import chip_smoke  # noqa: E402
import simple_bspline_example as jex  # noqa: E402

CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)
KNOTS = dict(m_nsplines=12, q_nsplines=8, a_nsplines=6, tilt_nsplines=6, z_nsplines=6)
MMIN, MMAX = 3.0, 100.0
C = 3


@pytest.fixture(scope="module")
def problem():
    """The catalog slice and both packages' models over it."""
    pe, inj, const, names = utils.load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:, :200]) for k, v in pe.items()}
    args = SimpleNamespace(mmin=MMIN, mmax=MMAX, **KNOTS)
    jm = {
        "mass": jutils.setup_bspline_mass_models(pe, inj, args.m_nsplines, args.q_nsplines, MMIN, MMAX),
        "z": jutils.setup_powerlaw_spline_redshift_model(pe, inj, args.z_nsplines),
    }
    jm["mag"], jm["tilt"] = jutils.setup_bspline_spin_models(pe, inj, args.a_nsplines, args.tilt_nsplines, iid=True)
    return SimpleNamespace(pe=pe, inj=inj, const=const, names=names, args=args, jm=jm,
                           tm=build_bspline_models(pe, inj, args, **F64))


def _coef_draws(rng, sizes, scale=0.4):
    return {k: scale * rng.standard_normal((C, n)) for k, n in sizes.items()}


# ------------------------------------------------------------------ bases

BASES = {
    "BasisSpline": (interpolation.BasisSpline, jinterp.BasisSpline, dict(xrange=(0.0, 1.0)), (-0.2, 1.2)),
    "BSpline": (interpolation.BSpline, jinterp.BSpline, dict(xrange=(-1.0, 1.0), normalize=True), (-1.3, 1.3)),
    "LogXBSpline": (interpolation.LogXBSpline, jinterp.LogXBSpline, dict(xrange=(0.05, 2.0)), (0.01, 3.0)),
    "LogYBSpline": (interpolation.LogYBSpline, jinterp.LogYBSpline, dict(xrange=(0.0, 1.0)), (-0.2, 1.2)),
    "LogXLogYBSpline": (interpolation.LogXLogYBSpline, jinterp.LogXLogYBSpline, dict(xrange=(3.0, 100.0)), (1.0, 150.0)),
}


@pytest.mark.parametrize("name", list(BASES))
def test_bases_norms_and_projections_match_jax(name):
    cls, jcls, kw, (lo, hi) = BASES[name]
    n = 9
    port, ref = cls(n, **kw, **F64), jcls(n, **kw)
    rng = np.random.default_rng(0)
    # points inside and outside the range, and both range ends exactly
    xs = np.concatenate([rng.uniform(lo, hi, 200), np.asarray(kw["xrange"], dtype=np.float64)])
    got, want = port.bases(xs), np.asarray(ref.bases(xs))
    assert got.shape == want.shape == (n, xs.size)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    if name in ("LogYBSpline", "LogXLogYBSpline"):
        assert np.isneginf(got).any(), "out-of-range points give the -inf sentinel"
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-15)

    coefs = rng.normal(0.5 if name == "BasisSpline" else 0.0, 0.4, (C, n))
    if name == "BasisSpline":
        coefs = np.abs(coefs) + 0.1
    dm = got  # with the -inf sentinels where the basis has them
    proj = port.project(torch.tensor(dm), torch.tensor(coefs))
    norm = port.norm(torch.tensor(coefs))
    for c in range(C):
        jc = jnp.asarray(coefs[c])
        np.testing.assert_allclose(proj[c].numpy(), np.asarray(ref.project(jnp.asarray(dm), jc)), rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(float(norm[c]), float(ref.norm(jc)), rtol=1e-12)


def test_log_range_projection_maps_non_finite_logs_to_zero_density():
    """``0 * -inf = nan`` and ``-inf * c < 0 = +inf`` both become density 0,
    with a finite gradient at the in-range points."""
    port = interpolation.LogYBSpline(6, xrange=(0.0, 1.0), normalize=False, **F64)
    ref = jinterp.LogYBSpline(6, xrange=(0.0, 1.0), normalize=False)
    dm = port.bases(np.array([-0.5, 0.1, 0.5, 1.5]))
    coefs = np.array([[0.3, -0.2, 0.0, 0.4, -0.1, 0.2], [0.3, 0.2, 0.1, 0.4, 0.1, 0.2], [-0.3, -0.2, -0.1, -0.4, -0.1, -0.2]])
    got = port.project(torch.tensor(dm), torch.tensor(coefs))
    assert bool((got[:, [0, 3]] == 0).all()) and bool((got[:, 1:3] > 0).all())
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(ref.project(jnp.asarray(dm), jnp.asarray(coefs[c]))), rtol=1e-12)
    cg = torch.tensor(coefs, requires_grad=True)
    (g,) = torch.autograd.grad(port.project(torch.tensor(dm[:, 1:3]), cg).sum(), cg)
    jg = jax.grad(lambda cc: ref.project(jnp.asarray(dm[:, 1:3]), cc).sum())(jnp.asarray(coefs[1]))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g[1].numpy(), np.asarray(jg), rtol=1e-12)


# ------------------------------------------------------------- smoothing


@pytest.mark.parametrize("degree", [1, 2])
def test_smoothing_prior_and_cholesky_match_jax(degree):
    rng = np.random.default_rng(degree)
    cs = rng.normal(0.0, 2.0, (C, 11))
    got = smoothing.apply_difference_prior(torch.tensor(cs), 25.0, degree=degree)
    assert got.shape == (C,)
    for c in range(C):
        np.testing.assert_allclose(float(got[c]), float(jsmoothing.apply_difference_prior(jnp.asarray(cs[c]), 25.0, degree)), rtol=1e-12)
    for drop_first in (False, True):
        L = smoothing.prior_precision_cholesky(11, 5.0, 25.0, degree=degree, drop_first=drop_first)
        np.testing.assert_array_equal(L, jsmoothing.prior_precision_cholesky(11, 5.0, 25.0, degree=degree, drop_first=drop_first))


# ------------------------------------------------------------ model pdfs


def test_model_pdfs_match_jax(problem):
    p, jm, tm = problem, problem.jm, problem.tm
    rng = np.random.default_rng(3)
    cs = _coef_draws(rng, {"m": 12, "q": 8, "a": 6, "t": 6, "z": 6})
    lamb = 1.7 + 0.5 * rng.uniform(-1, 1, C)
    t = {k: torch.tensor(v) for k, v in cs.items()}
    for pe_samples, d in ((True, p.pe), (False, p.inj)):
        z_t = torch.tensor(d["redshift"])
        got = {
            "mass": tm["mass"](t["m"], t["q"], pe_samples=pe_samples),
            "mag": tm["mag"](t["a"], pe_samples=pe_samples),
            "tilt": tm["tilt"](t["t"], pe_samples=pe_samples),
            "z": tm["z"](z_t, torch.tensor(lamb), t["z"]),
            "z_log": tm["z"].log_prob(z_t, torch.tensor(lamb), t["z"]),
        }
        for c in range(C):
            j = {k: jnp.asarray(v[c]) for k, v in cs.items()}
            want = {
                "mass": jm["mass"](j["m"], j["q"], pe_samples=pe_samples),
                "mag": jm["mag"](j["a"], pe_samples=pe_samples),
                "tilt": jm["tilt"](j["t"], pe_samples=pe_samples),
                "z": jm["z"](d["redshift"], lamb[c], j["z"]),
                "z_log": jm["z"].log_prob(d["redshift"], lamb[c], j["z"]),
            }
            for k, w in want.items():
                np.testing.assert_allclose(got[k][c].numpy(), np.asarray(w), rtol=1e-10, atol=1e-300, err_msg=k)
    norm = tm["z"].normalization(torch.tensor(lamb), t["z"])
    for c in range(C):
        np.testing.assert_allclose(float(norm[c]), float(jm["z"].normalization(lamb[c], jnp.asarray(cs["z"][c]))), rtol=1e-12)


# -------------------------------------------------------- coefficient priors

N_PRIOR = dict(m=12, q=9, a=8, ct=8, z=7)


def _prior_model(prior_utils, reparam):
    def model():
        mass_cs, q_cs = prior_utils.bspline_mass_prior(m_nsplines=N_PRIOR["m"], q_nsplines=N_PRIOR["q"], reparam=reparam)
        a_cs, tilt_cs = prior_utils.bspline_spin_prior(a_nsplines=N_PRIOR["a"], ct_nsplines=N_PRIOR["ct"], a_tau=25,
                                                       ct_tau=25, IID=True, reparam=reparam)
        z_cs = prior_utils.bspline_redshift_prior(z_nsplines=N_PRIOR["z"], z_tau=1, reparam=reparam)
        return mass_cs, q_cs, a_cs, tilt_cs, z_cs

    return model


@pytest.mark.parametrize("reparam", ["centered", "whitened"])
def test_coefficient_prior_log_density_matches_jax(reparam):
    rng = np.random.default_rng(11)
    sfx = "_white" if reparam == "whitened" else ""
    sizes = {"mass_cs": N_PRIOR["m"], "q_cs": N_PRIOR["q"], "a_cs": N_PRIOR["a"], "tilt_cs": N_PRIOR["ct"], "z_cs": N_PRIOR["z"] - 1}
    params = {k + sfx: 1.5 * rng.standard_normal((C, n)) for k, n in sizes.items()}
    got, tr = ppl.log_density(_prior_model(utils, reparam), params={k: torch.tensor(v) for k, v in params.items()})
    assert got.shape == (C,)
    for c in range(C):
        want, jtr = jppl.log_density(_prior_model(jutils, reparam), params={k: jnp.asarray(v[c]) for k, v in params.items()})
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-10)
        for name in sizes:  # the coefficients themselves (deterministic sites when whitened)
            np.testing.assert_allclose(tr[name]["value"][c].numpy(), np.asarray(jtr[name]["value"]), rtol=1e-10, atol=1e-14)


# --------------------------------------------------------- fused likelihood


@pytest.mark.parametrize("jax_path", ["interpret", "xla"])
def test_fused_likelihood_matches_jax(problem, jax_path):
    p, jm, tm = problem, problem.jm, problem.tm
    port = FusedBSplineLikelihood(tm["mass"], tm["mag"], tm["tilt"], tm["z"], p.pe, p.inj, p.const["total_inj"])
    ref = JFused(jm["mass"], jm["mag"], jm["tilt"], jm["z"], p.pe, p.inj, p.const["total_inj"])
    assert port.pe_design.shape == ref.pe_design.shape and port.inj_design.shape == ref.inj_design.shape
    np.testing.assert_allclose(port.pe_design.numpy(), np.asarray(ref.pe_design), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(torch.isinf(port.pe_nlp).numpy(), np.isinf(np.asarray(ref.pe_nlp)))
    rng = np.random.default_rng(4)
    cs = _coef_draws(rng, {"m": 12, "q": 8, "a": 6, "t": 6, "z": 6})
    cs["z"][:, 0] = 0.0
    lamb = 1.7 + 0.5 * rng.uniform(-1, 1, C)
    got = port(*(torch.tensor(cs[k]) for k in ("m", "q", "a", "t", "z")), torch.tensor(lamb))
    assert [tuple(g.shape) for g in got] == [(C, 69), (C, 69), (C,), (C,)]
    for c in range(C):
        args = [jnp.asarray(cs[k][c]) for k in ("m", "q", "a", "t", "z")] + [jnp.asarray(lamb[c])]
        want = ref(*args, interpret=True) if jax_path == "interpret" else ref(*args)
        for g, w, name in zip(got, want, ("logBFs", "log_n_effs", "log_mu", "log_n_eff_inj")):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w), rtol=1e-10, atol=1e-10, err_msg=name)


# ------------------------------------------------------------- K3 plain


def test_k3_plain_version_on_the_f3_bank():
    """F3: an event whose leading chunk is all -inf and a fully masked event.
    The Pallas kernel (interpret mode) gives NaN for the first; the port's
    plain version gives what the XLA reference gives (finite there, and
    logBF = -inf for the masked event), and the backward of the K3 Function
    gives finite gradients, exactly 0 on the masked event, where the
    unguarded formula gives NaN."""
    coefs, design, nlp, E, S = chip_smoke.k3_edge_case(seed=5, num_chains=2, n_events=4, n_samples=2300, n_rows=6)
    K = design.shape[0]
    nlp[:1024] = -np.inf  # event 0: the Pallas kernel's first 1024-sample chunk is empty
    got = fused.fused_logweight_logsumexp_torch(torch.tensor(coefs), torch.tensor(design), torch.tensor(nlp), E, S)
    want = jfused.fused_logweight_logsumexp_xla(jnp.asarray(coefs), jnp.asarray(design), jnp.asarray(nlp), E, S)
    pallas = jfused.fused_logweight_logsumexp(jnp.asarray(coefs), jnp.asarray(design), jnp.asarray(nlp), E, S,
                                              sample_chunk=1024, interpret=True)
    for g, w, pl in zip(got, want, pallas):
        g, w, pl = g.numpy(), np.asarray(w), np.asarray(pl)
        assert np.isnan(pl[:, 0]).all(), "the Pallas kernel gives NaN on the empty leading chunk (F3)"
        assert np.isfinite(g[:, [0, 1, 3]]).all()
        np.testing.assert_allclose(g, w, rtol=1e-12)  # equal infinities and NaNs count as equal
    assert np.isneginf(got[0][:, 2].numpy()).all(), "the fully masked event gives logBF = -inf"
    raw = fused._flw_torch(torch.tensor(coefs), torch.tensor(design), torch.tensor(nlp), E, S)
    assert all(bool(torch.isneginf(r[:, 2]).all()) for r in raw), "and raw lse1 = lse2 = -inf"

    # the K3 Function's backward on the CPU: finite, exactly 0 on the masked event
    ct = torch.tensor(coefs, requires_grad=True)
    nt = torch.tensor(nlp, requires_grad=True)
    keep = [0, 1, 3]
    lbf, lne = fused.fused_logweight_logsumexp(ct, torch.tensor(design), nt, E, S)
    ones = torch.ones(2, E, dtype=torch.float64)  # a non-zero cotangent on the masked event too
    gc, gn = torch.autograd.grad((lbf, lne), (ct, nt), grad_outputs=(ones, 0.5 * ones))
    assert bool(torch.isfinite(gc).all()) and bool(torch.isfinite(gn).all())
    assert bool((gn.reshape(E, S)[2] == 0).all())
    # without the -inf guard the backward's weight is exp(-inf - (-inf)) = NaN there
    logw = (torch.tensor(coefs) @ torch.tensor(design) + torch.tensor(nlp)).reshape(2, E, S)
    assert bool(torch.isnan(torch.exp(logw - raw[0][..., None])[:, 2]).all())

    # against autograd of the plain version over the live events only
    d3 = torch.tensor(design.reshape(K, E, S)[:, keep].reshape(K, -1))
    ct2 = torch.tensor(coefs, requires_grad=True)
    nt2 = torch.tensor(nlp.reshape(E, S)[keep].reshape(-1), requires_grad=True)
    lbf2, lne2 = fused.fused_logweight_logsumexp_torch(ct2, d3, nt2, len(keep), S)
    gc2, gn2 = torch.autograd.grad(lbf2.sum() + 0.5 * lne2.sum(), (ct2, nt2))
    np.testing.assert_allclose(gc.numpy(), gc2.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gn.reshape(E, S)[keep].numpy(), gn2.reshape(len(keep), S).numpy(), rtol=1e-10, atol=1e-15)


# --------------------------------------------------------- the whole model


def _jax_potential(bound, params):
    """Potential and flat gradient of the JAX model at constrained
    ``params`` (per chain, vmapped as the JAX sampler runs it)."""
    u = jax.vmap(lambda q: jppl.unconstrain_fn(bound, (), {}, q))({k: jnp.asarray(v) for k, v in params.items()})
    val, grad = jax.vmap(jax.value_and_grad(lambda uu: jppl.potential_energy(bound, (), {}, uu)))(u)
    return np.asarray(val), np.asarray(jax.vmap(lambda g: jax.flatten_util.ravel_pytree(g)[0])(grad))


def _model_params(rng, reparam):
    sfx = "_white" if reparam == "whitened" else ""
    sizes = {"mass_cs": 12, "q_cs": 8, "a_cs": 6, "tilt_cs": 6, "z_cs": 5}
    scale = 0.6 if reparam == "whitened" else 0.3
    params = {k + sfx: scale * rng.standard_normal((C, n)) for k, n in sizes.items()}
    params["lamb"] = 1.7 + 0.5 * rng.uniform(-1, 1, C)
    params["unscaled_rate"] = rng.uniform(40.0, 110.0, C)
    return params


def _port_model(problem, fused_route, reparam):
    tm = problem.tm
    return BSplineModel(problem.pe, problem.inj, problem.const, tm["mass"], tm["mag"], tm["tilt"], tm["z"], MMIN, MMAX,
                        param_names=problem.names, fused=fused_route, reparam=reparam)


@pytest.mark.parametrize("reparam", ["centered", "whitened"])
@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_model_potential_matches_jax(problem, route, reparam):
    p, jm = problem, problem.jm
    fused_route = route == "fused"
    jf = JFused(jm["mass"], jm["mag"], jm["tilt"], jm["z"], p.pe, p.inj, p.const["total_inj"]) if fused_route else None

    def bound():
        jex.model(p.pe, p.inj, p.const["nObs"], p.const["obs_time"], p.const["total_inj"], jm["mass"], jm["mag"],
                  jm["tilt"], jm["z"], MMIN, MMAX, p.names, fused_lik=jf, reparam=reparam)

    params = _model_params(np.random.default_rng(6), reparam)
    model = _port_model(p, fused_route, reparam)
    pot = ModelPotential(model, **F64)
    u, g = pot.value_and_grad(params_from_jax(params, model, **F64))
    want_u, want_g = _jax_potential(bound, params)
    assert bool((u.abs() < 1e30).all()), "the points must sit off the likelihood walls"
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-9, atol=1e-9 * float(np.abs(want_g).max()))


def test_routes_agree_and_launch_no_kernel_on_the_cpu(problem):
    """Both routes give one potential; on CPU tensors neither wrapper
    launches its CUDA kernel."""
    params = _model_params(np.random.default_rng(8), "whitened")
    before = (fused.FLW_KERNEL.launches, fused.DLSE_KERNEL.launches)
    out = []
    for fused_route in (False, True):
        model = _port_model(problem, fused_route, "whitened")
        out.append(ModelPotential(model, **F64).value_and_grad(params_from_jax(params, model, **F64)))
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(), rtol=1e-10)
    np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(), rtol=1e-9, atol=1e-10)
    assert (fused.FLW_KERNEL.launches, fused.DLSE_KERNEL.launches) == before


def test_hierarchical_likelihood_takes_the_bspline_kwargs():
    rng = np.random.default_rng(0)
    pe = torch.tensor(rng.normal(0.0, 1.0, (2, 4, 300)))
    inj = torch.tensor(rng.normal(0.0, 1.0, (2, 5000)))
    kw = dict(total_inj=1e5, Nobs=4, Tobs=1.0, surveyed_hypervolume=torch.ones(2))
    rates = {"unscaled_rate": torch.tensor([4.0, 5.0])}
    with ppl.trace() as plain, ppl.substitute(data=rates):
        analysis.hierarchical_likelihood(pe, inj, log=True, **kw)
    with ppl.trace() as extra, ppl.substitute(data=rates):
        analysis.hierarchical_likelihood(pe, inj, param_names=["mass_1"], pedata={}, injdata={}, m1min=3.0, m2min=3.0,
                                         mmax=100.0, log=True, **kw)
    assert torch.equal(plain.trace["log_l"]["value"], extra.trace["log_l"]["value"])
    with pytest.raises(NotImplementedError, match="log=False"), ppl.trace():
        analysis.hierarchical_likelihood(pe, inj, log=False, **kw)


def test_get_deterministic_recomputes_the_coefficients(problem, capsys):
    model = _port_model(problem, True, "whitened")
    mcmc = MCMC(NUTS(model, max_tree_depth=2), num_warmup=2, num_samples=3, num_chains=2, **F64)
    init = {k: v[:2] for k, v in _model_params(np.random.default_rng(9), "whitened").items()}
    mcmc.run(0, init_params=init)
    capsys.readouterr()
    det = mcmc.get_deterministic(site_names={"mass_cs", "z_cs", "rate"}, batch_size=4)
    assert capsys.readouterr().out == ""
    assert set(det) == {"mass_cs", "z_cs", "rate"}
    samples = mcmc.get_samples()
    assert det["mass_cs"].shape == (6, 12) and det["z_cs"].shape == (6, 5) and det["rate"].shape == (6,)
    L = smoothing.prior_precision_cholesky(12, 15, 1, degree=1)
    np.testing.assert_allclose(det["mass_cs"].numpy(), np.linalg.solve(L.T, samples["mass_cs_white"].numpy().T).T, rtol=1e-10)
    assert bool(torch.isfinite(det["rate"]).all())
    with pytest.raises(ValueError, match="whitened"):
        with ppl.trace(), ppl.substitute(data={"mass_cs": torch.zeros(1, 3)}):
            utils._coef_block("mass_cs", "f", 3, 1.0, 1.0, 1, "whitened_typo")


def test_k3_tile_spreads_long_rows():
    """K3's geometry cuts one long row (the injection bank) into tiles that
    cover most of the card, as the PE bank's 69 events do, and a longer row
    into more tiles (C = 8, float32, 2 blocks resident per SM)."""
    for num_sms in (132, 114):
        inj = fused.flw_geometry(1, 46770, 8, 165, torch.float32, num_sms, 2)
        assert inj.blocks >= num_sms and math.ceil(46770 / inj.tile) == inj.blocks
        assert fused.flw_geometry(1, 10**7, 8, 165, torch.float32, num_sms, 2).n_tiles > inj.n_tiles
        assert fused.flw_geometry(69, 8000, 8, 165, torch.float32, num_sms, 2).blocks >= num_sms
