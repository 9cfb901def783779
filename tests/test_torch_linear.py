"""CPU float64 parity of the port's linear-space library with the JAX
package: the linear pdfs (with their edges), the linear parametric models,
the cosmology remainder, the likelihood's linear path, categorical
subpopulations, the ``marginal_qs`` posterior-predictive sites, ``sample``
with an explicit key, ``transform_fn``, ``init_to_uniform`` and the plate's
shape check.

Tolerances: pdfs, models and cosmology rtol 1e-10 (float64 on both sides;
the erf / lgamma implementations and the order of operations differ);
likelihood sites rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import cosmology as jcosmo
from gwinferno_tpu import distributions as jdist
from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.parametric import parametric as jpar
from gwinferno_tpu.pipeline import analysis as janalysis
from gwinferno_tpu.ppl import distributions as jd
from gwinferno_tpu.ppl import infer_util as jinfer_util
from gwinferno_tpu_torch import cosmology as tcosmo
from gwinferno_tpu_torch import distributions as tdist
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.models.parametric import parametric as tpar
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.ppl import ModelPotential
from gwinferno_tpu_torch.ppl import distributions as td
from gwinferno_tpu_torch.ppl.constraints import biject_to
from gwinferno_tpu_torch.ppl import constraints as tconstraints

RTOL = 1e-10
C = 3


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _parity(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _per_chain(fn_t, fn_j, data, hyper):
    """The port on ``(C, 1)`` hyperparameters against the JAX package one
    chain at a time."""
    got = fn_t(*[_t(d) for d in data], *[_t(h)[:, None] for h in hyper])
    for c in range(C):
        _parity(got[c], fn_j(*[jnp.asarray(d) for d in data], *[jnp.asarray(h[c]) for h in hyper]))
    return got


# ------------------------------------------------------------------ linear pdfs


def _edges(lo, hi, rng, n=200):
    """Points inside and outside ``[lo, hi]`` and both ends exactly."""
    span = hi - lo
    return np.concatenate([rng.uniform(lo - 0.2 * span, hi + 0.2 * span, n), [lo, hi]])


@pytest.mark.parametrize("alpha", [-2.35, -1.0, 0.0, 1.7])
def test_powerlaw_pdf(alpha):
    rng = np.random.default_rng(0)
    x = _edges(5.0, 100.0, rng)
    _parity(tdist.powerlaw_pdf(_t(x), _t(alpha), 5.0, 100.0), jdist.powerlaw_pdf(x, alpha, 5.0, 100.0))
    # per-sample bounds (the mass ratio's [mmin / m1, 1]) and a tensor floor
    q, m1 = rng.uniform(0.0, 1.1, 300), rng.uniform(3.0, 80.0, 300)
    _parity(tdist.powerlaw_pdf(_t(q), _t(alpha), 5.0 / _t(m1), 1.0, floor=-1.0),
            jdist.powerlaw_pdf(q, alpha, 5.0 / m1, 1.0, floor=-1.0))
    # a number for alpha, as the spline perturbation models pass it
    _parity(tdist.powerlaw_pdf(_t(x), alpha, 5.0, 100.0), jdist.powerlaw_pdf(x, alpha, 5.0, 100.0))


@pytest.mark.parametrize("log", [False, True])
def test_truncnorm_pdf(log):
    rng = np.random.default_rng(1)
    lo, hi = (2.0, 100.0)
    x = np.concatenate([_edges(lo, hi, rng), [0.0, -1.0]])
    mu, sig = (np.log(30.0), 0.4) if log else (35.0, 6.0)
    _parity(tdist.truncnorm_pdf(_t(x), _t(mu), _t(sig), lo, hi, log=log),
            jdist.truncnorm_pdf(x, mu, sig, lo, hi, log=log))


def test_betadist():
    rng = np.random.default_rng(2)
    x = _edges(0.0, 1.0, rng)
    for a, b in ((2.0, 3.5), (1.3, 1.1)):
        _parity(tdist.betadist(_t(x), _t(a), _t(b)), jdist.betadist(x, a, b))
    x = _edges(0.0, 0.8, rng)
    _parity(tdist.betadist(_t(x), _t(2.5), _t(4.0), scale=0.8, floor=-3.0),
            jdist.betadist(x, 2.5, 4.0, scale=0.8, floor=-3.0))


def test_logistic_functions_and_powerlaw_logit():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 150.0, 400)
    _parity(tdist.logistic_function(_t(x), 2.0, 0.3, 40.0), jdist.logistic_function(x, 2.0, 0.3, 40.0))
    for sgn in (1, -1):
        _parity(tdist.logistic_unit(_t(x), 40.0, sgn=sgn, sc=3), jdist.logistic_unit(x, 40.0, sgn=sgn, sc=3))
        # deep in the truncated tail the log stays finite
        far = np.concatenate([x, [1e4, -1e4]])
        _parity(tdist.log_logistic_unit(_t(far), 40.0, sgn=sgn, sc=5), jdist.log_logistic_unit(far, 40.0, sgn=sgn, sc=5))
    for low, high in ((None, None), (5.0, None), (None, 90.0), (5.0, 90.0)):
        _parity(tdist.powerlaw_logit_pdf(_t(x), _t(-2.0), low, high, 3.0, 6.0),
                jdist.powerlaw_logit_pdf(x, -2.0, low, high, 3.0, 6.0))


# ------------------------------------------------------------------ linear models


def _mass_bank(rng, n=400):
    m1 = np.concatenate([rng.uniform(2.0, 120.0, n), [5.0, 100.0]])
    q = np.concatenate([rng.uniform(0.0, 1.05, n), [1.0, 0.05]])
    return m1, q


def test_linear_mass_models():
    rng = np.random.default_rng(4)
    m1, q = _mass_bank(rng)
    alpha, beta = rng.uniform(-3, -1.5, C), rng.uniform(-1, 2, C)
    mpp, sigpp, lam = rng.uniform(25, 40, C), rng.uniform(2, 8, C), rng.uniform(0.05, 0.5, C)
    _per_chain(lambda m, qq, a, b: tpar.powerlaw_primary_ratio_pdf(m, qq, a, b, 5.0, 100.0),
               lambda m, qq, a, b: jpar.powerlaw_primary_ratio_pdf(m, qq, a, b, 5.0, 100.0), (m1, q), (alpha, beta))
    _per_chain(lambda m, qq, a, b: tpar.powerlaw_primary_ratio_falloff_pdf(m, qq, a, b, 5.0, 100.0, 2.0),
               lambda m, qq, a, b: jpar.powerlaw_primary_ratio_falloff_pdf(m, qq, a, b, 5.0, 100.0, 2.0),
               (m1, q), (alpha, beta))
    for delta in (None, 4.0):
        _per_chain(lambda m, a, mp, sp, lm: tpar.plpeak_primary_pdf(m, a, 5.0, 100.0, mp, sp, lm, delta=delta),
                   lambda m, a, mp, sp, lm: jpar.plpeak_primary_pdf(m, a, 5.0, 100.0, mp, sp, lm, delta=delta),
                   (m1,), (alpha, mpp, sigpp, lam))
        _per_chain(lambda m, qq, a, b, mp, sp, lm: tpar.plpeak_primary_ratio_pdf(m, qq, a, b, 5.0, 100.0, mp, sp, lm,
                                                                                  delta=delta),
                   lambda m, qq, a, b, mp, sp, lm: jpar.plpeak_primary_ratio_pdf(m, qq, a, b, 5.0, 100.0, mp, sp, lm,
                                                                                  delta=delta),
                   (m1, q), (alpha, beta, mpp, sigpp, lam))


def test_linear_spin_models():
    rng = np.random.default_rng(5)
    a1, a2 = (np.concatenate([rng.uniform(-0.05, 1.05, 300), [0.0, 1.0]]) for _ in range(2))
    ct1, ct2 = (np.concatenate([rng.uniform(-1.1, 1.1, 300), [-1.0, 1.0]]) for _ in range(2))
    al, be = rng.uniform(1.5, 4, (2, C)), rng.uniform(1.5, 6, (2, C))
    xi, sig = rng.uniform(0.1, 0.9, (2, C)), rng.uniform(0.2, 2.0, (2, C))
    _per_chain(tpar.beta_spin_magnitude, jpar.beta_spin_magnitude, (a1,), (al[0], be[0]))
    _per_chain(tpar.iid_spin_magnitude, jpar.iid_spin_magnitude, (a1, a2), (al[0], be[0]))
    _per_chain(tpar.independent_spin_magnitude_beta_dist, jpar.independent_spin_magnitude_beta_dist, (a1, a2),
               (al[0], be[0], al[1], be[1]))
    _per_chain(tpar.mixture_isoalign_spin_tilt, jpar.mixture_isoalign_spin_tilt, (ct1,), (xi[0], sig[0]))
    _per_chain(tpar.iid_spin_tilt, jpar.iid_spin_tilt, (ct1, ct2), (xi[0], sig[0]))
    _per_chain(tpar.independent_spin_tilt, jpar.independent_spin_tilt, (ct1, ct2), (xi[0], xi[1], sig[0], sig[1]))
    _per_chain(tpar.default_spin_tilt, jpar.default_spin_tilt, (ct1, ct2), (xi[0], sig[0]))


def test_powerlaw_redshift_model_prob_and_call():
    rng = np.random.default_rng(6)
    z_pe, z_inj = rng.uniform(0.01, 1.9, (4, 50)), rng.uniform(0.02, 2.0, 300)
    port = tpar.PowerlawRedshiftModel(z_pe, z_inj, device="cpu", dtype=torch.float64)
    ref = jpar.PowerlawRedshiftModel(z_pe, z_inj)
    lamb = rng.uniform(-1, 4, C)
    for z in (z_pe, z_inj):
        got = port(_t(z), _t(lamb).reshape((C,) + (1,) * z.ndim))
        dv = port.dVdzs[z.ndim - 1]
        prob = port.prob(_t(z), _t(dv), _t(lamb).reshape((C,) + (1,) * z.ndim))
        for c in range(C):
            _parity(got[c], ref(jnp.asarray(z), lamb[c]))
            _parity(prob[c], ref.prob(jnp.asarray(z), jnp.asarray(dv), lamb[c]))
        assert bool((got[:, z > port.zmax] == 0).all())


# ------------------------------------------------------------------ cosmology


def test_cosmology_remainder():
    rng = np.random.default_rng(7)
    z = rng.uniform(0.0, 3.0, 500)
    for name in ("PLANCK_2015_Ho", "PLANCK_2015_OmegaMatter", "PLANCK_2015_OmegaLambda", "PLANCK_2015_OmegaRadiation",
                 "PLANCK_2015_LVK_OmegaRadiation"):
        assert getattr(tcosmo, name) == getattr(jcosmo, name), name
    for port, ref in ((tcosmo.PLANCK_2015_Cosmology, jcosmo.PLANCK_2015_Cosmology),
                      (tcosmo.PLANCK_2015_LVK_Cosmology, jcosmo.PLANCK_2015_LVK_Cosmology)):
        np.testing.assert_allclose(port.Dc, ref.Dc, rtol=RTOL)
        for q in ("z2Dc", "dVcdz", "logdVcdz", "z2DL"):
            np.testing.assert_allclose(getattr(port, q)(z, dz=0.5), np.asarray(getattr(ref, q)(z, dz=0.5)), rtol=RTOL,
                                       err_msg=q)
        DL = np.concatenate([rng.uniform(0.0, 3e4, 300), [0.0, 1e7]])  # the last beyond the table
        np.testing.assert_allclose(port.DL2z(DL), np.asarray(ref.DL2z(DL)), rtol=RTOL)
        np.testing.assert_allclose(port.DL2z(port.z2DL(z)), z, rtol=1e-6, atol=1e-9)
    # extend rebuilds the tables as the JAX package's does
    port = tcosmo.Cosmology(tcosmo.PLANCK_2015_Ho, tcosmo.PLANCK_2015_OmegaMatter, 0.0, tcosmo.PLANCK_2015_OmegaLambda,
                            max_z=2.0)
    ref = jcosmo.Cosmology(jcosmo.PLANCK_2015_Ho, jcosmo.PLANCK_2015_OmegaMatter, 0.0, jcosmo.PLANCK_2015_OmegaLambda,
                           max_z=2.0)
    port.extend(15.0, dz=2e-3)
    ref.extend(15.0, dz=2e-3)
    assert (port.max_z, port.dz) == (ref.max_z, ref.dz) == (15.0, 2e-3)
    np.testing.assert_allclose(port.Vc, ref.Vc, rtol=RTOL)
    zz = rng.uniform(5.0, 14.0, 50)
    np.testing.assert_allclose(port.dVcdz(zz), np.asarray(ref.dVcdz(zz)), rtol=RTOL)


# ------------------------------------------------------------------ the likelihood


F5_KW = dict(total_inj=2e4, Nobs=5, Tobs=1.0, surveyed_hypervolume=1.0, reconstruct_rate=False, min_neff_cut=False)
SITES = ("log_l", "logBFs", "log_nEffs", "log_nEff_inj", "detection_efficiency", "variance_log_BFs",
         "variance_log_detection_efficiency", "variance_log_likelihood", "selection_factor", "sum_logBFs")


def _linear_reproduction(seed=0):
    """5 events x 400 linear PE weights in [0.5, 2] and 3000 injection
    weights in [0.001, 0.01]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, (5, 400)), rng.uniform(0.001, 0.01, 3000)


def _compare_sites(tr, jtr, chain=0, names=SITES):
    for name in names:
        np.testing.assert_allclose(tr[name]["value"][chain].numpy(), np.asarray(jtr[name]["value"]), rtol=RTOL,
                                   err_msg=name)


def test_linear_likelihood_reproduces_the_reference():
    """The reference-style linear call, chain-batched: 36.62 and 0.00082 in
    each chain, as in the JAX package, for every setting of the cuts."""
    pe, inj = _linear_reproduction()
    scaled = np.stack([pe, 1.3 * pe]), np.stack([inj, 0.7 * inj])
    for flags in (dict(), dict(min_neff_cut=True), dict(marginalize_selection=True),
                  dict(max_variance_cut=True, min_neff_cut=False)):
        kw = dict(F5_KW, **flags)
        with ppl.trace() as tr:
            analysis.hierarchical_likelihood(_t(scaled[0]), _t(scaled[1]), **kw)
        for c in range(2):
            with jppl.trace() as jtr:
                janalysis.hierarchical_likelihood(jnp.asarray(scaled[0][c]), jnp.asarray(scaled[1][c]), **kw)
            _compare_sites(tr.trace, jtr.trace, c)
    with jppl.trace() as jtr:
        janalysis.hierarchical_likelihood(jnp.asarray(pe), jnp.asarray(inj), **F5_KW)
    with ppl.trace() as tr:
        analysis.hierarchical_likelihood(_t(pe)[None], _t(inj)[None], **F5_KW)
    assert abs(float(tr.trace["log_l"]["value"][0]) - 36.62) < 0.01
    assert abs(float(tr.trace["detection_efficiency"]["value"][0]) - 0.00082) < 1e-5
    # the K1 kernel plays no part on the linear path
    from gwinferno_tpu_torch.ops import fused

    before = fused.DLSE_KERNEL.launches
    analysis.per_event_log_bayes_factors(_t(pe))
    assert fused.DLSE_KERNEL.launches == before


def _categorical_banks(seed=1, E=5, S=300, N=2000):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, (E, S))
    b = rng.uniform(0.1, 4.0, (E, S))
    return a, b, rng.uniform(0.001, 0.01, N)


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("pop_frac", [[1.0, 0.0], [0.0, 1.0]], ids=["first", "second"])
def test_categorical_matches_jax_on_certain_draws(pop_frac, log):
    """With all weight on one subpopulation both packages draw it for every
    event, and the likelihood's sites agree."""
    a, b, inj = _categorical_banks()
    f = np.log if log else (lambda v: v)
    kw = dict(F5_KW, categorical=True, pop_frac=pop_frac, log=log)
    with jppl.trace() as jtr:
        janalysis.hierarchical_likelihood([jnp.asarray(f(a)), jnp.asarray(f(b))], jnp.asarray(f(inj)),
                                          rngkey=jax.random.PRNGKey(0), **kw)
    with ppl.trace() as tr:
        analysis.hierarchical_likelihood((_t(f(a))[None], _t(f(b))[None]), _t(f(inj))[None], rngkey=0, **kw)
    want = 0 if pop_frac[0] == 1.0 else 1
    assert tr.trace["Qs"]["value"].tolist() == [want] * 5
    assert np.asarray(jtr.trace["Qs"]["value"]).tolist() == [want] * 5
    assert tr.trace["Qs"]["explicit_rng"] and tr.trace["Qs"]["cond_indep_stack"][0][:2] == ("nObs", 5)
    _compare_sites(tr.trace, jtr.trace)


def test_categorical_with_substituted_draws_matches_jax():
    """The port's draws at an even split, substituted into the JAX model,
    give the same likelihood; a chain axis on ``Qs`` gives each chain its
    own mixture."""
    a, b, inj = _categorical_banks(seed=2)
    kw = dict(F5_KW, categorical=True, pop_frac=[0.5, 0.5])
    with ppl.trace() as tr:
        analysis.hierarchical_likelihood((_t(a)[None], _t(b)[None]), _t(inj)[None], rngkey=11, **kw)
    qs = tr.trace["Qs"]["value"]
    assert qs.shape == (5,) and 0 < int(qs.sum()) < 5
    with jppl.trace() as jtr, jppl.substitute(data={"Qs": jnp.asarray(qs.numpy())}):
        janalysis.hierarchical_likelihood([jnp.asarray(a), jnp.asarray(b)], jnp.asarray(inj),
                                          rngkey=jax.random.PRNGKey(0), **kw)
    _compare_sites(tr.trace, jtr.trace)
    per_chain = torch.stack([qs, 1 - qs])
    with ppl.trace() as tr2, ppl.substitute(data={"Qs": per_chain}):
        analysis.hierarchical_likelihood((_t(a).expand(2, 5, 300), _t(b).expand(2, 5, 300)), _t(inj).expand(2, 2000),
                                         rngkey=11, **kw)
    for c in range(2):
        with jppl.trace() as jtr, jppl.substitute(data={"Qs": jnp.asarray(per_chain[c].numpy())}):
            janalysis.hierarchical_likelihood([jnp.asarray(a), jnp.asarray(b)], jnp.asarray(inj),
                                              rngkey=jax.random.PRNGKey(0), **kw)
        _compare_sites(tr2.trace, jtr.trace, c)


def _categorical_model(a, b, inj, rngkey):
    def model():
        lamb = ppl.sample("lamb", td.Normal(0.0, 1.0))
        w = torch.exp(0.1 * lamb[:, None, None])
        analysis.hierarchical_likelihood((a * w, b * w), inj * torch.exp(0.05 * lamb[:, None]), rngkey=rngkey,
                                         categorical=True, pop_frac=[0.3, 0.7], **F5_KW)
    return model


def test_explicit_key_draws_are_fixed_and_skip_the_potential():
    """A fixed key gives identical ``Qs`` and ``log_l`` bit for bit in two
    calls, from an int and from a generator, without advancing the caller's
    generator; the potential has no ``Qs`` coordinate and does not count its
    density, and with ``Qs`` given a value its density counts, as in the
    JAX package."""
    a, b, inj = (_t(v) for v in _categorical_banks(seed=3))
    lamb = {"lamb": _t([0.3, -0.2])}
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    runs = {}
    for key in (7, gen):
        runs[key] = []
        for _ in range(2):
            with ppl.trace() as tr, ppl.substitute(data=lamb):
                _categorical_model(a, b, inj, key)()
            runs[key].append(tr.trace)
        assert torch.equal(runs[key][0]["Qs"]["value"], runs[key][1]["Qs"]["value"])
        assert torch.equal(runs[key][0]["log_l"]["value"], runs[key][1]["log_l"]["value"])
    assert torch.equal(gen.get_state(), state)
    # a seed handler does not override the site's own key
    with ppl.trace() as seeded, ppl.seed(rng_seed=99), ppl.substitute(data=lamb):
        _categorical_model(a, b, inj, 7)()
    assert torch.equal(seeded.trace["Qs"]["value"], runs[7][0]["Qs"]["value"])

    pot = ModelPotential(_categorical_model(a, b, inj, 7), device="cpu", dtype=torch.float64)
    assert pot.names == ["lamb"]
    z = _t([[0.3], [-0.2]])
    u, g = pot.value_and_grad(z)
    assert torch.equal(u, pot(z)) and bool(torch.isfinite(g).all())
    want = -(runs[7][0]["log_l"]["value"] + td.Normal(0.0, 1.0).log_prob(lamb["lamb"]))
    torch.testing.assert_close(u, want, rtol=1e-12, atol=0.0)
    ld, _ = ppl.log_density(_categorical_model(a, b, inj, 7), params=lamb)
    torch.testing.assert_close(ld, -u, rtol=1e-12, atol=0.0)

    def jmodel():
        lam = jppl.sample("lamb", jd.Normal(0.0, 1.0))
        w = jnp.exp(0.1 * lam)
        janalysis.hierarchical_likelihood([jnp.asarray(a.numpy()) * w, jnp.asarray(b.numpy()) * w],
                                          jnp.asarray(inj.numpy()) * jnp.exp(0.05 * lam), categorical=True,
                                          pop_frac=[0.3, 0.7], rngkey=jax.random.PRNGKey(1), **F5_KW)

    qs = runs[7][0]["Qs"]["value"]
    jld, jtr = jppl.log_density(jmodel, (), {}, {"lamb": jnp.asarray(0.3), "Qs": jnp.asarray(qs.numpy())})
    got, tr = ppl.log_density(_categorical_model(a, b, inj, 7), params={"lamb": _t([0.3]), "Qs": qs[None]})
    np.testing.assert_allclose(float(tr["log_l"]["value"][0]), float(jtr["log_l"]["value"]), rtol=RTOL)
    np.testing.assert_allclose(float(got[0]), float(jld), rtol=RTOL)
    jld_free, jtr_free = jppl.log_density(jmodel, (), {}, {"lamb": jnp.asarray(0.3)})
    np.testing.assert_allclose(float(jld_free) - float(jtr_free["log_l"]["value"]),
                               float(td.Normal(0.0, 1.0).log_prob(_t(0.3))), rtol=RTOL)


def _ppc_banks(log):
    """4 events, one sample each with weight (the rest 0), and one
    injection with weight: every draw is certain, in both packages."""
    rng = np.random.default_rng(4)
    E, S, N = 4, 30, 50
    pedata = {"mass_1": rng.uniform(10.0, 60.0, (E, S)), "mass_ratio": rng.uniform(0.3, 1.0, (E, S))}
    injdata = {"mass_1": rng.uniform(10.0, 60.0, N), "mass_ratio": rng.uniform(0.3, 1.0, N)}
    pe = np.zeros((E, S))
    pick = rng.integers(0, S, E)
    pe[np.arange(E), pick] = rng.uniform(0.5, 2.0, E)
    inj = np.zeros(N)
    inj[17] = 0.3
    indv = [0.25 * pe, 0.75 * pe]
    if log:
        with np.errstate(divide="ignore"):
            pe, inj = np.log(pe), np.log(inj)
    return pe, inj, pedata, injdata, indv, pick


@pytest.mark.parametrize("log", [False, True])
def test_marginal_qs_sites_match_jax(log):
    """``cat_frac_subpop_{i}_event_{ev}`` and the draws, on banks whose
    draws are certain; with ``log=True`` the ratio divides the linear
    ``indv_weights`` by the max-shifted weights, the JAX package's quirk."""
    pe, inj, pedata, injdata, indv, pick = _ppc_banks(log)
    kw = dict(posterior_predictive_check=True, param_names=("mass_1",), m1min=2.0, m2min=2.0, mmax=100.0, log=log,
              marginal_qs=True, indv_weights=indv, total_inj=1e3, Nobs=4, Tobs=1.0, reconstruct_rate=False,
              min_neff_cut=False)
    with jppl.trace() as jtr:
        janalysis.hierarchical_likelihood(jnp.asarray(pe), jnp.asarray(inj),
                                          pedata={k: jnp.asarray(v) for k, v in pedata.items()},
                                          injdata={k: jnp.asarray(v) for k, v in injdata.items()}, **kw)
    with ppl.trace() as tr, ppl.collect_deterministic():
        analysis.hierarchical_likelihood(_t(pe)[None], _t(inj)[None], pedata={k: _t(v) for k, v in pedata.items()},
                                         injdata={k: _t(v) for k, v in injdata.items()}, **kw)
    names = [k for k in jtr.trace if "_event_" in k]
    assert set(names) == {k for k in tr.trace if "_event_" in k} and len(names) == 4 * (2 + 2)
    for k in names:
        np.testing.assert_allclose(tr.trace[k]["value"][0].numpy(), np.asarray(jtr.trace[k]["value"]), rtol=RTOL,
                                   err_msg=k)
    frac = np.array([float(tr.trace[f"cat_frac_subpop_1_event_{ev}"]["value"][0]) for ev in range(4)])
    # linear: 0.25 of the bank's weight; log: 0.25 of the linear weight over
    # exp(logw - max) = 1 at the drawn (only) sample
    np.testing.assert_allclose(frac, 0.25 * np.exp(pe).max(1) if log else np.full(4, 0.25), rtol=RTOL)
    # without a reader of the deterministic sites, none is drawn
    with ppl.trace() as quiet:
        analysis.hierarchical_likelihood(_t(pe)[None], _t(inj)[None], pedata={k: _t(v) for k, v in pedata.items()},
                                         injdata={k: _t(v) for k, v in injdata.items()}, **kw)
    assert not any("_event_" in k for k in quiet.trace)


def test_marginal_qs_ratio_at_random_draws():
    """On banks with weight everywhere, each chain's ratio is its
    subpopulation's weight over the bank's at the drawn sample (recovered
    from the drawn mass), and the subpopulations' ratios sum to 1."""
    rng = np.random.default_rng(5)
    E, S, N = 6, 40, 80
    pedata = {"mass_1": rng.uniform(10.0, 60.0, (E, S)), "mass_ratio": rng.uniform(0.3, 1.0, (E, S))}
    injdata = {"mass_1": rng.uniform(10.0, 60.0, N), "mass_ratio": rng.uniform(0.3, 1.0, N)}
    share = rng.uniform(0.1, 0.9, (E, S))
    pe = rng.uniform(0.5, 2.0, (2, E, S))
    indv = [share * pe, (1.0 - share) * pe]
    with ppl.trace() as tr:
        analysis._posterior_predictive_sites(_t(pe), _t(rng.uniform(0.1, 1.0, (2, N))), {k: _t(v) for k, v in pedata.items()},
                                             {k: _t(v) for k, v in injdata.items()}, ("mass_1",), m1min=2.0, m2min=2.0,
                                             marginal_qs=True, indv_weights=[_t(w) for w in indv], log=False)
    for c in range(2):
        for ev in range(E):
            idx = int(np.flatnonzero(pedata["mass_1"][ev] == float(tr.trace[f"mass_1_obs_event_{ev}"]["value"][c]))[0])
            f1 = float(tr.trace[f"cat_frac_subpop_1_event_{ev}"]["value"][c])
            f2 = float(tr.trace[f"cat_frac_subpop_2_event_{ev}"]["value"][c])
            np.testing.assert_allclose(f1, share[ev, idx], rtol=RTOL)
            np.testing.assert_allclose(f1 + f2, 1.0, rtol=RTOL)


# ------------------------------------------------------------------ the PPL


def test_sample_with_a_positional_key_and_init_and_transform():
    """``sample(name, fn, obs, rng_key)`` draws at once outside any handler,
    the same values from the same key; ``init_to_uniform`` and
    ``transform_fn`` as in the JAX package."""
    a = ppl.sample("x", td.Normal(0.0, 1.0), None, 3, (4,))
    b = ppl.sample("x", td.Normal(0.0, 1.0), None, 3, (4,))
    assert a.shape == (4,) and torch.equal(a, b)
    g = torch.Generator().manual_seed(2)
    c = ppl.sample("y", td.Uniform(0.0, 1.0), None, g, (3,))
    assert torch.equal(c, ppl.sample("y", td.Uniform(0.0, 1.0), None, g, (3,)))
    assert torch.equal(c, torch.rand(3, generator=torch.Generator().manual_seed(2), dtype=c.dtype))
    with pytest.raises(ValueError, match="has no value"), ppl.trace():
        ppl.sample("z", td.Normal(0.0, 1.0))
    with pytest.raises(TypeError, match="rng_key"):
        ppl.sample("z", td.Normal(0.0, 1.0), None, 1.5)

    init = ppl.init_to_uniform(radius=0.7)
    u = init(torch.Generator().manual_seed(0), (2000, 3), dtype=torch.float64)
    assert u.shape == (2000, 3) and float(u.abs().max()) < 0.7 and float(u.abs().max()) > 0.69
    assert torch.equal(u, init(torch.Generator().manual_seed(0), (2000, 3), dtype=torch.float64))

    supports = {"s": "positive", "p": "unit_interval", "r": "real"}
    params = {"s": np.array([0.5, 2.0]), "p": np.array([0.1, 0.9]), "r": np.array([-1.0, 3.0]), "k": np.array([1.0])}
    tt = {k: biject_to(getattr(tconstraints, v)) for k, v in supports.items()}
    from gwinferno_tpu.ppl import constraints as jconstraints
    from gwinferno_tpu.ppl.constraints import biject_to as jbiject_to

    jt = {k: jbiject_to(getattr(jconstraints, v)) for k, v in supports.items()}
    for invert in (False, True):
        got = ppl.transform_fn(tt, {k: _t(v) for k, v in params.items()}, invert=invert)
        want = jinfer_util.transform_fn(jt, {k: jnp.asarray(v) for k, v in params.items()}, invert=invert)
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL)
    assert set(ppl.__all__) >= {"transform_fn", "init_to_uniform"}


def _plate_fault(pkg, dist_mod, zeros):
    with pkg.trace(), pkg.plate("n", 5):
        pkg.sample("x", dist_mod.Normal(0.0, 1.0), obs=zeros(3))


def test_plate_checks_the_shape_of_its_sites():
    """A site inside ``plate(5)`` whose value lacks 5 at the plate's axis
    raises in both packages; a chain-batched ``(C, 5)`` value and a value
    drawn once for all chains, ``(5,)``, pass, and so does an observed
    ``(C, 5)`` site."""
    with pytest.raises(ValueError, match=r"plate\(size=5, dim=-1\)"):
        _plate_fault(jppl, jd, jnp.zeros)
    with pytest.raises(ValueError, match=r"plate\(size=5, dim=-1\) has value shape \(3,\)"):
        _plate_fault(ppl, td, torch.zeros)
    with pytest.raises(ValueError, match="expected size 5"), ppl.trace(), ppl.plate("n", 5), \
            ppl.substitute(data={"x": torch.zeros(3, 4)}):
        ppl.sample("x", td.Normal(0.0, 1.0))
    with ppl.trace() as tr, ppl.plate("n", 5), ppl.substitute(data={"x": torch.zeros(3, 5)}):
        ppl.sample("x", td.Normal(0.0, 1.0))
        ppl.sample("y", td.Normal(0.0, 1.0), obs=torch.zeros(3, 5))
        ppl.sample("q", td.Categorical(probs=torch.tensor([0.2, 0.8])), rng_key=0)
    assert tr.trace["q"]["value"].shape == (5,)
