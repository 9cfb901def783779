"""CPU float64 parity of the port's hierarchical likelihood and bench model
with the JAX package.

Tolerances: likelihood summaries and deterministic sites rtol 1e-10; the
bench model's potential and gradient rtol 1e-9 (sums over ~10^4 terms taken
in another order)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JRedshift
from gwinferno_tpu.pipeline import analysis as janalysis
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT, INIT_JITTER, BenchModel
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)


def _weights(C=3, E=4, S=200, N=500, seed=0):
    rng = np.random.default_rng(seed)
    pe = -0.5 * rng.standard_normal((C, E, S)) ** 2 + rng.normal(size=(C, E, 1))
    inj = -0.5 * rng.standard_normal((C, N)) ** 2 - 3.0
    pe[0, 1, ::7] = -np.inf  # out-of-support samples
    inj[1, :] = -50.0
    inj[1, 0] = 0.0  # one injection dominates: log n_eff_inj below log(4 Nobs)
    pe[2, 3, :] = -40.0
    pe[2, 3, 5] = 0.0  # one sample dominates: an event's n_eff below Nobs
    return pe, inj


def test_per_event_and_detection_efficiency():
    pe, inj = _weights()
    for c in range(pe.shape[0]):
        want = janalysis.per_event_log_bayes_factors(jnp.asarray(pe[c]), log=True)
        got = analysis.per_event_log_bayes_factors(torch.tensor(pe[c]), log=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
        want = janalysis.detection_efficiency(jnp.asarray(inj[c]), 1e6, log=True)
        got = analysis.detection_efficiency(torch.tensor(inj[c]), 1e6, log=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-10, atol=1e-12)
    # batched over chains == per chain
    bf, ne, var = analysis.per_event_log_bayes_factors(torch.tensor(pe), log=True)
    assert bf.shape == ne.shape == var.shape == pe.shape[:2]


FLAGS = [
    dict(min_neff_cut=True, marginalize_selection=False, max_variance_cut=False),  # the bench's
    dict(min_neff_cut=False, marginalize_selection=True, max_variance_cut=False),
    dict(min_neff_cut=False, marginalize_selection=False, max_variance_cut=True),
]


@pytest.mark.parametrize("flags", FLAGS, ids=["bench", "marginalize", "max_variance"])
def test_hierarchical_likelihood_sites(flags):
    pe, inj = _weights()
    C, E = pe.shape[:2]
    rates = np.array([60.0, 75.0, 90.0])
    hv = np.array([3e9, 5e9, 8e9])
    kw = dict(total_inj=1e6, Nobs=E, Tobs=1.5, **flags)

    got_rate = None
    with ppl.trace() as tr, ppl.substitute(data={"unscaled_rate": torch.tensor(rates)}):
        got_rate = analysis.hierarchical_likelihood(torch.tensor(pe), torch.tensor(inj), surveyed_hypervolume=torch.tensor(hv), log=True, **kw)
    for c in range(C):
        with jppl.trace() as jtr, jppl.substitute(data={"unscaled_rate": jnp.asarray(rates[c])}):
            want_rate = janalysis.hierarchical_likelihood(
                jnp.asarray(pe[c]), jnp.asarray(inj[c]), surveyed_hypervolume=jnp.asarray(hv[c]), log=True, **kw
            )
        np.testing.assert_allclose(float(got_rate[c]), float(want_rate), rtol=1e-10, atol=1e-12)
        names = [n for n, s in jtr.trace.items() if s["type"] == "deterministic"]
        assert names == [n for n, s in tr.trace.items() if s["type"] == "deterministic"]
        for name in names + ["log_likelihood"]:
            site = jtr.trace.get(name)
            want = np.asarray(site["value"] if site["type"] == "deterministic" else site["fn"].log_prob(site["value"]))
            got_site = tr.trace[name]
            got = got_site["value"] if got_site["type"] == "deterministic" else got_site["fn"].log_prob(got_site["value"])
            np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-10, atol=1e-12, err_msg=f"{name} chain {c}")
    if flags["min_neff_cut"]:
        # chain 1 sits on the n_eff_inj wall, chain 2 on the per-event wall
        ll = tr.trace["neff_less_Nobs"]["value"]
        assert float(ll[0]) > -1e300 and float(ll[1]) == float(ll[2]) == torch.finfo(torch.float64).min


def test_max_variance_cut_excludes_the_other_cuts():
    pe, inj = _weights()
    with pytest.raises(ValueError, match="max_variance_cut"):
        with ppl.trace():
            analysis.hierarchical_likelihood(
                torch.tensor(pe), torch.tensor(inj), 1e6, 4, 1.0, surveyed_hypervolume=torch.ones(3),
                min_neff_cut=True, max_variance_cut=True, log=True,
            )


def _catalog_slice(n_events=12, n_samples=600, n_found=6000):
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    # read directly with h5py, never through the conftest fixtures that run the generator
    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:n_found]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=n_events)


def _jittered_params(n_chains, seed):
    rng = np.random.default_rng(seed)
    return {k: v + INIT_JITTER[k] * rng.uniform(-1, 1, n_chains) for k, v in FIDUCIAL_INIT.items()}


def test_bench_model_potential_and_gradient_match_jax():
    sys.path.insert(0, ROOT)
    import bench

    pe, inj, const = _catalog_slice()
    params = _jittered_params(4, seed=5)
    jmodel = bench.make_model(pe, inj, const, JRedshift(pe["redshift"], inj["redshift"]))

    want_u, want_g = [], []
    for c in range(4):
        pc = {k: jnp.asarray(v[c]) for k, v in params.items()}
        u = jppl.unconstrain_fn(jmodel, (), {}, pc)
        val, grad = jax.value_and_grad(lambda uu: jppl.potential_energy(jmodel, (), {}, uu))(u)
        want_u.append(float(val))
        want_g.append(np.asarray(jax.flatten_util.ravel_pytree(grad)[0]))

    tmodel = BenchModel(pe, inj, const, PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64), **F64)
    z = params_from_jax(params, tmodel, **F64)
    pot = ModelPotential(tmodel, **F64)
    assert pot.names == sorted(params)
    got_u, got_g = pot.value_and_grad(z)
    assert np.all(np.abs(want_u) < 1e30), "the slice must sit off the likelihood walls"
    np.testing.assert_allclose(got_u.numpy(), np.array(want_u), rtol=1e-9)
    np.testing.assert_allclose(got_g.numpy(), np.stack(want_g), rtol=1e-9, atol=1e-9)

    # the deterministic sites of the model at the same point
    with torch.no_grad(), ppl.trace() as tr, ppl.substitute(data=pot.constrain(z)):
        tmodel()
    pc = {k: jnp.asarray(v[0]) for k, v in params.items()}
    with jppl.trace() as jtr, jppl.substitute(data=pc):
        jmodel()
    for name in ("logBFs", "log_nEffs", "log_nEff_inj", "rate", "surveyed_hypervolume", "log_l"):
        np.testing.assert_allclose(tr.trace[name]["value"][0].numpy(), np.asarray(jtr.trace[name]["value"]), rtol=1e-9, err_msg=name)


def _linear_reproduction(seed=0):
    """5 events x 400 linear PE weights in [0.5, 2] and 3000 linear injection
    weights in [0.001, 0.01] (ROADMAP F5's reproduction)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, (5, 400)), rng.uniform(0.001, 0.01, 3000)


F5_KW = dict(total_inj=2e4, Nobs=5, Tobs=1.0, surveyed_hypervolume=1.0, reconstruct_rate=False, min_neff_cut=False)


def test_reference_style_linear_call_raises_and_the_log_call_matches():
    """A call written for the JAX package (linear weights, no ``log=``) gives
    the JAX package's ``log_l`` (36.62) and detection efficiency (0.00082),
    and so do the two helpers on the linear path; the same call on the
    weights' logs with ``log=True`` gives them too.  (Until the linear path
    was ported, the linear call raised.)"""
    pe, inj = _linear_reproduction()
    with jppl.trace() as jtr:
        janalysis.hierarchical_likelihood(jnp.asarray(pe), jnp.asarray(inj), **F5_KW)
    want = float(jtr.trace["log_l"]["value"])
    assert abs(want - 36.62) < 0.01 and abs(float(jtr.trace["detection_efficiency"]["value"]) - 0.00082) < 1e-5
    with ppl.trace() as lin:
        analysis.hierarchical_likelihood(torch.tensor(pe)[None], torch.tensor(inj)[None], **F5_KW)
    for name in ("log_l", "detection_efficiency", "logBFs", "log_nEffs", "log_nEff_inj", "variance_log_likelihood"):
        np.testing.assert_allclose(lin.trace[name]["value"][0].numpy(), np.asarray(jtr.trace[name]["value"]),
                                   rtol=1e-10, err_msg=name)
    for fn, jfn, args in ((analysis.per_event_log_bayes_factors, janalysis.per_event_log_bayes_factors, (pe,)),
                          (analysis.detection_efficiency, janalysis.detection_efficiency, (inj, 2e4))):
        got = fn(torch.tensor(args[0]), *args[1:])
        for g, w in zip(got, jfn(jnp.asarray(args[0]), *args[1:])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
    with ppl.trace() as tr:
        analysis.hierarchical_likelihood(torch.tensor(np.log(pe))[None], torch.tensor(np.log(inj))[None], log=True, **F5_KW)
    np.testing.assert_allclose(float(tr.trace["log_l"]["value"][0]), want, rtol=1e-12)
    np.testing.assert_allclose(float(tr.trace["detection_efficiency"]["value"][0]),
                               float(jtr.trace["detection_efficiency"]["value"]), rtol=1e-12)


@pytest.mark.parametrize("option", [dict(categorical=True, pop_frac=[1.0, 0.0], rngkey=3),
                                    dict(marginal_qs=True, indv_weights=[np.ones((5, 400))]),
                                    dict(indv_weights=np.ones(3)), dict(rngkey=0), dict(pop_frac=[0.5, 0.5])],
                         ids=["categorical", "marginal_qs", "indv_weights", "rngkey", "pop_frac"])
def test_unported_likelihood_options_raise(option):
    """Each option the port once raised on is taken and gives the JAX
    package's likelihood: categorical subpopulations (a pair of banks, all
    events in the first), and the options that matter only with another
    (the posterior-predictive ``marginal_qs`` and ``indv_weights``, the
    categorical ``rngkey`` and ``pop_frac``)."""
    pe, inj = _linear_reproduction()
    pe_t, inj_t = torch.tensor(np.log(pe))[None], torch.tensor(np.log(inj))[None]
    jpe = jnp.log(jnp.asarray(pe))
    if option.get("categorical"):
        pe_t, jpe = (pe_t, 0.5 * pe_t), [jpe, 0.5 * jpe]
    jopt = dict(option, **({"rngkey": jax.random.PRNGKey(option["rngkey"])} if "rngkey" in option else {}))
    with jppl.trace() as jtr:
        janalysis.hierarchical_likelihood(jpe, jnp.log(jnp.asarray(inj)), log=True, **jopt, **F5_KW)
    with ppl.trace() as tr:
        analysis.hierarchical_likelihood(pe_t, inj_t, log=True, **option, **F5_KW)
    for name in ("log_l", "logBFs", "log_nEffs", "detection_efficiency"):
        np.testing.assert_allclose(tr.trace[name]["value"][0].numpy(), np.asarray(jtr.trace[name]["value"]),
                                   rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("name", ["hierarchical_likelihood", "per_event_log_bayes_factors", "detection_efficiency"])
def test_likelihood_signatures_match_the_reference(name):
    """Each positional argument binds to the JAX package's parameter of the
    same name, with the same default."""
    import inspect

    got = inspect.signature(getattr(analysis, name)).parameters
    want = inspect.signature(getattr(janalysis, name)).parameters
    assert list(got) == list(want)
    for p in want.values():
        assert got[p.name].kind == p.kind and got[p.name].default == p.default, p.name
