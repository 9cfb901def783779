"""The port's config-driven pipeline against the JAX package's, on the CPU in
float64: the parser, ``construct_hierarchical_model``'s log density,
gradient and deterministic sites for C = 3 chains against the JAX model per
chain (rtol 1e-9), the posterior-predictive sites, the diagnostics and the
CLI end to end.  The catalogs are read directly from ``tests/data`` (the
config-validation catalog, and the synthetic catalog for the spin blocks of
the iid config)."""

import copy
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy import stats

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.infer import diagnostics as jdiag
from gwinferno_tpu.pipeline.analysis import construct_hierarchical_model as jax_model_of
from gwinferno_tpu.pipeline.parser import ConfigReader as JaxReader
from gwinferno_tpu.pipeline.parser import PopMixtureModel as JaxMixture
from gwinferno_tpu.pipeline.utils import posterior_dict_to_xarray as jax_posterior_dataset
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import MCMC
from gwinferno_tpu_torch.infer import NUTS
from gwinferno_tpu_torch.infer import diagnostics
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline import cli
from gwinferno_tpu_torch.pipeline.analysis import construct_hierarchical_model
from gwinferno_tpu_torch.pipeline.parser import ConfigReader
from gwinferno_tpu_torch.pipeline.parser import PopMixtureModel
from gwinferno_tpu_torch.pipeline.parser import PopPrior
from gwinferno_tpu_torch.pipeline.parser import load_model_from_python_file
from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict
from gwinferno_tpu_torch.utils.prof import Timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "examples", "config_files")
CONFIG_VAL_DATA = os.path.join(ROOT, "tests", "data", "pe_inj_config_val.h5")
SYNTHETIC_DATA = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
C = 3

# the mixture config of tests/ppl/test_mixture.py
MIXTURE_MODELS = """
  mass_1:
    model: numpyro.distributions.MixtureGeneral
    mixture_dist:
      model: numpyro.distributions.Categorical
      hyper_params:
        probs:
          value: [0.75, 0.25]
    component_1:
      model: gwinferno.numpyro_distributions.Powerlaw
      hyper_params:
        alpha:
          prior: numpyro.distributions.Normal
          prior_params: {loc: 0.0, scale: 3.0}
        minimum: {value: 5.0}
        maximum: {value: 100.0}
    component_2:
      model: numpyro.distributions.TruncatedNormal
      hyper_params:
        loc: {value: 35.0}
        scale: {value: 5.0}
        low: {value: 5.0}
        high: {value: 100.0}
  mass_ratio:
    model: gwinferno.numpyro_distributions.Powerlaw
    hyper_params:
      alpha: {value: 1.0}
      minimum: {value: 0.02}
      maximum: {value: 1.0}
  redshift:
    model: gwinferno.numpyro_distributions.PowerlawRedshift
    hyper_params:
      lamb: {value: 1.7}
      maximum: {value: 2.3}
"""
MIXTURE = f"""
label: mixture_roundtrip
outdir: /tmp/mixture_roundtrip
models:{MIXTURE_MODELS}
likelihood:
  min_neff_cut: false
  posterior_predictive_check: false
"""
# the same mixture with sampled mixing weights (a simplex site) and a
# sampled peak location (a PPL distribution with a chain-batched parameter)
MIXTURE_SAMPLED = MIXTURE.replace(
    "        probs:\n          value: [0.75, 0.25]",
    "        probs:\n          prior: numpyro.distributions.Dirichlet\n          prior_params: {concentration: [3.0, 1.0]}",
).replace("        loc: {value: 35.0}", "        loc:\n          prior: numpyro.distributions.Uniform\n"
          "          prior_params: {low: 20.0, high: 50.0}")
# the iid config of tests/pipeline/test_config.py (a_1 iid -> a_2)
IID = """
label: iid_roundtrip
outdir: /tmp/iid_roundtrip
models:
  mass_1:
    model: gwinferno.numpyro_distributions.Powerlaw
    hyper_params:
      alpha:
        prior: numpyro.distributions.Normal
        prior_params: {loc: 0.0, scale: 3.0}
      minimum: {value: 5.0}
      maximum: {value: 100.0}
  mass_ratio:
    model: gwinferno.numpyro_distributions.Powerlaw
    hyper_params:
      alpha: {value: 1.0}
      minimum: {value: 0.02}
      maximum: {value: 1.0}
  redshift:
    model: gwinferno.numpyro_distributions.PowerlawRedshift
    hyper_params:
      lamb: {value: 2.0}
      maximum: {value: 2.3}
  a_1:
    model: gwinferno.numpyro_distributions.Powerlaw
    hyper_params:
      alpha:
        prior: numpyro.distributions.Normal
        prior_params: {loc: 0.0, scale: 2.0}
      minimum: {value: 0.001}
      maximum: {value: 1.0}
    iid:
      shared_parameter: a_2
sampler:
  kernel: NUTS
likelihood:
  marginalize_selection: false
  min_neff_cut: false
  max_variance_cut: false
  posterior_predictive_check: false
"""

SMOOTHED = {
    "mass_1_alpha": [-2.35, -2.0, -3.0], "mass_1_minimum": [8.0, 6.0, 10.0], "mass_1_maximum": [70.0, 60.0, 80.0],
    "mass_1_alpha_min": [2.0, 1.0, 3.0], "mass_1_alpha_max": [10.0, 6.0, 15.0], "mass_ratio_alpha": [1.2, 0.5, 2.0],
    "redshift_lamb": [1.7, 0.5, 3.0], "unscaled_rate": [69.0, 50.0, 90.0],
}
# name: (config text or file, catalog, constrained values per chain)
CASES = {
    "config": (os.path.join(CONFIG_DIR, "config.yml"), "config_val", SMOOTHED),
    "config_validation": (os.path.join(CONFIG_DIR, "config_validation.yml"), "config_val", SMOOTHED),
    "mixture": (MIXTURE, "config_val", {"mass_1_component_1_alpha": [-2.0, -3.0, 0.5], "unscaled_rate": [40.0, 60.0, 80.0]}),
    "mixture_sampled": (MIXTURE_SAMPLED, "config_val", {
        "mass_1_component_1_alpha": [-2.0, -3.0, 0.5], "mass_1_component_2_loc": [35.0, 25.0, 45.0],
        "mass_1_mixture_dist_probs": [[0.75, 0.25], [0.5, 0.5], [0.9, 0.1]], "unscaled_rate": [40.0, 60.0, 80.0]}),
    "iid": (IID, "synthetic", {"mass_1_alpha": [-2.0, -2.5, -1.5], "a_1_alpha": [1.3, 0.2, -0.5],
                               "unscaled_rate": [40.0, 60.0, 80.0]}),
}


def _readers(case, tmp_path):
    src = CASES[case][0]
    if not src.endswith(".yml"):
        path = tmp_path / f"{case}.yml"
        path.write_text(src)
        src = str(path)
    r, j = ConfigReader(), JaxReader()
    r.parse(src)
    j.parse(src)
    return r, j, src


_CATALOGS = {}


def _catalog(name):
    """``(port args (tensors), JAX args)`` of a catalog: the config-validation
    catalog whole, the synthetic one on the first 200 samples of each
    event."""
    if name not in _CATALOGS:
        path, n = (CONFIG_VAL_DATA, None) if name == "config_val" else (SYNTHETIC_DATA, 200)
        pe, inj, const, _ = load_pe_and_injections_as_dict(path)
        pe = {k: v[:, :n] for k, v in pe.items()}
        tail = (const["total_inj"], const["nObs"], const["obs_time"])
        _CATALOGS[name] = (
            ({k: torch.tensor(v) for k, v in pe.items()}, {k: torch.tensor(v) for k, v in inj.items()}) + tail,
            ({k: jnp.asarray(v) for k, v in pe.items()}, {k: jnp.asarray(v) for k, v in inj.items()}) + tail,
        )
    return _CATALOGS[name]


def _plain(v):
    return np.asarray(v).tolist() if hasattr(v, "shape") else v


def _record(rec):
    if isinstance(rec, PopPrior) or (hasattr(rec, "dist") and hasattr(rec, "params")):
        return (rec.dist.__name__, {k: _plain(v) for k, v in rec.params.items()})
    return _plain(rec)


def _model_record(m):
    if isinstance(m, str):
        return m
    if isinstance(m, (PopMixtureModel, JaxMixture)):
        return (m.model.__name__, m.mixing_dist.__name__, m.mixing_params, [c.__name__ for c in m.components],
                m.component_params)
    return (m.model.__name__, m.params)


@pytest.mark.parametrize("case", list(CASES))
def test_config_reader_matches_jax(case, tmp_path):
    r, j, src = _readers(case, tmp_path)
    assert {k: _model_record(v) for k, v in r.models.items()} == {k: _model_record(v) for k, v in j.models.items()}
    assert {k: _record(v) for k, v in r.priors.items()} == {k: _record(v) for k, v in j.priors.items()}
    assert r.sampling_params == j.sampling_params
    for attr in ("label", "outdir", "data_conf", "sampler_conf", "likelihood_kwargs"):
        assert getattr(r, attr) == getattr(j, attr)
    for m in r.models.values():
        if not isinstance(m, str):
            assert m.model.__module__.startswith("gwinferno_tpu_torch.")
    # the mapping form gives the same reader as the file
    d = ConfigReader()
    with open(src) as f:
        d.parse_dict(yaml.safe_load(f))
    assert {k: _model_record(v) for k, v in d.models.items()} == {k: _model_record(v) for k, v in r.models.items()}
    assert {k: _record(v) for k, v in d.priors.items()} == {k: _record(v) for k, v in r.priors.items()}
    assert (d.sampling_params, d.sampler_conf, d.likelihood_kwargs) == (r.sampling_params, r.sampler_conf,
                                                                        r.likelihood_kwargs)


def test_smoke_holds_the_parsed_validation_config():
    import chip_smoke

    with open(os.path.join(CONFIG_DIR, "config_validation.yml")) as f:
        assert chip_smoke.CONFIG_VALIDATION == yaml.safe_load(f)


def test_python_file_model_loads_and_runs(tmp_path):
    reader = ConfigReader()
    reader.parse(os.path.join(CONFIG_DIR, "config_w_py_model.yml"))
    assert reader.models == {"file_path": "examples/config_files/model.py"} and not reader.priors
    path = tmp_path / "torch_model.py"
    path.write_text(
        "import torch\n"
        "from gwinferno_tpu_torch import ppl\n"
        "from gwinferno_tpu_torch.pipeline.analysis import hierarchical_likelihood\n"
        "from gwinferno_tpu_torch.population_distributions import Powerlaw, PowerlawRedshift\n"
        "from gwinferno_tpu_torch.ppl import distributions as dist\n\n"
        "def model(samps, injs, Ninj, Nobs, Tobs):\n"
        "    alpha = ppl.sample('alpha', dist.Normal(0.0, 3.0))\n"
        "    lamb = ppl.sample('lamb', dist.Normal(0.0, 3.0))\n"
        "    m, z = Powerlaw(alpha, minimum=2.0, maximum=100.0), PowerlawRedshift(lamb, maximum=2.3)\n"
        "    lw = [m.log_prob(d['mass_1']) + z.log_prob(d['redshift']) - torch.log(d['prior']) for d in (samps, injs)]\n"
        "    hierarchical_likelihood(lw[0], lw[1], Ninj, Nobs, Tobs, surveyed_hypervolume=z.norm, min_neff_cut=False,\n"
        "                            log=True)\n"
    )
    model = load_model_from_python_file(str(path))
    args = _catalog("config_val")[0]
    pot = ppl.ModelPotential(model, args, device="cpu", dtype=torch.float64)
    assert pot.names == ["alpha", "lamb", "unscaled_rate"]
    u, g = pot.value_and_grad(torch.tensor([[-1.5, 0.5, 4.0], [-2.0, 1.5, 4.2]], dtype=torch.float64))
    assert bool(torch.isfinite(u).all() and torch.isfinite(g).all())


def _jax_fns(jmodel, jargs):
    pe = jax.jit(jax.value_and_grad(lambda p: jppl.potential_energy(jmodel, jargs, {}, p)))
    return pe, lambda p: jppl.log_density(jmodel, jargs, {}, p)[1]


@pytest.mark.parametrize("case", list(CASES))
def test_hierarchical_model_matches_jax_per_chain(case, tmp_path):
    """Log density and gradient at C = 3 seeded points, against the JAX
    model per chain (rtol 1e-9), and the deterministic sites the CLI
    collects."""
    r, j, _ = _readers(case, tmp_path)
    args, jargs = _catalog(CASES[case][1])
    model = construct_hierarchical_model(r.models, r.priors, **r.likelihood_kwargs)
    jmodel = jax_model_of(j.models, j.priors, **j.likelihood_kwargs)
    pot = ppl.ModelPotential(model, args, device="cpu", dtype=torch.float64)
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in CASES[case][2].items()}
    assert pot.names == sorted(params)
    z = pot.unconstrain(params, C)
    u, grad = pot.value_and_grad(z)
    uz = pot.unravel(z)
    _, trace = ppl.log_density(model, args, {}, params)
    jpe, jtrace = _jax_fns(jmodel, jargs)
    for c in range(C):
        want, jg = jpe({k: jnp.asarray(v[c].numpy()) for k, v in uz.items()})
        np.testing.assert_allclose(float(u[c]), float(want), rtol=1e-9)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(jax.flatten_util.ravel_pytree(jg)[0]), rtol=1e-9,
                                   atol=1e-9)
        jt = jtrace({k: jnp.asarray(v[c].numpy()) for k, v in params.items()})
        for site in cli.DETERMINISTIC_SITES:
            value = np.broadcast_to(trace[site]["value"].numpy(), (C,))  # no chain axis when pinned
            np.testing.assert_allclose(value[c], float(jt[site]["value"]), rtol=1e-9)
    assert bool((u.abs() < 1e300).all())  # the points are off the likelihood walls


def _ppc_trace(model, args, params, site_names=None):
    with ppl.trace() as tr, ppl.substitute(data=params), ppl.collect_deterministic(site_names=site_names):
        model(*args)
    return tr.trace


def test_posterior_predictive_sites_match_jax_names_and_shapes(tmp_path):
    r, j, _ = _readers("config_validation", tmp_path)
    args, jargs = _catalog("config_val")
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in SMOOTHED.items()}
    model = construct_hierarchical_model(r.models, r.priors, **r.likelihood_kwargs)
    tr = _ppc_trace(model, args, params)
    ppc = {k: v["value"] for k, v in tr.items() if "_event_" in k}
    jt = jppl.log_density(jax_model_of(j.models, j.priors, **j.likelihood_kwargs), jargs, {},
                          {k: jnp.asarray(v[0].numpy()) for k, v in params.items()})[1]
    jppc = {k: v["value"] for k, v in jt.items() if "_event_" in k}
    assert set(ppc) == set(jppc) and len(ppc) == 69 * 3 * 2
    assert all(tuple(v.shape) == (C,) + tuple(np.shape(jppc[k])) for k, v in ppc.items())
    # each draw is one of its event's samples (or one of the injections)
    for ev in (0, 33, 68):
        assert bool(torch.isin(ppc[f"mass_1_obs_event_{ev}"], args[0]["mass_1"][ev]).all())
        assert bool(torch.isin(ppc[f"redshift_pred_event_{ev}"], args[1]["redshift"]).all())
    # deterministic given the weights: again, and for one chain alone
    again = _ppc_trace(model, args, params)
    alone = _ppc_trace(model, args, {k: v[1:2] for k, v in params.items()})
    for k in ppc:
        assert torch.equal(ppc[k], again[k]["value"]) and torch.equal(ppc[k][1:2], alone[k]["value"])


def test_posterior_predictive_draw_frequencies_follow_the_weights():
    """On a small bank of 2000 identical events, the observed draws' and the
    predicted draws' frequencies against the weights: chi-square test, each
    at the 0.1% level."""
    E, S, N = 2000, 4, 5
    w_pe, w_inj = np.array([0.1, 0.2, 0.3, 0.4]), np.array([0.05, 0.1, 0.15, 0.3, 0.4])
    pedata = {"mass_1": torch.arange(10.0, 10.0 + S, dtype=torch.float64).expand(E, S),
              "mass_ratio": torch.full((E, S), 0.5, dtype=torch.float64)}
    injdata = {"mass_1": torch.arange(20.0, 20.0 + N, dtype=torch.float64), "mass_ratio": torch.full((N,), 0.5,
                                                                                                   dtype=torch.float64)}
    pe_lw = torch.log(torch.tensor(w_pe)).expand(1, E, S)
    inj_lw = torch.log(torch.tensor(w_inj))[None]
    with ppl.trace() as handler:
        analysis._posterior_predictive_sites(pe_lw, inj_lw, pedata, injdata, ("mass_1",), m1min=2.0, m2min=2.0)
    tr = handler.trace
    obs = torch.stack([tr[f"mass_1_obs_event_{ev}"]["value"][0] for ev in range(E)]) - 10.0
    pred = torch.stack([tr[f"mass_1_pred_event_{ev}"]["value"][0] for ev in range(E)]) - 20.0
    for draws, w in ((obs, w_pe), (pred, w_inj)):
        counts = np.bincount(draws.long().numpy(), minlength=len(w))
        assert stats.chisquare(counts, E * w).pvalue > 1e-3, counts
    # a masked sample is never drawn
    masked = dict(pedata, mass_1=pedata["mass_1"].clone())
    masked["mass_1"][:, 3] = 150.0
    with ppl.trace() as handler:
        analysis._posterior_predictive_sites(pe_lw, inj_lw, masked, injdata, ("mass_1",), m1min=2.0, m2min=2.0)
    assert all(float(handler.trace[f"mass_1_obs_event_{ev}"]["value"][0]) < 150.0 for ev in range(E))


def test_no_posterior_predictive_draw_in_the_gradient(tmp_path, monkeypatch):
    r, _, _ = _readers("config_validation", tmp_path)
    args, _ = _catalog("config_val")
    calls = []
    real = analysis._posterior_predictive_sites
    monkeypatch.setattr(analysis, "_posterior_predictive_sites", lambda *a, **k: calls.append(1) or real(*a, **k))
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in SMOOTHED.items()}
    kw = dict(r.likelihood_kwargs)
    assert kw["posterior_predictive_check"] is True
    pots = {}
    for check in (True, False):
        kw["posterior_predictive_check"] = check
        pots[check] = ppl.ModelPotential(construct_hierarchical_model(r.models, r.priors, **kw), args, device="cpu",
                                         dtype=torch.float64)
    z = pots[True].unconstrain(params, C)
    u_on, g_on = pots[True].value_and_grad(z)
    assert calls == []
    u_off, g_off = pots[False].value_and_grad(z)
    assert torch.equal(u_on, u_off) and torch.equal(g_on, g_off)
    _ppc_trace(pots[True].model, args, params, site_names=set(cli.DETERMINISTIC_SITES))
    assert calls == []
    tr = _ppc_trace(pots[True].model, args, params, site_names={"redshift_pred_event_5"})
    assert calls == [1] and tr["redshift_pred_event_5"]["value"].shape == (C,)


def test_hpdi_and_summary_match_jax():
    rng = np.random.default_rng(3)
    samples = {"a": rng.normal(size=(4, 150)), "b": rng.gamma(2.0, size=(4, 150, 2)),
               "stuck": np.ones((2, 30))}
    for x in (samples["a"], samples["b"][..., 1]):
        np.testing.assert_allclose(diagnostics.hpdi(torch.tensor(x), 0.8), jdiag.hpdi(x, 0.8), rtol=1e-12)
    got = diagnostics.summary({k: torch.tensor(v) for k, v in samples.items()}, prob=0.9)
    want = jdiag.summary(samples, prob=0.9)
    assert list(got) == list(want) == ["a", "b[0]", "b[1]", "stuck"]
    for label in want:
        assert list(got[label]) == list(want[label])
        np.testing.assert_allclose(list(got[label].values()), list(want[label].values()), rtol=1e-12)


def test_mcmc_print_summary_and_max_steps_per_call(capsys):
    def model():
        ppl.sample("x", ppl.distributions.Normal(1.0, 0.5))

    with pytest.raises(ValueError, match="max_steps_per_call"):
        MCMC(NUTS(model), device="cpu", max_steps_per_call=0)
    runs = []
    for cap in (None, 3):
        mcmc = MCMC(NUTS(model, max_tree_depth=3), num_warmup=10, num_samples=10, num_chains=2, device="cpu",
                    dtype=torch.float64, max_steps_per_call=cap)
        runs.append(mcmc.run(5).get_samples()["x"])
    assert torch.equal(runs[0], runs[1])
    mcmc.print_summary()
    out = capsys.readouterr().out
    assert "90% hpdi lo" in out and "Number of divergences:" in out and out.splitlines()[1].split()[0] == "x"


def test_kernel_map_holds_nuts_and_hmc_raises():
    """The config's ``sampler.kernel`` names the port's NUTS or HMC; HMC no
    longer raises."""
    from gwinferno_tpu_torch.infer import HMC

    assert analysis.NP_KERNEL_MAP["NUTS"] is NUTS
    assert analysis.NP_KERNEL_MAP["HMC"] is HMC
    assert HMC(lambda: None, trajectory_length=0.5).trajectory_length == 0.5


def test_run_config_with_the_hmc_kernel(tmp_path, capsys):
    """``kernel: HMC`` in the sampler block runs through ``run_config`` on
    the config-validation catalog: every site and deterministic site finite,
    ``ceil(L / step size)`` leapfrogs a transition, no tree."""
    path, conf = _tmp_config(tmp_path)
    conf["sampler"]["kernel"] = "HMC"
    conf["sampler"]["kernel_kwargs"] = {"dense_mass": True, "trajectory_length": 0.2}
    reader = ConfigReader()
    reader.parse_dict(conf)
    pe, inj, const, _ = load_pe_and_injections_as_dict(CONFIG_VAL_DATA)
    mcmc, posterior = cli.run_config(reader, pe, inj, const, rng_seed=1, device="cpu", dtype=torch.float64)
    assert "Number of divergences" in capsys.readouterr().out
    assert type(mcmc.kernel).__name__ == "HMC" and mcmc.kernel.trajectory_length == 0.2
    assert set(cli.DETERMINISTIC_SITES) <= set(posterior)
    assert all(tuple(v.shape) == (6,) and bool(torch.isfinite(v).all()) for v in posterior.values())
    extra = mcmc.get_extra_fields(group_by_chain=True)
    steps = torch.ceil(0.2 / mcmc._adapt_info["step_size"]).clamp(1, 1023).to(torch.int64)
    assert torch.equal(extra["num_steps"], steps[:, None].expand(2, 3))
    assert int(extra["tree_depth"].abs().sum()) == 0


def _tmp_config(tmp_path):
    with open(os.path.join(CONFIG_DIR, "config_validation.yml")) as f:
        conf = yaml.safe_load(f)
    conf = copy.deepcopy(conf)
    conf["outdir"] = str(tmp_path / "run")
    conf["data"]["pe_inj_file"] = CONFIG_VAL_DATA
    conf["sampler"]["kernel_kwargs"]["max_tree_depth"] = 3
    conf["sampler"]["mcmc_kwargs"].update(num_warmup=4, num_samples=3, num_chains=2)
    path = tmp_path / "config_validation.yml"
    path.write_text(yaml.safe_dump(conf))
    return str(path), conf


def test_run_inference_writes_the_jax_layout(tmp_path, monkeypatch, capsys):
    path, conf = _tmp_config(tmp_path)
    cli.main([path, "--inspect", "--device", "cpu"])
    assert "sampling params: ['mass_1_alpha'" in capsys.readouterr().out
    calls = []
    real = analysis._posterior_predictive_sites
    monkeypatch.setattr(analysis, "_posterior_predictive_sites", lambda *a, **k: calls.append(1) or real(*a, **k))
    mcmc = cli.run_inference(path, device="cpu", dtype=torch.float64)
    out = capsys.readouterr().out
    assert "Number of divergences" in out and "posterior saved" in out and calls == []
    post_file = os.path.join(conf["outdir"], f"{conf['label']}_posterior_samples.h5")
    assert os.path.exists(os.path.join(conf["outdir"], f"trace_{conf['label']}.png"))
    sites = {
        "mass_1_alpha", "mass_1_minimum", "mass_1_maximum", "mass_1_alpha_min", "mass_1_alpha_max",
        "mass_ratio_alpha", "redshift_lamb", "unscaled_rate"}
    with h5py.File(post_file, "r") as f:
        got = {k: (f[k].shape, f[k].dtype, [s.decode() for s in f[k].attrs["dims"]] if "dims" in f[k].attrs else None)
               for k in f}
        posterior = {k: f[k][()] for k in f if not k.startswith("_coord_")}
    assert set(posterior) == sites | set(cli.DETERMINISTIC_SITES)
    assert all(v.shape == (6,) and np.isfinite(v).all() for v in posterior.values())
    jax_file = str(tmp_path / "jax_layout.h5")
    jax_posterior_dataset(posterior).to_hdf5(jax_file)
    with h5py.File(jax_file, "r") as f:
        want = {k: (f[k].shape, f[k].dtype, [s.decode() for s in f[k].attrs["dims"]] if "dims" in f[k].attrs else None)
                for k in f}
    assert got == want
    # a posterior-predictive site on request, from the run's own draws
    ppc = mcmc.get_deterministic(site_names={"mass_ratio_obs_event_3"})
    assert calls and tuple(ppc["mass_ratio_obs_event_3"].shape) == (6,)


def test_timer_accumulates_phases():
    timer, lines = Timer(), []
    for _ in range(2):
        with timer("a", block_until_ready_on={"x": [torch.zeros(2)]}):
            pass
    timer.report(print_fn=lines.append)
    assert timer.counts["a"] == 2 and lines[0].strip().startswith("a:") and lines[-1].strip().startswith("total")
