"""The README's quick-start examples on the port, on the CPU in float64,
against the JAX package's examples.

The catalog is a slice of ``tests/data/pe_inj_synthetic.h5`` read directly
(never through the conftest fixtures that run the generator): the first 5
events x 300 PE samples and the first 8000 found injections.  The JAX
examples are loaded from their files, with ``examples/`` first on
``sys.path`` (they run ``from utils import ...``).

Tolerances: the powerlaw+peak model's potential and gradient rtol 1e-9
(sums over ~10^4 terms in another order); its Beta shape sites rtol 1e-12
(the same four operations); the PPDs rtol 1e-9 (800-point grids,
trapezoids in another order), as ``tests/test_torch_postprocess.py``.
"""

import os
import sys
from types import SimpleNamespace

import h5py
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JZModel
from gwinferno_tpu.pipeline import utils as jutils
from gwinferno_tpu.postprocess import calculations as jcalc
from gwinferno_tpu.preprocess.conversions import alpha_beta_from_mu_var as jab
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.examples import simple_bspline_example as bex
from gwinferno_tpu_torch.examples import simple_powerlaw_peak_example as pex
from gwinferno_tpu_torch.examples import utils as exutils
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.ops import fused
from gwinferno_tpu_torch.pipeline.bspline_model import build_bspline_models
from gwinferno_tpu_torch.pipeline.utils import load_base_parser
from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict
from gwinferno_tpu_torch.pipeline.utils import to_tensors
from gwinferno_tpu_torch.ppl import ModelPotential
from gwinferno_tpu_torch.utils.dataset import Dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import simple_powerlaw_peak_example as jpex  # noqa: E402

CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)
N_EVENTS, N_SAMPLES, N_FOUND = 5, 300, 8000
MMIN, MMAX = 3.0, 100.0
C = 3
KNOTS = dict(m_nsplines=12, q_nsplines=8, a_nsplines=6, tilt_nsplines=6, z_nsplines=6)


def _slice(pe, inj, const):
    pe = {k: np.ascontiguousarray(v[:N_EVENTS, :N_SAMPLES]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:N_FOUND]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=N_EVENTS)


@pytest.fixture(scope="module")
def catalog():
    pe, inj, const, names = load_pe_and_injections_as_dict(CATALOG)
    return (*_slice(pe, inj, const), names)


def write_small_catalog(path):
    """The slice as a catalog file in the layout of the committed one."""
    with h5py.File(CATALOG, "r") as f, h5py.File(path, "w") as g:
        cut = {"posteriors": np.s_[:N_EVENTS, :, :N_SAMPLES], "injections": np.s_[:, :N_FOUND],
               "_coord_event": np.s_[:N_EVENTS], "_coord_sample": np.s_[:N_SAMPLES],
               "_coord_injection": np.s_[:N_FOUND]}
        for group in ("pe_data", "inj_data"):
            out = g.create_group(group)
            out.attrs.update(dict(f[group].attrs))
            for name, d in f[group].items():
                ds = out.create_dataset(name, data=d[cut.get(name, ())])
                ds.attrs.update(dict(d.attrs))
    return path


# ------------------------------------------------------------ powerlaw+peak


def _plpk_params(rng, n=C):
    """Valid draws around the synthetic catalog's population, ``(n,)`` each."""
    return {
        "alpha": rng.uniform(-3.0, -1.5, n), "beta": rng.uniform(0.0, 2.0, n), "mu_peak": rng.uniform(30.0, 40.0, n),
        "sig_peak": rng.uniform(3.0, 7.0, n), "lambda_m": rng.uniform(0.1, 0.4, n),
        "mu_a1": rng.uniform(0.25, 0.45, n), "var_a1": rng.uniform(0.02, 0.04, n),
        "mu_a2": rng.uniform(0.25, 0.45, n), "var_a2": rng.uniform(0.02, 0.04, n),
        "lambda_ct1": rng.uniform(0.5, 0.9, n), "lambda_ct2": rng.uniform(0.5, 0.9, n),
        "sig_ct1": rng.uniform(0.3, 0.8, n), "sig_ct2": rng.uniform(0.3, 0.8, n), "lamb": rng.uniform(1.0, 2.5, n),
        "unscaled_rate": rng.uniform(3.0, 8.0, n),
    }


def _models(catalog):
    """The port's bound model (banks on the CPU in float64) and the JAX
    example's, over the same slice."""
    pe, inj, const, names = catalog
    z = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    jz = JZModel(pe["redshift"], inj["redshift"])
    tpe, tinj = to_tensors(pe, **F64), to_tensors(inj, **F64)
    args = (const["nObs"], const["obs_time"], const["total_inj"])

    def port():
        pex.model(tpe, tinj, *args, z, MMIN, MMAX, names)

    def ref():
        jpex.model(pe, inj, *args, jz, MMIN, MMAX, names)

    return port, ref, z, jz


def _jax_potential(bound, params):
    u = jax.vmap(lambda q: jppl.unconstrain_fn(bound, (), {}, q))({k: jnp.asarray(v) for k, v in params.items()})
    val, grad = jax.vmap(jax.value_and_grad(lambda uu: jppl.potential_energy(bound, (), {}, uu)))(u)
    return np.asarray(val), np.asarray(jax.vmap(lambda g: jax.flatten_util.ravel_pytree(g)[0])(grad))


def test_powerlaw_peak_potential_and_gradient_match_jax(catalog):
    port, ref, _, _ = _models(catalog)
    params = _plpk_params(np.random.default_rng(0))
    pot = ModelPotential(port, **F64)
    assert pot.names == sorted(params)
    before = fused.DLSE_KERNEL.launches
    u, g = pot.value_and_grad(params_from_jax(params, port, **F64))
    assert fused.DLSE_KERNEL.launches == before, "no CUDA kernel on CPU tensors"
    want_u, want_g = _jax_potential(ref, params)
    assert bool((u.abs() < 1e30).all()), "the points must sit off the likelihood walls"
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-9, atol=1e-9 * float(np.abs(want_g).max()))


def test_powerlaw_peak_potential_matches_jax_at_an_invalid_spin_draw(catalog):
    """A ``(mu, var)`` pair outside the Beta moment map's range (both shapes
    negative): the potential only (the port's ``log_betadist`` gives a zero
    gradient off its support where the JAX one gives NaN, ROADMAP F2)."""
    port, ref, _, _ = _models(catalog)
    params = _plpk_params(np.random.default_rng(1), n=1)
    params["mu_a1"], params["var_a1"] = np.array([0.9]), np.array([0.2])
    a, b = jab(0.9, 0.2)
    assert a < 0 and b < 0
    u, _ = ModelPotential(port, **F64).value_and_grad(params_from_jax(params, port, **F64))
    want_u, _ = _jax_potential(ref, params)
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-9)


def test_powerlaw_peak_deterministic_sites_match_jax(catalog):
    """The four Beta shape sites against the JAX example's; the
    posterior-predictive sites by the JAX names and shapes, each draw one
    of its event's samples or one of the injections, drawn only when asked
    for and the same in two runs."""
    port, ref, _, _ = _models(catalog)
    pe, inj, _, names = catalog
    params = {k: torch.tensor(v) for k, v in _plpk_params(np.random.default_rng(2)).items()}
    with ppl.trace() as tr, ppl.substitute(data=params), ppl.collect_deterministic():
        port()
    with ppl.trace() as again, ppl.substitute(data=params), ppl.collect_deterministic():
        port()
    with ppl.trace() as quiet, ppl.substitute(data=params):
        port()
    assert not any("_event_" in k for k in quiet.trace)
    jt = jax.vmap(lambda p: {k: v["value"] for k, v in jppl.log_density(ref, (), {}, p)[1].items()
                             if v["type"] == "deterministic"})({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    for site in ("alpha_a1", "beta_a1", "alpha_a2", "beta_a2"):
        np.testing.assert_allclose(tr.trace[site]["value"].numpy(), np.asarray(jt[site]), rtol=1e-12)
    ppc = {k: v["value"] for k, v in tr.trace.items() if "_event_" in k}
    assert set(ppc) == {k for k in jt if "_event_" in k}
    assert len(ppc) == N_EVENTS * len(names) * 2
    for k, v in ppc.items():
        assert tuple(v.shape) == tuple(np.shape(jt[k])) == (C,)
        assert torch.equal(v, again.trace[k]["value"])
    for ev in range(N_EVENTS):
        assert bool(torch.isin(ppc[f"mass_1_obs_event_{ev}"], torch.tensor(pe["mass_1"][ev])).all())
        assert bool(torch.isin(ppc[f"redshift_pred_event_{ev}"], torch.tensor(inj["redshift"])).all())


def test_powerlawpeak_ppds_match_the_jax_calculations(catalog):
    """``powerlawpeak_ppds`` against the JAX example's chain of calculations
    on the same 130 posterior draws (more than one batch of 128)."""
    _, _, z, jz = _models(catalog)
    rng = np.random.default_rng(3)
    n = 130
    post = _plpk_params(rng, n)
    post["rate"] = rng.uniform(10.0, 50.0, n)
    args = SimpleNamespace(mmin=MMIN, mmax=MMAX)
    pdfs, grids = pex.powerlawpeak_ppds({k: torch.tensor(v) for k, v in post.items()}, z, args)
    j = {k: jnp.asarray(v) for k, v in post.items()}
    mass, m1s, mass_ratio, qs = jcalc.calculate_powerlaw_peak_mass_ppds(j["alpha"], j["beta"], j["mu_peak"],
                                                                        j["sig_peak"], j["lambda_m"], MMIN, MMAX)
    mag1, mags = jcalc.calculate_beta_spin_mag(*jab(j["mu_a1"], j["var_a1"]))
    mag2, _ = jcalc.calculate_beta_spin_mag(*jab(j["mu_a2"], j["var_a2"]))
    tilt1, tilts = jcalc.calculate_mixture_iso_aligned_spin_tilt(j["sig_ct1"], j["lambda_ct1"])
    tilt2, _ = jcalc.calculate_mixture_iso_aligned_spin_tilt(j["sig_ct2"], j["lambda_ct2"])
    r_of_z, zs = jcalc.calculate_powerlaw_rate_of_z_ppds(j["lamb"], j["rate"], jz)
    want = {"a1": (mag1, mags), "a2": (mag2, mags), "cos_tilt1": (tilt1, tilts), "cos_tilt2": (tilt2, tilts),
            "mass_1": (mass, m1s), "mass_ratio": (mass_ratio, qs), "redshift": (r_of_z, zs)}
    assert set(pdfs) == set(grids) == set(want)
    for k, (pdf, grid) in want.items():
        assert pdfs[k].shape == (n, np.shape(grid)[0])
        np.testing.assert_allclose(grids[k], np.asarray(grid), rtol=1e-12)
        np.testing.assert_allclose(pdfs[k], np.asarray(pdf), rtol=1e-9, atol=1e-12 * float(np.abs(pdf).max()))


def test_bspline_ppds_match_the_jax_calculations(catalog):
    pe, inj, _, _ = catalog
    args = SimpleNamespace(mmin=MMIN, mmax=MMAX, **KNOTS)
    models = build_bspline_models(pe, inj, args, **F64)
    jz = jutils.setup_powerlaw_spline_redshift_model(pe, inj, args.z_nsplines)
    rng = np.random.default_rng(4)
    n = 5
    post = {"mass_cs": 0.4 * rng.standard_normal((n, 12)), "q_cs": 0.3 * rng.standard_normal((n, 8)),
            "a_cs": 0.3 * rng.standard_normal((n, 6)), "tilt_cs": 0.3 * rng.standard_normal((n, 6)),
            "z_cs": 0.3 * rng.standard_normal((n, 5)), "lamb": rng.uniform(1.0, 2.5, n),
            "rate": rng.uniform(10.0, 50.0, n)}
    pdfs, grids = bex.bspline_ppds({k: torch.tensor(v) for k, v in post.items()}, models, args)
    knots = {"m1": 12, "q": 8, "a": 6, "tilt": 6, "redshift": 6}
    j = {k: jnp.asarray(v) for k, v in post.items()}
    mass, m1s, mass_ratio, qs = jcalc.calculate_bspline_mass_ppds(j["mass_cs"], j["q_cs"], knots, MMIN, MMAX)
    apdfs, mags, ctpdfs, tilts = jcalc.calculate_bspline_spin_ppds(j["a_cs"], j["tilt_cs"], knots)
    r_of_z, zs = jcalc.calculate_powerlaw_spline_rate_of_z_ppds(j["lamb"], j["z_cs"], j["rate"], jz)
    want = {"a1": (apdfs, mags), "cos_tilt1": (ctpdfs, tilts), "mass_1": (mass, m1s), "mass_ratio": (mass_ratio, qs),
            "redshift": (r_of_z, zs)}
    assert set(pdfs) == set(grids) == set(want)
    for k, (pdf, grid) in want.items():
        np.testing.assert_allclose(grids[k], np.asarray(grid), rtol=1e-12)
        np.testing.assert_allclose(pdfs[k], np.asarray(pdf), rtol=1e-9, atol=1e-12 * float(np.abs(pdf).max()))


# --------------------------------------------------------------- the mains

RUN = ["--device", "cpu", "--dtype", "float64", "--warmup", "3", "--samples", "3", "--chains", "1"]


def _outputs(result_dir, label):
    return (os.path.join(result_dir, f"{label}_posterior_samples.h5"), os.path.join(result_dir, f"{label}_pdfs.h5"),
            sorted(f for f in os.listdir(result_dir) if f.endswith(".png")))


def test_powerlaw_peak_main_end_to_end(tmp_path, capsys):
    path = write_small_catalog(str(tmp_path / "catalog.h5"))
    out = str(tmp_path / "plpk")
    pex.main(["--pe-inj-file", path, "--result-dir", out, *RUN])
    posterior, pdfs, plots = _outputs(out, "powerlaw_peak")
    samples = Dataset.from_hdf5(posterior)
    for site in ("alpha", "mu_a1", "lamb", "rate", "surveyed_hypervolume", "detection_efficiency"):
        assert site in samples and samples[site].shape == (3,)
        assert np.isfinite(np.asarray(samples[site])).all()
    pdf = Dataset.from_hdf5(pdfs)
    for k in ("a1", "a2", "cos_tilt1", "cos_tilt2", "mass_1", "mass_ratio", "redshift"):
        assert k in pdf and pdf[k].shape[0] == 3
    assert plots == sorted(f"{k}_pdf_powerlaw_peak.png" for k in ("cos_tilt1", "cos_tilt2", "mass", "mass_ratio",
                                                                  "redshift", "spin_mag1", "spin_mag2"))
    assert "pdfs saved" in capsys.readouterr().out


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_bspline_main_end_to_end(tmp_path, route):
    path = write_small_catalog(str(tmp_path / "catalog.h5"))
    out = str(tmp_path / route)
    knots = [f"--{k.replace('_', '-')}={v}" for k, v in KNOTS.items()]
    bex.main(["--pe-inj-file", path, "--result-dir", out, *knots, *RUN] + (["--fused"] if route == "fused" else []))
    posterior, pdfs, plots = _outputs(out, "bspline")
    samples = Dataset.from_hdf5(posterior)
    for site in ("mass_cs", "q_cs", "a_cs", "tilt_cs", "z_cs", "lamb", "rate"):
        assert site in samples and np.isfinite(np.asarray(samples[site])).all()
    pdf = Dataset.from_hdf5(pdfs)
    for k in ("a1", "cos_tilt1", "mass_1", "mass_ratio", "redshift"):
        assert k in pdf and np.isfinite(np.asarray(pdf[k])).all()
    assert plots == sorted(f"{k}_pdf_bspline.png" for k in ("cos_tilt1", "mass", "mass_ratio", "redshift",
                                                            "spin_mag1"))


def test_examples_run_on_cuda_unless_asked(monkeypatch, tmp_path):
    """Without ``--device`` the examples ask for CUDA and raise where it is
    absent, before reading the catalog; the runners raise the same way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (pex.main, bex.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--pe-inj-file", str(tmp_path / "absent.h5")])
    args = load_base_parser().parse_args([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exutils.run_powerlawpeak_analysis(pex.model, {"redshift": np.ones((1, 2))}, {"redshift": np.ones(2)}, {}, [],
                                          args, skip_inference=True)


def test_setup_result_dir_and_the_parser(tmp_path):
    parser = exutils.add_device_arguments(load_base_parser())
    args = parser.parse_args(["--result-dir", str(tmp_path / "r")])
    assert (args.device, args.dtype, args.save_plots) == ("cuda", "float32", True)
    label, result_dir = exutils.setup_result_dir(args, default_label="powerlaw_peak")
    assert label == "powerlaw_peak" and os.path.isdir(result_dir)
    args = parser.parse_args(["--run-label", "x"])
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        assert exutils.setup_result_dir(args) == ("x", "results/x") and os.path.isdir(tmp_path / "results" / "x")
    finally:
        os.chdir(cwd)


def test_run_powerlawpeak_analysis_returns_the_sites_and_the_run(catalog):
    pe, inj, const, names = catalog
    args = load_base_parser().parse_args(["--warmup", "2", "--samples", "2", "--chains", "2", "--max-tree-depth", "3"])
    params = {k: torch.tensor(v) for k, v in _plpk_params(np.random.default_rng(5), n=2).items()}
    posterior, z, mcmc = exutils.run_powerlawpeak_analysis(pex.model, pe, inj, const, names, args, init_params=params,
                                                           **F64)
    assert isinstance(z, PowerlawRedshiftModel) and mcmc.num_chains == 2
    assert set(posterior) == set(params) | {"rate", "surveyed_hypervolume", "detection_efficiency"}
    for v in posterior.values():
        assert tuple(v.shape) == (4,) and bool(torch.isfinite(v).all())


def test_run_bspline_analysis_returns_the_sites_and_the_run(catalog, capsys):
    """The B-spline runner is the pipeline's, and returns its run third as
    the powerlaw+peak runner does, after a progress bar and a summary."""
    from gwinferno_tpu_torch.pipeline import bspline_model

    assert exutils.run_bspline_analysis is bspline_model.run_bspline_analysis
    pe, inj, const, names = catalog
    knots = [f"--{k.replace('_', '-')}={v}" for k, v in KNOTS.items()]
    args = load_base_parser().parse_args([*knots, "--warmup", "2", "--samples", "2", "--chains", "2",
                                          "--max-tree-depth", "3"])
    posterior, models, mcmc = exutils.run_bspline_analysis(pe, inj, const, names, args, **F64)
    assert "z" in models and "_mcmc" not in models and mcmc.num_chains == 2 and mcmc.progress_bar
    for site in ("mass_cs", "q_cs", "a_cs", "tilt_cs", "z_cs", "lamb", "rate"):
        assert posterior[site].shape[0] == 4 and bool(torch.isfinite(posterior[site]).all())
    assert "[mcmc] sample step 4/4" in capsys.readouterr().err
