"""The port's preprocessing (``gwinferno_tpu_torch/preprocess/``) against the
JAX package's on the CPU in float64: conversions and priors (the same numpy
code: 1e-13 relative), the C++ chi_p prior library of each package's build
(1e-12), the O3 and O4a injection readers on synthetic files of each schema
variant (bit for bit), the catalog pipeline and the spin conversion (1e-12,
the same downsampled samples), the idata round trip, importance resampling,
and the slice as a whole: a small raw catalog preprocessed by each package,
then the chi_eff config route's model of each parser at three points.  Every
input is made here from a seed, into ``tmp_path``; no conftest fixture."""

import json
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy import stats

import chip_smoke
from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.pipeline.analysis import construct_hierarchical_model as jax_model_of
from gwinferno_tpu.pipeline.parser import ConfigReader as JaxReader
from gwinferno_tpu.preprocess import conversions as jconv
from gwinferno_tpu.preprocess import data_collection as jdc
from gwinferno_tpu.preprocess import native as jnative
from gwinferno_tpu.preprocess import priors as jpriors
from gwinferno_tpu.preprocess import selection as jsel
from gwinferno_tpu.utils.dataset import Dataset as JaxDataset
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.pipeline.analysis import construct_hierarchical_model
from gwinferno_tpu_torch.pipeline.parser import ConfigReader
from gwinferno_tpu_torch.preprocess import conversions
from gwinferno_tpu_torch.preprocess import data_collection as dc
from gwinferno_tpu_torch.preprocess import native
from gwinferno_tpu_torch.preprocess import priors
from gwinferno_tpu_torch.preprocess import selection
from gwinferno_tpu_torch.utils.dataset import Dataset

RTOL = 1e-12


def _spins(rng, n):
    return (rng.uniform(0.1, 1.0, n), rng.uniform(0.02, 0.98, n), rng.uniform(0.02, 0.98, n),
            rng.uniform(-0.98, 0.98, n), rng.uniform(-0.98, 0.98, n))


def _same_array(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)
    else:
        assert np.array_equal(got, want)


def _same_data_array(got, want, rtol=RTOL):
    assert got.dims == want.dims
    _same_array(got.data, want.data, rtol)
    assert set(got.coords) == set(want.coords)
    for k in want.coords:
        _same_array(got.coords[k], want.coords[k])
    assert set(got.attrs) == set(want.attrs)
    for k, v in want.attrs.items():
        _same_array(got.attrs[k], v)


# ----------------------------------------------------------------- conversions and priors


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_conversions_match_jax(kind):
    q, a1, a2, ct1, ct2 = _spins(np.random.default_rng(1), 2000)
    args = (q, a1, a2, ct1, ct2) if kind == "numpy" else tuple(torch.tensor(v) for v in (q, a1, a2, ct1, ct2))

    def host(v):
        return v.numpy() if isinstance(v, torch.Tensor) else v

    _same_array(host(conversions.chieff_from_q_component_spins(*args)),
                jconv.chieff_from_q_component_spins(q, a1, a2, ct1, ct2), 1e-13)
    want = jconv.chip_from_q_component_spins(q, a1, a2, ct1, ct2)
    _same_array(host(conversions.chip_from_q_component_spins(*args)), want, 1e-13)
    math = np if kind == "numpy" else torch
    _same_array(host(conversions.chip_from_q_component_spins(*args, math=math)), want, 1e-13)
    alpha, beta = (a1 * 5.0 + 0.5, a2 * 5.0 + 0.5) if kind == "numpy" else (args[1] * 5.0 + 0.5, args[2] * 5.0 + 0.5)
    for got, ref in zip(conversions.mu_var_from_alpha_beta(alpha, beta, xmax=2.0),
                        jconv.mu_var_from_alpha_beta(a1 * 5.0 + 0.5, a2 * 5.0 + 0.5, xmax=2.0)):
        _same_array(host(got), ref, 1e-13)
    mu, var = jconv.mu_var_from_alpha_beta(a1 * 5.0 + 0.5, a2 * 5.0 + 0.5)
    port_in = (mu, var) if kind == "numpy" else (torch.tensor(mu), torch.tensor(var))
    for got, ref in zip(conversions.alpha_beta_from_mu_var(*port_in), jconv.alpha_beta_from_mu_var(mu, var)):
        _same_array(host(got), ref, 1e-13)


@pytest.mark.parametrize("q", [0.3, 0.6, 0.9])
def test_analytic_priors_match_jax(q):
    x = np.linspace(-1.0, 1.0, 4001)
    _same_array(priors.chi_effective_prior_from_aligned_spins(x, q),
                jpriors.chi_effective_prior_from_aligned_spins(x, q), 1e-13)
    _same_array(priors.chi_effective_prior_from_isotropic_spins(x, q, a_max=0.9),
                jpriors.chi_effective_prior_from_isotropic_spins(x, q, a_max=0.9), 1e-13)
    # exactly on a case boundary: the two-sided average
    edge = np.array([q / (1.0 + q), (1.0 - q) / (1.0 + q)])
    _same_array(priors.chi_effective_prior_from_isotropic_spins(edge, q),
                jpriors.chi_effective_prior_from_isotropic_spins(edge, q), 1e-13)
    cp = np.linspace(0.0, 1.0, 2001)
    _same_array(priors.chi_p_prior_from_isotropic_spins(cp, q), jpriors.chi_p_prior_from_isotropic_spins(cp, q), 1e-13)
    z = np.linspace(-3.0, 0.99, 101)
    _same_array(priors.Di(z), jpriors.Di(z), 1e-13)


def test_isotropic_prior_over_a_bank_matches_jax():
    """q per sample, as the spin conversion calls it."""
    q, a1, a2, ct1, ct2 = _spins(np.random.default_rng(2), 5000)
    chi_eff = jconv.chieff_from_q_component_spins(q, a1, a2, ct1, ct2)
    _same_array(priors.chi_effective_prior_from_isotropic_spins(chi_eff, q),
                jpriors.chi_effective_prior_from_isotropic_spins(chi_eff, q), 1e-13)


def test_kde_priors_match_jax():
    """The Monte-Carlo conditional and joint priors draw from numpy's global
    stream: the same seed gives the same numbers."""
    out = []
    for mod in (priors, jpriors):
        np.random.seed(11)
        cond = mod.chi_p_prior_given_chi_eff_q(np.linspace(0.0, 0.9, 40), 0.1, 0.7, ndraws=3000)
        np.random.seed(12)
        joint = mod.joint_prior_from_isotropic_spins(np.array([0.2, 0.4]), np.array([0.05, -0.1]), 0.8, ndraws=2000)
        out.append((cond, joint))
    for got, want in zip(*out):
        _same_array(got, want, 1e-13)


def test_native_batch_matches_the_jax_build():
    """The port's build of its copy of the C++ source against the JAX
    package's build of its own (both with g++; skipped without it, as the
    JAX package's own test is)."""
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(7)
    chi_p, chi_eff, q = rng.uniform(0.05, 0.6, 64), rng.uniform(-0.2, 0.3, 64), rng.uniform(0.3, 0.95, 64)
    for seed in (0, 5):
        _same_array(native.chi_p_prior_given_chi_eff_q_batch(chi_p, chi_eff, q, ndraws=4000, seed=seed),
                    jnative.chi_p_prior_given_chi_eff_q_batch(chi_p, chi_eff, q, ndraws=4000, seed=seed))
    assert native.native_num_threads() >= 1


def test_native_fallback_matches_jax(monkeypatch):
    """Without a compiler both packages take the Python KDE path."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_build_failed", True)
    assert not native.native_available() and not jnative.native_available()
    assert native.native_num_threads() is None
    args = (np.array([0.1, 0.3, 0.5]), np.array([0.0, 0.1, -0.1]), 0.75)
    np.random.seed(3)
    got = native.chi_p_prior_given_chi_eff_q_batch(*args, ndraws=2000)
    np.random.seed(3)
    _same_array(got, jnative.chi_p_prior_given_chi_eff_q_batch(*args, ndraws=2000), 1e-13)


# ----------------------------------------------------------------- injection readers


O3_PARAMS = ["mass_1", "mass_ratio", "redshift", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2"]


def _write_o3(path, n=400, ifar_cols=("ifar_gstlal", "ifar_pycbc_bbh", "ifar_pycbc_full"), name_col=False,
              tg_as_dataset=False, analysis_time_key="analysis_time", analysis_time_on_group=False, aligned=False):
    rng = np.random.default_rng(42)
    m1 = rng.uniform(5, 80, n)
    q = rng.uniform(0.2, 1.0, n)
    a1, a2 = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    ct1, ct2 = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    with h5py.File(path, "w") as f:
        g = f.create_group("injections")
        g.create_dataset("mass1_source", data=m1)
        g.create_dataset("mass2_source", data=q * m1)
        g.create_dataset("redshift", data=rng.uniform(0.01, 1.5, n))
        g.create_dataset("sampling_pdf", data=rng.uniform(0.5, 2.0, n))
        g.create_dataset("spin1z", data=a1 * ct1)
        g.create_dataset("spin2z", data=a2 * ct2)
        if not aligned:
            for i, (a, ct) in enumerate(((a1, ct1), (a2, ct2)), start=1):
                phi = rng.uniform(0, 2 * np.pi, n)
                g.create_dataset(f"spin{i}x", data=a * np.sqrt(1 - ct**2) * np.cos(phi))
                g.create_dataset(f"spin{i}y", data=a * np.sqrt(1 - ct**2) * np.sin(phi))
        g.create_dataset("optimal_snr_net", data=rng.uniform(5, 20, n))
        for i, col in enumerate(ifar_cols):
            g.create_dataset(col, data=np.where(rng.uniform(size=n) < 0.4, 10.0 + i, 0.01))
        if name_col:
            g.create_dataset("name", data=np.where(rng.uniform(size=n) < 0.3, b"o1", b"o3"))
        if tg_as_dataset:
            g.create_dataset("total_generated", data=np.int64(12345))
        else:
            g.attrs["total_generated"] = 12345
        (g.attrs if analysis_time_on_group else f.attrs)[analysis_time_key] = 2.0 * 365.25 * 24 * 3600


O3_VARIANTS = {
    "canonical": {}, "other_searches": dict(ifar_cols=("ifar_cwb", "ifar_mbta")), "name_column": dict(name_col=True),
    "total_generated_dataset": dict(tg_as_dataset=True), "total_analysis_time": dict(analysis_time_key="total_analysis_time"),
    "analysis_time_on_group": dict(analysis_time_key="analysis_time_s", analysis_time_on_group=True),
    "aligned_spins_only": dict(aligned=True),
}


@pytest.mark.parametrize("params", [O3_PARAMS, ["mass_1", "redshift", "chi_eff"], ["mass_1", "redshift"]],
                         ids=["spins", "chi_eff", "no_spins"])
@pytest.mark.parametrize("variant", list(O3_VARIANTS))
def test_o3_reader_matches_jax(tmp_path, variant, params):
    path = str(tmp_path / "inj.h5")
    _write_o3(path, **O3_VARIANTS[variant])
    kw = dict(ifar_threshold=1, snr_threshold=10, additional_cuts={"optimal_snr_net": 19.5})
    _same_data_array(selection.get_o3_cumulative_injection_dict(path, params, **kw),
                     jsel.get_o3_cumulative_injection_dict(path, params, **kw), rtol=0.0)


def test_o3_reader_missing_total_generated_raises_as_jax(tmp_path):
    path = str(tmp_path / "inj.h5")
    _write_o3(path)
    with h5py.File(path, "a") as f:
        del f["injections"].attrs["total_generated"]
    errors = []
    for mod in (selection, jsel):
        with pytest.raises(KeyError) as info:
            mod.get_o3_cumulative_injection_dict(path, O3_PARAMS)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "total_generated" in errors[0]


def _write_o4a(path, n=500, analysis_time_key="analysis_time", total_generated=True):
    rng = np.random.default_rng(9)
    m1 = rng.uniform(5, 80, n)
    fields = {
        "semianalytic_observed_phase_maximized_snr_net": rng.uniform(4, 20, n),
        "far_gstlal": np.where(rng.uniform(size=n) < 0.3, 0.1, 100.0),
        "far_pycbc_hyperbank": np.where(rng.uniform(size=n) < 0.3, 0.5, 100.0),
        "mass1_source": m1, "mass2_source": m1 * rng.uniform(0.2, 1.0, n), "redshift": rng.uniform(0.01, 2.0, n),
        jsel._O4A_LNPDRAW: rng.normal(-10.0, 2.0, n), "weights": rng.uniform(0.5, 1.5, n),
        **{f"spin{i}{ax}": rng.uniform(-0.5, 0.5, n) for i in (1, 2) for ax in "xyz"},
    }
    events = np.zeros(n, dtype=[(k, "<f8") for k in fields])
    for k, v in fields.items():
        events[k] = v
    with h5py.File(path, "w") as f:
        f.create_dataset("events", data=events)
        if total_generated:
            f.attrs["total_generated"] = 54321
        if analysis_time_key:
            f.attrs[analysis_time_key] = 0.7 * 365.25 * 24 * 3600


@pytest.mark.parametrize("params", [O3_PARAMS, ["mass_1", "chi_eff"], ["mass_1", "redshift"]],
                         ids=["spins", "chi_eff", "no_spins"])
@pytest.mark.parametrize("time_key", ["analysis_time", "total_analysis_time"])
def test_o4a_reader_matches_jax(tmp_path, params, time_key):
    path = str(tmp_path / "o4a.h5")
    _write_o4a(path, analysis_time_key=time_key)
    kw = dict(snr_threshold=12, ifar_threshold=2)
    _same_data_array(selection.get_o4a_cumulative_injection_dict(path, params, **kw),
                     jsel.get_o4a_cumulative_injection_dict(path, params, **kw), rtol=0.0)


@pytest.mark.parametrize("missing", ["total_generated", "analysis_time"])
def test_o4a_reader_errors_as_jax(tmp_path, missing):
    path = str(tmp_path / "o4a.h5")
    _write_o4a(path, analysis_time_key=None if missing == "analysis_time" else "analysis_time",
               total_generated=missing != "total_generated")
    errors = []
    for mod in (selection, jsel):
        with pytest.raises(Exception) as info:
            mod.get_o4a_cumulative_injection_dict(path, O3_PARAMS)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------- catalog pipeline


def _structured(fields):
    out = np.zeros(len(next(iter(fields.values()))), dtype=[(k, "<f8") for k in fields])
    for k, v in fields.items():
        out[k] = v
    return out


def _event_samples(rng, n, layout):
    """One event's raw samples; ``sample_id`` tags each sample, so the
    downsampled rows can be compared by identity.  Masses sit off the mmax
    edge (far below it, or far above: the cut)."""
    z = rng.uniform(0.05, 1.0, n)
    m1 = rng.uniform(10.0, 70.0, n)
    m1[: n // 8] = rng.uniform(120.0, 150.0, n // 8)
    q, a1, a2, ct1, ct2 = _spins(rng, n)
    s = {"sample_id": np.arange(n, dtype=np.float64), "a_1": a1, "a_2": a2, "cos_tilt_1": ct1, "cos_tilt_2": ct2}
    if layout == "GWTC-1":
        s.update(luminosity_distance=jdc.PLANCK_2015_Cosmology.z2DL(z), mass_1_det=m1 * (1 + z), mass_ratio=q)
    elif layout == "mass_2":
        s.update(redshift=z, mass_1=m1, mass_2=q * m1)
    else:
        s.update(redshift=z, mass_1=m1, mass_ratio=q)
    return s


PROCESSED = ["redshift", "mass_1", "a_1", "cos_tilt_1", "mass_2", "a_2", "cos_tilt_2", "mass_ratio", "sample_id"]


@pytest.fixture
def metadata(tmp_path):
    """Three per-event HDF5 files (GWTC-1 'Overall_posterior' with
    luminosity distance and detector-frame mass; a waveform group with
    ``mass_2``; a flat ``posterior_samples``) and their metadata."""
    rng = np.random.default_rng(21)
    meta = {}
    for ev, layout, n, kind in (("GW150914", "GWTC-1", 240, "euclidean"), ("GW190000", "mass_2", 300, "euclidean"),
                                ("GW200000", "flat", 260, "comoving")):
        path = tmp_path / f"{ev}.h5"
        with h5py.File(path, "w") as f:
            post = _structured(_event_samples(rng, n, layout))
            if layout == "GWTC-1":
                f.create_dataset("Overall_posterior", data=post)
            elif layout == "mass_2":
                f.create_dataset("C01:Mixed/posterior_samples", data=post)
            else:
                f.create_dataset("posterior_samples", data=post)
        meta[ev] = {"file_path": str(path), "redshift_prior": kind}
        if layout == "GWTC-1":
            meta[ev]["catalog"] = "GWTC-1"
        elif layout == "mass_2":
            meta[ev]["waveform"] = "C01:Mixed"
    return meta


def test_unprocessed_catalog_matches_jax(metadata):
    got = dc.unprocessed_catalog_dict_from_metadata(metadata)
    want = jdc.unprocessed_catalog_dict_from_metadata(metadata)
    assert list(got) == list(want)
    for ev in want:
        assert got[ev]["meta"] == want[ev]["meta"] and list(got[ev]["samples"]) == list(want[ev]["samples"])
        for k, v in want[ev]["samples"].items():
            _same_array(got[ev]["samples"][k], v, rtol=0.0)


@pytest.mark.parametrize("mmax,max_samples", [(100.0, 10000), (60.0, 150)])
def test_processed_catalog_and_prior_row_match_jax(metadata, mmax, max_samples):
    """Source frame (the GWTC-1 event's DL -> z and detector-frame mass), the
    mmax cut, the common downsampling (the same ``sample_id`` rows) and the
    prior row per redshift-prior kind (euclidean and comoving)."""
    raw = jdc.unprocessed_catalog_dict_from_metadata(metadata)
    kinds = {ev: m["redshift_prior"] for ev, m in metadata.items()}
    out = []
    for mod in (dc, jdc):
        ds = mod.processed_catalog_dataset_from_dict(raw, PROCESSED, mmax=mmax, max_samples=max_samples)
        out.append((ds, mod.append_prior_to_processed_catalog(ds, kinds)))
    (got, got_p), (want, want_p) = out
    _same_data_array(got["posteriors"], want["posteriors"])
    _same_data_array(got_p["posteriors"], want_p["posteriors"])
    ids = got["posteriors"].sel(param="sample_id").data
    assert np.array_equal(ids, want["posteriors"].sel(param="sample_id").data)
    assert (got["posteriors"].sel(param="mass_1").data <= mmax).all()
    for kind in ("euclidean", "comoving"):
        z = np.linspace(0.01, 2.0, 50)
        _same_array(dc.dl_2_prior_on_z(z, kind=kind), jdc.dl_2_prior_on_z(z, kind=kind))
    for mod in (dc, jdc):
        with pytest.raises(ValueError, match="unknown redshift prior kind"):
            mod.dl_2_prior_on_z(z, kind="flat")


def test_load_posterior_dataset_and_idata_roundtrip_match_jax(metadata, tmp_path):
    """The metadata-file pipeline, an O3 injection set, and the idata file
    written by each package and read by the other."""
    meta_file = tmp_path / "metadata.json"
    meta_file.write_text(json.dumps(metadata))
    got = dc.load_posterior_dataset(metadata_file=str(meta_file), param_names=PROCESSED)
    want = jdc.load_posterior_dataset(metadata_file=str(meta_file), param_names=PROCESSED)
    _same_data_array(got["posteriors"], want["posteriors"])
    inj_path = str(tmp_path / "inj.h5")
    _write_o3(inj_path)
    inj = dc.load_injection_dataset(inj_path, O3_PARAMS)
    _same_data_array(inj, jdc.load_injection_dataset(inj_path, O3_PARAMS), rtol=0.0)
    for mod in (dc, jdc):
        with pytest.raises(ValueError, match="through_o3"):
            mod.load_injection_dataset(inj_path, O3_PARAMS, through_o3=False)
    files = {}
    for name, mod, ds_cls in (("port", dc, Dataset), ("jax", jdc, JaxDataset)):
        files[name] = str(tmp_path / f"idata_{name}.h5")
        pe = mod.load_posterior_dataset(metadata_file=str(meta_file), param_names=PROCESSED)
        mod.save_posterior_samples_and_injection_datasets_as_idata(
            pe, ds_cls({"injections": mod.load_injection_dataset(inj_path, O3_PARAMS)}), files[name])
    for path in files.values():
        a, b = dc.load_idata_file(path), jdc.load_idata_file(path)
        assert set(a) == set(b) == {"pe_data", "inj_data"}
        for group in a:
            assert set(a[group].variables) == set(b[group].variables)
            for k in b[group].variables:
                _same_data_array(a[group][k], b[group][k], rtol=0.0)
    # either package's file reads the same in the other
    x, y = dc.load_idata_file(files["port"]), jdc.load_idata_file(files["jax"])
    _same_data_array(x["pe_data"]["posteriors"], y["pe_data"]["posteriors"], rtol=0.0)


def test_load_catalog_netcdf3_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    raw = {f"GW{i:06d}": {p: rng.normal(size=50) for p in chip_smoke.RAW_PARAMS} for i in range(3)}
    path = str(tmp_path / "catalog.nc")
    chip_smoke.write_catalog_netcdf3(path, raw)
    got, want = dc.load_catalog_netcdf3(path)["posteriors"], jdc.load_catalog_netcdf3(path)["posteriors"]
    _same_data_array(got, want, rtol=0.0)
    assert list(got.coords["event"]) == list(raw) and list(got.coords["param"]) == list(chip_smoke.RAW_PARAMS)
    for i, ev in enumerate(raw):
        for j, p in enumerate(chip_smoke.RAW_PARAMS):
            assert np.array_equal(got.data[i, j], raw[ev][p])


def _spin_bank(rng, injections):
    params = ["mass_1", "mass_ratio", "redshift", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2", "prior"]
    shape = (300,) if injections else (3, 40)
    q, a1, a2, ct1, ct2 = (v.reshape(shape) for v in _spins(rng, int(np.prod(shape))))
    cols = {"mass_1": rng.uniform(5, 80, shape), "mass_ratio": q, "redshift": rng.uniform(0.05, 1.5, shape),
            "a_1": a1, "a_2": a2, "cos_tilt_1": ct1, "cos_tilt_2": ct2, "prior": rng.uniform(0.5, 2.0, shape)}
    if injections:
        return np.stack([cols[p] for p in params]), ("param", "injection"), params
    return np.stack([cols[p] for p in params], axis=1), ("event", "param", "sample"), params


@pytest.mark.parametrize("chi_p", [False, True], ids=["chi_eff", "chi_eff_chi_p"])
@pytest.mark.parametrize("injections", [False, True], ids=["pe", "injections"])
def test_convert_component_spins_to_chieff_matches_jax(injections, chi_p):
    data, dims, params = _spin_bank(np.random.default_rng(5), injections)
    names = ["mass_1", "mass_ratio", "redshift", "chi_eff"] + (["chi_p"] if chi_p else [])
    coords = {"param": np.array(params)}
    attrs = {"total_generated": 1000.0, "analysis_time": 1.0} if injections else {}
    out = []
    for mod in (dc, jdc):
        np.random.seed(8)  # the KDE path without a compiler
        out.append(mod.convert_component_spins_to_chieff(mod.DataArray(data, dims, coords, attrs), names,
                                                         injections=injections))
    _same_data_array(*out)
    assert list(out[0].coords["param"]) == ["mass_1", "mass_ratio", "redshift", "chi_eff"] + (
        ["chi_p"] if chi_p else []) + ["prior"]
    assert np.isfinite(out[0].sel(param="prior").data).all()


# ----------------------------------------------------------------- resampling

PARAM_MAP = {"x": 0, "prior": 1}


def _target(injdata):
    return 2.0 * injdata[PARAM_MAP["x"], :]  # p(x) = 2x on [0, 1]


def _bank(seed=5, n_found=4000):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, n_found)
    return np.stack([x, np.ones(n_found)])


def test_resample_injections_contract_and_jax():
    """The JAX package's test's contract, and the JAX values on the same
    weights: ``n_eff_bank`` equal, the new Neff to 1e-12."""
    data, n_draw = _bank(), 10000
    gen = torch.Generator().manual_seed(0)
    bank, n_eff, neff_new = selection.resample_injections(gen, _target, torch.tensor(data), n_draw, PARAM_MAP)
    jbank, jn_eff, jneff = jsel.resample_injections(jax.random.PRNGKey(0), _target, jnp.asarray(data), n_draw,
                                                    PARAM_MAP)
    w = _target(data)
    w_sum, w_sumsq = w.sum(), (w * w).sum()
    mu = w_sum / n_draw
    assert n_eff == jn_eff == int(w_sum**2 // w_sumsq)
    assert tuple(bank.shape) == tuple(jbank.shape) == (2, n_eff) and bank.dtype == torch.float64
    np.testing.assert_allclose(float(neff_new), float(jneff), rtol=1e-12)
    np.testing.assert_allclose(float(neff_new), mu**2 / (w_sumsq / n_draw**2 - mu**2 / n_draw), rtol=1e-6)
    np.testing.assert_allclose(bank[1].numpy(), _target(bank).numpy() / mu, rtol=1e-12)
    assert abs(float(bank[0].mean()) - 2.0 / 3.0) < 0.02
    # the resampled column follows the target's cdf x^2
    assert stats.kstest(bank[0].numpy(), lambda x: x**2).pvalue > 1e-3
    gen.manual_seed(0)
    again = selection.resample_injections(gen, _target, torch.tensor(data), n_draw, PARAM_MAP)[0]
    assert torch.equal(bank, again)


def test_resample_injections_float32_count_is_the_float64_formula():
    data = _bank(seed=6, n_found=46770)
    data[0] = data[0] ** 0.25  # weights spread over four decades
    bank32 = torch.tensor(data, dtype=torch.float32)
    w = (_target(bank32) / bank32[1]).double().numpy()
    gen = torch.Generator().manual_seed(1)
    bank, n_eff, _ = selection.resample_injections(gen, _target, bank32, 1e5, PARAM_MAP)
    assert n_eff == int(w.sum() ** 2 // np.square(w).sum()) and bank.dtype == torch.float32


def test_resample_injections_refuses_zero_weights():
    data = _bank()
    with pytest.raises(ValueError, match="positive sum"):
        selection.resample_injections(torch.Generator(), lambda d: 0.0 * d[0], torch.tensor(data), 10.0, PARAM_MAP)


# ----------------------------------------------------------------- the slice as a whole


def _chieff_readers(tmp_path):
    path = tmp_path / "chieff.yml"
    path.write_text(yaml.safe_dump(chip_smoke.chieff_config(), sort_keys=False))
    r, j = ConfigReader(), JaxReader()
    r.parse_dict(chip_smoke.chieff_config())
    j.parse(str(path))
    return r, j


def test_chieff_config_parses_as_in_jax(tmp_path):
    r, j = _chieff_readers(tmp_path)
    assert list(r.models) == list(j.models) == ["mass_1", "mass_ratio", "redshift", "chi_eff"]
    for k, m in r.models.items():
        assert (m.model.__name__, m.params) == (j.models[k].model.__name__, j.models[k].params)
    assert set(r.priors) == set(j.priors) and r.sampling_params == j.sampling_params
    for k, rec in r.priors.items():
        if hasattr(rec, "dist"):
            assert (rec.dist.__name__, rec.params) == (j.priors[k].dist.__name__, j.priors[k].params)
        else:
            assert rec == j.priors[k]
    assert r.likelihood_kwargs == j.likelihood_kwargs


CHIEFF_POINTS = {
    "mass_1_alpha": [-2.35, -2.0, -3.0], "mass_1_minimum": [8.0, 6.0, 10.0], "mass_1_maximum": [70.0, 60.0, 80.0],
    "mass_1_alpha_min": [2.0, 1.0, 3.0], "mass_1_alpha_max": [10.0, 6.0, 15.0], "mass_ratio_alpha": [1.0, 0.5, 2.0],
    "redshift_lamb": [1.7, 0.5, 3.0], "chi_eff_loc": [0.05, 0.0, 0.1], "chi_eff_scale": [0.12, 0.2, 0.3],
    "unscaled_rate": [40.0, 60.0, 80.0],
}


def test_preprocessed_chieff_route_matches_jax(tmp_path):
    """A small raw catalog (4 events x 300 PE samples, 3000 found
    injections) through each package's preprocessing, then the chi_eff
    config route's model of each parser at three points: the potential and
    ``log_l`` to 1e-10 relative, the gradient to 1e-8 of its largest
    component, float64."""
    pedict, injdict, constants = chip_smoke.make_catalog(3, n_events=4, n_samples=300, n_found=3000)
    out = {}
    for name, mod in (("port", dc), ("jax", jdc)):
        work = tmp_path / name
        work.mkdir()
        out[name] = chip_smoke.preprocess_catalog(pedict, injdict, constants, str(work), dc=mod)
    for got, want in zip(out["port"][:3], out["jax"][:3]):
        _same_data_array(got, want)
    pe, inj, const = chip_smoke.banks_of(*out["port"][1:3])
    assert pe["chi_eff"].shape[0] == 4 and np.isfinite(pe["prior"]).all() and np.isfinite(inj["prior"]).all()
    jpe, jinj, _ = chip_smoke.banks_of(*out["jax"][1:3])

    r, j = _chieff_readers(tmp_path)
    args = ({k: torch.tensor(v) for k, v in pe.items()}, {k: torch.tensor(v) for k, v in inj.items()},
            const["total_inj"], const["nObs"], const["obs_time"])
    jargs = ({k: jnp.asarray(v) for k, v in jpe.items()}, {k: jnp.asarray(v) for k, v in jinj.items()},
             const["total_inj"], const["nObs"], const["obs_time"])
    model = construct_hierarchical_model(r.models, r.priors, **r.likelihood_kwargs)
    jmodel = jax_model_of(j.models, j.priors, **j.likelihood_kwargs)
    pot = ppl.ModelPotential(model, args, device="cpu", dtype=torch.float64)
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in CHIEFF_POINTS.items()}
    assert pot.names == sorted(params)
    z = pot.unconstrain(params, 3)
    u, grad = pot.value_and_grad(z)
    assert bool((u.abs() < 1e30).all())  # off the likelihood walls
    _, trace = ppl.log_density(model, args, {}, params)
    jpe_fn = jax.jit(jax.value_and_grad(lambda p: jppl.potential_energy(jmodel, jargs, {}, p)))
    uz = pot.unravel(z)
    for c in range(3):
        want, jg = jpe_fn({k: jnp.asarray(v[c].numpy()) for k, v in uz.items()})
        np.testing.assert_allclose(float(u[c]), float(want), rtol=1e-10)
        jg = np.asarray(jax.flatten_util.ravel_pytree(jg)[0])
        np.testing.assert_allclose(grad[c].numpy(), jg, rtol=0.0, atol=1e-8 * np.abs(jg).max())
        jt = jppl.log_density(jmodel, jargs, {}, {k: jnp.asarray(v[c].numpy()) for k, v in params.items()})[1]
        np.testing.assert_allclose(float(trace["log_l"]["value"][c]), float(jt["log_l"]["value"]), rtol=1e-10)


def test_smoke_route_population_on_cpu(tmp_path):
    """The smoke's route population (the config's blocks at a point) as a
    density over a ``(param, injection)`` bank equals the product of the
    four distributions built by hand."""
    from gwinferno_tpu_torch import population_distributions as pd

    r, _ = _chieff_readers(tmp_path)
    rows = {p: i for i, p in enumerate(["mass_1", "mass_ratio", "redshift", "chi_eff"])}
    rng = np.random.default_rng(0)
    bank = torch.tensor(np.stack([rng.uniform(5, 90, 500), rng.uniform(0.1, 1, 500), rng.uniform(0.01, 2, 500),
                                  rng.uniform(-0.5, 0.5, 500)]))
    pt = {k: torch.tensor(c, dtype=torch.float64) for k, (c, _) in chip_smoke.CHIEFF_INIT.items()}
    got = chip_smoke.route_population(r, {k: float(v) for k, v in pt.items()}, rows, "cpu", torch.float64)(bank)
    want = (pd.PowerlawSmoothedPowerlaw(pt["mass_1_alpha"], pt["mass_1_minimum"], pt["mass_1_maximum"],
                                        pt["mass_1_alpha_max"], pt["mass_1_alpha_min"], 2.0, 100.0).log_prob(bank[0])
            + pd.Powerlaw(pt["mass_ratio_alpha"], minimum=0.02, maximum=1.0).log_prob(bank[1])
            + pd.PowerlawRedshift(pt["redshift_lamb"], 2.3).log_prob(bank[2])
            + ppl.distributions.TruncatedNormal(pt["chi_eff_loc"], pt["chi_eff_scale"], -1.0, 1.0).log_prob(bank[3]))
    assert bool((got > 0).all())
    torch.testing.assert_close(torch.log(got), want, rtol=1e-12, atol=1e-12)


def test_native_library_is_this_packages_build():
    """The port loads its own build of its own source (under ``_build/``),
    never the JAX package's ``native/`` library."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert native.native_available()
    assert "gwinferno_tpu_torch" in native.SOURCE and "_build" in native.library_path()
