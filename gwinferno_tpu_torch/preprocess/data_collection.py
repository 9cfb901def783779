"""Catalog ingestion and handoff-artifact IO.

Counterpart of ``gwinferno_tpu/preprocess/data_collection.py``, host numpy:
netCDF-3 catalogs through ``scipy.io.netcdf_file``, per-event HDF5 posterior
files and the idata layout (groups ``pe_data``/``inj_data``) through
``h5py``, imported inside the functions that read or write HDF5.  Source
frame conversion and the fiducial prior row run on this package's
``PLANCK_2015_Cosmology`` tables; the common downsampling draws from
``np.random.default_rng(0)`` in the JAX package's order, so it keeps the
same samples.
"""

from __future__ import annotations

import json

import numpy as np

from ..cosmology import PLANCK_2015_Cosmology
from ..utils.dataset import DataArray
from ..utils.dataset import Dataset
from ..utils.dataset import load_groups
from ..utils.dataset import save_groups
from .conversions import chieff_from_q_component_spins
from .conversions import chip_from_q_component_spins
from .native import chi_p_prior_given_chi_eff_q_batch
from .priors import chi_effective_prior_from_isotropic_spins
from .selection import get_o3_cumulative_injection_dict
from .selection import get_o4a_cumulative_injection_dict

__all__ = [
    "load_catalog_netcdf3",
    "unprocessed_catalog_dict_from_metadata",
    "processed_catalog_dataset_from_dict",
    "dl_2_prior_on_z",
    "append_prior_to_processed_catalog",
    "load_posterior_dataset",
    "load_injection_dataset",
    "save_posterior_samples_and_injection_datasets_as_idata",
    "load_idata_file",
    "convert_component_spins_to_chieff",
]

PE_PARAMS = ["redshift", "mass_1", "a_1", "cos_tilt_1", "mass_2", "a_2", "cos_tilt_2", "mass_ratio", "prior"]


def load_catalog_netcdf3(path):
    """Read a netCDF-3 per-event PE catalog (the reference's checked-in
    GWTC-3 test-file format: one (param, sample) variable per event plus a
    ``param`` name table).  Returns a Dataset with ``posteriors`` of dims
    (event, param, sample)."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        params = ["".join(c.decode() for c in row).strip() for row in f.variables["param"].data]
        events = [k for k in f.variables if k not in ("param", "sample")]
        data = np.stack([np.array(f.variables[ev].data, dtype=np.float64) for ev in events])
    arr = DataArray(
        data,
        ("event", "param", "sample"),
        coords={"event": np.array(events), "param": np.array(params), "sample": np.arange(data.shape[-1])},
    )
    return Dataset({"posteriors": arr})


def unprocessed_catalog_dict_from_metadata(catalog_metadata, param_names=None):
    """Per-event posterior reads keyed by a metadata dict
    ``{event: {file_path, waveform, redshift_prior, catalog}}``.

    Parity: gwinferno/preprocess/data_collection.py:24-36 (GWTC-1 'Overall'
    layout special-cased).
    """
    import h5py

    catalog = {}
    for ev, meta in catalog_metadata.items():
        with h5py.File(meta["file_path"], "r") as f:
            if meta.get("catalog") == "GWTC-1":
                post = f["Overall_posterior" if "Overall_posterior" in f else "overall_posterior"][()]
                samples = {name: post[name] for name in post.dtype.names}
            else:
                wf = meta.get("waveform", "C01:Mixed")
                grp = f[wf]["posterior_samples"] if wf in f else f["posterior_samples"]
                post = grp[()]
                samples = {name: post[name] for name in post.dtype.names}
        catalog[ev] = {"samples": samples, "meta": meta}
    return catalog


def processed_catalog_dataset_from_dict(catalog, param_names=None, mmax=100.0, max_samples=10000, cosmology=PLANCK_2015_Cosmology):
    """Source-frame conversion, mmax cut, common downsampling, packing to a
    (event, param, samples) Dataset.

    Parity: gwinferno/preprocess/data_collection.py:39-92.
    """
    param_names = param_names or [p for p in PE_PARAMS if p != "prior"]
    rng = np.random.default_rng(0)
    processed = {}
    for ev, entry in catalog.items():
        s = dict(entry["samples"])
        if "redshift" not in s and "luminosity_distance" in s:
            s["redshift"] = np.asarray(cosmology.DL2z(np.asarray(s["luminosity_distance"])))
        if "mass_1" not in s and "mass_1_det" in s:
            s["mass_1"] = s["mass_1_det"] / (1 + s["redshift"])
        if "mass_ratio" not in s and "mass_2" in s:
            s["mass_ratio"] = s["mass_2"] / s["mass_1"]
        if "mass_2" not in s and "mass_ratio" in s:
            s["mass_2"] = s["mass_ratio"] * s["mass_1"]
        keep = s["mass_1"] <= mmax
        s = {k: np.asarray(v)[keep] for k, v in s.items() if k in param_names or k == "luminosity_distance"}
        processed[ev] = s
    n_common = min(min(len(next(iter(s.values()))) for s in processed.values()), max_samples)
    events = sorted(processed.keys())
    data = np.empty((len(events), len(param_names), n_common))
    for i, ev in enumerate(events):
        n_ev = len(next(iter(processed[ev].values())))
        idx = rng.choice(n_ev, size=n_common, replace=False)
        for j, p in enumerate(param_names):
            data[i, j] = processed[ev][p][idx]
    arr = DataArray(
        data,
        ("event", "param", "sample"),
        coords={"event": np.array(events), "param": np.array(param_names), "sample": np.arange(n_common)},
    )
    return Dataset({"posteriors": arr})


def dl_2_prior_on_z(z, kind="euclidean", cosmology=PLANCK_2015_Cosmology):
    """Fiducial p(z) implied by the PE sampling prior on luminosity distance.

    Parity: gwinferno/preprocess/data_collection.py:95-100.
    """
    z = np.asarray(z)
    dl = np.asarray(cosmology.z2DL(z))
    ddl_dz = dl / (1 + z) + (1 + z) * np.asarray(cosmology.dDcdz(z))
    if kind == "euclidean":
        return dl**2 * ddl_dz
    if kind == "comoving":
        return np.asarray(cosmology.dVcdz(z)) / (1 + z)
    raise ValueError(f"unknown redshift prior kind: {kind}")


def append_prior_to_processed_catalog(dataset, redshift_priors=None, cosmology=PLANCK_2015_Cosmology):
    """Add the per-event fiducial prior row:
    p(z) * (1+z)^2 [detector-frame masses] * m1 [q jacobian] * 1/4 [spin mags].

    Parity: gwinferno/preprocess/data_collection.py:103-142.
    """
    arr = dataset["posteriors"]
    params = list(arr.coords["param"])
    events = list(arr.coords["event"])
    z = arr.data[:, params.index("redshift")]
    m1 = arr.data[:, params.index("mass_1")]
    prior = np.empty_like(z)
    for i, ev in enumerate(events):
        kind = (redshift_priors or {}).get(ev, "euclidean")
        prior[i] = dl_2_prior_on_z(z[i], kind=kind, cosmology=cosmology) * (1 + z[i]) ** 2 * m1[i] * 0.25
    new_data = np.concatenate([arr.data, prior[:, None]], axis=1)
    new_params = np.array(params + ["prior"])
    new_arr = DataArray(
        new_data,
        arr.dims,
        coords={**arr.coords, "param": new_params},
    )
    return Dataset({"posteriors": new_arr}, dataset.attrs)


def load_posterior_dataset(catalog_metadata=None, metadata_file=None, param_names=None, mmax=100.0, redshift_priors=None):
    """Full catalog pipeline: metadata -> reads -> processing -> prior row.

    Parity: gwinferno/preprocess/data_collection.py:145-169 (the reference
    CLI imports a stale name for this; we keep the library name).
    """
    if catalog_metadata is None:
        with open(metadata_file) as f:
            catalog_metadata = json.load(f)
    cat = unprocessed_catalog_dict_from_metadata(catalog_metadata, param_names)
    ds = processed_catalog_dataset_from_dict(cat, param_names, mmax=mmax)
    redshift_priors = redshift_priors or {
        ev: meta.get("redshift_prior", "euclidean") for ev, meta in catalog_metadata.items()
    }
    return append_prior_to_processed_catalog(ds, redshift_priors)


def load_injection_dataset(path, param_names=None, through_o3=True, through_o4a=False, ifar_threshold=1.0, snr_threshold=10.0):
    """Injection-set loader dispatching on observing-run vintage.

    Parity: gwinferno/preprocess/data_collection.py:172-200.
    """
    if through_o4a:
        return get_o4a_cumulative_injection_dict(path, param_names, snr_threshold=snr_threshold, ifar_threshold=ifar_threshold)
    if through_o3:
        return get_o3_cumulative_injection_dict(path, param_names, ifar_threshold=ifar_threshold)
    raise ValueError("one of through_o3/through_o4a must be True")


def save_posterior_samples_and_injection_datasets_as_idata(pe_dataset, inj_dataset, path):
    """Write the handoff artifact consumed by
    ``pipeline.utils.load_pe_and_injections_as_dict``: one HDF5 file with
    groups ``pe_data`` and ``inj_data`` (arviz-compatible layout).

    Parity: gwinferno/preprocess/data_collection.py:203-207.
    """
    save_groups(path, {"pe_data": pe_dataset, "inj_data": inj_dataset})


def load_idata_file(path):
    """Read an idata HDF5 file -> {"pe_data": Dataset, "inj_data": Dataset}."""
    return load_groups(path)


def convert_component_spins_to_chieff(dat_array, param_names, injections=False):
    """Convert component-spin columns to effective spins and renormalize the
    fiducial prior with the analytic p(chi_eff | q) (and, when requested, the
    KDE-based joint p(chi_eff, chi_p | q)).

    The analytic prior is evaluated vectorized over the whole bank; the
    chi_p branch's conditional prior runs in the C++/OpenMP library
    (:mod:`.native`) when it builds, else in the per-sample Python KDE.

    Args:
        dat_array: DataArray with dims (event, param, sample) [PE] or
            (param, injection) [injections].
        param_names: target parameter list ("chi_p" in it enables the joint prior).
        injections: injection-bank layout flag.

    Returns a new DataArray with chi_eff (+chi_p) and the renormalized prior.
    """
    want_chip = "chi_p" in param_names

    params = list(dat_array.coords["param"])
    ax = dat_array.dims.index("param")

    def get(p):
        return np.take(dat_array.data, params.index(p), axis=ax)

    q = get("mass_ratio")
    a_1, a_2 = get("a_1"), get("a_2")
    t_1, t_2 = get("cos_tilt_1"), get("cos_tilt_2")
    prior = get("prior")

    chi_eff = chieff_from_q_component_spins(q, a_1, a_2, t_1, t_2)
    chi_p = chip_from_q_component_spins(q, a_1, a_2, t_1, t_2) if want_chip else None

    spin_mag_jac = (2 * np.pi * a_1**2) * (2 * np.pi * a_2**2)
    shape = chi_eff.shape
    p_eff = np.real(chi_effective_prior_from_isotropic_spins(chi_eff.ravel(), q.ravel())).reshape(shape)
    new_prior = prior / spin_mag_jac * p_eff
    if want_chip:
        # joint prior p(chi_eff|q) * p(chi_p|chi_eff,q)
        new_prior = new_prior * chi_p_prior_given_chi_eff_q_batch(chi_p.ravel(), chi_eff.ravel(), q.ravel()).reshape(shape)

    keep = [p for p in params if p not in ("prior", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2")]
    new_params = keep + ["chi_eff"] + (["chi_p"] if want_chip else []) + ["prior"]
    pieces = [np.take(dat_array.data, params.index(p), axis=ax) for p in keep]
    pieces.append(chi_eff)
    if want_chip:
        pieces.append(chi_p)
    pieces.append(new_prior)
    new_data = np.stack(pieces, axis=ax)

    coords = dict(dat_array.coords)
    coords["param"] = np.array(new_params)
    return DataArray(new_data, dat_array.dims, coords=coords, attrs=dat_array.attrs)
