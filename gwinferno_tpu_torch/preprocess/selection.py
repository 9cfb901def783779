"""Injection search-result readers and importance resampling.

Counterpart of ``gwinferno_tpu/preprocess/selection.py``.  The readers (host
numpy; ``h5py`` imported inside them) take the LVK O3 sensitivity-injection
HDF5 layout (``injections`` group with ``mass1_source``/``mass2_source``/
``redshift``/``spin*``/``sampling_pdf``/ifar columns, ``total_generated``
as an attr or a scalar dataset) and the O4a cumulative layout (``events``
structured array with lnpdraw + weights).  They return a ``(param,
injection)`` DataArray whose ``prior`` row is the draw density over exactly
the parameters in ``param_names`` (jacobians applied as columns are
converted).  :func:`resample_injections` runs on torch tensors on any
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.dataset import DataArray

__all__ = [
    "get_o4a_cumulative_injection_dict",
    "get_o3_cumulative_injection_dict",
    "resample_injections",
]

_SECONDS_PER_YEAR = 365.25 * 24.0 * 3600.0
# names under which LVK releases have shipped the live-time scalar
_ANALYSIS_TIME_KEYS = ("analysis_time", "total_analysis_time", "analysis_time_s")
# the O4a cumulative file's draw-density column (one joint lnpdraw over
# source masses, redshift, and cartesian component spins)
_O4A_LNPDRAW = (
    "lnpdraw_mass1_source_mass2_source_redshift_spin1x_spin1y_spin1z_spin2x_spin2y_spin2z"
)


def _scalarize(value):
    """Collapse the 0-d / 1-element ndarray wrappers h5py hands back for
    scalar attrs and datasets (layouts differ across releases)."""
    arr = np.asarray(value)
    return arr.reshape(()).item() if arr.size == 1 else value


def _analysis_time_yr(*attr_maps):
    """Live time in years from the first recognized key in any attr map."""
    for attrs in attr_maps:
        for key in _ANALYSIS_TIME_KEYS:
            if key in attrs:
                return _scalarize(attrs[key]) / _SECONDS_PER_YEAR
    raise Exception("analysis time not found")


def _cartesian_spins_to_mag_tilt(columns, prefix_fmt="spin{i}{ax}"):
    """(a_1, cos_tilt_1, a_2, cos_tilt_2) from cartesian component-spin
    columns, plus the isotropic-direction prior factor: a draw density
    uniform over the sphere of radius ``a`` carries a 1/(2*pi*a^2) area
    element per component once marginalized to (a, cos_tilt), so converting
    the prior to magnitude/tilt coordinates multiplies it by
    (2*pi*a_1^2)(2*pi*a_2^2)."""
    out = {}
    factor = 1.0
    for i in (1, 2):
        comps = [columns[prefix_fmt.format(i=i, ax=ax)] for ax in "xyz"]
        mag = np.sqrt(sum(np.square(c) for c in comps))
        out[f"a_{i}"] = mag
        out[f"cos_tilt_{i}"] = comps[2] / mag
        factor = factor * (2.0 * np.pi * np.square(mag))
    return out, factor


def _pack_injection_array(columns, total_generated, analysis_time):
    """Stack the column dict into the (param, injection) DataArray the
    downstream pipeline consumes (reference dims/attrs layout)."""
    names = list(columns)
    table = np.stack([np.asarray(columns[p]) for p in names])
    return DataArray(
        table,
        ("param", "injection"),
        coords={"param": np.array(names), "injection": np.arange(table.shape[1])},
        attrs={"total_generated": total_generated, "analysis_time": analysis_time},
    )


def get_o4a_cumulative_injection_dict(file, param_names, snr_threshold=10, ifar_threshold=1):
    """O4a cumulative injection loader: found = semianalytic SNR >= thresh OR
    any far column <= 1/ifar; prior = exp(lnpdraw)/weights with q-jacobian and
    spin-magnitude factors.

    Parity: gwinferno/preprocess/selection.py:12-79.
    """
    import h5py

    with h5py.File(file, "r") as ff:
        total_generated = ff.attrs["total_generated"]
        live_time_yr = _analysis_time_yr(ff.attrs)
        events = np.asarray(ff["events"][:])

    detected = events["semianalytic_observed_phase_maximized_snr_net"] >= snr_threshold
    for column in events.dtype.names:
        if "far" in column:
            detected |= events[column] <= 1.0 / ifar_threshold
    events = events[detected]  # slice once; every later read is of found rows

    m1 = events["mass1_source"]
    m2 = events["mass2_source"]
    columns = {
        "mass_1": m1,
        "mass_2": m2,
        "mass_ratio": m2 / m1,
        "redshift": events["redshift"],
    }
    prior = np.exp(events[_O4A_LNPDRAW]) / events["weights"]
    if "mass_ratio" in param_names:
        prior = prior * m1  # |dm2/dq| at fixed m1
    if "a_1" in param_names or "chi_eff" in param_names:
        spins, iso_factor = _cartesian_spins_to_mag_tilt(
            {f"spin{i}{ax}": events[f"spin{i}{ax}"] for i in (1, 2) for ax in "xyz"}
        )
        columns.update(spins)
        prior = prior * iso_factor
    columns["prior"] = prior

    return _pack_injection_array(columns, total_generated, live_time_yr)


def get_o3_cumulative_injection_dict(fi, param_names, ifar_threshold=1, snr_threshold=10, additional_cuts=None):
    """O3 sensitivity-injection loader (LVK zenodo record 5546676 schema).

    found = any ifar column > threshold, plus o1/o2 SNR cut when a ``name``
    column exists.  Parity: gwinferno/preprocess/selection.py:82-140.
    """
    import h5py

    with h5py.File(fi, "r") as ff:
        grp = ff["injections"]

        n_total = grp["mass1_source"].shape[0]
        detected = np.zeros(n_total, dtype=bool)
        for column in grp:
            if "ifar" in column.lower():
                detected |= grp[column][()] > ifar_threshold
        if "name" in grp:
            name = grp["name"][()]
            early_runs = (name == b"o1") | (name == b"o2")
            detected |= early_runs & (grp["optimal_snr_net"][()] > snr_threshold)
        for column, floor in (additional_cuts or {}).items():
            detected |= grp[column][()] >= floor

        def col(name):
            return grp[name][()][detected]

        m1 = col("mass1_source")
        m2 = col("mass2_source")
        columns = {
            "mass_1": m1,
            "mass_2": m2,
            "mass_ratio": m2 / m1,
            "redshift": col("redshift"),
        }
        prior = col("sampling_pdf")
        if "a_1" in param_names or "chi_eff" in param_names:
            # aligned-spin-only variants of the release omit the in-plane
            # components; treat them as zero (a == |s_z|, cos_tilt = sign)
            zeros = np.zeros(int(detected.sum()))
            spins, iso_factor = _cartesian_spins_to_mag_tilt(
                {
                    f"spin{i}{ax}": (col(f"spin{i}{ax}") if f"spin{i}{ax}" in grp else zeros)
                    for i in (1, 2)
                    for ax in "xyz"
                }
            )
            columns.update(spins)
            prior = prior * iso_factor
        if "mass_ratio" in param_names:
            prior = prior * m1
        columns["prior"] = prior

        # total_generated appears as a group attr in some LVK releases and a
        # scalar dataset in others (reference selection.py:110-112 reads the
        # attr; real O3 files have shipped both layouts)
        if "total_generated" in grp.attrs:
            total_generated = _scalarize(grp.attrs["total_generated"])
        elif "total_generated" in grp:
            total_generated = _scalarize(grp["total_generated"][()])
        else:
            raise KeyError("injections group has neither a total_generated attr nor dataset")
        live_time_yr = _analysis_time_yr(ff.attrs, grp.attrs)

    return _pack_injection_array(columns, total_generated, live_time_yr)


def resample_injections(generator, model_prob, injdata, Ndraw, param_map, **kwargs):
    """Importance-resample the found-injection bank toward a target population.

    The bank rows ``injdata`` (a ``(param, injection)`` tensor) were drawn
    with density ``prior``; under the target density ``model_prob`` each
    carries weight w = target/prior.  Draws ``N = floor((sum w)^2 / sum
    w^2)`` (the bank's effective size under w) indices with probability
    proportional to w, from ``generator`` (a ``torch.Generator`` on
    ``injdata``'s device, where the JAX package takes a PRNG key), rewrites
    the prior row to the target density over its own normalization mu =
    sum(w)/Ndraw (the detection-efficiency estimate), and propagates the MC
    variance of mu into the updated effective injection count.

    ``sum w`` and ``sum w^2`` are formed in float64 whatever ``injdata``'s
    dtype, so ``N`` is the integer the float64 formula gives on the same
    weights.  Returns ``(bank, N, Neff)``: ``bank`` in ``injdata``'s dtype,
    ``Neff`` a float64 scalar tensor.
    """
    weights = model_prob(injdata, **kwargs) / injdata[param_map["prior"], :]
    w64 = weights.double()
    w_sum = w64.sum()
    w_sumsq = w64.square().sum()
    if not (bool(torch.isfinite(w_sum)) and float(w_sum) > 0.0 and bool(torch.isfinite(w_sumsq))):
        raise ValueError(f"importance weights must be finite with a positive sum, got sum {float(w_sum)}")
    n_eff_bank = int(w_sum**2 // w_sumsq)
    mu = w_sum / Ndraw

    idx = torch.multinomial(w64 / w_sum, n_eff_bank, replacement=True, generator=generator)
    bank = injdata[:, idx]  # a copy (advanced indexing)
    bank[param_map["prior"], :] = model_prob(bank, **kwargs) / mu.to(bank.dtype)

    var_mu = w_sumsq / Ndraw**2 - mu**2 / Ndraw
    return bank, n_eff_bank, mu**2 / var_mu
