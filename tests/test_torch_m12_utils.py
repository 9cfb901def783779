"""The utility remainders of the port against the JAX package's on the CPU:
the B-spline run's parser, the PPD container, ``DataArray`` and ``Dataset``,
the plotters (the same files with the same pixels, tensors in for the port),
``timed`` and ``trace_capture``."""

import json
import os
import re

import numpy as np
import pytest
import torch
from matplotlib import image

from gwinferno_tpu.pipeline.utils import load_base_parser as jax_base_parser
from gwinferno_tpu.pipeline.utils import pdf_dict_to_xarray as jax_pdf_dict_to_xarray
from gwinferno_tpu.postprocess import plot as jplot
from gwinferno_tpu.utils import prof as jprof
from gwinferno_tpu.utils.dataset import DataArray as JaxDataArray
from gwinferno_tpu.utils.dataset import Dataset as JaxDataset
from gwinferno_tpu_torch.pipeline.utils import load_base_parser
from gwinferno_tpu_torch.pipeline.utils import pdf_dict_to_xarray
from gwinferno_tpu_torch.postprocess import plot
from gwinferno_tpu_torch.utils import prof
from gwinferno_tpu_torch.utils.dataset import DataArray
from gwinferno_tpu_torch.utils.dataset import Dataset


@pytest.mark.parametrize("argv", [[], ["--fused", "--chains", "4", "--reparam", "whitened", "--m-tau", "2.5",
                                       "--max-steps-per-call", "25", "--chain-scheduler", "sync"]])
def test_base_parser_matches_jax(argv):
    assert vars(load_base_parser().parse_args(argv)) == vars(jax_base_parser().parse_args(argv))
    ours = {a.dest: (a.default, a.type, a.choices) for a in load_base_parser()._actions}
    theirs = {a.dest: (a.default, a.type, a.choices) for a in jax_base_parser()._actions}
    assert ours == theirs


def _ppds(seed=0):
    rng = np.random.default_rng(seed)
    grids = {"mass_1": np.linspace(3, 100, 60), "redshift": np.linspace(1e-3, 1.9, 40)}
    pdfs = {k: rng.uniform(0.1, 2.0, (7, len(g))) for k, g in grids.items()}
    return pdfs, grids


def test_pdf_dict_to_xarray_matches_jax():
    pdfs, grids = _ppds()
    got = pdf_dict_to_xarray({k: torch.tensor(v) for k, v in pdfs.items()},
                             {k: torch.tensor(v) for k, v in grids.items()}, 7)
    want = jax_pdf_dict_to_xarray(pdfs, grids, 7)
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        a, b = got[k], want[k]
        assert a.dims == b.dims and a.shape == b.shape and set(a.coords) == set(b.coords)
        assert np.array_equal(a.data, b.data)
        assert all(np.array_equal(a.coords[c], b.coords[c]) for c in b.coords)


def _labeled(cls):
    data = np.arange(2 * 3 * 4, dtype=np.float64).reshape(2, 3, 4)
    return cls(data, ("event", "param", "sample"),
               coords={"event": np.array(["GW1", "GW2"]), "param": np.array(["mass_1", "redshift", "prior"]),
                       "sample": np.arange(4)}, attrs={"total_generated": 10.0})


@pytest.mark.parametrize("labels", [dict(param="redshift"), dict(event="GW2", param="prior"), dict(sample=3),
                                    dict(event="GW1", param="mass_1", sample=1)])
def test_data_array_sel_shape_and_array_match_jax(labels):
    a, b = _labeled(DataArray).sel(**labels), _labeled(JaxDataArray).sel(**labels)
    assert a.dims == b.dims and a.shape == b.shape and a.attrs == b.attrs and set(a.coords) == set(b.coords)
    assert np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a, dtype=np.float32).dtype == np.float32
    assert _labeled(DataArray).shape == _labeled(JaxDataArray).shape == (2, 3, 4)


def test_data_array_sel_missing_label_raises_as_jax():
    errors = []
    for cls in (DataArray, JaxDataArray):
        with pytest.raises(KeyError) as info:
            _labeled(cls).sel(param="chi_eff")
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_dataset_mapping_methods_match_jax():
    out = []
    for ds_cls, arr_cls in ((Dataset, DataArray), (JaxDataset, JaxDataArray)):
        ds = ds_cls({"posteriors": _labeled(arr_cls)})
        ds["injections"] = arr_cls(np.ones((2, 5)), ("param", "injection"))
        out.append((list(ds.keys()), "injections" in ds, "missing" in ds, ds["injections"].shape))
    assert out[0] == out[1] == (["posteriors", "injections"], True, False, (2, 5))


def _pixels(path):
    return image.imread(path)


def test_plotters_write_the_same_files_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    m1, q = np.linspace(3, 100, 80), np.linspace(0.05, 1, 50)
    aa, cc, z = np.linspace(0, 1, 40), np.linspace(-1, 1, 40), np.linspace(1e-3, 1.9, 60)
    mp = [rng.uniform(1e-4, 0.1, (20, 80)) for _ in range(2)]
    qp = [rng.uniform(0.1, 3, (20, 50)) for _ in range(2)]
    ap, cp = [rng.uniform(0.1, 3, (20, 40))], [rng.uniform(0.1, 1, (20, 40))]
    rz = rng.uniform(10, 500, (20, 60))
    dirs = {}
    for name, mod, conv in (("port", plot, torch.tensor), ("jax", jplot, np.asarray)):
        d = tmp_path / name
        d.mkdir()
        dirs[name] = d
        mod.plot_mass_pdfs([conv(v) for v in mp], [conv(v) for v in qp], conv(m1), conv(q), ["a", "b"], "run", str(d))
        mod.plot_spin_pdfs([conv(v) for v in ap], [conv(v) for v in cp], conv(aa), conv(cc), ["a"], "run", str(d))
        mod.plot_spin_pdfs([conv(v) for v in ap], [conv(v) for v in cp], conv(aa), conv(cc), ["a"], "run", str(d),
                           secondary=True)
        mod.plot_rate_of_z_pdfs(conv(rz), conv(z), "run", str(d))
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) == sorted([
        "mass_pdf_run.png", "mass_ratio_pdf_run.png", "spin_mag1_pdf_run.png", "cos_tilt1_pdf_run.png",
        "spin_mag2_pdf_run.png", "cos_tilt2_pdf_run.png", "redshift_pdf_run.png"])
    for n in names:
        assert np.array_equal(_pixels(dirs["port"] / n), _pixels(dirs["jax"] / n)), n


def test_plot_pdf_draws_the_same_band_as_jax(tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(4)
    x, pdf = np.linspace(1, 10, 30), rng.uniform(0.1, 1, (50, 30))
    paths = []
    for name, mod, conv in (("port", plot, torch.tensor), ("jax", jplot, np.asarray)):
        plt.figure()
        mod.plot_pdf(conv(x), conv(pdf), "m", color="green", loglog=False, alpha=0.5)
        paths.append(tmp_path / f"{name}.png")
        plt.savefig(paths[-1], dpi=50)
        plt.close()
    assert np.array_equal(_pixels(paths[0]), _pixels(paths[1]))


def test_timed_prints_the_jax_line():
    lines = {}
    for name, mod in (("port", prof), ("jax", jprof)):
        got = []
        with mod.timed("compile", print_fn=got.append):
            sum(range(1000))
        lines[name] = got
    for got in lines.values():
        assert len(got) == 1 and re.fullmatch(r"\[compile\] \d+\.\d{3}s", got[0])


def test_trace_capture_writes_a_trace_on_cpu(tmp_path):
    logdir = tmp_path / "trace"
    x = torch.randn(64, 64, dtype=torch.float64)
    with prof.trace_capture(str(logdir)):
        (x @ x).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    off = tmp_path / "off"
    with prof.trace_capture(str(off), enabled=False):
        (x @ x).sum()
    assert not off.exists()
