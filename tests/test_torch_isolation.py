"""The port stands alone: no JAX, no JAX package, h5py, PyYAML and
matplotlib only lazily; config dotted paths resolve onto the port and never
fall back to the JAX package; CUDA entry points never fall back to the CPU
on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gwinferno_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "torch_scheduler_routes.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(tree):
    """(module name, at module level?) for every absolute import."""
    top = {id(node) for node in tree.body}
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, id(node) in top) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.module, id(node) in top))
    return out


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for name, at_top in _imported_modules(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "gwinferno_tpu"), f"{path} imports {name}"
        assert not (root in LAZY and at_top), f"{path} imports {name} at module level"


# what the port may import only inside the functions that need it (the
# card's machine has none of these)
LAZY = ("h5py", "yaml", "matplotlib")


def test_port_and_smoke_import_without_jax_and_h5py():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'h5py', 'yaml', 'matplotlib', 'gwinferno_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import gwinferno_tpu_torch\n"
        "for m in pkgutil.walk_packages(gwinferno_tpu_torch.__path__, 'gwinferno_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert sys.modules['gwinferno_tpu'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# a finder that records every attempt to import the JAX package
_SPY = (
    "import sys\n"
    "class Spy:\n"
    "    seen = []\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('gwinferno_tpu', 'jax'):\n"
    "            Spy.seen.append(name)\n"
    "        return None\n"
    "sys.meta_path.insert(0, Spy())\n"
)


def _config_paths():
    """Every dotted path a config of the repo names (the example configs and
    the configs written by the JAX package's config tests)."""
    import re

    files = [os.path.join(ROOT, "examples", "config_files", n) for n in os.listdir(os.path.join(ROOT, "examples",
                                                                                                "config_files"))
             if n.endswith(".yml")]
    files += [os.path.join(ROOT, "tests", "ppl", "test_mixture.py"), os.path.join(ROOT, "tests", "pipeline",
                                                                                   "test_config.py")]
    paths = set()
    for path in files:
        with open(path) as f:
            paths |= set(re.findall(r"^\s*(?:model|prior):\s*([A-Za-z_][\w.]*)\s*$", f.read(), re.M))
    return sorted(paths)


def test_config_dotted_paths_resolve_onto_the_port():
    paths = _config_paths()
    assert "gwinferno.numpyro_distributions.PowerlawSmoothedPowerlaw" in paths
    assert "numpyro.distributions.MixtureGeneral" in paths and len(paths) >= 8
    code = _SPY + (
        "from gwinferno_tpu_torch.pipeline.parser import ConfigReader, load_dist_from_string\n"
        f"for p in {paths!r}:\n"
        "    obj = load_dist_from_string(p)\n"
        "    assert obj.__module__.startswith('gwinferno_tpu_torch.'), (p, obj.__module__)\n"
        "r = ConfigReader()\n"
        "r.parse('examples/config_files/config_validation.yml')\n"
        "assert Spy.seen == [], Spy.seen\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_jax_package_paths_never_fall_back_to_the_jax_package():
    """A dotted path of the JAX package that the port lacks, or a JAX path,
    raises ImportError without any attempt to import the JAX package."""
    code = _SPY + (
        "from gwinferno_tpu_torch.pipeline.parser import load_dist_from_string\n"
        "for p in ('gwinferno_tpu.parallel.mesh.create_mesh', 'gwinferno.parallel.sharding.shard_chain_state',\n"
        "          'gwinferno_tpu.ops.chunked.chunked_summaries', 'numpyro.distributions.StudentT',\n"
        "          'jax.numpy.sum'):\n"
        "    try:\n"
        "        load_dist_from_string(p)\n"
        "    except ImportError as e:\n"
        "        assert 'not imported' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(p)\n"
        "from gwinferno_tpu_torch.infer.svi import find_map\n"
        "for p in ('gwinferno_tpu.infer.svi.find_map', 'gwinferno.pipeline.analysis.find_map'):\n"
        "    assert load_dist_from_string(p) is find_map, p\n"
        "assert Spy.seen == [], Spy.seen\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_module_walk_covers_the_engines():
    """The import checks above walk every module of the port, the inference
    engines and the checkpoint module among them."""
    walked = {os.path.relpath(p, PKG) for p in _port_files()}
    engines = {os.path.join("infer", n) for n in ("hmc.py", "mcmc.py", "nuts.py", "smc.py", "svi.py")}
    assert engines | {os.path.join("utils", "checkpoint.py")} <= walked


def test_the_module_walk_covers_the_model_library():
    """The import checks above walk the model library and the
    posterior-predictive calculations too."""
    walked = {os.path.relpath(p, PKG) for p in _port_files()}
    library = {"cosmology.py", "distributions.py", "interpolation.py", os.path.join("models", "spline_perturbation.py"),
               os.path.join("postprocess", "calculations.py"), os.path.join("pipeline", "analysis.py")}
    library |= {os.path.join("models", "bsplines", n) for n in ("single.py", "separable.py", "smoothing.py")}
    library |= {os.path.join("models", "parametric", "parametric.py"), os.path.join("ppl", "infer_util.py"),
                os.path.join("ppl", "primitives.py")}
    assert library <= walked


def test_resolve_device_raises_without_cuda(monkeypatch):
    from gwinferno_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    import numpy as np

    from gwinferno_tpu_torch.infer import MCMC, NUTS
    from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
    from gwinferno_tpu_torch.pipeline.utils import setup_bspline_mass_models
    from gwinferno_tpu_torch.pipeline.utils import to_tensors

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MCMC(NUTS(lambda: None))
    with pytest.raises(RuntimeError, match="CUDA"):
        to_tensors({"x": np.zeros(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        PowerlawRedshiftModel(np.full((2, 3), 0.5), np.full(4, 0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        setup_bspline_mass_models({"mass_1": np.full((2, 3), 10.0), "mass_ratio": np.full((2, 3), 0.5)},
                                  {"mass_1": np.full(4, 10.0), "mass_ratio": np.full(4, 0.5)}, 8, 6, 3.0, 100.0)
    # the config route: the CLI's run and the config model under MCMC
    import chip_smoke
    from gwinferno_tpu_torch.pipeline.cli import model_from_reader, run_config
    from gwinferno_tpu_torch.pipeline.parser import ConfigReader

    reader = ConfigReader()
    reader.parse_dict(chip_smoke.CONFIG_VALIDATION)
    bank = {k: np.full((2, 3), 0.5) for k in ("mass_1", "mass_ratio", "redshift", "prior")}
    with pytest.raises(RuntimeError, match="CUDA"):
        run_config(reader, bank, {k: v[0] for k, v in bank.items()}, {"total_inj": 10.0, "nObs": 2, "obs_time": 1.0})
    with pytest.raises(RuntimeError, match="CUDA"):
        MCMC(NUTS(model_from_reader(reader)))
    # the model library and the posterior-predictive calculations
    from gwinferno_tpu_torch.interpolation import RectBivariateBasisSpline
    from gwinferno_tpu_torch.models.bsplines import separable, single
    from gwinferno_tpu_torch.models.spline_perturbation import PowerlawBasisSplinePrimaryPowerlawRatio
    from gwinferno_tpu_torch.models.spline_perturbation import PowerlawBasisSplinePrimaryRatio
    from gwinferno_tpu_torch.pipeline.utils import setup_bspline_spin_models
    from gwinferno_tpu_torch.postprocess import calculations

    x, x_inj = np.full((2, 3), 0.5), np.full(4, 0.5)
    m, m_inj = np.full((2, 3), 20.0), np.full(4, 20.0)
    builders = [
        lambda: single.BSplineRedshift(6, x, x_inj, x, x_inj),
        lambda: single.BSplineChiEffective(6, x, x_inj),
        lambda: single.BSplineSymmetricChiEffective(6, x, x_inj),
        lambda: single.BSplineChiPrecess(6, x, x_inj),
        lambda: separable.BSplineIndependentSpinMagnitudes(6, 6, x, x, x_inj, x_inj),
        lambda: separable.BSplineIndependentSpinTilts(6, 6, x, x, x_inj, x_inj),
        lambda: separable.BSplinePrimaryPowerlawRatio(6, m, m_inj),
        lambda: separable.PLPeakPrimaryBSplineRatio(6, x, x_inj),
        lambda: separable.BSplineIIDComponentMasses(6, m, m, m_inj, m_inj),
        lambda: separable.BSplineIndependentComponentMasses(6, 6, m, m, m_inj, m_inj),
        lambda: separable.BSplineEffectiveSpinDims(6, 6, x, x, x_inj, x_inj),
        lambda: PowerlawBasisSplinePrimaryPowerlawRatio(6, m, m_inj),
        lambda: PowerlawBasisSplinePrimaryRatio(6, 6, m, x, m_inj, x_inj),
        lambda: RectBivariateBasisSpline(5, 5),
        lambda: setup_bspline_spin_models({k: x for k in ("a_1", "a_2", "cos_tilt_1", "cos_tilt_2")},
                                          {k: x_inj for k in ("a_1", "a_2", "cos_tilt_1", "cos_tilt_2")}, 6, 6, iid=False),
        lambda: calculations.calculate_bspline_mass_ppds(np.zeros((1, 6)), np.zeros((1, 6)), {"m1": 6, "q": 6}, 3.0, 100.0),
        lambda: calculations.calculate_powerlaw_peak_mass_ppds(*np.ones((5, 1)), 3.0, 100.0),
        lambda: calculations.calculate_peak_logm1_bspline_q_ppds(np.ones(1), np.ones(1), np.zeros((1, 6)), {"q": 6}, 3.0,
                                                                 100.0),
        lambda: calculations.calculate_beta_spin_mag(np.ones(1), np.ones(1)),
        lambda: calculations.calculate_mixture_iso_aligned_spin_tilt(np.ones(1), np.ones(1)),
        lambda: calculations.calculate_bspline_spin_ppds(np.zeros((1, 6)), np.zeros((1, 6)), {"a": 6, "tilt": 6}),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_double_logsumexp_on_cpu_uses_the_plain_version(monkeypatch):
    from gwinferno_tpu_torch.ops import fused

    def no_kernel(x):
        raise AssertionError("the CUDA kernel must not run for a CPU tensor")

    monkeypatch.setattr(fused, "dlse_cuda", no_kernel)
    before = fused.DLSE_KERNEL.launches
    x = torch.randn(3, 7, dtype=torch.float64)
    l1, l2 = fused.double_logsumexp(x)
    p1, p2 = fused._dlse_torch(x)
    assert torch.equal(l1, p1) and torch.equal(l2, p2)
    assert fused.DLSE_KERNEL.launches == before


def test_dlse_cuda_rejects_what_the_kernel_does_not_take():
    from gwinferno_tpu_torch.ops.fused import dlse_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        dlse_cuda(torch.zeros(2, 3))


@pytest.mark.cuda
def test_k1_kernel_matches_plain_version_on_the_card():
    """K1 on the card against its plain version (both dtypes, -inf rows,
    the gradient through the autograd Function against the plain version's
    on every shape), on one block a row and on rows split over many blocks
    (the injection calls), with row lengths that are not a multiple of the
    16-byte vector (rows starting unaligned); two launches on the same
    input give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gwinferno_tpu_torch.ops.fused import DLSE_KERNEL, _dlse_torch, dlse_device_geometry, double_logsumexp

    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0.0)), (torch.float64, dict(atol=0.0, rtol=1e-12))):
        for shape in ((48, 5000), (16, 46770), (8, 46770), (5, 4097), (3, 3)):
            x = 10.0 + 3.0 * torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            x[2] = -torch.inf
            x[1, ::3] = -torch.inf
            before = DLSE_KERNEL.launches
            got, want = double_logsumexp(x), _dlse_torch(x)
            assert DLSE_KERNEL.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(torch.isinf(a), torch.isinf(b))
                fin = torch.isfinite(b)
                torch.testing.assert_close(a[fin], b[fin], **tol)
            again = double_logsumexp(x)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            if shape[1] > 40000:
                assert dlse_device_geometry(x).n_tiles > 1
            grads = []
            for fn in (double_logsumexp, _dlse_torch):
                xg = x.clone().requires_grad_(True)
                l1, l2 = fn(xg)
                (grad,) = torch.autograd.grad((l1[torch.isfinite(l1)].sum() + 2 * l2[torch.isfinite(l2)].sum()), xg)
                grads.append(grad)
            assert torch.isfinite(grads[0]).all()
            gtol = 1e-4 if dtype == torch.float32 else 1e-10
            torch.testing.assert_close(grads[0], torch.nan_to_num(grads[1], nan=0.0), atol=gtol, rtol=0.0)


def test_streamed_op_on_cpu_uses_the_plain_versions(monkeypatch):
    import chip_smoke
    from gwinferno_tpu_torch.ops import streamed

    def no_kernel(*args):
        raise AssertionError("the CUDA kernels must not run for CPU tensors")

    monkeypatch.setattr(streamed, "streamed_fwd_cuda", no_kernel)
    monkeypatch.setattr(streamed, "streamed_bwd_cuda", no_kernel)
    before = (streamed.STREAMED_FWD_KERNEL.launches, streamed.STREAMED_BWD_KERNEL.launches)
    banks, valid, zmax = chip_smoke.k2_edge_case(seed=1, rows=4, n_samples=60)
    bank = streamed.StreamedBank(banks, 5.0, 100.0, zmax, valid=valid)
    th = {k: v.requires_grad_(True) for k, v in chip_smoke.k2_edge_theta(2).items()}
    l1, l2 = bank(th)
    live = torch.isfinite(l1) & torch.isfinite(l2)
    grads = torch.autograd.grad(l1[live].sum() + l2[live].sum(), list(th.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert (streamed.STREAMED_FWD_KERNEL.launches, streamed.STREAMED_BWD_KERNEL.launches) == before


def test_streamed_cuda_wrappers_reject_cpu_tensors():
    from gwinferno_tpu_torch.ops.streamed import N_COL, P_STRIDE, streamed_bwd_cuda, streamed_fwd_cuda

    cols, flags, P = torch.zeros(N_COL, 2, 8), torch.zeros(2, 8, dtype=torch.int32), torch.zeros(1, P_STRIDE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        streamed_fwd_cuda(cols, flags, P)
    with pytest.raises(ValueError, match="CUDA tensors"):
        streamed_bwd_cuda(cols, flags, P, *[torch.zeros(1, 2)] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("num_chains", [1, 2, 3, 17])
@pytest.mark.parametrize("shape", [(6, 700), (69, 8000)], ids=["edge", "full_width"])
def test_k2_kernels_match_plain_versions_on_the_card(num_chains, shape):
    """K2's forward and backward kernels against their plain versions on a
    bank that drives every branch (both dtypes; f32 against the f32 plain
    version, since the redshift floor is the dtype's own), small and at the
    PE bank's full width (the geometry the main path launches with; 2 and 3
    chains run in one forward block of 4 with the rest masked, 17 in five
    chain groups, the last of one chain), then the whole op, gradient
    included, on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke
    from gwinferno_tpu_torch.ops import streamed

    banks, valid, zmax = chip_smoke.k2_edge_case(seed=2, rows=shape[0], n_samples=shape[1])
    bank = streamed.StreamedBank(banks, 5.0, 100.0, zmax, valid=valid)
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    for dtype in (torch.float32, torch.float64):
        cols, flags = bank.columns(dtype, "cuda")
        P = streamed.chain_params(chip_smoke.k2_edge_theta(num_chains, dtype, "cuda"), 5.0, 100.0).contiguous()
        before = (streamed.STREAMED_FWD_KERNEL.launches, streamed.STREAMED_BWD_KERNEL.launches)
        got = streamed.streamed_fwd_cuda(cols, flags, P)
        want = streamed._streamed_fwd_torch(cols, flags, P)
        for a, b in zip(got, want):
            assert torch.equal(torch.isinf(a), torch.isinf(b))
            fin = torch.isfinite(b)
            assert float((a[fin] - b[fin]).abs().max()) <= tol[dtype]
        l1, l2 = (torch.where(torch.isfinite(v), v, 0.0) for v in want)
        g1 = torch.where(torch.isfinite(want[0]), torch.rand(l1.shape, device="cuda", dtype=dtype), 0.0)
        g2 = torch.where(torch.isfinite(want[1]), torch.rand(l2.shape, device="cuda", dtype=dtype) - 0.5, 0.0)
        dP = streamed.streamed_bwd_cuda(cols, flags, P, g1, g2, l1, l2)
        dP_plain = streamed._streamed_bwd_torch(cols, flags, P, g1, g2, l1, l2)
        rel = (dP - dP_plain).norm(dim=1) / dP_plain.norm(dim=1)
        assert float(rel.max()) <= tol[dtype], rel
        assert (streamed.STREAMED_FWD_KERNEL.launches, streamed.STREAMED_BWD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1,
        )

    grads = []
    for dev in ("cuda", "cpu"):
        th = {k: v.requires_grad_(True) for k, v in chip_smoke.k2_edge_theta(num_chains, torch.float64, dev).items()}
        l1, l2 = bank(th)
        live = torch.isfinite(l1) & torch.isfinite(l2)
        grads.append(torch.stack(torch.autograd.grad(l1[live].sum() + 0.5 * l2[live].sum(), list(th.values()))).cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-10)


def test_chip_smoke_fails_without_cuda_and_prints_nothing():
    code = "import sys, torch; torch.cuda.is_available = lambda: False; sys.argv = ['chip_smoke.py']; import chip_smoke; chip_smoke.main()"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_k3_on_cpu_uses_the_plain_version(monkeypatch):
    import chip_smoke
    from gwinferno_tpu_torch.ops import fused

    def no_kernel(*args):
        raise AssertionError("the CUDA kernel must not run for CPU tensors")

    monkeypatch.setattr(fused, "flw_cuda", no_kernel)
    before = fused.FLW_KERNEL.launches
    coefs, design, nlp, E, S = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                for a in chip_smoke.k3_edge_case(seed=1, num_chains=2, n_samples=300))
    got = fused.fused_logweight_logsumexp(coefs, design, nlp, E, S)
    want = fused.fused_logweight_logsumexp_torch(coefs, design, nlp, E, S)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(g[~torch.isnan(w)], w[~torch.isnan(w)])
    assert fused.FLW_KERNEL.launches == before


def test_flw_cuda_rejects_what_the_kernel_does_not_take():
    from gwinferno_tpu_torch.ops.fused import flw_cuda

    with pytest.raises(ValueError, match="CUDA tensors"):
        flw_cuda(torch.zeros(2, 3), torch.zeros(3, 8), torch.zeros(8), 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("num_chains", [1, 3])
def test_k3_kernel_matches_plain_version_on_the_card(num_chains):
    """K3 on the card against its plain version on the edge bank (an empty
    leading tile, a fully masked event, S a multiple of no tile) and as one
    long row split over many blocks, both dtypes, on the contiguous design,
    on a padded-stride view of it and on events of an odd length (runs
    straddling tiles and events); two launches give identical bits; and the
    gradient through the autograd Function against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke
    from gwinferno_tpu_torch.ops import fused

    coefs, design, nlp, E, S = chip_smoke.k3_edge_case(seed=2, num_chains=num_chains)
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        c, d, n = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (coefs, design, nlp))
        for e, s in ((E, S), (1, E * S), (E * 4, S // 4), (E * 20, S // 20)):
            for dd in (d, fused.padded_rows(d)):
                before = fused.FLW_KERNEL.launches
                got = fused.flw_cuda(c, dd, n, e, s)
                want = fused._flw_torch(c, d, n, e, s)
                assert fused.FLW_KERNEL.launches == before + 1
                for a, b in zip(got, want):
                    assert torch.equal(torch.isinf(a), torch.isinf(b)) and not bool(torch.isnan(a).any())
                    fin = torch.isfinite(b)
                    assert float((a[fin] - b[fin]).abs().max()) <= tol
                again = fused.flw_cuda(c, dd, n, e, s)
                assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert fused.flw_device_geometry(c, d, 1, E * S).n_tiles > 1
    grads = []
    for dev in ("cuda", "cpu"):
        ct = torch.tensor(coefs, device=dev, requires_grad=True)
        lbf, lne = fused.fused_logweight_logsumexp(ct, torch.tensor(design, device=dev), torch.tensor(nlp, device=dev), E, S)
        live = torch.isfinite(lbf) & torch.isfinite(lne)
        grads.append(torch.autograd.grad(lbf[live].sum() + 0.5 * lne[live].sum(), ct)[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-10)
