"""The port's sample-axis-chunked likelihood (``ops/chunked.py``) and the
bench model's chunked route (``BenchModel(sample_chunks=n)``) on the CPU,
float64, against the JAX package's ``ops/chunked.py`` and ``bench.py``
(``BENCH_SAMPLE_CHUNKS``) on the same seeded inputs, and against the flat
path.

Tolerances (float64; the chunks reorder the reductions):
- chunked against flat and against JAX: values rtol 1e-12, gradients rtol
  1e-10;
- the bench model chunked against flat: potential rtol 1e-10, gradients
  rtol 1e-7 / atol 1e-9 (``tests/test_chunked.py``'s); against the JAX
  chunked model, potential rtol 1e-9, gradient rtol 1e-8 / atol 1e-9;
- the summaries against ``per_event_log_bayes_factors`` and
  ``detection_efficiency``: rtol 1e-12 (n_eff of the injections 1e-10).
"""

import math
import os
import sys

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JRedshift
from gwinferno_tpu.ops import chunked as jchunked
from gwinferno_tpu.pipeline import analysis as janalysis
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.ops import fused
from gwinferno_tpu_torch.ops.chunked import chunked_double_logsumexp
from gwinferno_tpu_torch.ops.chunked import chunked_summaries
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline.bench_model import INIT_JITTER
from gwinferno_tpu_torch.pipeline.bench_model import BenchModel
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402

CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)


def _quadratic(x, theta):
    """``theta x - 0.1 x^2`` with ``theta`` a scalar or ``(C,)`` (a leading
    chain axis in the port)."""
    th = theta if theta.ndim == 0 else theta[:, None, None]
    return th * x - 0.1 * x**2


@pytest.mark.parametrize("theta", [[0.7], [0.7, -0.4, 1.3]], ids=["scalar", "three-chains"])
def test_chunked_double_logsumexp_matches_flat(theta):
    x = np.random.default_rng(0).normal(size=(5, 24))
    th = torch.tensor(theta[0] if len(theta) == 1 else theta, dtype=torch.float64, requires_grad=True)
    lse1, lse2 = chunked_double_logsumexp(lambda part: _quadratic(part["x"], th), {"x": torch.tensor(x)}, 4)
    (g_chunk,) = torch.autograd.grad((lse1 + lse2).sum(), th)

    thf = th.detach().clone().requires_grad_(True)
    lw = _quadratic(torch.tensor(x), thf)
    flat1, flat2 = torch.logsumexp(lw, -1), torch.logsumexp(2 * lw, -1)
    (g_flat,) = torch.autograd.grad((flat1 + flat2).sum(), thf)
    np.testing.assert_allclose(lse1.detach().numpy(), flat1.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(lse2.detach().numpy(), flat2.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_chunk.numpy(), g_flat.numpy(), rtol=1e-10)

    # the JAX function, one chain at a time (its vmap is the port's chain axis)
    for c, t in enumerate(np.atleast_1d(theta)):
        def jf(t_):
            return jchunked.chunked_double_logsumexp(lambda part: t_ * part["x"] - 0.1 * part["x"] ** 2, {"x": x}, 4)

        j1, j2 = jf(t)
        jg = jax.grad(lambda t_: jnp.sum(jf(t_)[0] + jf(t_)[1]))(t)
        np.testing.assert_allclose(np.atleast_2d(lse1.detach().numpy())[c], np.asarray(j1), rtol=1e-12)
        np.testing.assert_allclose(np.atleast_2d(lse2.detach().numpy())[c], np.asarray(j2), rtol=1e-12)
        np.testing.assert_allclose(np.atleast_1d(g_chunk.numpy())[c], float(jg), rtol=1e-10)


def test_chunked_handles_minus_inf_rows():
    """-inf log weights (out-of-support samples) must neither poison the
    merge nor the gradient."""
    x = np.linspace(-1, 1, 12).reshape(1, 12)
    th = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)

    def logw(part):
        return torch.where(part["x"] > 0.5, -torch.inf, th * part["x"])

    lse1, _ = chunked_double_logsumexp(logw, {"x": torch.tensor(x)}, 3)
    (g,) = torch.autograd.grad(lse1[0], th)
    want = jax.value_and_grad(
        lambda t: jchunked.chunked_double_logsumexp(
            lambda part: jnp.where(part["x"] > 0.5, jnp.nan_to_num(-jnp.inf), t * part["x"]), {"x": x}, 3)[0][0]
    )(1.3)
    np.testing.assert_allclose(float(lse1[0]), float(want[0]), rtol=1e-12)
    np.testing.assert_allclose(float(g), float(want[1]), rtol=1e-10)
    assert math.isfinite(float(g))


def test_chunk_all_minus_inf_for_a_row():
    """A row that is -inf over a whole chunk (the first and the last of
    four here), and a row that is -inf everywhere: the merged value and the
    gradient equal the flat ``torch.logsumexp`` path's on every row it
    defines, and are finite (the all--inf row: -inf with a zero gradient).
    ``torch.logaddexp``'s own merge gives the gradient a NaN there."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(4, 40)))
    dead = torch.zeros(4, 40, dtype=torch.bool)
    dead[1, :10] = dead[1, 30:] = True  # chunks 0 and 3 of row 1
    dead[2, 20:30] = True  # chunk 2 of row 2
    dead[3] = True  # all of row 3
    th = torch.tensor([0.6, -1.1], dtype=torch.float64, requires_grad=True)

    def logw(part):
        return torch.where(part["dead"], -torch.inf, th[:, None, None] * part["x"] + 0.3 * th[:, None, None] ** 2)

    banks = {"x": x, "dead": dead}
    l1, l2 = chunked_double_logsumexp(logw, banks, 4)
    live = slice(0, 3)
    (g,) = torch.autograd.grad(l1[:, live].sum() + 0.5 * l2[:, live].sum() + 0.0 * (l1[:, 3] + l2[:, 3]).sum(), th)
    assert bool(torch.isfinite(g).all())
    assert bool((l1[:, 3] == -torch.inf).all() and (l2[:, 3] == -torch.inf).all())

    thf = th.detach().clone().requires_grad_(True)
    lw = torch.where(dead, -torch.inf, thf[:, None, None] * x + 0.3 * thf[:, None, None] ** 2)
    f1, f2 = torch.logsumexp(lw, -1), torch.logsumexp(2 * lw, -1)
    (gf,) = torch.autograd.grad(f1[:, live].sum() + 0.5 * f2[:, live].sum(), thf)
    np.testing.assert_allclose(l1[:, live].detach().numpy(), f1[:, live].detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(l2[:, live].detach().numpy(), f2[:, live].detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), gf.numpy(), rtol=1e-10)

    # the fault the guarded merge avoids
    a = torch.tensor(-math.inf, requires_grad=True)
    torch.logaddexp(a, torch.tensor(-math.inf)).backward()
    assert math.isnan(float(a.grad))
    b = torch.tensor(-math.inf, requires_grad=True)
    fused.logaddexp(b, torch.tensor(-math.inf)).backward()
    assert float(b.grad) == 0.0


def test_chunked_rejects_a_chunk_count_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        chunked_double_logsumexp(lambda part: part["x"], {"x": torch.zeros(2, 10)}, 3)


def _cloud_catalog():
    """``tests/test_chunked.py``'s catalog: 6 events x 32 samples, 64 found
    injections, uniform clouds from seed 1."""
    rng = np.random.default_rng(1)
    E, S, F = 6, 32, 64
    spec = {"mass_1": (6, 90), "mass_ratio": (0.3, 1), "redshift": (0.05, 1.5), "a_1": (0.05, 0.9),
            "a_2": (0.05, 0.9), "cos_tilt_1": (-1, 1), "cos_tilt_2": (-1, 1), "prior": (0.5, 2)}
    pedict = {k: rng.uniform(lo, hi, (E, S)) for k, (lo, hi) in spec.items()}
    injdict = {k: rng.uniform(lo, hi, (F,)) for k, (lo, hi) in spec.items()}
    return pedict, injdict, {"total_inj": 10.0 * F, "obs_time": 1.0, "nObs": E}


def _catalog_slice(n_events=12, n_samples=600, n_found=6000):
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    # read directly with h5py, never through the conftest fixtures that run the generator
    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:n_found]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=n_events)


def _jax_potential(model, u):
    """The JAX model's potential and flat gradient (sorted-name order, as
    the port's) at the unconstrained ``u`` (``{site: (C,)}``), vmapped over
    the chains and compiled."""
    u = {k: jnp.asarray(v.numpy()) for k, v in u.items()}
    val, grad = jax.jit(jax.vmap(jax.value_and_grad(lambda uu: jppl.potential_energy(model, (), {}, uu))))(u)
    return np.asarray(val), np.asarray(jax.vmap(lambda g: jax.flatten_util.ravel_pytree(g)[0])(grad))


def _jax_bench(pe, inj, const, chunks):
    old = os.environ.get("BENCH_SAMPLE_CHUNKS")
    os.environ["BENCH_SAMPLE_CHUNKS"] = str(chunks)
    try:
        return bench.make_model(pe, inj, const, JRedshift(pe["redshift"], inj["redshift"]))
    finally:
        if old is None:
            os.environ.pop("BENCH_SAMPLE_CHUNKS", None)
        else:
            os.environ["BENCH_SAMPLE_CHUNKS"] = old


@pytest.mark.parametrize("catalog, chunks, against_jax", [("cloud", 4, True), ("slice", 4, True), ("slice", 8, False)])
def test_bench_model_chunked_matches_flat_potential(catalog, chunks, against_jax):
    """The chunked route evaluates the same posterior density as the flat
    route, and as the JAX bench's chunked model, at three jittered starts:
    on ``tests/test_chunked.py``'s cloud catalog (which sits on the n_eff
    wall) and on a slice of the committed catalog (off the walls)."""
    pe, inj, const = _cloud_catalog() if catalog == "cloud" else _catalog_slice()
    rng = np.random.default_rng(7)
    params = {k: v + INIT_JITTER[k] * rng.uniform(-1, 1, 3) for k, v in bench.FIDUCIAL_INIT.items()}
    zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    out = {}
    for n in (1, chunks):
        model = BenchModel(pe, inj, const, zm, sample_chunks=n, **F64)
        pot = ModelPotential(model, **F64)
        z = params_from_jax(params, model, **F64)
        out[n] = pot.value_and_grad(z)
    (u1, g1), (un, gn) = out[1], out[chunks]
    if catalog == "slice":
        assert bool((u1.abs() < 1e30).all()), "the slice must sit off the likelihood walls"
    np.testing.assert_allclose(un.numpy(), u1.numpy(), rtol=1e-10)
    np.testing.assert_allclose(gn.numpy(), g1.numpy(), rtol=1e-7, atol=1e-9)
    if against_jax:
        want_u, want_g = _jax_potential(_jax_bench(pe, inj, const, chunks), pot.unravel(z))
        np.testing.assert_allclose(un.numpy(), want_u, rtol=1e-9)
        np.testing.assert_allclose(gn.numpy(), want_g, rtol=1e-8, atol=1e-9)


def test_bench_model_refuses_two_routes():
    pe, inj, const = _cloud_catalog()
    zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    with pytest.raises(ValueError, match="pick one"):
        BenchModel(pe, inj, const, zm, streamed=True, sample_chunks=4, **F64)
    with pytest.raises(ValueError, match="divide"):
        BenchModel(pe, inj, const, zm, sample_chunks=5, **F64)


@pytest.mark.parametrize("inj_chunks", [3, 4], ids=["divides", "falls-back-to-one"])
def test_chunked_summaries_semantics(inj_chunks):
    """chunked_summaries reproduces per_event_log_bayes_factors and
    detection_efficiency on the log path, the port's and the JAX
    package's, and equals the JAX chunked_summaries."""
    rng = np.random.default_rng(3)
    pe_x = rng.normal(size=(4, 20))
    inj_x = rng.normal(size=(30,))

    def logw(part):
        return -0.5 * part["x"] ** 2

    (logBFs, log_n_effs, S), (log_mu, log_n_eff_inj) = chunked_summaries(
        logw, {"x": torch.tensor(pe_x)}, logw, {"x": torch.tensor(inj_x)}, 300.0, 4, inj_chunks=inj_chunks
    )
    assert S == 20
    want_bf, want_ne, _ = janalysis.per_event_log_bayes_factors(jnp.asarray(-0.5 * pe_x**2), log=True)
    np.testing.assert_allclose(logBFs.numpy(), np.asarray(want_bf), rtol=1e-12)
    np.testing.assert_allclose(log_n_effs.numpy(), np.asarray(want_ne), rtol=1e-12)
    port_bf, port_ne, _ = analysis.per_event_log_bayes_factors(torch.tensor(-0.5 * pe_x**2), log=True)
    np.testing.assert_allclose(logBFs.numpy(), port_bf.numpy(), rtol=1e-12)
    np.testing.assert_allclose(log_n_effs.numpy(), port_ne.numpy(), rtol=1e-12)
    want_mu, want_nei, _ = janalysis.detection_efficiency(jnp.asarray(-0.5 * inj_x**2), 300.0, log=True)
    np.testing.assert_allclose(float(log_mu), float(want_mu), rtol=1e-12)
    np.testing.assert_allclose(float(log_n_eff_inj), float(want_nei), rtol=1e-10)
    (jbf, jne, jS), (jmu, jnei) = jchunked.chunked_summaries(
        lambda p: -0.5 * p["x"] ** 2, {"x": pe_x}, lambda p: -0.5 * p["x"] ** 2, {"x": inj_x}, 300.0, 4,
        inj_chunks=inj_chunks,
    )
    assert jS == S
    np.testing.assert_allclose(logBFs.numpy(), np.asarray(jbf), rtol=1e-12)
    np.testing.assert_allclose(log_n_effs.numpy(), np.asarray(jne), rtol=1e-12)
    np.testing.assert_allclose(float(log_mu), float(jmu), rtol=1e-12)
    np.testing.assert_allclose(float(log_n_eff_inj), float(jnei), rtol=1e-10)
