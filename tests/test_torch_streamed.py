"""K2, the port's streamed whole-chain likelihood, on the CPU (its plain
versions), against the JAX package and against the port's flat route.

Tolerances:
- against the JAX streamed op in interpret mode: potential rtol 1e-5,
  gradient rtol 2e-3 / atol 1e-2 (the JAX kernels compute in float32; the
  tolerances of ``tests/ops/test_streamed.py``);
- against the JAX flat model and the port's flat route, float64: potential
  rtol 1e-9, gradient rtol 1e-8 / atol 1e-9 (sums over ~10^4 terms taken in
  another order);
- the analytic backward against autograd of the flat log-weights, the
  summaries tail against JAX's and the seam against the weight path,
  float64: rtol 1e-10.
"""

import math
import os
import sys
from types import SimpleNamespace

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JRedshift
from gwinferno_tpu.ops import streamed as jstreamed
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.ops import streamed
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT, INIT_JITTER, MMAX, MMIN, PARAMS7, BenchModel
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402
import chip_smoke  # noqa: E402

CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)
N_CHAINS = 4


def _catalog_slice(n_events=12, n_samples=600, n_found=6000):
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    # read directly with h5py, never through the conftest fixtures that run the generator
    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:n_found]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=n_events)


@pytest.fixture(scope="module")
def problem():
    """The catalog slice, jittered starts for N_CHAINS chains and the port's
    float64 potential of both routes (the streamed one rows of 1024)."""
    pe, inj, const = _catalog_slice()
    rng = np.random.default_rng(5)
    params = {k: v + INIT_JITTER[k] * rng.uniform(-1, 1, N_CHAINS) for k, v in FIDUCIAL_INIT.items()}
    zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    out = {"pe": pe, "inj": inj, "const": const, "params": params}
    for route, streamed_ in (("flat", False), ("streamed", True)):
        model = BenchModel(pe, inj, const, zm, streamed=streamed_, **F64)
        pot = ModelPotential(model, **F64)
        z = params_from_jax(params, model, **F64)
        out[route] = (model, pot, z) + tuple(pot.value_and_grad(z))
    return out


def _jax_potential(model, params):
    """Potential and flat gradient of a JAX model at constrained ``params``
    (sorted-name flattening, as the port's), vmapped over the chains as the
    JAX sampler runs it (the streamed op then takes its chain-batched
    kernels)."""
    u = jax.vmap(lambda p: jppl.unconstrain_fn(model, (), {}, p))({k: jnp.asarray(v) for k, v in params.items()})
    val, grad = jax.vmap(jax.value_and_grad(lambda uu: jppl.potential_energy(model, (), {}, uu)))(u)
    return np.asarray(val), np.asarray(jax.vmap(lambda g: jax.flatten_util.ravel_pytree(g)[0])(grad))


def test_streamed_route_matches_flat_route(problem):
    _, pot_f, z_f, u_f, g_f = problem["flat"]
    model, pot_s, z_s, u_s, g_s = problem["streamed"]
    assert model.streamed and pot_s.names == pot_f.names
    torch.testing.assert_close(z_s, z_f, rtol=0, atol=0)
    assert bool((u_f.abs() < 1e30).all()), "the slice must sit off the likelihood walls"
    np.testing.assert_allclose(u_s.numpy(), u_f.numpy(), rtol=1e-9)
    np.testing.assert_allclose(g_s.numpy(), g_f.numpy(), rtol=1e-8, atol=1e-9)

    # the deterministic sites of both routes at one point
    sites = {}
    for route in ("flat", "streamed"):
        model, pot, z = problem[route][:3]
        with torch.no_grad(), ppl.trace() as tr, ppl.substitute(data=pot.constrain(z)):
            model()
        sites[route] = tr.trace
    for name, site in sites["flat"].items():
        if site["type"] == "deterministic":
            np.testing.assert_allclose(
                sites["streamed"][name]["value"].numpy(), site["value"].numpy(), rtol=1e-9, err_msg=name
            )


@pytest.mark.parametrize("route", ["jax_flat", "jax_streamed_interpret"])
def test_streamed_route_matches_jax(problem, route):
    pe, inj, const, params = problem["pe"], problem["inj"], problem["const"], problem["params"]
    if route == "jax_streamed_interpret":
        # The JAX op casts its banks to float32 and then tests z <= zmax
        # against the float64 zmax, so the sample AT zmax (the bank maximum
        # that defines it) can round above it and drop out (ROADMAP F2).
        # Both sides therefore get the catalog rounded to float32 values,
        # on which that cast is exact.
        pe, inj = ({k: v.astype(np.float32).astype(np.float64) for k, v in d.items()} for d in (pe, inj))
        zm = JRedshift(pe["redshift"], inj["redshift"])
        # the Pallas kernels run in interpret mode off the TPU
        os.environ["BENCH_STREAMED"] = "1"
        try:
            jmodel = bench.make_model(pe, inj, const, zm)
        finally:
            os.environ.pop("BENCH_STREAMED", None)
        model = BenchModel(pe, inj, const, PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64), streamed=True, **F64)
        u_s, g_s = ModelPotential(model, **F64).value_and_grad(params_from_jax(params, model, **F64))
        tol_u, tol_g = dict(rtol=1e-5), dict(rtol=2e-3, atol=1e-2)
    else:
        jmodel = bench.make_model(pe, inj, const, JRedshift(pe["redshift"], inj["redshift"]))
        _, _, _, u_s, g_s = problem["streamed"]
        tol_u, tol_g = dict(rtol=1e-9), dict(rtol=1e-8, atol=1e-9)
    want_u, want_g = _jax_potential(jmodel, params)
    np.testing.assert_allclose(u_s.numpy(), want_u, **tol_u)
    np.testing.assert_allclose(g_s.numpy(), want_g, **tol_g)


def _flat_log_weight(banks, idx, zmax, th):
    """``BenchModel.log_weight`` (the flat route) at the flat sample indices
    ``idx`` of a 2-D bank."""
    cols = {k: torch.tensor(np.asarray(banks[k]).reshape(-1)[idx]) for k in PARAMS7 + ("log_prior", "log_dvdz", "log1pz")}
    ns = SimpleNamespace(**cols, z_ok=cols["redshift"] <= zmax)
    return BenchModel.log_weight(ns, {k: v[:, None] for k, v in th.items()})


@pytest.mark.parametrize("num_chains", [1, 4, 8])
def test_streamed_backward_matches_autograd_of_the_flat_log_weights(num_chains):
    """``_streamed_bwd_torch`` (carried to theta by autograd through
    ``chain_params``) against autograd of the flat route's log-weights,
    weighted by ``g1 e^(lw-l1) + 2 g2 e^(2lw-l2)``, on a bank that drives
    every branch: beta on both sides of -1 and at -1, q below mmin/m1, m1
    outside [mmin, mmax], a on 0 and 1, |ct| > 1, z > zmax, a row all -inf,
    a row all above zmax and padded lanes."""
    banks, valid, zmax = chip_smoke.k2_edge_case(seed=3)
    rows, S = banks["mass_1"].shape
    bank = streamed.StreamedBank(banks, MMIN, MMAX, zmax, valid=valid)
    cols, flags = bank.columns(torch.float64, "cpu")
    th = {k: v.requires_grad_(True) for k, v in chip_smoke.k2_edge_theta(num_chains).items()}
    P = streamed.chain_params(th, MMIN, MMAX)

    # the forward: the same log-weights as the flat route on every valid lane
    lw, _ = streamed._chain_terms(cols, flags, P.detach(), grad=False)
    flat = _flat_log_weight(banks, np.arange(rows * S), zmax, th).detach().reshape(num_chains, rows, S)
    ok = torch.as_tensor(valid > 0)
    assert torch.equal(torch.isinf(lw[:, ok]), torch.isinf(flat[:, ok]))
    assert bool((lw[:, ~ok] == -math.inf).all())
    fin = torch.isfinite(flat) & ok
    np.testing.assert_allclose(lw[fin].numpy(), flat[fin].numpy(), rtol=1e-12)
    assert bool((lw[:, -2] == -math.inf).all()), "the all--inf row"
    assert bool((lw[:, -1] == torch.finfo(torch.float64).min).all()), "the row above zmax sits on the floor"

    l1, l2 = streamed._streamed_fwd_torch(cols, flags, P.detach(), chunk=256)
    assert bool(torch.isneginf(l1[:, -2]).all()) and bool(torch.isneginf(l2[:, -1]).all())
    rng = np.random.default_rng(num_chains)
    g1 = torch.tensor(rng.uniform(0.2, 1.0, (num_chains, rows)))
    g2 = torch.tensor(rng.uniform(-1.0, 1.0, (num_chains, rows)))
    # rows with a non-finite lse get a zero cotangent and a finite residual, as in the op
    g1, g2 = torch.where(torch.isfinite(l1), g1, 0.0), torch.where(torch.isfinite(l2), g2, 0.0)
    l1, l2 = torch.where(torch.isfinite(l1), l1, 0.0), torch.where(torch.isfinite(l2), l2, 0.0)
    dP = streamed._streamed_bwd_torch(cols, flags, P.detach(), g1, g2, l1, l2, chunk=256)
    assert bool(torch.isfinite(dP).all())
    got = torch.autograd.grad(P, list(th.values()), grad_outputs=dP)

    # reference: autograd of sum_s w_s lw_s over the live samples only (a dead
    # sample weighs 0, but autograd of the flat chain there is 0 * inf = NaN)
    w = torch.where(g1[..., None] != 0, torch.exp(flat - l1[..., None]) * g1[..., None], 0.0) + torch.where(
        g2[..., None] != 0, torch.exp(2.0 * flat - l2[..., None]) * (2.0 * g2[..., None]), 0.0
    )
    w = torch.where(fin, w, 0.0).reshape(num_chains, -1)
    idx = np.flatnonzero(fin.any(0).reshape(-1).numpy())
    w = w[:, idx]
    lw_live = _flat_log_weight(banks, idx, zmax, th)
    want = torch.autograd.grad((torch.where(w != 0, w * lw_live, 0.0)).sum(), list(th.values()))
    for name, g_, w_ in zip(th, got, want):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=1e-10, atol=1e-10 * float(w_.abs().max()), err_msg=name)


def test_reshape_bank_rows():
    rng = np.random.default_rng(0)
    bank = {"a": rng.normal(size=1000), "b": rng.normal(size=1000)}
    rows, valid = streamed.reshape_bank_rows(bank, cols=256)
    jrows, jvalid = jstreamed.reshape_bank_rows(bank, cols=256)
    np.testing.assert_array_equal(valid, jvalid)
    for k in bank:
        assert rows[k].shape == (4, 256) and rows[k].dtype == np.float64
        np.testing.assert_allclose(rows[k], jrows[k], rtol=1e-7)  # the JAX version casts to float32
        np.testing.assert_array_equal(rows[k].reshape(-1)[:1000], bank[k])
    with pytest.raises(ValueError, match="one length"):
        streamed.reshape_bank_rows({"a": np.zeros(10), "b": np.zeros(11)})


def test_streamed_summaries_match_the_jax_tail():
    rng = np.random.default_rng(1)
    C, E, R = 3, 5, 6
    pe = (rng.normal(-3, 1, (C, E)), rng.normal(-5, 1, (C, E)))
    inj = (rng.normal(-9, 1, (C, R)), rng.normal(-16, 1, (C, R)))
    got_pe, got_inj = streamed.streamed_summaries(
        lambda th: tuple(map(torch.tensor, pe)), lambda th: tuple(map(torch.tensor, inj)), None, 800, 1e7
    )
    for c in range(C):
        want_pe, want_inj = jstreamed.streamed_summaries(
            lambda th: (jnp.asarray(pe[0][c]), jnp.asarray(pe[1][c])),
            lambda th: (jnp.asarray(inj[0][c]), jnp.asarray(inj[1][c])),
            None, 800, 1e7,
        )
        assert got_pe[2] == want_pe[2] == 800
        for g, w in zip(got_pe[:2] + got_inj, want_pe[:2] + want_inj):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w), rtol=1e-10)


def _weights(C=3, E=4, S=200, N=500, seed=0):
    rng = np.random.default_rng(seed)
    pe = -0.5 * rng.standard_normal((C, E, S)) ** 2 + rng.normal(size=(C, E, 1))
    inj = -0.5 * rng.standard_normal((C, N)) ** 2 - 3.0
    pe[0, 1, ::7] = -np.inf
    inj[1, :] = -50.0
    inj[1, 0] = 0.0  # chain 1 on the n_eff_inj wall
    pe[2, 3, :] = -40.0
    pe[2, 3, 5] = 0.0  # chain 2 on the per-event n_eff wall
    return torch.tensor(pe), torch.tensor(inj)


@pytest.mark.parametrize(
    "flags",
    [dict(min_neff_cut=True), dict(min_neff_cut=False, marginalize_selection=True), dict(min_neff_cut=False, max_variance_cut=True)],
    ids=["bench", "marginalize", "max_variance"],
)
def test_summaries_seam_gives_the_sites_of_the_weight_path(flags):
    pe, inj = _weights()
    kw = dict(total_inj=1e6, Nobs=4, Tobs=1.5, surveyed_hypervolume=torch.tensor([3e9, 5e9, 8e9]), log=True, **flags)
    rates = {"unscaled_rate": torch.tensor([60.0, 75.0, 90.0])}
    with ppl.trace() as want, ppl.substitute(data=rates):
        analysis.hierarchical_likelihood(pe, inj, **kw)
    logBFs, log_n_effs, _ = analysis.per_event_log_bayes_factors(pe, log=True)
    log_mu, log_n_eff_inj, _ = analysis.detection_efficiency(inj, 1e6, log=True)
    with ppl.trace() as got, ppl.substitute(data=rates):
        analysis.hierarchical_likelihood(
            None, None, pe_summaries=(logBFs, log_n_effs, pe.shape[-1]), inj_summaries=(log_mu, log_n_eff_inj), **kw
        )
    assert list(got.trace) == list(want.trace)
    for name, site in want.trace.items():
        g = got.trace[name]
        gv = g["value"] if g["type"] != "sample" else g["fn"].log_prob(g["value"])
        wv = site["value"] if site["type"] != "sample" else site["fn"].log_prob(site["value"])
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)


def test_summaries_seam_guards():
    pe, inj = _weights()
    summaries = dict(pe_summaries=(pe[..., 0], pe[..., 0], 200), inj_summaries=(inj[:, 0], inj[:, 0]))
    kw = dict(total_inj=1e6, Nobs=4, Tobs=1.5, surveyed_hypervolume=torch.ones(3))
    with pytest.raises(ValueError, match="categorical"), ppl.trace():
        analysis.hierarchical_likelihood(None, None, categorical=True, **summaries, **kw)
    with pytest.raises(ValueError, match="posterior_predictive_check"), ppl.trace():
        analysis.hierarchical_likelihood(None, None, posterior_predictive_check=True, **summaries, **kw)
    with pytest.raises(NotImplementedError), ppl.trace():
        analysis.hierarchical_likelihood(pe, inj, categorical=True, **kw)


def test_bank_columns_are_cached_per_dtype_and_checked():
    banks, valid, zmax = chip_smoke.k2_edge_case(seed=0, rows=3, n_samples=40)
    bank = streamed.StreamedBank(banks, MMIN, MMAX, zmax, valid=valid)
    c64, f64 = bank.columns(torch.float64, "cpu")
    c32, f32 = bank.columns(torch.float32, "cpu")
    assert c64.dtype == torch.float64 and c32.dtype == torch.float32 and torch.equal(f64, f32)
    assert bank.columns(torch.float64, "cpu")[0] is c64
    l32 = bank(chip_smoke.k2_edge_theta(2, dtype=torch.float32))
    assert all(v.dtype == torch.float32 and v.shape == (2, 3) for v in l32)
    with pytest.raises(ValueError, match="one 2-D shape"):
        streamed.StreamedBank(dict(banks, a_1=banks["a_1"][:, :10]), MMIN, MMAX, zmax)
    with pytest.raises(ValueError, match="misses"):
        streamed.StreamedBank({k: v for k, v in banks.items() if k != "log1pz"}, MMIN, MMAX, zmax)
