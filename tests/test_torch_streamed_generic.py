"""The port's generic streamed op (``ops/streamed.py::make_streamed_double_logsumexp``)
on the CPU (K1's plain version reduces each block), against the JAX op of
that name and against the direct computation, and on the bench chain
against K2's op (``StreamedBank``, its plain version here) and the flat
route.

Tolerances:
- against the JAX op, which computes in float32 (Pallas interpret mode,
  ``gwinferno_tpu/ops/streamed.py:125``): values and gradients rtol 1e-5;
- against the direct float64 computation (torch autograd of the flat
  logsumexps): values rtol 1e-12, gradients rtol 1e-10;
- the bench chain against K2's op and the flat route, float64: pairs rtol
  1e-12, gradients rtol 1e-10 / atol 1e-12 of the largest component of the
  gradient (a component that is zero in exact arithmetic, as
  ``d/dz_lognorm`` of the PE pair's weighted sum nearly is, keeps only
  roundoff), potential rtol 1e-10, gradient
  rtol 1e-8 / atol 1e-9 (sums over ~10^4 terms in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.ops import streamed as jstreamed
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.ops import streamed
from gwinferno_tpu_torch.ops.streamed import make_streamed_double_logsumexp
from gwinferno_tpu_torch.ops.streamed import reshape_bank_rows
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT
from gwinferno_tpu_torch.pipeline.bench_model import INIT_JITTER
from gwinferno_tpu_torch.pipeline.bench_model import MMAX
from gwinferno_tpu_torch.pipeline.bench_model import MMIN
from gwinferno_tpu_torch.pipeline.bench_model import BenchModel
from gwinferno_tpu_torch.pipeline.bench_model import bench_banks
from gwinferno_tpu_torch.pipeline.bench_model import bench_log_weight
from gwinferno_tpu_torch.ppl import ModelPotential

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)


def _logw(b, th, lib):
    return th["a"] * b["x"] + lib.log(b["y"]) * th["b"] - lib.exp(th["a"] * 0.1) * b["y"]


@pytest.fixture(scope="module")
def problem():
    """``tests/ops/test_streamed.py``'s banks (5 x 300, float32 values,
    unaligned) as float64, the port's op over them (blocks of 2 rows) and
    the JAX op (blocks of 2 rows, interpret mode)."""
    rng = np.random.default_rng(0)
    E, S = 5, 300
    banks = {
        "x": rng.normal(size=(E, S)).astype(np.float32).astype(np.float64),
        "y": rng.uniform(0.1, 2.0, size=(E, S)).astype(np.float32).astype(np.float64),
    }
    op = make_streamed_double_logsumexp(lambda b, th: _logw(b, th, torch), banks, block_rows=2)
    jop = jstreamed.make_streamed_double_logsumexp(lambda b, th: _logw(b, th, jnp), banks, block_rows=2)
    return banks, op, jop


def _direct(banks, th):
    """Flat torch logsumexps over the whole banks, ``theta`` scalars or
    ``(C,)``."""
    t = {k: (v[:, None, None] if v.ndim == 1 else v) for k, v in th.items()}
    lw = _logw({k: torch.tensor(v) for k, v in banks.items()}, t, torch)
    return torch.logsumexp(lw, -1), torch.logsumexp(2 * lw, -1)


def _theta(a, b, grad=False):
    return {"a": torch.tensor(a, dtype=torch.float64, requires_grad=grad),
            "b": torch.tensor(b, dtype=torch.float64, requires_grad=grad)}


def test_forward_parity(problem):
    banks, op, jop = problem
    l1, l2 = op(_theta(0.7, -1.3))
    d1, d2 = _direct(banks, _theta(0.7, -1.3))
    np.testing.assert_allclose(l1.numpy(), d1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(l2.numpy(), d2.numpy(), rtol=1e-12)
    j1, j2 = jop({"a": jnp.float32(0.7), "b": jnp.float32(-1.3)})
    np.testing.assert_allclose(l1.numpy(), np.asarray(j1), rtol=1e-5)
    np.testing.assert_allclose(l2.numpy(), np.asarray(j2), rtol=1e-5)


def _loss(pair):
    a, b = pair
    return (torch.sin(a) + 0.3 * b).sum()


def test_gradient_parity(problem):
    banks, op, jop = problem
    th = _theta(0.7, -1.3, grad=True)
    got = torch.autograd.grad(_loss(op(th)), [th["a"], th["b"]])
    thd = _theta(0.7, -1.3, grad=True)
    want = torch.autograd.grad(_loss(_direct(banks, thd)), [thd["a"], thd["b"]])
    jg = jax.grad(lambda t: jnp.sum(jnp.sin(jop(t)[0]) + 0.3 * jop(t)[1]))({"a": jnp.float32(0.7), "b": jnp.float32(-1.3)})
    for name, g, w in zip("ab", got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-10, err_msg=name)
        np.testing.assert_allclose(float(g), float(jg[name]), rtol=1e-5, err_msg=name)


def test_chain_batched_call(problem):
    """A ``(C,)`` theta is one call over all chains, ``(C, rows)`` out; each
    chain equals the direct computation and the JAX op's vmapped
    (chain-batched kernel) call, values and gradients."""
    banks, op, jop = problem
    a, b = np.linspace(0.2, 0.9, 4), np.linspace(-2.0, -1.0, 4)
    th = _theta(a, b, grad=True)
    l1, l2 = op(th)
    assert tuple(l1.shape) == (4, 5) and tuple(l2.shape) == (4, 5)
    got = torch.autograd.grad(l1.sum(), [th["a"], th["b"]])
    thd = _theta(a, b, grad=True)
    d1, d2 = _direct(banks, thd)
    want = torch.autograd.grad(d1.sum(), [thd["a"], thd["b"]])
    np.testing.assert_allclose(l1.detach().numpy(), d1.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(l2.detach().numpy(), d2.detach().numpy(), rtol=1e-12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10)

    ja, jb = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    jl1, jl2 = jax.vmap(lambda ai, bi: jop({"a": ai, "b": bi}))(ja, jb)
    np.testing.assert_allclose(l1.detach().numpy(), np.asarray(jl1), rtol=1e-5)
    np.testing.assert_allclose(l2.detach().numpy(), np.asarray(jl2), rtol=1e-5)
    jg = jax.vmap(jax.grad(lambda ai, bi: jnp.sum(jop({"a": ai, "b": bi})[0]), argnums=(0, 1)))(ja, jb)
    for g, w in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_flat_bank_reshape(problem):
    """A flat bank reshaped into rows with ``reshape_bank_rows``: the
    padded lanes are masked by ``valid``, so the rows' pairs merge to the
    flat bank's, and their gradient is the flat bank's."""
    rng = np.random.default_rng(3)
    flat = {
        "x": rng.normal(size=(1000,)).astype(np.float32).astype(np.float64),
        "y": rng.uniform(0.1, 2.0, size=(1000,)).astype(np.float32).astype(np.float64),
    }
    rows, valid = reshape_bank_rows(flat, cols=256)
    op2 = make_streamed_double_logsumexp(lambda b, th: _logw(b, th, torch), rows, block_rows=2, valid=valid)
    th = _theta(0.4, -0.8, grad=True)
    f1, f2 = op2(th)
    got = torch.logsumexp(f1, 0), torch.logsumexp(f2, 0)
    (g,) = torch.autograd.grad(got[0] + got[1], [th["a"]])
    thd = _theta(0.4, -0.8, grad=True)
    lw = _logw({k: torch.tensor(v) for k, v in flat.items()}, thd, torch)
    want = torch.logsumexp(lw, 0), torch.logsumexp(2 * lw, 0)
    (gw,) = torch.autograd.grad(want[0] + want[1], [thd["a"]])
    for x, y in zip(got, want):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-12)
    np.testing.assert_allclose(float(g), float(gw), rtol=1e-10)
    jrows, jvalid = jstreamed.reshape_bank_rows(flat, cols=256)
    j1, _ = jstreamed.make_streamed_double_logsumexp(lambda b, t: _logw(b, t, jnp), jrows, block_rows=2,
                                                      valid=jvalid)({"a": jnp.float32(0.4), "b": jnp.float32(-0.8)})
    np.testing.assert_allclose(float(got[0]), float(jax.scipy.special.logsumexp(j1)), rtol=1e-5)


def test_interpret_flag_is_ignored(problem):
    banks, op, _ = problem
    op_i = make_streamed_double_logsumexp(lambda b, th: _logw(b, th, torch), banks, block_rows=2, interpret=True)
    for x, y in zip(op_i(_theta(0.7, -1.3)), op(_theta(0.7, -1.3))):
        assert torch.equal(x, y)


def _catalog_slice(n_events=12, n_samples=600, n_found=6000):
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    # read directly with h5py, never through the conftest fixtures that run the generator
    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:n_found]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=n_events)


@pytest.fixture(scope="module")
def bench_problem():
    """A slice of the committed catalog; the bench chain as a torch
    ``logw_fn`` through the generic op (PE rows in blocks of 8, the
    injections as rows of 1024 with their ``valid`` mask) and through K2's
    op over the same banks; jittered starts for 4 chains."""
    pe, inj, const = _catalog_slice()
    zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    pe_bank = bench_banks(pe, zm.dVdzs[1], zm.zmax)
    inj_rows, inj_valid = reshape_bank_rows(bench_banks(inj, zm.dVdzs[0], zm.zmax), cols=1024)
    generic = [make_streamed_double_logsumexp(bench_log_weight, pe_bank, block_rows=8),
               make_streamed_double_logsumexp(bench_log_weight, inj_rows, block_rows=8, valid=inj_valid)]
    k2 = [streamed.StreamedBank(pe_bank, MMIN, MMAX, zm.zmax),
          streamed.StreamedBank(inj_rows, MMIN, MMAX, zm.zmax, valid=inj_valid)]
    rng = np.random.default_rng(11)
    params = {k: v + INIT_JITTER[k] * rng.uniform(-1, 1, 4) for k, v in FIDUCIAL_INIT.items()}
    return pe, inj, const, zm, generic, k2, params


def _bench_theta(params, zm):
    """The bench chain's hyperparameters (``streamed.THETA``) of the
    constrained ``params``, float64, with gradients."""
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    th = {k: p[k] for k in ("alpha", "beta", "mu_peak", "sig_peak", "lambda_m", "lambda_ct1", "lambda_ct2",
                            "sig_ct1", "sig_ct2", "lamb")}
    for i in ("1", "2"):
        mu, var = p["mu_a" + i], p["var_a" + i]
        nu = mu * (1.0 - mu) / var - 1.0
        th["alpha_a" + i], th["beta_a" + i] = mu * nu, (1.0 - mu) * nu
    th["z_lognorm"] = torch.log(zm.normalization(th["lamb"]))
    assert sorted(th) == sorted(streamed.THETA)
    return {k: v.detach().requires_grad_(True) for k, v in th.items()}


def test_bench_chain_matches_k2(bench_problem):
    """The bench chain through the generic op equals K2's op (its plain
    version) on both banks: the pairs and their gradients to every
    hyperparameter."""
    *_, zm, generic, k2, params = bench_problem
    for bank, (g_op, k_op) in zip(("PE", "injections"), zip(generic, k2)):
        th_g, th_k = _bench_theta(params, zm), _bench_theta(params, zm)
        got, want = g_op(th_g), k_op(th_k)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-12, err_msg=bank)
        w = torch.linspace(0.5, 1.5, got[0].shape[-1], dtype=torch.float64)
        gg = torch.autograd.grad((w * got[0]).sum() - 0.5 * got[1].sum(), list(th_g.values()))
        gk = torch.autograd.grad((w * want[0]).sum() - 0.5 * want[1].sum(), list(th_k.values()))
        scale = max(float(b.abs().max()) for b in gk)
        for name, a, b in zip(th_g, gg, gk):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12 * scale, err_msg=f"{bank} d/d{name}")


def test_bench_model_streamed_matches_flat(bench_problem):
    """The bench model with its streamed ops replaced by the generic op's
    callables (``streamed_summaries`` takes either) evaluates the flat
    route's potential and gradient, and the K2 route's."""
    pe, inj, const, zm, generic, _, params = bench_problem
    out = {}
    for route in ("flat", "k2", "generic"):
        model = BenchModel(pe, inj, const, zm, streamed=route != "flat", **F64)
        if route == "generic":
            model.pe_op, model.inj_op = generic
        pot = ModelPotential(model, **F64)
        out[route] = pot.value_and_grad(params_from_jax(params, model, **F64))
    u_f, g_f = out["flat"]
    assert bool((u_f.abs() < 1e30).all()), "the slice must sit off the likelihood walls"
    for route in ("k2", "generic"):
        u, g = out[route]
        np.testing.assert_allclose(u.numpy(), u_f.numpy(), rtol=1e-10, err_msg=route)
        np.testing.assert_allclose(g.numpy(), g_f.numpy(), rtol=1e-8, atol=1e-9, err_msg=route)


def test_lse_vjp_is_the_gradient_of_the_pair():
    """``lse_vjp`` (its plain version on the CPU, the generic op's backward)
    against autograd of the two logsumexps, float64, rtol 1e-12: a chain
    axis, -inf entries (zero cotangent), a row that is all -inf (its
    ``l1``, ``l2`` -inf: zero, not NaN), a row whose ``l2`` is not finite
    (only the ``g1`` term, as the JAX ``core_bwd`` sanitises it)."""
    rng = np.random.default_rng(3)
    lw = torch.tensor(rng.normal(size=(3, 4, 50)) * 2.0)
    lw[:, 1, ::4] = -torch.inf
    lw[:, 0] = -torch.inf
    g1, g2 = torch.tensor(rng.uniform(size=(3, 4))), torch.tensor(rng.uniform(size=(3, 4)))
    x = lw.clone().requires_grad_(True)
    l1, l2 = torch.logsumexp(x, -1), torch.logsumexp(2 * x, -1)
    live = torch.isfinite(l1)
    (want,) = torch.autograd.grad((g1 * l1)[live].sum() + (g2 * l2)[live].sum(), x)
    got = streamed.lse_vjp(lw, g1, g2, l1.detach(), l2.detach())
    # torch's own backward is NaN on the all -inf row, even with a zero cotangent
    assert bool((got[:, 0] == 0).all()) and bool(torch.isnan(want[:, 0]).all())
    np.testing.assert_allclose(got[:, 1:].numpy(), want[:, 1:].numpy(), rtol=1e-12, atol=0.0)
    l2_bad = l2.detach().clone()
    l2_bad[:, 2] = torch.inf
    got = streamed.lse_vjp(lw, g1, g2, l1.detach(), l2_bad)
    only_g1 = g1[:, 2, None] * torch.exp(lw[:, 2] - l1.detach()[:, 2, None])
    np.testing.assert_allclose(got[:, 2].numpy(), only_g1.numpy(), rtol=1e-12, atol=0.0)
