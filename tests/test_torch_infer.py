"""The port's sampler against the JAX package's: the integrator, the NUTS
state machine and the adaptation arithmetic step for step on the same
inputs (float64, rtol 1e-10), the diagnostics on the same arrays (rtol
1e-12), and NUTS itself statistically on a correlated Gaussian."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.infer import diagnostics as jdiag
from gwinferno_tpu.infer import hmc_util as jhu
from gwinferno_tpu.infer import nuts as jnuts
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import mcmc_state_from_jax
from gwinferno_tpu_torch.infer import MCMC, NUTS
from gwinferno_tpu_torch.infer import diagnostics as tdiag
from gwinferno_tpu_torch.infer import hmc_util as thu
from gwinferno_tpu_torch.infer import nuts as tnuts
from gwinferno_tpu_torch.ppl import distributions as td

RTOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a correlated 3-d Gaussian potential: U(z) = z^T P z / 2
COV = np.array([[1.0, 0.8, 0.1], [0.8, 1.0, -0.3], [0.1, -0.3, 2.0]])
PREC = np.linalg.inv(COV)


def jpot(z):
    return 0.5 * z @ jnp.asarray(PREC) @ z


def tpot(z):
    return 0.5 * torch.einsum("ci,ij,cj->c", z, torch.tensor(PREC), z)


def _inverse_masses(C, dense, seed=0):
    rng = np.random.default_rng(seed)
    if not dense:
        return rng.uniform(0.5, 2.0, (C, 3))
    a = rng.normal(size=(C, 3, 3))
    return a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3)


@pytest.mark.parametrize("dense", [False, True])
def test_mass_matrix_and_leapfrog(dense):
    C = 4
    rng = np.random.default_rng(1)
    inv = _inverse_masses(C, dense)
    mm, _ = mcmc_state_from_jax(np.ones(C), inv, device="cpu", dtype=torch.float64)
    z, r = rng.normal(size=(C, 3)), rng.normal(size=(C, 3))
    eps = np.array([0.1, -0.2, 0.3, 0.05])
    pe, grad = thu.value_and_grad(tpot, torch.tensor(z))
    out = thu.leapfrog(tpot)(torch.tensor(z), torch.tensor(r), grad, torch.tensor(eps), mm)
    for c in range(C):
        jmm = jhu.mass_matrix_from_inverse(jnp.asarray(inv[c]))
        np.testing.assert_allclose(mm.mass_chol[c].numpy(), np.asarray(jmm.mass_chol), rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose(float(thu.kinetic_energy(mm, torch.tensor(r))[c]), float(jhu.kinetic_energy(jmm, jnp.asarray(r[c]))), rtol=RTOL)
        jpe, jgrad = jax.value_and_grad(jpot)(jnp.asarray(z[c]))
        want = jhu.leapfrog(jpot)(jnp.asarray(z[c]), jnp.asarray(r[c]), jgrad, eps[c], jmm)
        for g, w in zip(out, want):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w), rtol=RTOL, atol=1e-13)


def _jax_carry(carry, c):
    return jnuts.TreeCarry(
        i=jnp.asarray(int(carry.i[c]), jnp.int32), turning=jnp.asarray(bool(carry.turning[c])),
        diverging=jnp.asarray(bool(carry.diverging[c])), vecs=jnp.asarray(carry.vecs[c].numpy()),
        scal=jnp.asarray(carry.scal[c].numpy()), ckpts=jnp.asarray(carry.ckpts[c].numpy()),
        const_f=jnp.asarray(carry.const_f[c].numpy()), h0=jnp.asarray(float(carry.h0[c])),
        step_size=jnp.asarray(float(carry.step_size[c])),
    )


def _step_to_the_end(carry, mm, jcarries, jmms, md):
    """Masked tree steps of every lane (as ``nuts_transition`` takes them)
    against the JAX state machine chain by chain, to the end; returns the
    port's final carry."""
    for _ in range((1 << md) - 1):
        active = tnuts.tree_active(carry, md)
        if not bool(active.any()):
            break
        carry = tnuts.select_lanes(active, tnuts.tree_step(tpot, mm, carry, md), carry)
        for c in active.nonzero().squeeze(1).tolist():
            jcarries[c] = jnuts.tree_step(jpot, jmms[c], jcarries[c], md)
            for name in ("i", "turning", "diverging", "vecs", "scal", "ckpts"):
                got, want = getattr(carry, name)[c].numpy(), np.asarray(getattr(jcarries[c], name))
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12, err_msg=f"{name} chain {c}")
    fin = tnuts.tree_finish(carry, md)
    for c in range(carry.i.shape[0]):
        jf = jnuts.tree_finish(jcarries[c], md)
        for name in fin._fields:
            np.testing.assert_allclose(getattr(fin, name)[c].numpy(), np.asarray(getattr(jf, name)), rtol=RTOL, atol=1e-12, err_msg=name)
    assert len(set(fin.num_steps.tolist())) > 1, "the chains should stop at different depths"
    return carry


STEP_SIZES = [0.05, 0.3, 0.9, 1.6, 3.0, 6.0]


@pytest.mark.parametrize("dense", [False, True])
def test_nuts_tree_steps_match_jax(dense):
    """From one tree_start (its momenta and pre-drawn uniforms handed to both
    sides), every tree_step and the tree_finish agree with the JAX state
    machine, chain by chain, including chains that stop early."""
    C, md = 6, 6
    inv = _inverse_masses(C, dense, seed=2)
    mm, _ = mcmc_state_from_jax(np.ones(C), inv, device="cpu", dtype=torch.float64)
    z0 = torch.tensor(np.random.default_rng(3).normal(size=(C, 3)))
    state = tnuts.nuts_init(tpot, z0)
    carry = tnuts.tree_start(state, mm, torch.tensor(STEP_SIZES, dtype=torch.float64), torch.Generator().manual_seed(4), md)
    jcarries = [_jax_carry(carry, c) for c in range(C)]
    jmms = [jhu.mass_matrix_from_inverse(jnp.asarray(inv[c])) for c in range(C)]
    _step_to_the_end(carry, mm, jcarries, jmms, md)


@pytest.mark.parametrize("dense", [False, True])
def test_nuts_start_from_jax_draws(dense):
    """Each chain's draws made as the JAX ``tree_start`` makes them (its key
    split: unit normals, then the direction, multinomial and merge
    uniforms), handed to the port's ``tree_start_from``: the packed start
    agrees with the JAX one, and so does every step to the end."""
    C, md = 6, 6
    total = (1 << md) - 1
    inv = _inverse_masses(C, dense, seed=5)
    mm, _ = mcmc_state_from_jax(np.ones(C), inv, device="cpu", dtype=torch.float64)
    z0 = np.random.default_rng(6).normal(size=(C, 3))
    state = tnuts.nuts_init(tpot, torch.tensor(z0))
    jmms = [jhu.mass_matrix_from_inverse(jnp.asarray(inv[c])) for c in range(C)]
    draws, jcarries = [], []
    for c in range(C):
        key = jax.random.PRNGKey(20 + c)
        k_mom, k_dirs, k_mult, k_merge = jax.random.split(key, 4)
        f64 = jnp.float64
        draws.append([np.asarray(jax.random.normal(k_mom, (3,), f64)), np.asarray(jax.random.uniform(k_dirs, (md + 1,), f64)),
                      np.asarray(jax.random.uniform(k_mult, (total,), f64)), np.asarray(jax.random.uniform(k_merge, (md,), f64))])
        jstate = jnuts.nuts_init(jpot, jnp.asarray(z0[c]))
        jcarries.append(jnuts.tree_start(jstate, jmms[c], STEP_SIZES[c], key, md))
    tdraws = tnuts.TreeDraws(*(torch.tensor(np.stack(f)) for f in zip(*draws)))
    carry = tnuts.tree_start_from(state, mm, torch.tensor(STEP_SIZES, dtype=torch.float64), tdraws)
    for c in range(C):
        for name in ("vecs", "scal", "ckpts", "const_f", "h0", "step_size"):
            got, want = getattr(carry, name)[c].numpy(), np.asarray(getattr(jcarries[c], name))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12, err_msg=f"{name} chain {c}")
    _step_to_the_end(carry, mm, jcarries, jmms, md)


def test_tree_start_is_its_draws_then_its_start():
    """``tree_start`` is ``tree_draws`` then ``tree_start_from``, bit for
    bit, and ``tree_draws`` takes ``randn(C, dim)``, ``rand(C, md + 1)``,
    ``rand(C, total)`` and ``rand(C, md)`` from the generator in that
    order."""
    C, md = 5, 4
    mm = thu.identity_mass_matrix(C, 3, dense=True, dtype=torch.float64)
    state = tnuts.nuts_init(tpot, torch.tensor(np.random.default_rng(9).normal(size=(C, 3))))
    ss = torch.full((C,), 0.4, dtype=torch.float64)
    g1, g2, g3 = (torch.Generator().manual_seed(11) for _ in range(3))
    a = tnuts.tree_start(state, mm, ss, g1, md)
    d = tnuts.tree_draws(C, 3, md, torch.float64, "cpu", g2)
    b = tnuts.tree_start_from(state, mm, ss, d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    raw = [torch.randn((C, 3), generator=g3, dtype=torch.float64)] + [
        torch.rand((C, n), generator=g3, dtype=torch.float64) for n in (md + 1, (1 << md) - 1, md)]
    assert all(torch.equal(x, y) for x, y in zip(d, raw))
    assert torch.equal(g1.get_state(), g3.get_state())


@pytest.mark.parametrize("dense", [False, True])
def test_welford_and_dual_averaging(dense):
    C, n = 3, 40
    x = np.random.default_rng(5).normal(size=(n, C, 3)) * np.array([1.0, 2.0, 0.5])
    wf = thu.welford_init(C, 3, dense, torch.float64)
    jwf = [jhu.welford_init(3, dense, jnp.float64) for _ in range(C)]
    for t in range(n):
        wf = thu.welford_update(wf, torch.tensor(x[t]))
        jwf = [jhu.welford_update(jwf[c], jnp.asarray(x[t, c])) for c in range(C)]
    cov = thu.welford_covariance(wf)
    for c in range(C):
        np.testing.assert_allclose(cov[c].numpy(), np.asarray(jhu.welford_covariance(jwf[c])), rtol=RTOL)
    stacked = jhu.WelfordState(*(jnp.stack([getattr(w, f) for w in jwf]) for f in jhu.WelfordState._fields))
    pooled, jpooled = thu.welford_pool(wf), jhu.welford_pool(stacked)
    for f in thu.WelfordState._fields:
        np.testing.assert_allclose(getattr(pooled, f)[0].numpy(), np.asarray(getattr(jpooled, f)), rtol=RTOL)

    da = thu.da_init(torch.tensor([0.1, 1.0, 3.0], dtype=torch.float64))
    jda = [jhu.da_init(jnp.asarray(s)) for s in (0.1, 1.0, 3.0)]
    acc = np.random.default_rng(6).uniform(size=(25, C))
    for t in range(25):
        da = thu.da_update(da, torch.tensor(acc[t]), target=0.8)
        jda = [jhu.da_update(jda[c], jnp.asarray(acc[t, c]), target=0.8) for c in range(C)]
    for c in range(C):
        for f in thu.DAState._fields:
            np.testing.assert_allclose(float(getattr(da, f)[c]), float(getattr(jda[c], f)), rtol=RTOL)


@pytest.mark.parametrize("num_warmup", [0, 1, 10, 30, 149, 150, 300, 1000])
def test_warmup_schedule(num_warmup):
    for adapt in (True, False):
        for got, want in zip(thu.build_warmup_schedule(num_warmup, adapt), jhu.build_warmup_schedule(num_warmup, adapt)):
            np.testing.assert_array_equal(got, want)


def test_find_reasonable_step_size_brackets_the_target():
    C = 5
    mm = thu.identity_mass_matrix(C, 3, dense=True, dtype=torch.float64)
    z = torch.tensor(np.random.default_rng(7).normal(size=(C, 3)))
    ss = thu.find_reasonable_step_size(tpot, mm, z, torch.Generator().manual_seed(0))
    assert ss.shape == (C,) and torch.all(ss > 0.05) and torch.all(ss < 20.0)


def test_diagnostics_match_jax():
    rng = np.random.default_rng(8)
    ar = np.cumsum(rng.normal(size=(4, 500)), axis=1) * 0.05 + rng.normal(size=(4, 500))
    for x in (ar, rng.normal(size=(4, 300)), rng.normal(size=(1, 50)), np.ones((3, 20)), rng.normal(size=(2, 3))):
        np.testing.assert_allclose(tdiag.effective_sample_size(torch.tensor(x)), jdiag.effective_sample_size(x), rtol=1e-12)
        np.testing.assert_allclose(tdiag.split_rhat(x), jdiag.split_rhat(x), rtol=1e-12)


def _gaussian_model():
    x = ppl.sample("x", td.Normal(0.0, 1.0))
    y = ppl.sample("y", td.Normal(0.0, 1.0))
    # p(x, y) with corr 0.9, sd 1 and 2: the two Normal(0, 1) priors are cancelled
    rho, sy = 0.9, 2.0
    q = (x**2 - 2 * rho * x * y / sy + (y / sy) ** 2) / (1 - rho**2)
    ppl.factor("gauss", -0.5 * q + 0.5 * (x**2 + y**2))


def test_nuts_correlated_gaussian_moments():
    mcmc = MCMC(NUTS(_gaussian_model, dense_mass=True), num_warmup=200, num_samples=400, num_chains=4,
                device="cpu", dtype=torch.float64)
    mcmc.run(11)
    s = mcmc.get_samples()
    x, y = s["x"].numpy(), s["y"].numpy()
    assert x.shape == (1600,)
    # tolerances: ~5 MC standard errors at an ESS of several hundred
    assert abs(x.mean()) < 0.2 and abs(y.mean()) < 0.4
    assert abs(x.var() - 1.0) < 0.25 and abs(y.var() - 4.0) < 1.0
    assert abs(np.corrcoef(x, y)[0, 1] - 0.9) < 0.05
    extra = mcmc.get_extra_fields(group_by_chain=True)
    assert extra["diverging"].shape == (4, 400) and int(extra["diverging"].sum()) == 0
    assert float(extra["accept_prob"].mean()) > 0.6
    by_chain = mcmc.get_samples(group_by_chain=True)
    assert by_chain["x"].shape == (4, 400) and tdiag.split_rhat(by_chain["x"]) < 1.05


def test_short_mcmc_on_the_bench_model_is_finite():
    import chip_smoke
    from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
    from gwinferno_tpu_torch.pipeline.bench_model import BenchModel, jittered_init

    pe, inj, const = chip_smoke.make_catalog(0, n_events=8, n_samples=500, n_found=4000)
    f64 = dict(device="cpu", dtype=torch.float64)
    model = BenchModel(pe, inj, const, PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **f64), **f64)
    init = jittered_init(2, torch.Generator().manual_seed(0), dtype=torch.float64)
    mcmc = MCMC(NUTS(model, dense_mass=True, max_tree_depth=4), num_warmup=6, num_samples=4, num_chains=2, **f64)
    mcmc.run(0, init_params=init)
    s = mcmc.get_samples(group_by_chain=True)
    assert len(s) == 15 and all(v.shape == (2, 4) and torch.isfinite(v).all() for v in s.values())
    assert set(mcmc.timings) == {"init", "warmup", "sample"}
