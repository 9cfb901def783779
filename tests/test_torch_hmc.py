"""The port's HMC kernel against the JAX package's: the transition body from
the JAX engine's own draws, chain by chain (float64, rtol 1e-10), with
diagonal and dense mass and chains that take different numbers of
leapfrogs; and HMC under the MCMC engine on a standard normal (the JAX
test's limits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.infer import hmc as jhmc
from gwinferno_tpu.infer import hmc_util as jhu
from gwinferno_tpu.infer import nuts as jnuts
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import mcmc_state_from_jax
from gwinferno_tpu_torch.infer import HMC, MCMC
from gwinferno_tpu_torch.infer import hmc as thmc
from gwinferno_tpu_torch.infer import nuts as tnuts
from gwinferno_tpu_torch.ppl import distributions as td

RTOL = 1e-10
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
@pytest.mark.parametrize("trajectory_length", [1.0, 2.0 * np.pi])
def test_hmc_body_matches_jax_from_its_draws(dense, trajectory_length):
    """Each chain's momentum and accept uniform are drawn as
    ``hmc_transition`` draws them (its key split), handed to the port's
    body, and every output field agrees with the JAX transition's."""
    C = 6
    inv = _inverse_masses(C, dense, seed=1)
    mm, _ = mcmc_state_from_jax(np.ones(C), inv, device="cpu", dtype=torch.float64)
    z0 = np.random.default_rng(2).normal(size=(C, 3))
    step_size = np.array([0.07, 0.2, 0.45, 0.9, 1.6, 2.5])
    state = tnuts.nuts_init(tpot, torch.tensor(z0))

    r0, u, want = [], [], []
    for c in range(C):
        key = jax.random.PRNGKey(10 + c)
        jmm = jhu.mass_matrix_from_inverse(jnp.asarray(inv[c]))
        jstate = jnuts.nuts_init(jpot, jnp.asarray(z0[c]))
        key_mom, key_accept = jax.random.split(key)
        r0.append(np.asarray(jhu.sample_momentum(jmm, key_mom, jstate.z)))
        u.append(float(jax.random.uniform(key_accept, dtype=jnp.float64)))
        want.append(jhmc.hmc_transition(jpot, jstate, jmm, step_size[c], key, trajectory_length=trajectory_length))

    got = thmc.hmc_body(tpot, state, mm, torch.tensor(step_size), torch.tensor(np.stack(r0)),
                        torch.tensor(u), trajectory_length=trajectory_length)
    for c in range(C):
        for name in got._fields:
            np.testing.assert_allclose(getattr(got, name)[c].numpy(), np.asarray(getattr(want[c], name)),
                                       rtol=RTOL, atol=1e-12, err_msg=f"{name} chain {c}")
    assert len(set(got.num_steps.tolist())) > 2, "the chains should take different numbers of leapfrogs"
    assert bool((got.accept_prob > 0.5).any()) and bool((got.accept_prob < 1e-3).any()), "accepts and rejects"


def test_hmc_transition_draws_then_runs_the_body():
    """``hmc_transition`` is ``hmc_draws`` (momenta, then one uniform per
    chain) followed by ``hmc_body``; the leapfrog count is clipped to
    ``[1, max_num_steps]``."""
    C = 4
    mm, _ = mcmc_state_from_jax(np.ones(C), _inverse_masses(C, True), device="cpu", dtype=torch.float64)
    state = tnuts.nuts_init(tpot, torch.tensor(np.random.default_rng(3).normal(size=(C, 3))))
    ss = torch.tensor([0.1, 0.3, 1.0, 3.0], dtype=torch.float64)
    got = thmc.hmc_transition(tpot, state, mm, ss, torch.Generator().manual_seed(5), trajectory_length=1.0)
    r0, u = thmc.hmc_draws(state, mm, torch.Generator().manual_seed(5))
    want = thmc.hmc_body(tpot, state, mm, ss, r0, u, trajectory_length=1.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    steps = thmc.num_leapfrog_steps(1.0, torch.tensor([1e-20, 0.3, 2.0, 50.0], dtype=torch.float64))
    assert steps.tolist() == [1023, 4, 1, 1]


def _std_normal():
    ppl.sample("x", td.Normal(torch.zeros(3), torch.ones(3)))


def test_hmc_std_normal_moments():
    mcmc = MCMC(HMC(_std_normal, trajectory_length=1.5), num_warmup=300, num_samples=600, num_chains=2,
                device="cpu", dtype=torch.float64)
    mcmc.run(3)
    x = mcmc.get_samples()["x"].numpy()
    assert x.shape == (1200, 3)
    assert np.all(np.abs(x.mean(0)) < 0.2)
    assert np.all(np.abs(x.std(0) - 1.0) < 0.2)
    extra = mcmc.get_extra_fields()
    assert int(extra["tree_depth"].abs().sum()) == 0 and int(extra["num_steps"].min()) >= 1
