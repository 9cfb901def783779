"""The port's SMC against the JAX package's: systematic resampling with the
uniform handed over (exact indices) and the ESS (rtol 1e-12), float64; the
JAX package's SMC tests mirrored at their own limits (Gaussian moments and
correlation, the bimodal double well); and the edge cases: the bisection's
landing point, a covariance that is not positive definite (rejected
proposals, as JAX's NaN factor gives, not an exception), and a particle of
infinite potential (``-inf`` weight, never NaN)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.infer import smc as jsmc
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import SMC
from gwinferno_tpu_torch.infer import smc as tsmc
from gwinferno_tpu_torch.ppl import distributions as td

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resample_and_ess_match_jax(seed):
    rng = np.random.default_rng(seed)
    lw = rng.normal(0.0, 3.0, 500)
    lw[rng.uniform(size=500) < 0.1] = -np.inf
    key = jax.random.PRNGKey(seed)
    u = float(jax.random.uniform(key, dtype=jnp.float64))
    want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(lw)))
    got = tsmc._systematic_resample(torch.tensor(u, dtype=torch.float64), torch.tensor(lw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(lw[got]))
    np.testing.assert_allclose(float(tsmc._ess(torch.tensor(lw))), float(jsmc._ess(jnp.asarray(lw))), rtol=1e-12)


def correlated_gaussian_model():
    x = ppl.sample("x", td.Normal(0.0, 1.0))
    y = ppl.sample("y", td.Normal(0.0, 1.0))
    # y | x ~ N(0.9 x, sqrt(0.19)): the Normal(0, 1) prior of y is cancelled
    ppl.factor("y_given_x", -0.5 * (y - 0.9 * x) ** 2 / 0.19 - 0.5 * math.log(0.19) + 0.5 * y**2)


def test_smc_gaussian_moments():
    res = SMC(correlated_gaussian_model, num_particles=2000, num_mutation_steps=5, **F64).run(0)
    x, y = res.particles["x"].numpy(), res.particles["y"].numpy()
    assert x.shape == y.shape == (2000,)
    assert abs(x.mean()) < 0.15
    assert abs(x.std() - 1.0) < 0.15
    assert abs(np.corrcoef(x, y)[0, 1] - 0.9) < 0.1
    assert int(res.num_stages) >= 1
    assert np.isfinite(float(res.log_evidence))
    # the model is normalized (Z = 1); the base's potential, as in the JAX
    # package, leaves out (2 pi)^(dim / 2), so the estimate is log Z - log(2 pi)
    assert abs(float(res.log_evidence) + math.log(2 * math.pi)) < 0.2
    assert torch.equal(res.log_weights, torch.zeros(2000, dtype=torch.float64))
    assert 0.0 < float(res.final_acceptance) <= 1.0


def test_smc_multimodal_double_well():
    def bimodal():
        x = ppl.sample("x", td.Normal(0.0, 3.0))
        # double-well likelihood: modes near +/-2
        ppl.factor("wells", -((x**2 - 4.0) ** 2) / 4.0)

    res = SMC(bimodal, num_particles=3000, num_mutation_steps=5, **F64).run(2)
    x = res.particles["x"].numpy()
    frac_pos = float((x > 0).mean())
    assert 0.25 < frac_pos < 0.75, f"mode collapse: {frac_pos}"
    assert abs(abs(x).mean() - 2.0) < 0.3
    assert np.isfinite(float(res.log_evidence))


def test_bisection_lands_on_the_ess_target():
    """The chosen beta keeps ESS >= target and the end of its 1e-5 bracket
    does not; a full step that keeps the target is taken whole."""
    rng = np.random.default_rng(3)
    pe_post = torch.tensor(rng.normal(50.0, 20.0, 1000))
    pe_base = torch.tensor(rng.normal(5.0, 1.0, 1000))
    target = 500.0
    for beta_old in (0.0, 0.2, 0.7):
        beta = tsmc._choose_beta(beta_old, pe_post, pe_base, target)
        assert beta_old < beta < 1.0

        def ess(b):
            return float(tsmc._ess(tsmc._incremental_logw(b, beta_old, pe_post, pe_base)))

        assert ess(beta) >= target > ess(beta + 1e-5)
    flat = torch.zeros(1000, dtype=torch.float64)
    assert tsmc._choose_beta(0.3, flat, flat, target) == 1.0


def test_cholesky_of_a_matrix_that_is_not_positive_definite_is_nan_as_in_jax():
    bad = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    np.testing.assert_array_equal(tsmc._cholesky_or_nan(torch.tensor(bad)).numpy(), want)
    assert np.all(np.isnan(want[np.tril_indices(3)])) and np.all(want[np.triu_indices(3, 1)] == 0.0)
    good = np.array([[2.0, 0.3], [0.3, 1.0]])
    np.testing.assert_allclose(tsmc._cholesky_or_nan(torch.tensor(good)).numpy(), np.linalg.cholesky(good), rtol=1e-14)


def test_mutation_with_a_covariance_that_is_not_positive_definite_rejects(monkeypatch):
    """A particle covariance whose Cholesky factor fails gives NaN proposals,
    which are all rejected; the run goes on with its particles unchanged."""
    monkeypatch.setattr(tsmc, "_particle_cov", lambda z: -torch.eye(z.shape[1], dtype=z.dtype))
    z = torch.tensor(np.random.default_rng(4).normal(size=(200, 2)))

    def post(v):
        return 0.5 * (v**2).sum(-1)

    def base(v):
        return 0.125 * (v**2).sum(-1)

    gen = torch.Generator().manual_seed(0)
    z1, p1, b1, acc = tsmc._mutate(z, post(z), base(z), 0.5, 0.5, 3, post, base, gen)
    assert torch.equal(z1, z) and torch.equal(p1, post(z)) and torch.equal(b1, base(z))
    assert float(acc) == 0.0
    res = SMC(correlated_gaussian_model, num_particles=300, max_stages=3, **F64).run(0)
    assert float(res.final_acceptance) == 0.0 and res.num_stages >= 1
    assert all(bool(torch.isfinite(v).all()) for v in res.particles.values())


def test_infinite_potential_gets_minus_inf_weight_never_nan():
    logw = tsmc._incremental_logw(0.3, 0.1, torch.tensor([torch.inf, 2.0], dtype=torch.float64),
                                  torch.tensor([1.0, 1.0], dtype=torch.float64))
    assert logw[0] == -torch.inf and torch.isfinite(logw[1])

    def walled():
        x = ppl.sample("x", td.Normal(0.0, 1.0))
        # a wall: zero density (infinite potential) above x = 1
        ppl.factor("wall", torch.where(x > 1.0, -torch.inf, 0.0))

    res = SMC(walled, num_particles=1000, **F64).run(1)
    x = res.particles["x"]
    assert bool(torch.isfinite(x).all()) and bool((x <= 1.0).all())
    assert math.isfinite(float(res.log_evidence))
    # Z = P(N(0,1) <= 1), less log(2 pi) / 2 for the base's normalization
    assert abs(float(res.log_evidence) - math.log(0.8413447) + 0.5 * math.log(2 * math.pi)) < 0.1


def test_mesh_is_refused():
    """A mesh that is not a ``parallel.Mesh`` is refused (the sharded runs
    are in ``tests/test_torch_parallel.py``)."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        SMC(correlated_gaussian_model, mesh=object(), **F64)


def test_smc_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SMC(correlated_gaussian_model)
