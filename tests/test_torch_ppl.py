"""The port's PPL against the JAX package's: transforms, distributions,
handlers and the potential energy, in float64 (rtol 1e-12 for elementwise
terms, 1e-10 for the potential and its gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.ppl import distributions as jd
from gwinferno_tpu.ppl.constraints import biject_to as jbiject_to
from gwinferno_tpu.ppl.constraints import interval as jinterval
from gwinferno_tpu.ppl.constraints import positive as jpositive
from gwinferno_tpu.ppl.constraints import real as jreal
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.ppl import distributions as td
from gwinferno_tpu_torch.ppl.constraints import biject_to, interval, positive, real

X = np.linspace(-4.0, 4.0, 17)


@pytest.mark.parametrize(
    "pair",
    [(real, jreal), (positive, jpositive), (interval(0.005, 0.25), jinterval(0.005, 0.25)), (interval(5.0, 100.0), jinterval(5.0, 100.0))],
    ids=["real", "positive", "interval_small", "interval_mass"],
)
def test_transforms(pair):
    t, jt = biject_to(pair[0]), jbiject_to(pair[1])
    x = torch.tensor(X)
    y = t(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jt(jnp.asarray(X))), rtol=1e-12)
    np.testing.assert_allclose(t.inv(y).numpy(), np.asarray(jt.inv(jt(jnp.asarray(X)))), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        t.log_abs_det_jacobian(x, y).numpy(), np.asarray(jt.log_abs_det_jacobian(jnp.asarray(X), jt(jnp.asarray(X)))), rtol=1e-12
    )


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.Normal(0.3, 5.0),
        lambda m: m.HalfNormal(10.0),
        lambda m: m.Uniform(0.005, 0.25),
        lambda m: m.Uniform(5.0, 100.0),
        lambda m: m.Gamma(69.0),
        lambda m: m.Gamma(3.0, 2.5),
    ],
    ids=["normal", "halfnormal", "uniform_small", "uniform_mass", "gamma_rate", "gamma"],
)
def test_distribution_log_prob(make):
    v = np.concatenate([X, [0.1, 0.2, 50.0, 69.0, 120.0]])
    got, want = make(td).log_prob(torch.tensor(v)), make(jd).log_prob(jnp.asarray(v))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin], rtol=1e-12)


def test_distribution_arguments_are_validated_and_sampled():
    with pytest.raises(ValueError, match="high > low"):
        td.Uniform(1.0, 0.0)
    with pytest.raises(ValueError, match="positive"):
        td.Normal(0.0, -1.0)
    g = torch.Generator().manual_seed(0)
    torch.set_default_dtype(torch.float64)
    try:
        draws = {name: d.sample(g, (4000,)) for name, d in
                 {"n": td.Normal(1.0, 2.0), "h": td.HalfNormal(3.0), "u": td.Uniform(2.0, 5.0), "g": td.Gamma(4.0, 2.0)}.items()}
    finally:
        torch.set_default_dtype(torch.float32)
    assert abs(float(draws["n"].mean()) - 1.0) < 0.15 and abs(float(draws["n"].std()) - 2.0) < 0.15
    assert float(draws["h"].min()) >= 0.0 and abs(float(draws["h"].mean()) - 3.0 * np.sqrt(2 / np.pi)) < 0.15
    assert 2.0 <= float(draws["u"].min()) and float(draws["u"].max()) <= 5.0
    assert abs(float(draws["g"].mean()) - 2.0) < 0.1


def _model(m, dist, data):
    mu = m.sample("mu", dist.Normal(0.0, 10.0))
    sigma = m.sample("sigma", dist.HalfNormal(5.0))
    frac = m.sample("frac", dist.Uniform(0.1, 0.9))
    m.deterministic("twice_mu", 2.0 * mu)
    return mu, sigma, frac


def _torch_model(data):
    mu, sigma, frac = _model(ppl, td, data)
    d = torch.as_tensor(data)
    ll = (-0.5 * ((d - mu[:, None]) / sigma[:, None]) ** 2 - torch.log(sigma[:, None])).sum(-1) + torch.log(frac) * 3
    ppl.factor("lik", ll)


def _jax_model(data):
    mu, sigma, frac = _model(jppl, jd, data)
    ll = jnp.sum(-0.5 * ((data - mu) / sigma) ** 2 - jnp.log(sigma)) + jnp.log(frac) * 3
    jppl.factor("lik", ll)


def test_potential_energy_and_log_density_match_jax():
    data = np.random.default_rng(0).normal(1.0, 2.0, 30)
    u = {"mu": np.array([0.3, -1.0, 2.0]), "sigma": np.array([0.2, -0.5, 1.1]), "frac": np.array([0.0, 1.5, -2.0])}
    pot = ppl.ModelPotential(_torch_model, (data,), device="cpu", dtype=torch.float64)
    assert pot.names == ["frac", "mu", "sigma"] and pot.dim == 3
    z = pot.ravel({k: torch.tensor(v) for k, v in u.items()})
    got, grad = pot.value_and_grad(z)
    for c in range(3):
        uc = {k: jnp.asarray(v[c]) for k, v in u.items()}
        want, jgrad = jax.value_and_grad(lambda p: jppl.potential_energy(_jax_model, (data,), {}, p))(uc)
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-10)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(jax.flatten_util.ravel_pytree(jgrad)[0]), rtol=1e-10)
        cons = {k: v[c] for k, v in pot.constrain(z).items()}
        jcons = jppl.constrain_fn(_jax_model, (data,), {}, uc)
        for k in cons:
            np.testing.assert_allclose(float(cons[k]), float(jcons[k]), rtol=1e-12)
        ld, _ = ppl.log_density(_torch_model, (data,), {}, {k: v[c : c + 1] for k, v in pot.constrain(z).items()})
        jld, _ = jppl.log_density(_jax_model, (data,), {}, jcons)
        np.testing.assert_allclose(float(ld[0]), float(jld), rtol=1e-10)
    # unconstrain_fn / constrain_fn / ModelPotential.unconstrain round trip
    back = ppl.unconstrain_fn(_torch_model, (data,), {}, pot.constrain(z))
    torch.testing.assert_close(pot.ravel(back), z)
    torch.testing.assert_close(pot.unconstrain(pot.constrain(z), 3), z)
    torch.testing.assert_close(pot.ravel(ppl.constrain_fn(_torch_model, (data,), {}, pot.unravel(z))), pot.ravel(pot.constrain(z)))


def test_handlers_trace_seed_condition_block():
    def model():
        mu = ppl.sample("mu", td.Normal(0.0, 10.0))
        sigma = ppl.sample("sigma", td.HalfNormal(5.0))
        ppl.deterministic("twice_mu", 2.0 * mu)
        ppl.sample("frac", td.Uniform(0.1, 0.9))
        ppl.factor("lik", -0.5 * (mu / sigma) ** 2)

    g = torch.Generator().manual_seed(3)
    with ppl.trace() as tr, ppl.seed(rng_seed=g), ppl.substitute(data={"mu": torch.zeros(())}):
        model()
    assert list(tr.trace) == ["mu", "sigma", "twice_mu", "frac", "lik"]
    assert float(tr.trace["mu"]["value"]) == 0.0 and float(tr.trace["sigma"]["value"]) > 0.0
    assert 0.1 <= float(tr.trace["frac"]["value"]) <= 0.9
    with pytest.raises(ValueError, match="has no value"):
        with ppl.trace():
            model()
    with ppl.trace() as tr2, ppl.seed(rng_seed=0), ppl.condition(data={"frac": torch.tensor(0.5)}):
        model()
    assert tr2.trace["frac"]["is_observed"] and float(tr2.trace["frac"]["value"]) == 0.5
    # block hides "mu" from the outer substitute, so the seed draws it
    with ppl.trace() as tr3, ppl.substitute(data={"mu": torch.tensor(5.0), "sigma": torch.tensor(2.0)}), ppl.block(hide=["mu"]), ppl.seed(rng_seed=0):
        model()
    assert float(tr3.trace["mu"]["value"]) != 5.0 and float(tr3.trace["sigma"]["value"]) == 2.0
    with pytest.raises(ValueError, match="duplicate site"):
        with ppl.trace(), ppl.seed(rng_seed=0):
            model()
            model()
    with ppl.plate("n", 5) as idx, ppl.trace() as tr4, ppl.seed(rng_seed=1):
        ppl.sample("x", td.Normal(0.0, 1.0))
    assert idx.tolist() == list(range(5)) and tr4.trace["x"]["value"].shape == (5,)
