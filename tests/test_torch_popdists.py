"""The port's PPL additions and population distributions against the JAX
package's, in float64 on the CPU: transforms and constraints, the PPL
distributions (log_prob, cdf/icdf, gradients; samplers by moments), the
population distributions with chain-batched ``(C,)`` hyperparameters against
C JAX evaluations (rtol 1e-10), the batched interpolation, and a simplex
site through ``ModelPotential``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import population_distributions as jpop
from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.ppl import constraints as jcons
from gwinferno_tpu.ppl import distributions as jd
from gwinferno_tpu.ppl import transforms as jt
from gwinferno_tpu_torch import population_distributions as pop
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.ppl import constraints as cons
from gwinferno_tpu_torch.ppl import distributions as td
from gwinferno_tpu_torch.ppl import transforms as tt

RTOL = 1e-10
RNG = np.random.default_rng(7)
XV = RNG.normal(size=(4, 5))  # 4 vectors of 5 unconstrained coordinates


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=RTOL, atol=0.0):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# ----------------------------------------------------------------- transforms

TRANSFORMS = {
    "sigmoid": (lambda m: m.SigmoidTransform(), XV),
    "affine": (lambda m: m.AffineTransform(0.5, -2.0), XV),
    "ordered": (lambda m: m.OrderedTransform(), XV),
    "stick_breaking": (lambda m: m.StickBreakingTransform(), XV),
    "softplus": (lambda m: m.SoftplusTransform(), XV),
    "compose": (lambda m: m.ComposeTransform([m.AffineTransform(1.0, 0.5), m.SoftplusTransform()]), XV),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    make, x = TRANSFORMS[name]
    t, j = make(tt), make(jt)
    y, jy = t(torch.tensor(x)), j(jnp.asarray(x))
    _close(y, jy)
    _close(t.inv(y), j.inv(jy), rtol=1e-9)
    _close(t.log_abs_det_jacobian(torch.tensor(x), y), j.log_abs_det_jacobian(jnp.asarray(x), jy))
    assert t.unconstrained_shape((3, 6)) == tuple(j.unconstrained_shape((3, 6)))
    assert t.event_dims == j.event_dims


def test_stick_breaking_lands_on_the_simplex_and_its_jacobian_is_autograd_s():
    t = tt.StickBreakingTransform()
    x = torch.tensor(XV, requires_grad=True)
    y = t(x)
    torch.testing.assert_close(y.sum(-1), torch.ones(4, dtype=torch.float64))
    assert t.unconstrained_shape((4, 6)) == (4, 5)
    for i in range(4):
        jac = torch.autograd.functional.jacobian(lambda v: t(v)[:-1], x[i].detach())
        torch.testing.assert_close(t.log_abs_det_jacobian(x[i], y[i]), torch.linalg.slogdet(jac)[1])


@pytest.mark.parametrize("name", ["real", "real_vector", "positive", "unit_interval", "simplex", "ordered", "integer"])
def test_constraints_match_jax(name):
    c, j = getattr(cons, name), getattr(jcons, name)
    assert c.is_discrete == j.is_discrete and c.event_dims == j.event_dims
    assert type(cons.biject_to(c)).__name__ == type(jcons.biject_to(j)).__name__


# ----------------------------------------------------------------- PPL distributions

V1 = np.concatenate([np.linspace(-2.0, 3.0, 21), [0.0, 1.0, 1e-3, 0.999]])
SIMPLEX = np.abs(RNG.normal(size=(6, 3))) + 0.05
SIMPLEX /= SIMPLEX.sum(-1, keepdims=True)

DISTS = {
    "lognormal": (lambda m: m.LogNormal(0.3, 0.7), V1),
    "exponential": (lambda m: m.Exponential(1.7), V1),
    "beta": (lambda m: m.Beta(2.5, 1.5), V1),
    "dirichlet": (lambda m: m.Dirichlet(np.array([1.5, 2.0, 0.7])), SIMPLEX),
    "categorical": (lambda m: m.Categorical(probs=np.array([0.2, 0.5, 0.3])), np.array([0, 1, 2, 2, 0])),
    "categorical_logits": (lambda m: m.Categorical(logits=np.array([[0.1, -1.0], [2.0, 0.3]])), np.array([1, 0])),
    "truncnorm": (lambda m: m.TruncatedNormal(0.5, 1.2, -1.0, 2.0), V1),
    "truncnorm_halfline": (lambda m: m.TruncatedNormal(35.0, 5.0, low=5.0), V1 * 20),
    "delta": (lambda m: m.Delta(1.0), V1),
    "improper_vector": (lambda m: m.ImproperUniform(_support(m, "real_vector"), (), (5,)), XV),
    "mixture": (lambda m: m.MixtureGeneral(m.Categorical(probs=np.array([0.3, 0.7])),
                                           [m.Normal(-1.0, 0.5), m.TruncatedNormal(2.0, 1.5, 0.0, 4.0)]), V1),
    "normal": (lambda m: m.Normal(0.3, 2.0), V1),
    "uniform": (lambda m: m.Uniform(-1.0, 2.5), V1),
}


def _support(m, name):
    return getattr(cons if m is td else jcons, name)


def _args(m, x):
    return torch.tensor(x) if m is td else jnp.asarray(x)


@pytest.mark.parametrize("name", list(DISTS))
def test_distribution_log_prob_matches_jax(name):
    make, v = DISTS[name]
    d, j = make(td), make(jd)
    got = d.log_prob(_args(td, v))
    _close(got, j.log_prob(_args(jd, v)))
    assert tuple(d.batch_shape) == tuple(j.batch_shape) and tuple(d.event_shape) == tuple(j.event_shape)
    for fn in ("cdf", "icdf"):
        if hasattr(j, fn):
            q = np.linspace(0.01, 0.99, 9) if fn == "icdf" else v
            _close(getattr(d, fn)(torch.tensor(q)), getattr(j, fn)(jnp.asarray(q)), atol=1e-15)


@pytest.mark.parametrize("name", ["lognormal", "exponential", "beta", "truncnorm", "mixture"])
def test_distribution_gradient_matches_jax(name):
    """d log_prob / d value where the JAX gradient is finite."""
    make, v = DISTS[name]
    x = torch.tensor(v, requires_grad=True)
    (g,) = torch.autograd.grad(make(td).log_prob(x).sum(), x)
    jg = np.asarray(jax.grad(lambda a: jnp.sum(make(jd).log_prob(a)))(jnp.asarray(v)))
    fin = np.isfinite(jg)
    np.testing.assert_allclose(g.numpy()[fin], jg[fin], rtol=RTOL, atol=1e-12)


def test_mixture_gradient_through_weights_and_components_matches_jax():
    def lp(m, lam, mu, x):
        mix = m.MixtureGeneral(m.Categorical(probs=(torch.stack if m is td else jnp.stack)([lam, 1.0 - lam])),
                               [m.Normal(mu, 1.0), m.Normal(0.0, 2.0)])
        return mix.log_prob(x).sum()

    x = np.array([0.5, -1.0, 2.0])
    lam = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    mu = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    g = torch.autograd.grad(lp(td, lam, mu, torch.tensor(x)), (lam, mu))
    jg = jax.grad(lambda a, b: lp(jd, a, b, jnp.asarray(x)), argnums=(0, 1))(0.4, 1.0)
    np.testing.assert_allclose([float(v) for v in g], [float(v) for v in jg], rtol=RTOL)


def test_samplers_match_their_moments():
    g = torch.Generator().manual_seed(0)
    torch.set_default_dtype(torch.float64)
    try:
        n = 40_000
        ln = td.LogNormal(0.3, 0.5).sample(g, (n,))
        ex = td.Exponential(2.0).sample(g, (n,))
        be = td.Beta(2.0, 3.0).sample(g, (n,))
        di = td.Dirichlet(torch.tensor([1.0, 2.0, 3.0])).sample(g, (n,))
        ca = td.Categorical(probs=torch.tensor([0.2, 0.5, 0.3])).sample(g, (n,))
        tn = td.TruncatedNormal(3.0, 0.5, 2.0, 4.0).sample(g, (n,))
        mix = td.MixtureGeneral(td.Categorical(probs=torch.tensor([0.25, 0.75])),
                                [td.Uniform(0.0, 1.0), td.TruncatedNormal(3.0, 0.5, 2.0, 4.0)]).sample(g, (n,))
    finally:
        torch.set_default_dtype(torch.float32)
    assert abs(float(ln.mean()) - np.exp(0.3 + 0.125)) < 0.02
    assert abs(float(ex.mean()) - 0.5) < 0.01 and float(ex.min()) >= 0.0
    assert abs(float(be.mean()) - 0.4) < 0.005
    torch.testing.assert_close(di.mean(0), torch.tensor([1 / 6, 2 / 6, 3 / 6], dtype=torch.float64), atol=5e-3, rtol=0)
    torch.testing.assert_close(torch.bincount(ca, minlength=3).double() / n, torch.tensor([0.2, 0.5, 0.3], dtype=torch.float64),
                               atol=0.01, rtol=0)
    assert 2.0 <= float(tn.min()) and float(tn.max()) <= 4.0 and abs(float(tn.mean()) - 3.0) < 0.01
    assert 0.0 <= float(mix.min()) and float(mix.max()) <= 4.0 and abs(float((mix <= 1.0).double().mean()) - 0.25) < 0.01


def test_distribution_arguments_are_validated():
    with pytest.raises(ValueError, match="positive"):
        td.Dirichlet(torch.tensor([1.0, -1.0]))
    with pytest.raises(ValueError, match="high > low"):
        td.TruncatedNormal(0.0, 1.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="positive"):
        td.Beta(0.0, 1.0)
    with pytest.raises(ValueError, match="exactly one"):
        td.Categorical()


def test_population_log_prob_puts_the_chain_axis_first():
    """A PPL distribution with chain-batched parameters evaluates data with
    the chains in front, as each chain's own distribution would."""
    loc = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    x = torch.tensor(RNG.normal(size=(4, 7)))
    got = td.population_log_prob(td.TruncatedNormal(loc, 1.5, -3.0, 3.0), x)
    assert got.shape == (3, 4, 7)
    for c in range(3):
        torch.testing.assert_close(got[c], td.TruncatedNormal(float(loc[c]), 1.5, -3.0, 3.0).log_prob(x))
    assert td.population_log_prob(td.Normal(0.0, 1.0), x).shape == (4, 7)


# ----------------------------------------------------------------- population distributions

C = 3
M = np.concatenate([np.linspace(1.0, 120.0, 60), [2.0, 3.0, 100.0]]).reshape(7, 9)  # masses
Q = np.linspace(0.0, 1.2, 25)  # mass ratios
Z = np.concatenate([np.linspace(0.0, 2.5, 40), [1e-9, 2.3]])  # redshifts
ANG = np.linspace(-0.5, 3.5, 21)
GRID = np.linspace(2.0, 100.0, 300)
DMAT = np.abs(np.sin(np.outer(np.arange(1, 7), GRID) / 40.0)) + 0.01  # (6, 300) positive design
CS = RNG.normal(size=(C, 6)) * 0.3

# name: (class name, per-chain hyperparameters (C,), pinned kwargs, values)
POP = {
    "sine": ("Sine", {"maximum": [3.0, 2.5, np.pi]}, {"minimum": 0.2}, ANG),
    "cosine": ("Cosine", {"minimum": [-1.5, -1.0, -0.5]}, {"maximum": 1.2}, ANG - 1.5),
    "powerlaw": ("Powerlaw", {"alpha": [-2.3, 1.5, 0.0]}, {"minimum": 0.02, "maximum": 1.0}, Q),
    "powerlaw_log_uniform": ("Powerlaw", {"alpha": [-1.0, -1.0, -2.0]}, {"minimum": 5.0, "maximum": 100.0}, M),
    "powerlaw_redshift": ("PowerlawRedshift", {"lamb": [1.7, -2.0, 4.5]}, {"maximum": 2.3}, Z),
    # production-prior slopes: alpha_max up to 25 (95**22 overflows float32 linearly)
    "smoothed_powerlaw": ("PowerlawSmoothedPowerlaw",
                          {"alpha": [-2.35, 3.0, -8.0], "minimum": [8.0, 3.5, 19.0], "maximum": [70.0, 41.0, 95.0],
                           "alpha_max": [10.0, 24.5, 3.2], "alpha_min": [2.0, 0.1, 5.9]},
                          {"low": 2.0, "high": 100.0}, M),
}


def _pop(mod, cls, batched, pinned, c=None):
    kw = dict(pinned)
    for k, v in batched.items():
        kw[k] = torch.tensor(v, dtype=torch.float64) if c is None else jnp.asarray(v[c])
    return getattr(mod, cls)(**kw)


@pytest.mark.parametrize("name", list(POP))
def test_population_distribution_matches_jax_per_chain(name):
    cls, batched, pinned, v = POP[name]
    d = _pop(pop, cls, batched, pinned)
    lp, cdf, icdf = d.log_prob(torch.tensor(v)), None, None
    assert lp.shape == (C,) + v.shape
    has_cdf = hasattr(getattr(jpop, cls), "cdf")
    if has_cdf:
        cdf, icdf = d.cdf(torch.tensor(v)), d.icdf(torch.tensor(np.linspace(0.01, 0.99, 11)))
    for c in range(C):
        j = _pop(jpop, cls, batched, pinned, c)
        _close(lp[c], j.log_prob(jnp.asarray(v)))
        if has_cdf:
            _close(cdf[c], j.cdf(jnp.asarray(v)), atol=1e-15)
            _close(icdf[c], j.icdf(jnp.asarray(np.linspace(0.01, 0.99, 11))))
        if hasattr(j, "norm"):
            np.testing.assert_allclose(float(d.norm[c]), float(j.norm), rtol=RTOL)
        if hasattr(j, "log_k1"):
            np.testing.assert_allclose([float(d.log_k1[c]), float(d.log_k3[c])], [float(j.log_k1), float(j.log_k3)],
                                       rtol=RTOL)


@pytest.mark.parametrize("name", ["powerlaw", "powerlaw_redshift", "smoothed_powerlaw"])
def test_population_gradients_match_jax(name):
    """Gradient of the summed in-support log-density to each chain's
    hyperparameters, where JAX's is finite."""
    cls, batched, pinned, v = POP[name]
    params = {k: torch.tensor(val, dtype=torch.float64, requires_grad=True) for k, val in batched.items()}
    lp = getattr(pop, cls)(**pinned, **params).log_prob(torch.tensor(v))
    keep = torch.isfinite(lp) & (lp > -1e300)
    grads = torch.autograd.grad(torch.where(keep, lp, 0.0).sum(), list(params.values()))
    for c in range(C):
        def f(*args):
            j = getattr(jpop, cls)(**pinned, **dict(zip(batched, args)))
            jl = j.log_prob(jnp.asarray(v))
            return jnp.sum(jnp.where(jnp.asarray(keep[c].numpy()), jl, 0.0))

        jg = jax.grad(f, argnums=tuple(range(len(batched))))(*(jnp.asarray(val[c]) for val in batched.values()))
        for g, want in zip(grads, jg):
            if np.isfinite(float(want)):
                np.testing.assert_allclose(float(g[c]), float(want), rtol=1e-9, atol=1e-12)


def test_bspline_distribution_matches_jax_per_chain():
    x = np.linspace(1.0, 101.0, 50)
    d = pop.BSplineDistribution(2.0, 100.0, torch.tensor(CS), torch.tensor(GRID), torch.tensor(DMAT))
    lp, cdf = d.log_prob(torch.tensor(x)), d.cdf(torch.tensor(x))
    icdf = d.icdf(torch.tensor(np.linspace(0.0, 1.0, 13)))
    assert d.batch_shape == (C,) and lp.shape == (C, 50)
    for c in range(C):
        j = jpop.BSplineDistribution(2.0, 100.0, jnp.asarray(CS[c]), jnp.asarray(GRID), jnp.asarray(DMAT))
        _close(lp[c], j.log_prob(jnp.asarray(x)))
        _close(cdf[c], j.cdf(jnp.asarray(x)), atol=1e-15)
        _close(icdf[c], j.icdf(jnp.asarray(np.linspace(0.0, 1.0, 13))))


def test_pspline_prior_matches_jax():
    v = RNG.normal(size=(C, 8))
    inv_var = np.array([0.5, 2.0, 10.0])
    got = pop.PSplineCoeficientPrior(8, torch.tensor(inv_var), diff_order=2).log_prob(torch.tensor(v))
    for c in range(C):
        want = jpop.PSplineCoeficientPrior(8, jnp.asarray(inv_var[c]), diff_order=2).log_prob(jnp.asarray(v[c]))
        np.testing.assert_allclose(float(got[c]), float(want), rtol=RTOL)


@pytest.mark.parametrize("name", ["sine", "powerlaw", "powerlaw_log_uniform", "powerlaw_redshift"])
def test_population_samplers_follow_their_cdf(name):
    """Inverse-cdf draws per chain: their empirical cdf at a few points
    against the distribution's own cdf (sample_shape + batch_shape order)."""
    cls, batched, pinned, v = POP[name]
    d = _pop(pop, cls, batched, pinned)
    g = torch.Generator().manual_seed(1)
    torch.set_default_dtype(torch.float64)
    try:
        x = d.sample(g, (20_000,))
    finally:
        torch.set_default_dtype(torch.float32)
    assert x.shape == (20_000, C)
    probes = torch.quantile(x, torch.tensor([0.2, 0.5, 0.8], dtype=torch.float64), dim=0)  # (3, C)
    want = torch.stack([d.cdf(probes[:, c])[c] for c in range(C)], dim=1)
    torch.testing.assert_close(want, torch.tensor([[0.2], [0.5], [0.8]], dtype=torch.float64).expand(3, C),
                               atol=0.015, rtol=0)


def test_interp_and_cumtrapz_match_jax():
    xp = np.sort(RNG.uniform(0, 10, 40))
    xp[10] = xp[11]  # a zero-width interval
    fp = RNG.normal(size=(C, 40))
    x = np.concatenate([RNG.uniform(-1, 11, 30), xp[:5], [xp[10]]])
    shared = pop.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
    per_chain_xp = np.cumsum(np.abs(RNG.normal(size=(C, 40))), axis=1)
    xq = RNG.uniform(-1, 45, (C, 30))
    batched = pop.interp(torch.tensor(xq), torch.tensor(per_chain_xp), torch.tensor(GRID[:40]))
    for c in range(C):
        _close(shared[c], jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp[c])))
        _close(batched[c], jnp.interp(jnp.asarray(xq[c]), jnp.asarray(per_chain_xp[c]), jnp.asarray(GRID[:40])))
        _close(pop.cumtrapz(torch.tensor(fp), torch.tensor(xp))[c], jpop.cumtrapz(jnp.asarray(fp[c]), jnp.asarray(xp)))


# ----------------------------------------------------------------- simplex site through the potential


def _dirichlet_model(m, dist, data):
    w = m.sample("w", dist.Dirichlet(np.array([2.0, 1.0, 3.0]) if m is jppl else torch.tensor([2.0, 1.0, 3.0], dtype=torch.float64)))
    mu = m.sample("mu", dist.Normal(0.0, 2.0))
    return w, mu


def test_simplex_site_has_k_minus_one_unconstrained_coordinates_and_matches_jax():
    data = RNG.normal(size=20)

    def torch_model():
        w, mu = _dirichlet_model(ppl, td, data)
        mix = td.MixtureGeneral(td.Categorical(probs=w), [td.Normal(mu - 1.0, 1.0), td.Normal(mu, 1.0), td.Normal(mu + 2.0, 0.5)])
        ppl.factor("lik", td.population_log_prob(mix, torch.tensor(data)).sum(-1))

    def jax_model():
        w, mu = _dirichlet_model(jppl, jd, data)
        mix = jd.MixtureGeneral(jd.Categorical(probs=w), [jd.Normal(mu - 1.0, 1.0), jd.Normal(mu, 1.0), jd.Normal(mu + 2.0, 0.5)])
        jppl.factor("lik", jnp.sum(mix.log_prob(jnp.asarray(data))))

    pot = ppl.ModelPotential(torch_model, device="cpu", dtype=torch.float64)
    assert pot.dim == 3 and pot.shapes["w"] == (3,) and pot.unconstrained_shapes["w"] == (2,)
    z = torch.tensor(RNG.normal(size=(C, 3)))
    u, grad = pot.value_and_grad(z)
    for c in range(C):
        uc = {"mu": jnp.asarray(z[c, 0].item()), "w": jnp.asarray(z[c, 1:].numpy())}
        want, jg = jax.value_and_grad(lambda p: jppl.potential_energy(jax_model, (), {}, p))(uc)
        np.testing.assert_allclose(float(u[c]), float(want), rtol=RTOL)
        np.testing.assert_allclose(grad[c].numpy(), np.concatenate([[float(jg["mu"])], np.asarray(jg["w"])]), rtol=1e-9)
    torch.testing.assert_close(pot.unconstrain(pot.constrain(z), C), z)


def test_discrete_latent_site_is_rejected():
    def model():
        ppl.sample("k", td.Categorical(probs=torch.tensor([0.5, 0.5])))

    with pytest.raises(ValueError, match="discrete latent site 'k'"):
        ppl.ModelPotential(model, device="cpu", dtype=torch.float64)
