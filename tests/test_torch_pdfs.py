"""CPU float64 parity of the port's pdfs, population models, cosmology and
catalog loader with the JAX package, on numpy-seeded inputs.

Tolerance: values and gradients rtol 1e-10 (both sides are float64; the
remaining differences are the order of floating-point operations and the
erf / lgamma implementations)."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import cosmology as jcosmo
from gwinferno_tpu import distributions as jdist
from gwinferno_tpu.models.parametric import parametric as jpar
from gwinferno_tpu_torch import cosmology as tcosmo
from gwinferno_tpu_torch import distributions as tdist
from gwinferno_tpu_torch.models.parametric import parametric as tpar

RTOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _assert_parity(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _grad_parity(f_jax, f_torch, params, data, rtol=RTOL, atol=1e-12):
    """Values and the gradient of sum(finite values) wrt the hyperparameters."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = f_jax(data, jp)

    def jsum(p):
        v = f_jax(data, p)
        return jnp.sum(jnp.where(jnp.isfinite(v), v, 0.0))

    jg = jax.grad(jsum)(jp)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    td = {k: _t(v) for k, v in data.items()}
    got = f_torch(td, tp)
    _assert_parity(got, want)
    total = torch.where(torch.isfinite(got), got, 0.0).sum()
    tg = torch.autograd.grad(total, list(tp.values()), allow_unused=True)
    for (k, _), g in zip(tp.items(), tg):
        g = np.zeros(()) if g is None else g.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=rtol, atol=atol, err_msg=k)


def _rng():
    return np.random.default_rng(7)


def test_safe_log_and_logaddexp():
    x = np.array([-1.0, 0.0, 1e-300, 0.3, 2.0])
    _assert_parity(tdist.safe_log(_t(x)), jdist.safe_log(jnp.asarray(x)))
    a = np.array([-np.inf, -np.inf, 0.5, -3.0])
    b = np.array([-np.inf, 1.0, -np.inf, 2.0])
    _assert_parity(tdist.safe_logaddexp(_t(a), _t(b)), jdist.safe_logaddexp(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    ga, gb = torch.autograd.grad(tdist.safe_logaddexp(ta, tb)[1:].sum(), [ta, tb])
    ja, jb = jax.grad(lambda u, v: jnp.sum(jdist.safe_logaddexp(u, v)[1:]), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=RTOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=RTOL)


def test_smooth_window():
    x = np.linspace(2.0, 12.0, 41)
    _assert_parity(tdist.smooth(3.0, _t(x), 5.0), jdist.smooth(3.0, jnp.asarray(x), 5.0))


@pytest.mark.parametrize("alpha", [-2.35, -1.0, 0.0, 1.7])
def test_log_powerlaw_pdf(alpha):
    x = np.concatenate([_rng().uniform(3.0, 110.0, 200), [5.0, 100.0, 4.999, 100.001]])
    data = {"x": x}
    _grad_parity(
        lambda d, p: jdist.log_powerlaw_pdf(d["x"], p["alpha"], 5.0, 100.0),
        lambda d, p: tdist.log_powerlaw_pdf(d["x"], p["alpha"], 5.0, 100.0),
        {"alpha": alpha}, data,
    )
    # per-sample lower bound (the mass-ratio form low = mmin / m1)
    m1 = _rng().uniform(3.0, 100.0, 300)
    q = _rng().uniform(0.01, 1.0, 300)
    _grad_parity(
        lambda d, p: jdist.log_powerlaw_pdf(d["q"], p["alpha"], 5.0 / d["m1"], 1.0),
        lambda d, p: tdist.log_powerlaw_pdf(d["q"], p["alpha"], 5.0 / d["m1"], 1.0),
        {"alpha": alpha}, {"q": q, "m1": m1},
    )


@pytest.mark.parametrize("log", [False, True])
def test_log_truncnorm_pdf(log):
    x = np.concatenate([_rng().uniform(1.0, 110.0, 200), [5.0, 100.0]])
    _grad_parity(
        lambda d, p: jdist.log_truncnorm_pdf(d["x"], p["mu"], p["sig"], 5.0, 100.0, log=log),
        lambda d, p: tdist.log_truncnorm_pdf(d["x"], p["mu"], p["sig"], 5.0, 100.0, log=log),
        {"mu": 3.3 if log else 35.0, "sig": 0.4 if log else 5.0}, {"x": x},
    )


def test_log_betadist():
    x = _rng().uniform(-0.2, 1.2, 300)
    inb = (x >= 0) & (x <= 1)
    # values everywhere; gradients on the support, where the reference's are
    # finite (it clips out-of-support points onto the infinite endpoint logs)
    _assert_parity(tdist.log_betadist(_t(x), _t(2.3), _t(4.28)), jdist.log_betadist(x, jnp.asarray(2.3), jnp.asarray(4.28)))
    _grad_parity(
        lambda d, p: jdist.log_betadist(d["x"], p["a"], p["b"]),
        lambda d, p: tdist.log_betadist(d["x"], p["a"], p["b"]),
        {"a": 2.3, "b": 4.28}, {"x": x[inb]},
    )
    a = _t(2.3).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.where(torch.tensor(inb), tdist.log_betadist(_t(x), a, _t(4.28)), 0.0).sum(), a)
    assert torch.isfinite(g)


def _bank(n=400):
    rng = _rng()
    return {
        "m1": rng.uniform(3.0, 110.0, n), "q": rng.uniform(0.01, 1.0, n),
        "a1": rng.uniform(0.0, 1.0, n), "a2": rng.uniform(0.0, 1.0, n),
        "ct1": rng.uniform(-1.1, 1.1, n), "ct2": rng.uniform(-1.0, 1.0, n),
    }


def test_log_plpeak_primary_ratio_pdf():
    params = {"alpha": -2.35, "beta": 1.0, "mpp": 35.0, "sigpp": 5.0, "lam": 0.25}

    def f(mod):
        return lambda d, p: mod.log_plpeak_primary_ratio_pdf(
            d["m1"], d["q"], p["alpha"], p["beta"], 5.0, 100.0, p["mpp"], p["sigpp"], p["lam"]
        )

    _grad_parity(f(jpar), f(tpar), params, _bank())


def test_log_independent_spin_models():
    mag = {"a1": 2.3, "b1": 4.28, "a2": 1.5, "b2": 3.0}
    _grad_parity(
        lambda d, p: jpar.log_independent_spin_magnitude_beta_dist(d["a1"], d["a2"], p["a1"], p["b1"], p["a2"], p["b2"]),
        lambda d, p: tpar.log_independent_spin_magnitude_beta_dist(d["a1"], d["a2"], p["a1"], p["b1"], p["a2"], p["b2"]),
        mag, _bank(),
    )
    tilt = {"xi1": 0.7, "xi2": 0.4, "s1": 0.5, "s2": 1.3}
    _grad_parity(
        lambda d, p: jpar.log_independent_spin_tilt(d["ct1"], d["ct2"], p["xi1"], p["xi2"], p["s1"], p["s2"]),
        lambda d, p: tpar.log_independent_spin_tilt(d["ct1"], d["ct2"], p["xi1"], p["xi2"], p["s1"], p["s2"]),
        tilt, _bank(),
    )
    _grad_parity(
        lambda d, p: jpar.log_mixture_isoalign_spin_tilt(d["ct1"], p["xi1"], p["s1"]),
        lambda d, p: tpar.log_mixture_isoalign_spin_tilt(d["ct1"], p["xi1"], p["s1"]),
        {"xi1": 0.7, "s1": 0.5}, _bank(),
    )


def test_cosmology_tables_and_queries():
    jc, tc = jcosmo.PLANCK_2015_LVK_Cosmology, tcosmo.PLANCK_2015_LVK_Cosmology
    np.testing.assert_allclose(tc.Dc, np.asarray(jc.Dc), rtol=1e-14)
    np.testing.assert_allclose(tc.Vc, np.asarray(jc.Vc), rtol=1e-14)
    z = _rng().uniform(0.0, 3.0, 100)
    np.testing.assert_allclose(tc.dVcdz(z), np.asarray(jc.dVcdz(z)), rtol=1e-14)
    np.testing.assert_allclose(tc.logdVcdz(z[1:]), np.asarray(jc.logdVcdz(z[1:])), rtol=1e-14)
    np.testing.assert_allclose(tc.z2DL(z), np.asarray(jc.z2DL(z)), rtol=1e-14)


def test_powerlaw_redshift_model():
    rng = _rng()
    z_pe, z_inj = rng.uniform(0.01, 1.3, (5, 40)), rng.uniform(0.02, 1.2, 300)
    jm = jpar.PowerlawRedshiftModel(z_pe, z_inj)
    tm = tpar.PowerlawRedshiftModel(z_pe, z_inj, device="cpu", dtype=torch.float64)
    assert tm.zmax == float(jm.zmax) and tm.zmin == float(jm.zmin)
    np.testing.assert_allclose(tm.dVdzs[0], np.asarray(jm.dVdzs[0]), rtol=1e-14)
    np.testing.assert_allclose(tm.dVdzs[1], np.asarray(jm.dVdzs[1]), rtol=1e-14)
    lambs = np.array([-3.0, 0.0, 1.0, 1.7, 6.0])
    want = np.array([float(jm.normalization(jnp.asarray(lm))) for lm in lambs])
    _assert_parity(tm.normalization(_t(lambs)), want)
    jg = jax.grad(lambda lm: jnp.log(jm.normalization(lm)))(jnp.asarray(1.7))
    tl = _t(1.7).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.log(tm.normalization(tl)), tl)
    np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL)
    for z in (z_pe, z_inj):
        _assert_parity(tm.log_prob(_t(z), _t(1.7)), jm.log_prob(jnp.asarray(z), jnp.asarray(1.7)))


def test_catalog_loader_matches_the_jax_package():
    from gwinferno_tpu.pipeline.utils import load_pe_and_injections_as_dict as jload
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict, to_tensors

    pe, inj, const, names = load_pe_and_injections_as_dict(CATALOG)
    jpe, jinj, jconst, jnames = jload(CATALOG)
    assert names == jnames and const == jconst
    assert const == {"total_inj": 9.6e7, "obs_time": 1.0, "nObs": 69}
    for d, jd in ((pe, jpe), (inj, jinj)):
        assert d.keys() == jd.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], jd[k])
    t = to_tensors({"mass_1": pe["mass_1"]}, device="cpu", dtype=torch.float64)
    assert t["mass_1"].shape == (69, 8000) and t["mass_1"].dtype == torch.float64
    with h5py.File(CATALOG, "r") as f:  # the layout the loader reads
        assert f["pe_data/posteriors"].shape == (69, 9, 8000)
