"""CPU float64 parity of the port's posterior-predictive calculations
(``postprocess/calculations.py``) with the JAX package's, at small knots and
a few draws (more than one batch of 128 where the grid is 1-D).

Tolerance: rtol 1e-9 (grids of 800 points, trapezoids in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.models.spline_perturbation import PowerlawSplineRedshiftModel as JZModel
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JPlainZ
from gwinferno_tpu.postprocess import calculations as jcalc
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.models.spline_perturbation import PowerlawSplineRedshiftModel
from gwinferno_tpu_torch.postprocess import calculations as calc

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9
MMIN, MMAX = 3.0, 100.0


def _parity(got, want):
    assert isinstance(got, np.ndarray)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-12 * float(np.abs(want[fin]).max()))


def _all(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _parity(g, w)


def test_bspline_mass_ppds():
    rng = np.random.default_rng(0)
    n = 3
    m_cs, q_cs = 0.4 * rng.standard_normal((n, 10)), 0.3 * rng.standard_normal((n, 6))
    knots = {"m1": 10, "q": 6}
    rate, frac = rng.uniform(10, 50, n), rng.uniform(0.2, 1.0, n)
    got = calc.calculate_bspline_mass_ppds(m_cs, q_cs, knots, MMIN, MMAX, rate=rate, pop_frac=frac, **F64)
    _all(got, jcalc.calculate_bspline_mass_ppds(jnp.asarray(m_cs), jnp.asarray(q_cs), knots, MMIN, MMAX, rate=rate,
                                                pop_frac=frac))
    plain = calc.calculate_bspline_mass_ppds(m_cs, q_cs, knots, MMIN, MMAX, **F64)
    np.testing.assert_allclose(np.trapezoid(plain[0], plain[1], axis=-1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.trapezoid(plain[2], plain[3], axis=-1), 1.0, rtol=1e-12)


def test_powerlaw_peak_mass_ppds():
    rng = np.random.default_rng(1)
    n = 3
    hp = [rng.uniform(-3, -1.5, n), rng.uniform(-1, 2, n), rng.uniform(25, 40, n), rng.uniform(2, 8, n),
          rng.uniform(0.05, 0.5, n)]
    rate = rng.uniform(10, 50, n)
    got = calc.calculate_powerlaw_peak_mass_ppds(*hp, MMIN, MMAX, rate=rate, **F64)
    _all(got, jcalc.calculate_powerlaw_peak_mass_ppds(*[jnp.asarray(v) for v in hp], MMIN, MMAX, rate=rate))


def test_peak_logm1_bspline_q_ppds():
    rng = np.random.default_rng(2)
    n = 3
    logmp, logsigp = np.log(rng.uniform(20, 40, n)), rng.uniform(0.2, 0.6, n)
    q_cs = 0.3 * rng.standard_normal((n, 6))
    got = calc.calculate_peak_logm1_bspline_q_ppds(logmp, logsigp, q_cs, {"q": 6}, MMIN, MMAX, **F64)
    _all(got, jcalc.calculate_peak_logm1_bspline_q_ppds(jnp.asarray(logmp), jnp.asarray(logsigp), jnp.asarray(q_cs),
                                                        {"q": 6}, MMIN, MMAX))


def test_beta_spin_mag_and_tilt_mixture_over_batches():
    """300 draws: three batches of at most 128, the last partial."""
    rng = np.random.default_rng(3)
    n = 300
    a, b = rng.uniform(1.2, 5, n), rng.uniform(1.2, 8, n)
    rate, frac = rng.uniform(10, 50, n), rng.uniform(0.2, 1.0, n)
    got = calc.calculate_beta_spin_mag(a, b, amax=0.9, rate=rate, pop_frac=frac, **F64)
    _all(got, jcalc.calculate_beta_spin_mag(jnp.asarray(a), jnp.asarray(b), amax=0.9, rate=rate, pop_frac=frac))
    assert got[0].shape == (n, calc.GRID_N)
    sig, lam = rng.uniform(0.2, 2.0, n), rng.uniform(0.05, 0.95, n)
    got = calc.calculate_mixture_iso_aligned_spin_tilt(sig, lam, rate=rate, **F64)
    _all(got, jcalc.calculate_mixture_iso_aligned_spin_tilt(jnp.asarray(sig), jnp.asarray(lam), rate=rate))


@pytest.mark.parametrize("iid", [True, False], ids=["iid", "independent"])
def test_bspline_spin_ppds(iid):
    rng = np.random.default_rng(4)
    n = 5
    a1, t1, a2, t2 = (0.4 * rng.standard_normal((n, k)) for k in (7, 6, 5, 8))
    if iid:
        knots = {"a": 7, "tilt": 6}
        got = calc.calculate_bspline_spin_ppds(a1, t1, knots, **F64)
        want = jcalc.calculate_bspline_spin_ppds(jnp.asarray(a1), jnp.asarray(t1), knots)
    else:
        knots = {"a1": 7, "a2": 5, "tilt1": 6, "tilt2": 8}
        got = calc.calculate_bspline_spin_ppds(a1, t1, knots, a2_cs=a2, tilt2_cs=t2, pop_frac=np.full(n, 0.4), **F64)
        want = jcalc.calculate_bspline_spin_ppds(jnp.asarray(a1), jnp.asarray(t1), knots, a2_cs=jnp.asarray(a2),
                                                 tilt2_cs=jnp.asarray(t2), pop_frac=np.full(n, 0.4))
    _all(got, want)


def test_rate_of_z_ppds():
    rng = np.random.default_rng(5)
    z_pe, z_inj = rng.uniform(0.01, 1.9, (4, 60)), rng.uniform(0.02, 2.0, 400)
    n = 140
    lamb, rate = rng.uniform(-1, 4, n), rng.uniform(10, 60, n)
    plain, jplain = PowerlawRedshiftModel(z_pe, z_inj, **F64), JPlainZ(z_pe, z_inj)
    got = calc.calculate_powerlaw_rate_of_z_ppds(lamb, rate, plain)
    _all(got, jcalc.calculate_powerlaw_rate_of_z_ppds(jnp.asarray(lamb), jnp.asarray(rate), jplain))
    zm, jzm = PowerlawSplineRedshiftModel(6, z_pe, z_inj, **F64), JZModel(6, z_pe, z_inj)
    z_cs = 0.3 * rng.standard_normal((n, 5))
    got = calc.calculate_powerlaw_spline_rate_of_z_ppds(lamb, z_cs, rate, zm, pop_frac=np.full(n, 0.7))
    _all(got, jcalc.calculate_powerlaw_spline_rate_of_z_ppds(jnp.asarray(lamb), jnp.asarray(z_cs), jnp.asarray(rate),
                                                             jzm, pop_frac=np.full(n, 0.7)))


def test_calculations_cover_the_jax_module():
    assert set(calc.__all__) == set(jcalc.__all__) and calc.GRID_N == jcalc.GRID_N
