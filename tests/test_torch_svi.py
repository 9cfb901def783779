"""The port's SVI against the JAX package's: AutoDelta with Adam from full
``init_values`` is deterministic, so 50 steps on the bench model over a
slice of the committed catalog match JAX's ``SVI`` step for step
(parameters and losses, float64, rtol 1e-8), and ``find_map`` returns the
same constrained point; then the JAX package's SVI tests mirrored at their
own limits (AutoDelta MAP, AutoNormal posterior, ``find_map`` on a
Gaussian)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gwinferno_tpu.infer import svi as jsvi
from gwinferno_tpu.models.parametric.parametric import PowerlawRedshiftModel as JRedshift
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import SVI, Adam, AutoDelta, AutoNormal, Trace_ELBO, find_map
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.pipeline import analysis
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT, BenchModel
from gwinferno_tpu_torch.ppl import distributions as td

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-8


def _catalog_slice(n_events=10, n_samples=200):
    """The first ``n_events`` events' first ``n_samples`` samples and every
    found injection, read directly (never through the conftest fixtures)."""
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    return pe, inj, dict(const, nObs=n_events)


def test_autodelta_adam_matches_jax_step_for_step():
    sys.path.insert(0, ROOT)
    import bench

    pe, inj, const = _catalog_slice()
    steps, lr = 50, 0.02
    jmodel = bench.make_model(pe, inj, const, JRedshift(pe["redshift"], inj["redshift"]))
    jguide = jsvi.AutoDelta(jmodel, init_values=FIDUCIAL_INIT)
    want = jsvi.SVI(jmodel, jguide, jsvi.Adam(lr), jsvi.Trace_ELBO()).run(jax.random.PRNGKey(0), steps)

    tmodel = BenchModel(pe, inj, const, PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64), **F64)
    guide = AutoDelta(tmodel, init_values=FIDUCIAL_INIT)
    got = SVI(tmodel, guide, Adam(lr), Trace_ELBO(), **F64).run(0, steps)

    assert np.all(np.isfinite(np.asarray(want.losses))) and np.all(np.abs(np.asarray(want.losses)) < 1e30)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=RTOL)
    assert set(got.params) == set(want.params) == set(FIDUCIAL_INIT)
    for k, v in want.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(v), rtol=RTOL, atol=1e-12, err_msg=k)
    assert float(got.losses[-1]) < float(got.losses[0])

    # find_map (AutoDelta + Adam) from the same start: the same constrained point
    est = find_map(1, tmodel, Niter=steps, lr=lr, init_values=FIDUCIAL_INIT, **F64)
    jest = jguide.median(want.params)
    for k, v in jest.items():
        assert est[k].shape == ()
        np.testing.assert_allclose(est[k].numpy(), np.asarray(v), rtol=RTOL, err_msg=k)
    assert analysis.find_map is find_map


DATA = np.array([1.1, 0.9, 1.3, 0.7, 1.0, 1.2, 0.8, 1.0])


def model(data):
    mu = ppl.sample("mu", td.Normal(0.0, 10.0))
    sigma = ppl.sample("sigma", td.HalfNormal(5.0))
    ppl.sample("obs", td.Normal(mu[:, None], sigma[:, None]), obs=data)


def test_autodelta_map():
    guide = AutoDelta(model)
    result = SVI(model, guide, Adam(0.05), Trace_ELBO(), **F64).run(0, 800, torch.tensor(DATA))
    est = guide.median(result.params)
    assert abs(float(est["mu"]) - DATA.mean()) < 0.02
    assert float(result.losses[-1]) < float(result.losses[0])
    assert result.losses.shape == (800,) and bool(torch.isfinite(result.losses).all())


def test_autonormal_posterior():
    guide = AutoNormal(model)
    result = SVI(model, guide, Adam(0.05), Trace_ELBO(num_particles=4), **F64).run(0, 1500, torch.tensor(DATA))
    post = guide.sample_posterior(1, result.params, sample_shape=(2000,))
    mu, sigma = post["mu"].numpy(), post["sigma"].numpy()
    assert mu.shape == sigma.shape == (2000,)
    # analytic posterior of mu | data roughly N(mean, sd/sqrt(n))
    assert abs(mu.mean() - DATA.mean()) < 0.1
    assert np.all(sigma > 0)
    assert 0.02 < mu.std() < 0.4  # nonzero but concentrated
    assert set(guide.median(result.params)) == {"mu", "sigma"}


def test_guides_start_from_init_values():
    """Both guides start their locations at ``init_values`` mapped to
    unconstrained space (``sigma`` through its exp transform), AutoNormal
    with scale ``init_scale``."""
    args, kw = (torch.tensor(DATA),), dict(device="cpu", dtype=torch.float64)
    init = {"mu": 1.5, "sigma": 0.2}
    delta = AutoDelta(model, init_values=init).init_params(torch.Generator().manual_seed(0), args, **kw)
    normal = AutoNormal(model, init_scale=0.05, init_values=init).init_params(torch.Generator(), args, **kw)
    for params in (delta, normal["loc"]):
        assert float(params["mu"]) == 1.5 and abs(float(params["sigma"]) - np.log(0.2)) < 1e-15
    assert all(float(v) == np.log(0.05) for v in normal["log_scale"].values())


def test_find_map_gaussian():
    data = torch.tensor([1.0, 1.4, 0.9, 1.2], dtype=torch.float64)

    def m(data):
        mu = ppl.sample("mu", td.Normal(0.0, 100.0))
        ppl.sample("obs", td.Normal(mu[:, None], 1.0), obs=data)

    params = find_map(0, m, data, Niter=500, lr=0.05, **F64)
    assert abs(float(params["mu"]) - float(data.mean())) < 0.02


def test_svi_and_find_map_default_to_cuda(monkeypatch):
    import pytest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SVI(model, AutoDelta(model), Adam(0.1), Trace_ELBO())
    with pytest.raises(RuntimeError, match="CUDA"):
        find_map(0, model, torch.tensor(DATA))
