"""Checkpoint and resume in the port: a resumed run continues the saved run
exactly, and a checkpoint written by the JAX package loads into the port
and resumes from its positions, inverse mass matrix and step size, carried
over exactly (float64 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import ppl as jppl
from gwinferno_tpu.infer import MCMC as JaxMCMC
from gwinferno_tpu.infer import NUTS as JaxNUTS
from gwinferno_tpu.ppl import distributions as jdist
from gwinferno_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import HMC, MCMC, NUTS
from gwinferno_tpu_torch.ppl import distributions as td
from gwinferno_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

F64 = dict(device="cpu", dtype=torch.float64)


def jax_model():
    x = jppl.sample("x", jdist.Normal(jnp.zeros(2), jnp.ones(2)))
    jppl.sample("y", jdist.Normal(x.sum(), 1.0), obs=jnp.array(0.3))


def model():
    x = ppl.sample("x", td.Normal(torch.zeros(2), torch.ones(2)))
    ppl.sample("y", td.Normal(x.sum(-1), 1.0), obs=torch.tensor(0.3, dtype=torch.float64))


@pytest.mark.parametrize("kernel", [NUTS, HMC])
def test_resume_continues_the_run_exactly(tmp_path, kernel):
    """Warmup + 30 samples, saved and resumed for 20 more, gives the last 20
    samples of one warmup + 50 run; the resumed run does no warmup."""
    kw = dict(num_warmup=60, num_chains=2, **F64)
    whole = MCMC(kernel(model), num_samples=50, **kw).run(0)
    first = MCMC(kernel(model), num_samples=30, **kw).run(0)
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, first)
    resumed = MCMC(kernel(model), num_samples=20, **kw).run(7, post_warmup_state=load_checkpoint(path))
    assert "warmup" not in resumed.timings
    torch.testing.assert_close(resumed.get_samples()["x"], whole.get_samples()["x"][-40:], rtol=1e-12, atol=1e-12)
    for key in ("step_size", "inverse_mass_matrix"):
        assert torch.equal(resumed._adapt_info[key], first._adapt_info[key])
    pws = resumed.post_warmup_state
    assert [tuple(v.shape) for v in pws["state"]] == [(2, 2), (2,), (2, 2)] + [(2,)] * 5
    assert pws["rng_key"].dtype == torch.uint8


def test_resume_from_a_run_in_memory_and_fresh_draws():
    """``post_warmup_state`` of a finished run resumes directly; the same
    state with another generator state gives other draws from the same
    posterior."""
    mcmc = MCMC(NUTS(model), num_warmup=100, num_samples=50, num_chains=2, **F64).run(0)
    s1 = mcmc.get_samples()["x"].numpy()
    state = dict(mcmc.post_warmup_state, rng_key=torch.Generator().manual_seed(99).get_state())
    m2 = MCMC(NUTS(model), num_warmup=100, num_samples=50, num_chains=2, **F64).run(1, post_warmup_state=state)
    s2 = m2.get_samples()["x"].numpy()
    assert s2.shape == s1.shape and not np.allclose(s1, s2)
    assert np.all(np.abs(np.concatenate([s1, s2]).mean(0) - 0.15) < 0.4)
    np.testing.assert_allclose(m2._adapt_info["step_size"].numpy(), mcmc._adapt_info["step_size"].numpy())


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote: the port starts from its
    positions (with no sample taken the state is returned as loaded), its
    inverse mass matrix and step size exactly; its JAX rng key gives way to
    the port's seed."""
    jm = JaxMCMC(JaxNUTS(jax_model, dense_mass=True), num_warmup=100, num_samples=20, num_chains=2)
    jm.run(jax.random.PRNGKey(0))
    path = os.path.join(tmp_path, "jax_ckpt.npz")
    jax_save_checkpoint(path, jm)
    saved = load_checkpoint(path)
    assert saved["rng_key"].dtype != np.uint8

    kw = dict(num_warmup=100, num_chains=2, **F64)
    still = MCMC(NUTS(model, dense_mass=True), num_samples=0, **kw).run(0, post_warmup_state=saved)
    st = still.post_warmup_state
    np.testing.assert_array_equal(st["state"][0].numpy(), saved["state"][0])
    np.testing.assert_allclose(st["state"][1].numpy(), saved["state"][1], rtol=1e-12)
    np.testing.assert_allclose(st["state"][2].numpy(), saved["state"][2], rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(st["step_size"].numpy(), saved["step_size"])
    np.testing.assert_array_equal(st["inverse_mass_matrix"].numpy(), saved["inverse_mass_matrix"])
    np.testing.assert_allclose(st["mass_chol"].numpy(), saved["mass_chol"], rtol=1e-12, atol=1e-14)

    runs = [MCMC(NUTS(model, dense_mass=True), num_samples=30, **kw).run(seed, post_warmup_state=saved)
            for seed in (0, 0, 1)]
    xs = [r.get_samples()["x"] for r in runs]
    assert torch.equal(xs[0], xs[1]) and not torch.equal(xs[0], xs[2])
    assert all(bool(torch.isfinite(x).all()) for x in xs) and "warmup" not in runs[0].timings
    np.testing.assert_array_equal(runs[0]._adapt_info["step_size"].numpy(), np.asarray(jm._adapt_info["step_size"]))


def test_resume_rejects_a_state_of_another_layout():
    mcmc = MCMC(NUTS(model), num_warmup=20, num_samples=5, num_chains=2, **F64).run(0)
    with pytest.raises(ValueError, match="post_warmup_state"):
        MCMC(NUTS(model), num_samples=5, num_chains=3, **F64).run(0, post_warmup_state=mcmc.post_warmup_state)
    with pytest.raises(ValueError, match="inverse mass matrix"):
        MCMC(NUTS(model, dense_mass=True), num_samples=5, num_chains=2, **F64).run(
            0, post_warmup_state=mcmc.post_warmup_state)
