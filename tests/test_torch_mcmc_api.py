"""The port's MCMC engine surfaces, mirroring the JAX package's
``tests/infer/test_mcmc_api.py`` and its collective-adaptation test: the
``chain_method`` validation, sequential chains and chain batches (each a
whole run with its own adaptation), ``"parallel"`` on one device, and
``collective_adaptation`` (one step size per chain, one pooled mass matrix),
float64 on the CPU at the JAX tests' limits; and the keyword surface that
``bench.py`` and ``examples/utils.py`` pass (``progress_bar`` on stderr
only, ``jit_model_args``, ``mesh`` (a ``parallel.Mesh``, without
``chain_batch_size`` or ``chain_groups``), ``NUTS(init_strategy=)``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import HMC, MCMC, NUTS
from gwinferno_tpu_torch.parallel import create_mesh
from gwinferno_tpu_torch.ppl import distributions as td

F64 = dict(device="cpu", dtype=torch.float64)


def model():
    ppl.sample("x", td.Normal(0.0, 1.0))
    ppl.sample("s", td.HalfNormal(2.0))


def std_normal_model():
    ppl.sample("x", td.Normal(torch.zeros(3), torch.ones(3)))


def test_chain_method_validation():
    with pytest.raises(ValueError, match="chain_method"):
        MCMC(NUTS(model), chain_method="banana", **F64)
    with pytest.raises(ValueError, match="collective_adaptation"):
        MCMC(NUTS(model), chain_method="sequential", collective_adaptation=True, **F64)
    with pytest.raises(ValueError, match="chain_batch_size"):
        MCMC(NUTS(model), num_chains=4, chain_method="sequential", chain_batch_size=2, **F64)
    with pytest.raises(ValueError, match="collective_adaptation"):
        MCMC(NUTS(model), num_chains=4, chain_batch_size=2, collective_adaptation=True, **F64)
    with pytest.raises(ValueError, match="divide"):
        MCMC(NUTS(model), num_chains=6, chain_batch_size=4, **F64)
    with pytest.raises(ValueError, match="divide"):
        MCMC(NUTS(model), chain_groups=2, **F64)  # one chain cannot be tiled into two groups


def test_sequential_chain_method_samples():
    m = MCMC(NUTS(model), num_warmup=100, num_samples=200, num_chains=3, chain_method="sequential", **F64)
    m.run(0)
    s = m.get_samples(group_by_chain=True)
    assert s["x"].shape == (3, 200)
    x = m.get_samples()["x"].numpy()
    assert abs(x.mean()) < 0.2 and abs(x.std() - 1.0) < 0.2
    # chains must differ (each batch draws on from the run's stream)
    assert not np.allclose(s["x"][0].numpy(), s["x"][1].numpy())
    assert m._adapt_info["step_size"].shape == (3,)
    assert m.get_extra_fields(group_by_chain=True)["accept_prob"].shape == (3, 200)


def test_chain_batches_run_whole_batches_in_turn():
    """``chain_batch_size=2`` over 4 chains: two vectorized runs one after
    another; the first batch is the 2-chain run from the same seed and
    starts, bit for bit."""
    init = {"x": torch.tensor([0.1, -0.2, 0.3, 0.5], dtype=torch.float64),
            "s": torch.tensor([1.0, 0.5, 2.0, 1.5], dtype=torch.float64)}
    kw = dict(num_warmup=40, num_samples=30, **F64)
    batched = MCMC(HMC(model, trajectory_length=1.0), num_chains=4, chain_batch_size=2, **kw).run(
        5, init_params=init)
    alone = MCMC(HMC(model, trajectory_length=1.0), num_chains=2, **kw).run(
        5, init_params={k: v[:2] for k, v in init.items()})
    xb, xa = batched.get_samples(group_by_chain=True)["x"], alone.get_samples(group_by_chain=True)["x"]
    assert xb.shape == (4, 30) and torch.equal(xb[:2], xa)
    assert not torch.equal(xb[2:], xa)
    assert [tuple(v.shape[:1]) for v in batched.post_warmup_state["state"]] == [(4,)] * 8


def test_parallel_on_one_device_runs_vectorized(capsys):
    kw = dict(num_warmup=30, num_samples=20, num_chains=2, **F64)
    par = MCMC(NUTS(model), chain_method="parallel", **kw).run(3)
    vec = MCMC(NUTS(model), **kw).run(3)
    assert torch.equal(par.get_samples()["x"], vec.get_samples()["x"])
    out = capsys.readouterr()
    assert out.out == "" and "running vectorized" in out.err


def test_collective_adaptation_matches():
    mcmc = MCMC(NUTS(std_normal_model), num_warmup=200, num_samples=300, num_chains=4,
                collective_adaptation=True, **F64)
    mcmc.run(4)
    x = mcmc.get_samples()["x"].numpy()
    assert np.all(np.abs(x.mean(0)) < 0.15)
    ss = mcmc._adapt_info["step_size"]
    assert ss.shape == (4,) and bool((ss > 0).all())
    inv = mcmc._adapt_info["inverse_mass_matrix"]
    assert inv.shape == (4, 3) and all(torch.equal(inv[0], inv[c]) for c in range(4))
    own = MCMC(NUTS(std_normal_model), num_warmup=200, num_samples=5, num_chains=4, **F64).run(4)
    assert not torch.equal(own._adapt_info["inverse_mass_matrix"][0], own._adapt_info["inverse_mass_matrix"][1])


def test_progress_bar_writes_to_stderr_only(capsys):
    m = MCMC(NUTS(model), num_warmup=20, num_samples=20, num_chains=2, progress_bar=True, **F64).run(1)
    out = capsys.readouterr()
    assert out.out == ""
    lines = out.err.strip().splitlines()
    assert len(lines) == 10 and lines[0].startswith("[mcmc] warmup step 4/40") and "divergences" in lines[0]
    assert lines[-1].startswith("[mcmc] sample step 40/40")
    # the progress line's divergence count is one more read a segment (of a
    # tenth of the run)
    quiet = MCMC(NUTS(model), num_warmup=20, num_samples=20, num_chains=2, max_steps_per_call=4, **F64).run(1)
    assert m.host_reads == quiet.host_reads + 10
    assert torch.equal(m.get_samples()["x"], quiet.get_samples()["x"])


def test_unsupported_keywords_raise():
    with pytest.raises(ValueError, match="jit_model_args"):
        MCMC(NUTS(model), jit_model_args=True, **F64)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        MCMC(NUTS(model), mesh=object(), **F64)
    with pytest.raises(ValueError, match="without a mesh"):
        MCMC(NUTS(model), mesh=create_mesh(1), chain_batch_size=1, **F64)
    with pytest.raises(ValueError, match="chain_groups"):
        MCMC(NUTS(model), mesh=create_mesh(1), num_chains=2, chain_groups=2, **F64)
    assert NUTS(model, init_strategy=None).init_strategy is None


def _args(**kw):
    return SimpleNamespace(warmup=20, samples=10, chains=2, thinning=2, target_accept=0.8, max_tree_depth=6, **kw)


@pytest.mark.parametrize("extra", [{}, dict(max_steps_per_call=7, chain_scheduler="sync")], ids=["defaults", "from-args"])
def test_examples_and_bench_keyword_sets_run(extra, capsys):
    """The keyword sets of ``examples/utils.py``'s runners (``progress_bar``,
    ``max_steps_per_call`` and ``chain_scheduler`` from ``args``) and of
    ``bench.py`` (``leapfrogs_per_round``, ``progress_bar``,
    ``max_steps_per_call=25``) run on the port, plus ``device``/``dtype``."""
    args = _args(**extra)
    mcmc = MCMC(
        NUTS(model, target_accept_prob=getattr(args, "target_accept", 0.8),
             max_tree_depth=getattr(args, "max_tree_depth", 10)),
        num_warmup=args.warmup,
        num_samples=args.samples,
        num_chains=args.chains,
        thinning=args.thinning,
        progress_bar=True,
        max_steps_per_call=getattr(args, "max_steps_per_call", None),
        chain_scheduler=getattr(args, "chain_scheduler", "auto"),
        **F64,
    )
    mcmc.run(args.warmup)
    assert mcmc.get_samples(group_by_chain=True)["x"].shape == (2, 10)
    bench = MCMC(NUTS(model, dense_mass=True, max_tree_depth=6, target_accept_prob=0.8), num_warmup=20,
                 num_samples=10, num_chains=2, leapfrogs_per_round=None, progress_bar=True, max_steps_per_call=25,
                 **F64).run(0)
    assert bench.get_samples()["x"].shape == (20,)
    assert capsys.readouterr().out == ""
