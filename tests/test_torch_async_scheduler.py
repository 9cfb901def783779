"""The port's continuous-batching (async) chain scheduler against its sync
one, mirroring the JAX package's ``tests/infer/test_async_scheduler.py``
case by case on the same funnel-like model (depth 6, 4 chains; float64 on
the CPU; starts drawn with numpy from a seed).

The async scheduler is a reschedule: its samples, extra fields, step size,
inverse mass matrix and final generator state equal the sync engine's bit
for bit, for diagonal and dense mass, every ``leapfrogs_per_round``,
segmented runs, a resume, and collective adaptation at a fixed step size.
The JAX package holds dense mass only to ULPs (its two programs fuse the
batched Cholesky differently); the port runs the same eager operations in
both schedulers, so it holds dense mass bit for bit too.  The statistical
cases (collective with an adaptive step size, ``chain_groups``, chain
batches) use the JAX test's limits.
``test_async_collective_sharded_matches_unsharded``, which needs a chain
mesh of several processes, is mirrored in ``tests/test_torch_parallel.py``."""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.infer import HMC, MCMC, NUTS
from gwinferno_tpu_torch.ppl import distributions as td
from gwinferno_tpu_torch.ppl.handlers import Messenger

F64 = dict(device="cpu", dtype=torch.float64)
NUM_CHAINS, WARMUP, SAMPLES = 4, 60, 40


def funnelish_model():
    # varying curvature: strongly varying tree depths across chains and
    # steps, the regime the async scheduler exists for; x's scale depends on
    # log_s, written as a factor over a unit-normal site (a site's
    # distribution may not take another site's value in the port's PPL)
    log_s = ppl.sample("log_s", td.Normal(0.0, 1.0))
    x = ppl.sample("x", td.Normal(torch.zeros(4), torch.ones(4)))
    s = torch.exp(0.5 * log_s)[:, None]
    ppl.factor("funnel", (-0.5 * (x / s) ** 2 - torch.log(s) + 0.5 * x**2).sum(-1))


def std_normal_model():
    ppl.sample("x", td.Normal(torch.zeros(3), torch.ones(3)))


def _starts(seed=7, num_chains=NUM_CHAINS):
    rng = np.random.default_rng(seed)
    return {"log_s": torch.tensor(rng.uniform(-1.0, 1.0, num_chains)),
            "x": torch.tensor(rng.normal(0.0, 0.5, (num_chains, 4)))}


class Runs(Messenger):
    """Counts the model's runs by its ``funnel`` factor."""

    def __init__(self):
        super().__init__()
        self.runs = 0

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] == "funnel":
            self.runs += 1


@functools.lru_cache(maxsize=None)
def _run(scheduler, dense=False, adapt_step_size=True, num_warmup=WARMUP, num_samples=SAMPLES, **kw):
    """One run from the seed 7 and the numpy starts, its model runs counted;
    cached, since the sync runs are the baselines of several cases."""
    kernel = NUTS(funnelish_model, max_tree_depth=6, dense_mass=dense, adapt_step_size=adapt_step_size,
                  step_size=1.0 if adapt_step_size else 0.2)
    mcmc = MCMC(kernel, num_warmup=num_warmup, num_samples=num_samples, num_chains=NUM_CHAINS,
                chain_scheduler=scheduler, **kw, **F64)
    with Runs() as runs:
        mcmc.run(7, init_params=_starts())
    mcmc.model_runs = runs.runs
    return mcmc


def _assert_identical(a, b):
    sa, sb = a.get_samples(group_by_chain=True), b.get_samples(group_by_chain=True)
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ea, eb = a.get_extra_fields(), b.get_extra_fields()
    for k in ("num_steps", "tree_depth", "diverging", "accept_prob", "energy", "potential_energy"):
        assert ea[k].dtype == eb[k].dtype and torch.equal(ea[k], eb[k]), k
    for k in ("step_size", "inverse_mass_matrix", "mass_chol", "rng_key"):
        assert torch.equal(a.post_warmup_state[k], b.post_warmup_state[k]), k
    assert torch.equal(a.transition_steps, b.transition_steps)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_async_bitwise_equals_sync(dense):
    _assert_identical(_run("sync", dense), _run("async", dense))


@pytest.mark.parametrize("leapfrogs", [1, 2, 3, 8])
def test_leapfrogs_per_round_bitwise_identical(leapfrogs):
    """L masked leapfrogs a round only reschedule the work: the results
    equal the sync engine's (and so each other's) for every L."""
    _assert_identical(_run("sync"), _run("async", leapfrogs_per_round=leapfrogs))


def test_async_bitwise_equals_sync_segmented():
    """Segments (``max_steps_per_call``) cross the warmup schedule's windows
    at arbitrary points; the equivalence survives."""
    _assert_identical(_run("sync", max_steps_per_call=17), _run("async", max_steps_per_call=17))
    _assert_identical(_run("sync"), _run("sync", max_steps_per_call=17))


@pytest.mark.parametrize("leapfrogs", [1, 5])
def test_async_collective_bitwise_equals_sync_when_ss_fixed(leapfrogs):
    """With ``adapt_step_size=False`` the only adaptation is the pooled
    Welford mass matrix, whose async window-barrier close equals the lockstep
    collective engine's: the whole runs are equal, for every L."""
    kw = dict(adapt_step_size=False, collective_adaptation=True)
    _assert_identical(_run("sync", **kw), _run("async", leapfrogs_per_round=leapfrogs, **kw))


def test_async_resume_bitwise_equals_sync():
    """A run resumed from a sync run's ``post_warmup_state``: the sync and
    async continuations are equal."""
    saved = _run("sync").post_warmup_state
    out = []
    for scheduler in ("sync", "async"):
        m = MCMC(NUTS(funnelish_model, max_tree_depth=6), num_warmup=WARMUP, num_samples=30, num_chains=NUM_CHAINS,
                 chain_scheduler=scheduler, **F64)
        out.append(m.run(3, post_warmup_state=saved))
    _assert_identical(*out)
    assert "warmup" not in out[1].timings


@pytest.mark.parametrize(
    "scheduler, kw",
    [("sync", {}), ("async", {}), ("async", dict(leapfrogs_per_round=4)), ("sync", dict(max_steps_per_call=17)),
     ("async", dict(max_steps_per_call=17)), ("async", dict(leapfrogs_per_round=3, max_steps_per_call=17))],
    ids=["sync", "async", "async-L4", "sync-segmented", "async-segmented", "async-L3-segmented"],
)
def test_model_runs_and_host_reads_match_the_formulas(scheduler, kw):
    """The loop's model runs: sync ``sum_t max_c n``; async ``max_c sum_t n``
    at L = 1, in general ``sum_seg max_c sum_t L ceil(n / L)``
    (``chip_smoke.loop_model_runs``).  The other runs (the site probe, the
    starts' gradient, the step-size search) are those of a run with no
    transitions.  Host reads: one a leapfrog round (sync), one a round
    (async)."""
    m = _run(scheduler, **kw)
    extras = _run(scheduler, num_warmup=0, num_samples=0, **kw)
    assert extras.transition_steps.shape == (0, NUM_CHAINS) and extras.host_reads == 0
    L = kw.get("leapfrogs_per_round", 1)
    loop = chip_smoke.loop_model_runs(m.transition_steps, scheduler, L, kw.get("max_steps_per_call"))
    assert m.model_runs == extras.model_runs + loop
    assert m.host_reads == loop // L
    if scheduler == "async" and not kw:
        steps = m.transition_steps
        assert loop == int(steps.sum(0).max()) < chip_smoke.loop_model_runs(steps, "sync")


def test_async_collective_adaptive_ss_statistics():
    """Async with collective adaptation and an adaptive (per-chain) step
    size: valid posterior statistics, and one pooled mass matrix for every
    chain.  Not comparable bit for bit with the sync collective engine,
    whose dual averaging follows the chains' mean accept probability (the
    documented deviation)."""
    m = MCMC(NUTS(std_normal_model, max_tree_depth=6), num_warmup=250, num_samples=400, num_chains=4,
             collective_adaptation=True, chain_scheduler="async", **F64)
    m.run(3)
    x = m.get_samples()["x"].numpy()
    assert np.all(np.abs(x.mean(0)) < 0.15)
    assert np.all(np.abs(x.std(0) - 1.0) < 0.15)
    inv = m.post_warmup_state["inverse_mass_matrix"]
    assert all(torch.equal(inv[0], inv[c]) for c in range(4))


def test_async_grouped_leapfrogs_statistics():
    """``chain_groups=2`` under async runs each round's leapfrogs as two
    sub-batches of two lanes: valid statistics, no divergences, and the
    same draws from the same seed.  The port's per-lane arithmetic does not
    depend on the batch, so the grouped run here equals the ungrouped one;
    a card's kernels may pick another geometry for the smaller batch."""

    def run(groups):
        m = MCMC(NUTS(std_normal_model, max_tree_depth=6), num_warmup=250, num_samples=400, num_chains=4,
                 chain_scheduler="async", chain_groups=groups, **F64)
        return m.run(11)

    m = run(2)
    x = m.get_samples()["x"].numpy()
    assert np.all(np.abs(x.mean(0)) < 0.15)
    assert np.all(np.abs(x.std(0) - 1.0) < 0.15)
    assert int(m.get_extra_fields()["diverging"].sum()) == 0
    np.testing.assert_array_equal(x, run(1).get_samples()["x"].numpy())


def test_chain_batch_size_dispatch():
    """``chain_batch_size=2`` over 4 chains under async: two 2-chain batches
    in turn, each async (its batch has 2 chains); shapes and statistics, and
    the first batch is the 2-chain run from the same seed and starts, bit
    for bit, while the second draws on from the stream."""
    rng = np.random.default_rng(9)
    init = {"x": torch.tensor(rng.normal(0.0, 0.5, (4, 3)))}
    kw = dict(num_warmup=200, num_samples=300, **F64)
    m = MCMC(NUTS(std_normal_model, max_tree_depth=6), num_chains=4, chain_batch_size=2, **kw)
    assert m._resolve_scheduler(2) is True
    m.run(9, init_params=init)
    xs = m.get_samples(group_by_chain=True)["x"]
    assert xs.shape == (4, 300, 3)
    flat = xs.reshape(-1, 3).numpy()
    assert np.all(np.abs(flat.mean(0)) < 0.15)
    assert np.all(np.abs(flat.std(0) - 1.0) < 0.15)
    alone = MCMC(NUTS(std_normal_model, max_tree_depth=6), num_chains=2, **kw).run(
        9, init_params={"x": init["x"][:2]})
    assert torch.equal(xs[:2], alone.get_samples(group_by_chain=True)["x"])
    assert not torch.allclose(xs[0], xs[2])


@pytest.mark.parametrize(
    "kernel, kw, want",
    [(NUTS, dict(num_chains=4), True), (NUTS, dict(num_chains=4, chain_method="parallel"), False),
     (HMC, dict(num_chains=4), False), (NUTS, dict(num_chains=2, chain_method="sequential"), False),
     (NUTS, dict(num_chains=4, collective_adaptation=True), False), (NUTS, dict(num_chains=1), False)],
    ids=["nuts", "parallel", "hmc", "sequential", "collective", "one-chain"],
)
def test_auto_resolves_the_scheduler(kernel, kw, want):
    m = MCMC(kernel(funnelish_model), **kw, **F64)
    assert m._resolve_scheduler(m._batch_size()) is want


def test_async_guards():
    with pytest.raises(ValueError, match="make_tree_ops"):
        MCMC(HMC(funnelish_model), num_chains=4, chain_scheduler="async", **F64)._resolve_scheduler(4)
    m = MCMC(NUTS(funnelish_model), num_chains=2, chain_method="sequential", chain_scheduler="async", **F64)
    with pytest.raises(ValueError, match="batched chain axis"):
        m._resolve_scheduler(1)
    with pytest.raises(ValueError, match="chain_scheduler"):
        MCMC(NUTS(funnelish_model), chain_scheduler="fast", **F64)


def test_leapfrogs_per_round_guards():
    with pytest.raises(ValueError, match=">= 1"):
        MCMC(NUTS(funnelish_model), num_chains=4, leapfrogs_per_round=0, **F64)
    m = MCMC(NUTS(funnelish_model), num_chains=4, chain_scheduler="sync", leapfrogs_per_round=4, **F64)
    with pytest.raises(ValueError, match="async"):
        m._resolve_leapfrogs_per_round(False)
    assert m._resolve_leapfrogs_per_round(True) == 4
    assert MCMC(NUTS(funnelish_model), num_chains=4, **F64)._resolve_leapfrogs_per_round(True) == 1
    with pytest.raises(ValueError, match="async"):  # auto resolves to sync for one chain, at run time
        MCMC(NUTS(funnelish_model), num_warmup=2, num_samples=2, leapfrogs_per_round=2, **F64).run(0)


def test_chain_batch_size_and_groups_guards():
    with pytest.raises(ValueError, match="divide"):
        MCMC(NUTS(funnelish_model), num_chains=4, chain_batch_size=3, **F64)
    with pytest.raises(ValueError, match="collective_adaptation"):
        MCMC(NUTS(funnelish_model), num_chains=4, chain_batch_size=2, collective_adaptation=True, **F64)
    with pytest.raises(ValueError, match="alternative tilings"):
        MCMC(NUTS(funnelish_model), num_chains=4, chain_batch_size=2, chain_groups=2, **F64)
    with pytest.raises(ValueError, match="divide"):
        MCMC(NUTS(funnelish_model), num_chains=6, chain_groups=4, **F64)
