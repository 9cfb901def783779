"""The parallel layer (``gwinferno_tpu_torch/parallel``) on the CPU: process
meshes on ``torch.distributed`` with gloo ranks spawned here
(``file://`` init under ``tmp_path``), mirroring ``tests/test_parallel.py``,
``tests/infer/test_nuts.py::test_smc_sharded_*`` and
``tests/infer/test_async_scheduler.py::test_async_collective_sharded_matches_unsharded``.

Two spawns (2 and 4 ranks, started together by one module fixture that
several tests read); while the ranks run, this process runs the unsharded
references.  Tolerances (float64):
- the mesh layout against the JAX ``create_mesh`` on 8 virtual devices:
  equal;
- ``sharded_logsumexp`` against ``torch.logsumexp``: value and gradient
  rtol 1e-12;
- the data-sharded potential and gradient (the bench model's flat,
  chunked and streamed routes with the PE samples and the injections
  split over 2 and 4 ranks; the JAX test's hierarchical model with its
  events and injections split, linear weights) against the unsharded one:
  rtol 1e-12, the gradient with atol 1e-12 of its largest component; the
  unsharded hierarchical potential against the JAX package's: rtol 1e-12;
- chain-sharded MCMC (sync, async, collective adaptation under both, and
  ``chain_method="parallel"``) against unsharded: equal bit for bit, which
  implies the JAX test's ``atol=rtol=1e-4`` and means within 1e-6;
- SMC sharded against unsharded: particles and log evidence rtol = atol
  1e-8, the same ``num_stages`` (the JAX test's limits);
- async collective adaptation on a chain-sharded mesh: every chain carries
  the same pooled mass matrix; moments within 0.12 of the unsharded run's
  (the JAX test's invariants), and here equal bit for bit.
"""

import os
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.convert import params_from_jax
from gwinferno_tpu_torch.infer import MCMC
from gwinferno_tpu_torch.infer import NUTS
from gwinferno_tpu_torch.infer import SMC
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel
from gwinferno_tpu_torch.parallel import create_mesh
from gwinferno_tpu_torch.parallel import distributed_initialize
from gwinferno_tpu_torch.parallel import mesh_layout
from gwinferno_tpu_torch.parallel import shard_catalog
from gwinferno_tpu_torch.parallel import shard_data_dict
from gwinferno_tpu_torch.parallel import sharded_logsumexp
from gwinferno_tpu_torch.parallel import use_mesh
from gwinferno_tpu_torch.parallel.sharding import all_gather
from gwinferno_tpu_torch.pipeline.analysis import hierarchical_likelihood
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT
from gwinferno_tpu_torch.pipeline.bench_model import INIT_JITTER
from gwinferno_tpu_torch.pipeline.bench_model import BenchModel
from gwinferno_tpu_torch.ppl import ModelPotential
from gwinferno_tpu_torch.ppl import distributions as dist_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "tests", "data", "pe_inj_synthetic.h5")
F64 = dict(device="cpu", dtype=torch.float64)


# ----------------------------------------------------------------- spawning


def _rank_main(fn, rank, world, init, queue, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        distributed_initialize(init, world, rank)  # a group is up: a no-op
        # plain pickle: tensors travel by value, not as shared memory that
        # the rank's exit would release before this process reads it
        queue.put((rank, None, pickle.dumps(fn(rank, *args))))
    except BaseException:
        queue.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _Ranks:
    """``world`` gloo ranks, each running ``fn(rank, *args)`` in a spawned
    process; :meth:`results` returns their results in rank order."""

    def __init__(self, fn, world, tmp_path, *args):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        init = f"file://{tmp_path / 'dist_init'}"
        self.procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init, self.queue, args)) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=300):
        got = {}
        try:
            for _ in self.procs:
                rank, err, out = self.queue.get(timeout=timeout)
                if err is not None:
                    raise AssertionError(f"rank {rank} failed:\n{err}")
                got[rank] = pickle.loads(out)
        finally:
            for p in self.procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        assert all(p.exitcode == 0 for p in self.procs), [p.exitcode for p in self.procs]
        return [got[r] for r in sorted(got)]


# ----------------------------------------------------------------- problems


def _catalog_slice(n_events=12, n_samples=600, n_found=6000):
    from gwinferno_tpu_torch.pipeline.utils import load_pe_and_injections_as_dict

    # read directly with h5py, never through the conftest fixtures that run the generator
    pe, inj, const, _ = load_pe_and_injections_as_dict(CATALOG)
    pe = {k: np.ascontiguousarray(v[:n_events, :n_samples]) for k, v in pe.items()}
    inj = {k: np.ascontiguousarray(v[:n_found]) for k, v in inj.items()}
    return pe, inj, dict(const, nObs=n_events)


BENCH_ROUTES = {"flat": {}, "chunked": {"sample_chunks": 3}, "streamed": {"streamed": True}}


def _bench_potentials(mesh=None, events=False):
    """The bench model's potential and gradient at 3 jittered starts on
    every route, from this rank's shard of the catalog slice under ``mesh``
    (the PE banks along their sample axis, or with ``events`` along their
    event axis; the injections along theirs), or the whole slice."""
    pe, inj, const = _catalog_slice()
    rng = np.random.default_rng(2)
    params = {k: v + INIT_JITTER[k] * rng.uniform(-1, 1, 3) for k, v in FIDUCIAL_INIT.items()}
    zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **F64)
    if mesh is not None and events:
        pe = shard_data_dict(mesh, dict(pe, dVdz=zm.dVdzs[1]))
        inj = shard_data_dict(mesh, dict(inj, dVdz=zm.dVdzs[0]))
        zm.dVdzs = [inj.pop("dVdz"), pe.pop("dVdz")]
    elif mesh is not None:
        pe, inj, zm = shard_catalog(mesh, pe, inj, zm)
    out = {}
    with use_mesh(mesh):
        for route, kw in BENCH_ROUTES.items():
            model = BenchModel(pe, inj, const, zm, **kw, **F64)
            out[route] = ModelPotential(model, **F64).value_and_grad(params_from_jax(params, model, **F64))
    return out


N_OBS, N_SAMP, N_FOUND = 8, 32, 64


def _hier_data():
    """``tests/test_parallel.py::test_sharded_hierarchical_step``'s data."""
    rng = np.random.default_rng(0)
    pe = {"m": rng.normal(1.0, 0.2, (N_OBS, N_SAMP)), "prior": rng.uniform(0.5, 1.5, (N_OBS, N_SAMP))}
    inj = {"m": rng.normal(1.0, 0.5, (N_FOUND,)), "prior": rng.uniform(0.5, 1.5, (N_FOUND,))}
    return ({k: torch.tensor(v) for k, v in pe.items()}, {k: torch.tensor(v) for k, v in inj.items()})


def hier_model(pe, inj):
    """The JAX test's hierarchical model (linear weights), with a chain
    axis."""
    mu = ppl.sample("mu", dist_.Normal(torch.tensor(1.0, dtype=torch.float64), 1.0))
    sig = ppl.sample("sig", dist_.HalfNormal(torch.tensor(1.0, dtype=torch.float64)))

    def w(d, lead):
        shape = (-1,) + (1,) * lead
        return torch.exp(dist_.Normal(mu.reshape(shape), sig.reshape(shape)).log_prob(d["m"])) / d["prior"]

    hierarchical_likelihood(
        w(pe, 2), w(inj, 1), total_inj=10.0 * N_FOUND, Nobs=N_OBS, Tobs=1.0,
        surveyed_hypervolume=1e9, marginalize_selection=False, min_neff_cut=False,
    )


# unconstrained (mu, sig, unscaled_rate) of 3 chains
HIER_Z = torch.tensor([[0.1, -0.5, 2.0], [-0.2, -1.0, 2.2], [0.3, -0.1, 1.9]], dtype=torch.float64)


def _hier_potential(mesh=None):
    pe, inj = _hier_data()
    if mesh is not None:
        pe, inj = shard_data_dict(mesh, pe), shard_data_dict(mesh, inj)
    with use_mesh(mesh):
        return ModelPotential(hier_model, (pe, inj), **F64).value_and_grad(HIER_Z)


def _lse_case():
    g = torch.Generator().manual_seed(0)
    return torch.randn(16, 64, generator=g, dtype=torch.float64)


def _data_checks(mesh):
    """This rank's data-axis results on ``mesh`` (its chain axis of size
    1): placement, ``sharded_logsumexp`` and its gradient, the
    data-sharded potentials."""
    world = mesh.shape["data"]
    placed = shard_data_dict(mesh, {"x": torch.arange(16 * 10).reshape(16, 10), "n": torch.tensor(3.0)})
    refused = {}
    cases = (("7 injections", {"y": torch.zeros(7)}, 0), ("a 1-D bank on axis 1", {"y": torch.zeros(8)}, 1),
             ("7 PE samples on axis 1", {"y": torch.zeros(4, 7)}, 1))
    for name, data, axis in cases:
        try:
            shard_data_dict(mesh, data, axis=axis)
        except ValueError as e:
            refused[name] = str(e)
    xs = _lse_case()[:, mesh.rows("data", 64)].clone().requires_grad_(True)
    with use_mesh(mesh):
        v = sharded_logsumexp(xs, "data", axis=1)
    (g,) = torch.autograd.grad(v.sum() / world, xs)
    g_full = torch.cat(all_gather(g, mesh.group("data")).unbind(0), dim=1)
    # summaries computed upstream that did not pass through summaries_over_data
    with use_mesh(mesh):
        try:
            hierarchical_likelihood(None, None, 10.0, 2, 1.0, surveyed_hypervolume=1.0, log=True,
                                    pe_summaries=(torch.zeros(2), torch.zeros(2), 5),
                                    inj_summaries=(torch.tensor(0.0), torch.tensor(0.0)))
        except ValueError as e:
            refused["unmerged summaries"] = str(e)
    return {"coords": mesh.coords, "shape": mesh.shape, "x": placed["x"], "n": placed["n"], "refused": refused,
            "lse": v.detach(), "lse_grad": g_full, "bench": _bench_potentials(mesh),
            "bench_events": _bench_potentials(mesh, events=True), "hier": _hier_potential(mesh)}


def gauss4_model():
    x = ppl.sample("x", dist_.Normal(torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64)))
    ppl.sample("y", dist_.Normal(x.sum(-1), 1.0), obs=torch.tensor(0.5, dtype=torch.float64))


def correlated_gaussian_model():
    """``tests/test_torch_smc.py``'s model: y | x ~ N(0.9 x, sqrt(0.19))."""
    x = ppl.sample("x", dist_.Normal(0.0, 1.0))
    y = ppl.sample("y", dist_.Normal(0.0, 1.0))
    ppl.factor("y_given_x", -0.5 * (y - 0.9 * x) ** 2 / 0.19 - 0.5 * np.log(0.19) + 0.5 * y**2)


MCMC_CASES = {
    "sync": dict(chain_scheduler="sync"),
    "async": dict(chain_scheduler="async"),
    "collective sync": dict(chain_scheduler="sync", collective_adaptation=True),
    "collective async": dict(chain_scheduler="async", collective_adaptation=True),
}


def _chain_runs(mesh, parallel=False):
    """The chain-axis runs: ``MCMC_CASES`` at 20 + 10 transitions of 4
    chains (the warmup holds a slow window, so collective adaptation pools
    once), ``chain_method="parallel"`` and SMC (512 particles, 3 mutation
    steps)."""
    kw = dict(num_warmup=20, num_samples=10, num_chains=4, **F64)
    out = {}
    for name, case in MCMC_CASES.items():
        m = MCMC(NUTS(gauss4_model, max_tree_depth=6), mesh=mesh, **case, **kw).run(5)
        out[name] = (m.get_samples()["x"], m.post_warmup_state["inverse_mass_matrix"],
                     m.post_warmup_state["step_size"])
    if parallel:
        m = MCMC(NUTS(gauss4_model, max_tree_depth=6), chain_method="parallel", chain_scheduler="sync", **kw).run(5)
        out["parallel"] = (m.mesh.shape, m.get_samples()["x"])
    r = SMC(correlated_gaussian_model, num_particles=512, num_mutation_steps=3, mesh=mesh, **F64).run(5)
    out["smc"] = (r.particles, r.log_evidence, r.num_stages)
    return out


def _two_rank(rank):
    """A rank of the 2-rank spawn: the data axis (a (1, 2) mesh), then the
    chain axis (a (2, 1) mesh)."""
    out = _data_checks(create_mesh(2, chain_axis_size=1))
    out["chain"] = _chain_runs(create_mesh(2, chain_axis_size=2), parallel=True)
    return out


def _four_rank(rank):
    """A rank of the 4-rank spawn: the data axis (a (1, 4) mesh), then the
    JAX test's sharded hierarchical step on the default (2, 2) mesh: events
    and injections over ``data``, chains over ``chain``, collective
    adaptation."""
    out = _data_checks(create_mesh(4, chain_axis_size=1))
    mesh = create_mesh(4)
    pe, inj = _hier_data()
    pe, inj = shard_data_dict(mesh, pe), shard_data_dict(mesh, inj)
    m = MCMC(NUTS(hier_model, max_tree_depth=5), num_warmup=25, num_samples=25, num_chains=2 * mesh.shape["chain"],
             collective_adaptation=True, mesh=mesh, **F64).run(1, pe, inj)
    out["nuts"] = (mesh.shape, m.get_samples()["mu"], m.post_warmup_state["inverse_mass_matrix"])
    return out


def _references():
    x = _lse_case().requires_grad_(True)
    lse = torch.logsumexp(x, 1)
    (lse_grad,) = torch.autograd.grad(lse.sum(), x)
    return {"lse": lse.detach(), "lse_grad": lse_grad, "bench": _bench_potentials(), "hier": _hier_potential(),
            "chain": _chain_runs(None)}


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """Both spawns, started together; this process's unsharded references
    run meanwhile.  Returns ``{world: (results in rank order,
    references)}``."""
    two = _Ranks(_two_rank, 2, tmp_path_factory.mktemp("two_ranks"))
    four = _Ranks(_four_rank, 4, tmp_path_factory.mktemp("four_ranks"))
    want = _references()
    return {2: (two.results(), want), 4: (four.results(), want)}


@pytest.fixture
def two_ranks(spawns):
    return spawns[2]


@pytest.fixture
def four_ranks(spawns):
    return spawns[4]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()), err_msg=what)


def test_create_mesh_shapes():
    """The layout (pure, no process group) against the JAX ``create_mesh``
    on the 8 virtual devices; a one-process mesh."""
    import jax

    from gwinferno_tpu.parallel import create_mesh as jcreate_mesh

    for n in (1, 2, 4, 8):
        for chain in (None, 1, n):
            want = jcreate_mesh(n, chain_axis_size=chain)
            assert mesh_layout(n, chain) == (want.shape["chain"], want.shape["data"]), (n, chain)
    assert len(jax.devices()) == 8
    with pytest.raises(ValueError, match="does not divide"):
        mesh_layout(6, 4)
    m = create_mesh(1)
    assert m.shape == {"chain": 1, "data": 1} and m.coords == {"chain": 0, "data": 0} and m.group("data") is None
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh(2)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_data_dict_placement(world, spawns):
    results = spawns[world][0]
    b = 16 // world
    for rank, r in enumerate(results):
        assert r["shape"] == {"chain": 1, "data": world} and r["coords"] == {"chain": 0, "data": rank}
        assert torch.equal(r["x"], torch.arange(16 * 10).reshape(16, 10)[rank * b : (rank + 1) * b])
        assert torch.equal(r["n"], torch.tensor(3.0))  # a scalar stays whole
        # an array that does not split would be reduced whole on every rank
        # and counted once a rank: it raises, naming axis=1 for PE banks
        shard_refusals = {k: v for k, v in r["refused"].items() if k != "unmerged summaries"}
        assert sorted(shard_refusals) == ["7 PE samples on axis 1", "7 injections", "a 1-D bank on axis 1"]
        assert all("axis=1" in msg for msg in shard_refusals.values())


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_logsumexp_matches_dense(world, spawns):
    results, want = spawns[world]
    for r in results:
        _close(r["lse"], want["lse"], "sharded_logsumexp")
        _close(r["lse_grad"], want["lse_grad"], "sharded_logsumexp gradient")


@pytest.mark.parametrize("world", [2, 4])
def test_data_sharded_potential_equals_unsharded(world, spawns):
    """C3: with the PE samples or the events, and the injections, split over
    the data axis (the bench model's three routes), or the events and the
    injections (the hierarchical model, linear weights), every rank's
    potential and gradient equal the unsharded ones; under the data axis
    the summaries seam refuses summaries that were not merged over it."""
    results, want = spawns[world]
    for rank, r in enumerate(results):
        assert "summaries_over_data" in r["refused"]["unmerged summaries"]
        for split in ("bench", "bench_events"):
            for route, (u, g) in r[split].items():
                assert bool((want["bench"][route][0].abs() < 1e30).all()), "the slice must sit off the walls"
                _close(u, want["bench"][route][0], f"{split} {route} potential, rank {rank}")
                _close(g, want["bench"][route][1], f"{split} {route} gradient, rank {rank}")
        _close(r["hier"][0], want["hier"][0], f"hierarchical potential, rank {rank}")
        _close(r["hier"][1], want["hier"][1], f"hierarchical gradient, rank {rank}")


def test_unsharded_hierarchical_potential_matches_jax():
    import jax
    import jax.numpy as jnp

    from gwinferno_tpu import ppl as jppl
    from gwinferno_tpu.pipeline.analysis import hierarchical_likelihood as jhier
    from gwinferno_tpu.ppl import distributions as jdist

    pe, inj = ({k: jnp.asarray(v.numpy()) for k, v in d.items()} for d in _hier_data())

    def jmodel():
        mu = jppl.sample("mu", jdist.Normal(1.0, 1.0))
        sig = jppl.sample("sig", jdist.HalfNormal(1.0))

        def w(d):
            return jnp.exp(jdist.Normal(mu, sig).log_prob(d["m"])) / d["prior"]

        jhier(w(pe), w(inj), total_inj=10.0 * N_FOUND, Nobs=N_OBS, Tobs=1.0, surveyed_hypervolume=1e9,
              marginalize_selection=False, min_neff_cut=False)

    def pot(zz):
        return jppl.potential_energy(jmodel, (), {}, {"mu": zz[0], "sig": zz[1], "unscaled_rate": zz[2]})

    u, g = jax.jit(jax.vmap(jax.value_and_grad(pot)))(jnp.asarray(HIER_Z.numpy()))
    hier = _hier_potential()
    _close(hier[0], torch.tensor(np.asarray(u)), "hierarchical potential against JAX")
    _close(hier[1], torch.tensor(np.asarray(g)), "hierarchical gradient against JAX")


def test_sharded_hierarchical_step(four_ranks):
    """The JAX test's assertions (finite samples of the right shape, mean
    within 0.5 of 1), every chain on the pooled mass matrix, and the same
    draws on every rank."""
    results, _ = four_ranks
    shape, s, mm = results[0]["nuts"]
    assert shape == {"chain": 2, "data": 2}
    assert tuple(s.shape) == (25 * 4,) and bool(torch.isfinite(s).all()) and abs(float(s.mean()) - 1.0) < 0.5
    assert all(torch.equal(mm[0], mm[c]) for c in range(4))
    for r in results[1:]:
        assert torch.equal(r["nuts"][1], s) and torch.equal(r["nuts"][2], mm)


@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_sharded_mcmc_matches_unsharded(case, two_ranks):
    """Chains sharded over 2 ranks: samples, inverse mass matrix and step
    size equal the unsharded run's bit for bit on every rank."""
    results, want = two_ranks
    for rank, r in enumerate(results):
        got = r["chain"][case]
        for a, b in zip(got, want["chain"][case]):
            assert torch.equal(a, b), (rank, case)
        np.testing.assert_allclose(got[0].numpy(), want["chain"][case][0].numpy(), atol=1e-4, rtol=1e-4)


def test_chain_method_parallel_shards_over_the_ranks(two_ranks):
    results, want = two_ranks
    for r in results:
        shape, x = r["chain"]["parallel"]
        assert shape == {"chain": 2, "data": 1} and torch.equal(x, want["chain"]["sync"][0])


def test_async_collective_sharded_matches_unsharded(two_ranks):
    """The JAX test's invariants: every chain carries the same pooled mass
    matrix, the moments and the mass matrices of the two runs agree (here
    the runs are equal bit for bit, see above)."""
    results, want = two_ranks
    xu, mmu, _ = want["chain"]["collective async"]
    for r in results:
        xs, mm, _ = r["chain"]["collective async"]
        np.testing.assert_allclose(xs.mean(0).numpy(), xu.mean(0).numpy(), atol=0.12)
        np.testing.assert_allclose(xs.std(0).numpy(), xu.std(0).numpy(), atol=0.12)
        assert all(torch.equal(mm[0], mm[c]) for c in range(4))
        np.testing.assert_allclose(mm[0].numpy(), mmu[0].numpy(), rtol=0.5)


def test_smc_sharded_matches_unsharded(two_ranks):
    results, want = two_ranks
    wp, we, ws = want["chain"]["smc"]
    for r in results:
        particles, evid, stages = r["chain"]["smc"]
        assert stages == ws
        for k in wp:
            np.testing.assert_allclose(particles[k].numpy(), wp[k].numpy(), rtol=1e-8, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(float(evid), float(we), rtol=1e-8)
    x = results[0]["chain"]["smc"][0]["x"].numpy()
    assert abs(x.mean()) < 0.2 and abs(x.std() - 1.0) < 0.2
