#!/usr/bin/env python3
"""The port's parallel layer over several cards, one process per card.

Run from the repository root on a machine with W NVIDIA GPUs (W even):

    torchrun --nproc-per-node=W chip_parallel.py [--seed N]

(``python -m torch.distributed.run`` is the same launcher.)  Every rank
joins the NCCL process group (``parallel.distributed_initialize``, from the
launcher's environment), makes the smoke's full-width synthetic catalog
from ``--seed`` (``chip_smoke.make_catalog``) and the bench flat route at
16 chains, float32, and then:

1. on the default mesh ``create_mesh()`` ((2, 2) on 4 ranks): the PE
   samples and the injections split over ``data`` (``parallel.shard_catalog``),
   this rank's block of the chains over ``chain``; its potential and
   gradient against the unsharded ones of the same chains on the same card
   (the potential to 1e-5 relative, the gradient to 1e-4 of its largest
   component: float32 sums in another order), K1 twice a gradient;
2. with every rank on the chain axis (``create_mesh(W, chain_axis_size=W)``,
   16 / W chains a rank): the rank's potential and gradient at its rows of
   the starts against the unsharded 16-chain evaluation's rows (to 1e-5 /
   1e-4, float32 roundoff) and against the unsharded evaluation of those
   16 / W chains alone (bit for bit: the mesh adds nothing but the batch
   size); K1 on a random ``(16 * 69, 8000)`` bank, the rank's rows of the
   16-chain call against the call on those rows alone (its tiles follow the
   rows it is given, so the sums may take another order); then the first
   transition (no warmup, one sample) unsharded and on the chain axis: the
   step size (searched over all chains) and every chain's tree depth, step
   count and divergence bit for bit (the same momenta and directions), the
   draws within 1e-2 of each site's largest value (another row block would
   differ by O(1));
3. NUTS (dense mass, depth 6, the jittered starts, ``--warmup`` +
   ``--samples``, the async scheduler) three ways: unsharded on each card,
   on the default mesh, and on the chain axis; each run's wall time (host
   clock, the card synchronized), model runs and K1 launches on rank 0 (2 a
   model run), every site finite, and every rank holding the same gathered
   samples.  The chain-axis run draws the unsharded run's randomness; its
   samples are compared with the unsharded run's (max abs difference: equal
   bit for bit where each card's kernels sum in the same order at 16 / W
   chains as at 16, as on the CPU).

Rank 0 prints one line a check and, last, one JSON object with the numbers
and the cards' names and power limits; the other ranks print nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gwinferno_tpu_torch.infer import MCMC  # noqa: E402
from gwinferno_tpu_torch.infer import NUTS  # noqa: E402
from gwinferno_tpu_torch.parallel import create_mesh  # noqa: E402
from gwinferno_tpu_torch.parallel import distributed_initialize  # noqa: E402
from gwinferno_tpu_torch.parallel import shard_catalog  # noqa: E402
from gwinferno_tpu_torch.parallel import use_mesh  # noqa: E402
from gwinferno_tpu_torch.parallel.sharding import all_gather  # noqa: E402
from gwinferno_tpu_torch.ppl import ModelPotential  # noqa: E402


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nuts_run(model, mesh, args, init, dev, warmup=None, samples=None):
    """One NUTS run of the flat route (``--warmup`` + ``--samples`` unless
    given); returns ``(MCMC, wall s, model runs, K1 launches)`` on this
    rank."""
    mcmc = MCMC(NUTS(model, dense_mass=True, max_tree_depth=cs.MAX_TREE_DEPTH),
                num_warmup=args.warmup if warmup is None else warmup,
                num_samples=args.samples if samples is None else samples, num_chains=cs.N_CHAINS,
                chain_scheduler="async", mesh=mesh, device=dev, dtype=torch.float32)
    cs._zero_counts()
    sync(dev)
    t0 = time.perf_counter()
    with cs.ModelRuns() as runs:
        mcmc.run(args.seed, init_params=init)
        sync(dev)
    return mcmc, time.perf_counter() - t0, runs.runs, cs.DLSE_KERNEL.launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--samples", type=int, default=5)
    # the CPU (gloo) rehearsal's sizes; on the cards the defaults are the smoke's
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--events", type=int, default=cs.N_EVENTS)
    parser.add_argument("--pe-samples", type=int, default=cs.N_SAMPLES)
    parser.add_argument("--found", type=int, default=cs.N_FOUND)
    args = parser.parse_args(argv)

    distributed_initialize()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.empty(0, device=args.device).device
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    out = {"world": world, "backend": dist.get_backend()}
    if rank == 0 and dev.type == "cuda":
        out["cards"] = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                         capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")[:-1]
        cs.log(f"cards: {out['cards']}")
    try:
        pedict, injdict, constants = cs.make_catalog(args.seed, args.events, args.pe_samples, args.found)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        init = {k: v.to(dev, torch.float32)
                for k, v in cs.jittered_init(cs.N_CHAINS, gen, dtype=torch.float64).items()}
        z_model = cs.PowerlawRedshiftModel(pedict["redshift"], injdict["redshift"], device=dev, dtype=torch.float32)
        flat = cs.BenchModel(pedict, injdict, constants, z_model, device=dev, dtype=torch.float32)
        pot = ModelPotential(flat, device=dev, dtype=torch.float32)
        z0 = pot.unconstrain(init, cs.N_CHAINS)
        want = pot.value_and_grad(z0)

        # 1. the default mesh: data and chain axes
        mesh = create_mesh()
        pe, inj, zm = shard_catalog(mesh, pedict, injdict, z_model)
        rows = mesh.rows("chain", cs.N_CHAINS)
        with use_mesh(mesh):
            sharded = cs.BenchModel(pe, inj, constants, zm, device=dev, dtype=torch.float32)
            spot = ModelPotential(sharded, device=dev, dtype=torch.float32)
            cs._zero_counts()
            got = spot.value_and_grad(z0[rows])
            sync(dev)
            k1 = cs.DLSE_KERNEL.launches
        du, dg = cs._agree(got, (want[0][rows], want[1][rows]), f"rank {rank} {mesh.coords}")
        if dev.type == "cuda" and k1 != 2:  # the CPU rehearsal runs K1's plain version
            raise AssertionError(f"rank {rank}: K1 launched {k1} times a gradient, 2 expected")
        errs = torch.tensor([du, dg], dtype=torch.float64, device=dev)
        errs = all_gather(errs, dist.group.WORLD).amax(0)
        out["mesh"] = mesh.shape
        out["potential_rel_diff"], out["gradient_diff"] = float(errs[0]), float(errs[1])
        cs.log(f"  {mesh.shape} mesh, {pe['mass_1'].shape} PE and {inj['mass_1'].shape} injections a rank, "
               f"{rows.stop - rows.start} chains a rank: potential rel diff {out['potential_rel_diff']:.2e}, "
               f"gradient diff {out['gradient_diff']:.2e} of its largest component (max over ranks); K1 {k1} a "
               "gradient")

        # 2. the chain axis: the potential at this rank's rows, K1's row
        # count, the first transition
        chain_mesh = create_mesh(world, chain_axis_size=world)
        crows = chain_mesh.rows("chain", cs.N_CHAINS)
        alone = pot.value_and_grad(z0[crows])
        with use_mesh(chain_mesh):
            got = pot.value_and_grad(z0[crows])
        same = all(torch.equal(a, b) for a, b in zip(got, alone))
        du, dg = cs._agree(got, (want[0][crows], want[1][crows]), f"rank {rank} on the chain axis")
        if not same:
            raise AssertionError(f"rank {rank}: the chain-axis potential differs from the unsharded evaluation "
                                 "of its own chains")
        n_rows = cs.N_CHAINS * args.events
        block = slice(crows.start * args.events, crows.stop * args.events)
        x = 10.0 + 3.0 * torch.randn(n_rows, args.pe_samples, generator=gen, device=dev)
        k1_full = cs.double_logsumexp(x)
        k1_rows = cs.double_logsumexp(x[block].contiguous())
        k1_diff = max(float((a[block] - b).abs().max()) for a, b in zip(k1_full, k1_rows))
        geo = ""
        if dev.type == "cuda":
            g16, g4 = cs.fused.dlse_device_geometry(x), cs.fused.dlse_device_geometry(x[block].contiguous())
            geo = (f"; K1's tile {g16.tile} at {n_rows} rows, {g4.tile} at {block.stop - block.start} rows, "
                   f"{g16.n_tiles} and {g4.n_tiles} tiles a row")
        first = {}
        for label, m in (("unsharded", None), ("chain axis", chain_mesh)):
            first[label] = nuts_run(flat, m, args, init, dev, warmup=0, samples=1)[0]
        a, b = first["unsharded"], first["chain axis"]
        ea, eb = a.get_extra_fields(), b.get_extra_fields()
        same_fields = [k for k in ("tree_depth", "num_steps", "diverging") if torch.equal(ea[k], eb[k])]
        same_step = torch.equal(a.post_warmup_state["step_size"], b.post_warmup_state["step_size"])
        sa, sb = a.get_samples(), b.get_samples()
        draw_diff = max(float((sb[k] - sa[k]).abs().max() / sa[k].abs().max()) for k in sa)
        if not (same_step and len(same_fields) == 3 and draw_diff <= 1e-2):
            raise AssertionError(f"rank {rank}: the chain axis's first transition: step size equal {same_step}, "
                                 f"equal fields {same_fields}, draws max rel diff {draw_diff:.3e}")
        out["chain_axis"] = {"potential_rel_diff": du, "gradient_diff": dg, "equal_to_own_chains": same,
                             "k1_rows_max_abs_diff": k1_diff, "first_transition_draws_max_rel_diff": draw_diff,
                             "first_transition_tree_depths": ea["tree_depth"].tolist()}
        cs.log(f"  chain axis {world}, {crows.stop - crows.start} chains a rank (rank 0): potential and gradient "
               f"equal bit for bit to the unsharded evaluation of its chains alone; against the 16-chain "
               f"evaluation's rows: potential rel diff {du:.2e}, gradient diff {dg:.2e} of its largest component")
        cs.log(f"  K1 on ({n_rows}, {args.pe_samples}): rank 0's rows of the whole call against the call on its "
               f"{block.stop - block.start} rows alone: max abs diff {k1_diff:.3e}{geo}")
        cs.log(f"  first transition (no warmup, one sample): step size, tree depths {ea['tree_depth'].tolist()}, "
               f"steps and divergences equal bit for bit; draws max abs diff {draw_diff:.3e} of each site's "
               "largest value")

        # 3. NUTS unsharded, on the default mesh, on the chain axis
        runs = {"unsharded": (flat, None), f"mesh {mesh.shape['chain']}x{mesh.shape['data']}": (sharded, mesh),
                f"chain axis {world}": (flat, chain_mesh)}
        out["nuts"] = {}
        results = {}
        for label, (model, m) in runs.items():
            mcmc, wall, nruns, k1 = nuts_run(model, m, args, init, dev)
            x = torch.stack([v.double().sum() for v in mcmc.get_samples().values()])
            if not all(bool(torch.isfinite(v).all()) for v in mcmc.get_samples().values()):
                raise AssertionError(f"{label}: samples not finite")
            if dev.type == "cuda" and k1 != 2 * nruns:
                raise AssertionError(f"{label}: K1 launched {k1} times over {nruns} model runs")
            if m is not None:
                sums = all_gather(x, dist.group.WORLD)
                if not bool((sums == sums[0]).all()):
                    raise AssertionError(f"{label}: the ranks hold different samples")
            results[label] = mcmc
            out["nuts"][label] = {"wall_s": wall, "model_runs": nruns, "k1_launches": k1}
            cs.log(f"  NUTS {label}: {wall:.2f} s, {nruns} model runs on rank 0, K1 {k1}, "
                   f"{args.warmup} + {args.samples} transitions, 16 chains")
        base = results["unsharded"].get_samples()
        chain_run = results[f"chain axis {world}"].get_samples()
        diff = max(float((chain_run[k] - base[k]).abs().max()) for k in base)
        out["chain_axis_max_abs_diff"] = diff
        cs.log(f"  chain-axis run against the unsharded run: samples max abs diff {diff:.3e}")
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
