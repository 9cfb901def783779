#!/usr/bin/env python3
"""The port's NUTS schedulers on every route of ``chip_smoke.py``, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/torch_scheduler_routes.py [--seed N --warmup W --samples S]

On the smoke's full-width synthetic catalog (made from ``--seed``), each
route's NUTS run of the smoke (flat and streamed bench routes: 16 chains,
dense mass, the jittered starts; B-spline fused route: 8 chains, whitened,
target 0.9, diagonal mass, starts from the init search; config route:
``config_validation.yml``'s model, 4 chains, dense mass, the init search;
depth 6, float32) runs under the sync scheduler, the async one at L = 1
and at L = 4, then again in the reverse order.  Per run it prints the model
runs (counted by the ``log_likelihood`` site), the host reads, the loop's
model runs by the sync and the async formula for the run's ``num_steps``
(``chip_smoke.loop_model_runs``) and the wall time (host clock, card
synchronized); it checks that the three schedulers' runs are equal bit for
bit and that each run's model runs follow its formula.  The last line is one
JSON object with every run's numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gwinferno_tpu_torch.infer import MCMC  # noqa: E402
from gwinferno_tpu_torch.infer import NUTS  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import build_bspline_models  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import model_from_args  # noqa: E402
from gwinferno_tpu_torch.pipeline.cli import model_from_reader  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import to_tensors  # noqa: E402

SCHEDULERS = (("sync", "sync", None), ("async L=1", "async", 1), ("async L=4", "async", 4))


def routes(args, gen):
    """``{route: (kernel factory, chains, model args, init params)}``."""
    pedict, injdict, constants = cs.make_catalog(args.seed)
    dev, dtype = torch.device("cuda"), torch.float32
    z_model = cs.PowerlawRedshiftModel(pedict["redshift"], injdict["redshift"], device=dev, dtype=dtype)
    init = cs.flat_starts(cs.jittered_init(cs.N_CHAINS, gen, dtype=torch.float64))
    out = {}
    for name, streamed in (("flat", False), ("streamed", True)):
        model = cs.BenchModel(pedict, injdict, constants, z_model, device=dev, dtype=dtype, streamed=streamed)
        out[name] = (lambda m=model: NUTS(m, dense_mass=True, max_tree_depth=cs.MAX_TREE_DEPTH), cs.N_CHAINS, (), init)
    bargs = cs.bspline_args(args)
    models = build_bspline_models(pedict, injdict, bargs, device=dev, dtype=dtype)
    bmodel = model_from_args(pedict, injdict, constants, list(pedict), models, bargs)
    out["B-spline fused"] = (lambda: NUTS(bmodel, target_accept_prob=bargs.target_accept,
                                          max_tree_depth=bargs.max_tree_depth), bargs.chains, (), None)
    reader = cs.config_reader(args.warmup, args.samples)
    cmodel = model_from_reader(reader)
    cargs = (to_tensors(pedict, dev, dtype), to_tensors(injdict, dev, dtype), constants["total_inj"], constants["nObs"],
             constants["obs_time"])
    n_config = reader.sampler_conf["mcmc_kwargs"]["num_chains"]
    out["config"] = (lambda: NUTS(cmodel, dense_mass=True, max_tree_depth=cs.MAX_TREE_DEPTH), n_config, cargs, None)
    return out


def run_once(kernel, chains, model_args, init, args, scheduler, L):
    mcmc = MCMC(kernel, num_warmup=args.warmup, num_samples=args.samples, num_chains=chains, chain_scheduler=scheduler,
                leapfrogs_per_round=L, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cs.ModelRuns() as runs:
        mcmc.run(args.seed, *model_args, init_params=init)
        torch.cuda.synchronize()
    return mcmc, runs.runs, time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--samples", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_scheduler_routes: CUDA is not available; this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "warmup": args.warmup, "samples": args.samples, "routes": {}}
    for route, (make_kernel, chains, model_args, init) in routes(args, gen).items():
        outside = cs.outside_loop_runs(MCMC(make_kernel(), num_chains=chains, device="cuda"), args.seed, *model_args,
                                       init_params=init)
        rows, ref = [], None
        for label, scheduler, L in SCHEDULERS + SCHEDULERS[::-1]:
            mcmc, runs, wall = run_once(make_kernel(), chains, model_args, init, args, scheduler, L)
            steps = mcmc.transition_steps
            sync_loop, async_loop = cs.loop_model_runs(steps, "sync"), cs.loop_model_runs(steps, "async")
            loop = cs.loop_model_runs(steps, scheduler, L or 1)
            if runs != outside + loop:
                raise AssertionError(f"{route} {label}: {runs} model runs, want {outside} + {loop}")
            ref = ref or mcmc  # the first run, under sync
            diff = cs._same_run(mcmc, ref)
            if diff:
                raise AssertionError(f"{route} {label} differs from the sync run in {diff}")
            row = {"scheduler": label, "model_runs": runs, "outside_loop": outside, "host_reads": mcmc.host_reads,
                   "sync_formula": sync_loop, "async_formula": async_loop, "wall_s": wall,
                   "warmup_s": mcmc.timings["warmup"], "sample_s": mcmc.timings["sample"],
                   "mean_tree_depth": float(mcmc.get_extra_fields()["tree_depth"].double().mean())}
            rows.append(row)
            cs.log(f"{route}, {chains} chains, {label}: {runs} model runs ({outside} outside the loop), "
                   f"{mcmc.host_reads} host reads, loop by the sync formula {sync_loop}, by the async one "
                   f"{async_loop}, wall {wall:.3f} s (warmup {row['warmup_s']:.3f} s, sampling {row['sample_s']:.3f} s)")
        result["routes"][route] = {"chains": chains, "runs": rows}
        cs.log(f"{route}: the three schedulers' runs equal bit for bit")
        torch.cuda.empty_cache()
    cs.log(card)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
