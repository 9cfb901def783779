"""Config-driven pipeline runner.

Counterpart of ``gwinferno_tpu/pipeline/cli.py``.  Run from a shell as

    python -m gwinferno_tpu_torch.pipeline.cli config.yml [--inspect] [--rngkey N] [--device cpu] [--dtype float64]

It parses the YAML config, builds the hierarchical model, loads the catalog
named by ``data.pe_inj_file``, runs the ``sampler`` block (NUTS or HMC) on the card
(on the CPU only when asked), prints the posterior summary and writes
``{outdir}/{label}_posterior_samples.h5`` and a trace plot.

:func:`run_config` carries the run itself on an already-parsed reader and
in-memory banks, so a caller without PyYAML or h5py (or with a catalog made
in memory) runs the same path; :func:`run_inference` wraps it with the
config parser, the catalog loader and the writers.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..device import resolve_device
from ..infer import MCMC
from ..postprocess.plot import plot_trace
from ..utils.prof import Timer
from .analysis import NP_KERNEL_MAP
from .analysis import construct_hierarchical_model
from .parser import ConfigReader
from .parser import load_model_from_python_file
from .utils import load_pe_and_injections_as_dict
from .utils import posterior_dict_to_xarray
from .utils import to_tensors

__all__ = ["DETERMINISTIC_SITES", "model_from_reader", "run_config", "run_inference", "main"]

# the deterministic sites the posterior file holds beside the samples
DETERMINISTIC_SITES = ("rate", "surveyed_hypervolume", "detection_efficiency", "log_nEff_inj")


def model_from_reader(reader):
    """The model of a parsed config: the ``python_file`` model, or the
    hierarchical model of its model and prior blocks."""
    if "file_path" in reader.models:
        return load_model_from_python_file(reader.models.pop("file_path"))
    return construct_hierarchical_model(reader.models, reader.priors, **(reader.likelihood_kwargs or {}))


def run_config(reader, pedict, injdict, constants, rng_seed=0, device=None, dtype=torch.float32, model=None,
               timer=None):
    """Run the sampler block of a parsed config on in-memory banks.

    ``pedict`` ``{param: (E, S)}`` and ``injdict`` ``{param: (N,)}`` (numpy
    or tensors, ``prior`` among the keys) go to ``device`` (CUDA unless
    asked otherwise) in ``dtype``; ``constants`` holds ``total_inj``,
    ``nObs`` and ``obs_time``.  Prints the posterior summary.  Returns
    ``(mcmc, posterior)``, the posterior holding every sample site and
    :data:`DETERMINISTIC_SITES`, ``(num_samples * num_chains, ...)`` each.
    """
    timer = timer or Timer()
    dev = resolve_device(device)
    model = model if model is not None else model_from_reader(reader)
    samps, injs = to_tensors(pedict, dev, dtype), to_tensors(injdict, dev, dtype)
    sampler_conf = reader.sampler_conf or {}
    kernel = NP_KERNEL_MAP[sampler_conf.get("kernel", "NUTS")](model, **(sampler_conf.get("kernel_kwargs") or {}))
    mcmc = MCMC(kernel, device=dev, dtype=dtype, **(sampler_conf.get("mcmc_kwargs") or {}))
    with timer("mcmc (warmup+sample)"):
        mcmc.run(rng_seed, samps, injs, constants["total_inj"], constants["nObs"], constants["obs_time"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    mcmc.print_summary()
    posterior = dict(mcmc.get_samples())
    posterior.update(mcmc.get_deterministic(site_names=set(DETERMINISTIC_SITES)))
    return mcmc, posterior


def run_inference(config_file, inspect=False, rng_seed=0, device=None, dtype=torch.float32):
    """Parse ``config_file``, load its catalog, run it (:func:`run_config`)
    and write the posterior file and the trace plot into the config's
    ``outdir``.  With ``inspect`` only the parsed config is printed and
    None returned.  Returns the MCMC run."""
    timer = Timer()
    reader = ConfigReader()
    reader.parse(config_file)
    model = model_from_reader(reader)
    if inspect:
        print(f"label: {reader.label}  outdir: {reader.outdir}")
        print(f"models: {list(reader.models)}")
        print(f"sampling params: {reader.sampling_params}")
        print(f"sampler: {reader.sampler_conf}")
        return None

    data_conf = reader.data_conf or {}
    pe_inj_file = data_conf.get("pe_inj_file")
    if pe_inj_file is None:
        raise ValueError("config data block must provide 'pe_inj_file' (pe+injection handoff artifact)")
    with timer("load_data"):
        pedict, injdict, constants, _ = load_pe_and_injections_as_dict(pe_inj_file, ignore=data_conf.get("ignore"))
    mcmc, posterior = run_config(reader, pedict, injdict, constants, rng_seed=rng_seed, device=device, dtype=dtype,
                                 model=model, timer=timer)

    os.makedirs(reader.outdir, exist_ok=True)
    out = os.path.join(reader.outdir, f"{reader.label}_posterior_samples.h5")
    posterior_dict_to_xarray(posterior).to_hdf5(out)
    print(f"posterior saved: {out}")
    trace_path = plot_trace(mcmc.get_samples(group_by_chain=True), label=reader.label, result_dir=reader.outdir)
    if trace_path:
        print(f"trace plot saved: {trace_path}")
    timer.report()
    return mcmc


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run a config-driven population analysis.")
    parser.add_argument("config", type=str)
    parser.add_argument("--inspect", action="store_true", default=False)
    parser.add_argument("--rngkey", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = parser.parse_args(argv)
    run_inference(args.config, inspect=args.inspect, rng_seed=args.rngkey, device=args.device,
                  dtype=getattr(torch, args.dtype))


if __name__ == "__main__":
    main()
