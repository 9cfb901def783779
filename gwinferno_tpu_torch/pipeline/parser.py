"""Config-file and CLI parsing for analysis pipelines.

Counterpart of ``gwinferno_tpu/pipeline/parser.py``, with the same YAML
schema: top-level ``label`` / ``outdir`` / ``data`` / ``sampler`` /
``likelihood`` / ``models``; per source parameter a ``model`` (dotted path)
and ``hyper_params``, each either ``prior`` + ``prior_params`` (sampled) or
``value`` (pinned; a list is a vector); mixtures (any ``model`` containing
``"Mixture"``) with a ``mixture_dist`` block and ``component_{i}`` blocks;
``iid: {shared_parameter: x}`` aliases; the ``python_file`` escape hatch.

Dotted paths of the reference and of the JAX package (``gwinferno.*``,
``gwinferno_tpu.*``, ``numpyro.distributions``) resolve onto this package,
so the repo's configs run unmodified; a path that still names one of those
packages, or JAX, after the aliasing is rejected rather than imported.
``yaml`` is imported inside :meth:`ConfigReader.parse` only:
:meth:`ConfigReader.parse_dict` reads an already-loaded mapping.
"""

from __future__ import annotations

import importlib.util
from argparse import ArgumentParser
from dataclasses import dataclass
from importlib import import_module
from pathlib import Path

import torch

__all__ = [
    "PopModel",
    "PopPrior",
    "PopMixtureModel",
    "load_model_from_python_file",
    "load_dist_from_string",
    "ConfigReader",
    "load_base_parser",
]


@dataclass
class PopModel:
    """Config record: population-model class + hyperparameter names."""

    model: object
    params: list


@dataclass
class PopPrior:
    """Config record: hyperprior distribution class + its kwargs."""

    dist: object
    params: dict


class PopMixtureModel(PopModel):
    """Config record of a mixture parameter: the mixture class, the mixing
    distribution and its hyperparameter names, and the component classes
    with their hyperparameter names."""

    def __init__(self, model, mix_dist, mix_params, components, component_params):
        self.model = model
        self.mixing_dist = mix_dist
        self.mixing_params = mix_params
        self.components = components
        self.component_params = component_params


def load_model_from_python_file(path):
    """The ``model`` symbol of a user python file, loaded from its path.
    For this package the model is a torch model: it takes the data banks
    ``(samps, injs, Ninj, Nobs, Tobs)`` and its sites carry a chain axis."""
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.model


# reference-era and JAX-package module paths -> this package
_MODULE_ALIASES = {
    "gwinferno": "gwinferno_tpu_torch",
    "gwinferno_tpu": "gwinferno_tpu_torch",
    "numpyro.distributions": "gwinferno_tpu_torch.ppl.distributions",
    "gwinferno.numpyro_distributions": "gwinferno_tpu_torch.population_distributions",
    "gwinferno_tpu.numpyro_distributions": "gwinferno_tpu_torch.population_distributions",
}
# packages a dotted path must never import: each pulls JAX in
_FORBIDDEN_ROOTS = ("gwinferno", "gwinferno_tpu", "numpyro", "jax", "jaxlib")


def _alias_module(module):
    # the longest prefix wins, so "gwinferno.numpyro_distributions" is not
    # shadowed by the bare "gwinferno" alias
    for old in sorted(_MODULE_ALIASES, key=len, reverse=True):
        new = _MODULE_ALIASES[old]
        if module == old:
            return new
        if module.startswith(old + "."):
            return new + module[len(old):]
    return module


def load_dist_from_string(dist):
    """Resolve a dotted path to a class or callable, mapping the reference's
    and the JAX package's module names onto this package.  A path whose
    aliased module does not have the symbol falls back to the literal
    module only if that module is not one of the JAX-side packages."""
    module, _, symbol = dist.rpartition(".")
    aliased = _alias_module(module)
    for candidate in dict.fromkeys((aliased, module)):
        if candidate.split(".")[0] in _FORBIDDEN_ROOTS:
            continue
        try:
            return getattr(import_module(candidate), symbol)
        except (ImportError, AttributeError):
            continue
    raise ImportError(
        f"cannot resolve '{dist}' in this package (tried module '{aliased}'); "
        f"modules of {', '.join(_FORBIDDEN_ROOTS)} are not imported"
    )


def _as_tensor_if_list(v):
    """A YAML list becomes a float64 CPU tensor (a vector parameter; the
    model moves it to its device and dtype); scalars pass through."""
    return torch.tensor(v, dtype=torch.float64) if isinstance(v, list) else v


def _hyper_param_entries(prefix, hyper_block):
    """Rows ``(key, record, sampled)`` of one ``hyper_params`` mapping: a
    ``PopPrior`` for ``prior`` + ``prior_params``, the constant for
    ``value``; other blocks are skipped.  Keys are ``{prefix}_{name}``, the
    site names the model samples."""
    for name, spec in hyper_block.items():
        key = f"{prefix}_{name}" if prefix else name
        if "prior" in spec and "prior_params" in spec:
            cls = load_dist_from_string(spec["prior"])
            kwargs = {k: _as_tensor_if_list(v) for k, v in spec["prior_params"].items()}
            yield key, PopPrior(cls, kwargs), True
        elif "value" in spec:
            yield key, _as_tensor_if_list(spec["value"]), False


def _component_blocks(subd):
    """``(index, block)`` of a mixture's ``component_{i}`` blocks, from 1."""
    i = 1
    while f"component_{i}" in subd:
        yield i, subd[f"component_{i}"]
        i += 1


class ConfigReader:
    """Parse an analysis config into model and prior dicts and run settings.

    ``models``: source parameter -> :class:`PopModel` /
    :class:`PopMixtureModel`, or the name of the parameter an iid alias
    reuses; ``priors``: flat site name -> :class:`PopPrior` or pinned
    constant; ``sampling_params``: the sampled site names in declaration
    order.
    """

    def __init__(self):
        self.models = {}
        self.priors = {}
        self.sampling_params = []
        self.label = None
        self.outdir = None
        self.data_conf = None
        self.sampler_conf = None
        self.likelihood_kwargs = None

    def parse(self, yml_file):
        """Read a YAML config file (needs PyYAML)."""
        import yaml

        with open(yml_file, "r") as f:
            self.parse_dict(yaml.safe_load(f))

    def parse_dict(self, conf):
        """Read a config already loaded into a mapping."""
        self.label = conf.get("label", "label")
        self.outdir = conf.get("outdir", "./")
        self.data_conf = conf.get("data", {})
        self.sampler_conf = conf.get("sampler", {})
        self.likelihood_kwargs = conf.get("likelihood", {})
        self.construct_model_and_prior_dicts(conf["models"])

    def construct_model_and_prior_dicts(self, models_block):
        if "python_file" in models_block:
            self.models["file_path"] = models_block["python_file"]
            return
        for param, subd in models_block.items():
            builder = self.add_mixture_model if "Mixture" in subd["model"] else self.add_model
            builder(param, subd)

    def _record(self, entries):
        for key, record, sampled in entries:
            self.priors[key] = record
            if sampled:
                self.sampling_params.append(key)

    def add_prior(self, key, subd):
        """Register one hyperparameter block under the flat name ``key``."""
        self._record((key, rec, s) for _, rec, s in _hyper_param_entries("", {key: subd}))

    def add_model(self, param, subd):
        cls = load_dist_from_string(subd["model"])
        self.models[param] = PopModel(cls, list(subd["hyper_params"]))
        self._record(_hyper_param_entries(param, subd["hyper_params"]))
        if "iid" in subd:
            self.add_iid_model(param, subd["iid"]["shared_parameter"])

    def add_iid_model(self, param, shared_param):
        # the shared parameter reuses `param`'s model
        self.models[shared_param] = param

    def add_mixture_model(self, param, subd):
        mix_block = subd["mixture_dist"]
        self._record(_hyper_param_entries(f"{param}_mixture_dist", mix_block["hyper_params"]))
        components, component_params = [], []
        last_block = None
        for i, block in _component_blocks(subd):
            components.append(load_dist_from_string(block["model"]))
            component_params.append(list(block["hyper_params"]))
            self._record(_hyper_param_entries(f"{param}_component_{i}", block["hyper_params"]))
            last_block = block
        self.models[param] = PopMixtureModel(
            load_dist_from_string(subd["model"]),
            load_dist_from_string(mix_block["model"]),
            list(mix_block["hyper_params"]),
            components,
            component_params,
        )
        if last_block is not None and "iid" in last_block:
            self.add_iid_model(param, last_block["iid"]["shared_parameter"])


def load_base_parser():
    parser = ArgumentParser()
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--inj-file", type=str, default="./data/injections.h5")
    parser.add_argument("--outdir", type=str, default="results")
    parser.add_argument("--mmin", type=float, default=3.0)
    parser.add_argument("--mmax", type=float, default=100.0)
    parser.add_argument("--chains", type=int, default=1)
    parser.add_argument("--samples", type=int, default=1500)
    parser.add_argument("--thinning", type=int, default=1)
    parser.add_argument("--warmup", type=int, default=500)
    parser.add_argument("--skip-inference", action="store_true", default=False)
    return parser
