"""MCMC engine: warmup adaptation and sampling over a batched chain axis.

Counterpart of the synchronous vectorized engine of
``gwinferno_tpu/infer/mcmc.py``: every step runs one NUTS transition for all
chains (each chain's tree grows only while it is active), then per-chain
adaptation during warmup: dual-averaging step size, and a Welford mass
matrix (diagonal or dense) refreshed at the end of each Stan slow window.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device
from ..ppl import handlers
from ..ppl.infer_util import ModelPotential
from ..ppl.infer_util import find_valid_initial_params
from .diagnostics import print_summary
from .hmc_util import build_warmup_schedule
from .hmc_util import da_init
from .hmc_util import da_update
from .hmc_util import find_reasonable_step_size
from .hmc_util import identity_mass_matrix
from .hmc_util import mass_matrix_from_inverse
from .hmc_util import welford_covariance
from .hmc_util import welford_init
from .hmc_util import welford_update
from .nuts import nuts_init
from .nuts import nuts_transition

__all__ = ["MCMC"]

_EXTRA_FIELDS = ("accept_prob", "diverging", "num_steps", "energy", "potential_energy", "tree_depth")


class MCMC:
    """Run a NUTS kernel: warmup (dual-averaging step size + Welford mass
    matrix in Stan windows), then sampling.

    ``run(rng_seed, *model_args, init_params=None, **model_kwargs)`` draws
    every random number from one ``torch.Generator`` on ``device`` seeded
    with ``rng_seed``.  ``init_params`` maps site names to constrained
    values, site-shaped or with a leading ``(num_chains,)`` axis; without it
    the chains start from :func:`find_valid_initial_params`.

    ``max_steps_per_call`` (None or a positive int) is accepted because the
    configs set it.  In the JAX package it cuts the fused scan into host
    calls of that many transitions and leaves the results unchanged; this
    loop already takes one transition per host step, so it changes nothing.
    """

    def __init__(self, kernel, num_warmup=500, num_samples=1500, num_chains=1, thinning=1,
                 device=None, dtype=torch.float32, max_steps_per_call=None):
        if max_steps_per_call is not None and (int(max_steps_per_call) != max_steps_per_call
                                               or max_steps_per_call < 1):
            raise ValueError(f"max_steps_per_call must be None or a positive integer, got {max_steps_per_call!r}")
        self.max_steps_per_call = max_steps_per_call
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thinning = int(thinning)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.timings = {}
        self._potential = None
        self._collected_z = None
        self._extra = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, rng_seed, *model_args, init_params=None, **model_kwargs):
        k = self.kernel
        nc, dev, dtype = self.num_chains, self.device, self.dtype
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
        potential = ModelPotential(k.model, model_args, model_kwargs, device=dev, dtype=dtype)
        self._potential = potential
        dim = potential.dim

        if init_params is not None:
            z0 = potential.unconstrain(init_params, nc)
        else:
            z0 = find_valid_initial_params(potential, nc, gen)
        state = nuts_init(potential, z0)
        mm = identity_mass_matrix(nc, dim, k.dense_mass, dtype, dev)
        if k.adapt_step_size:
            step_size = find_reasonable_step_size(potential, mm, state.z, gen, k.step_size,
                                                  pe_grad=(state.pe, state.grad))
        else:
            step_size = torch.full((nc,), float(k.step_size), dtype=dtype, device=dev)
        da = da_init(step_size)
        wf = welford_init(nc, dim, k.dense_mass, dtype, dev)
        ss_final = step_size
        self._sync()
        self.timings["init"] = time.perf_counter() - t0

        W = self.num_warmup
        window_end, in_slow = build_warmup_schedule(W, k.adapt_mass_matrix)
        total = self.num_samples * self.thinning
        zs, extra = [], {f: [] for f in _EXTRA_FIELDS}
        t_phase = time.perf_counter()
        for t in range(W + total):
            warm = t < W
            ss = torch.exp(da.log_step) if warm else ss_final
            state = nuts_transition(potential, state, mm, ss, gen, k.max_tree_depth, k.max_delta_energy)
            if warm:
                if k.adapt_step_size:
                    da = da_update(da, state.accept_prob, target=k.target_accept_prob)
                if k.adapt_mass_matrix and in_slow[t]:
                    wf = welford_update(wf, state.z)
                if k.adapt_mass_matrix and window_end[t]:
                    mm = mass_matrix_from_inverse(welford_covariance(wf))
                    da = da_init(torch.exp(da.log_step))  # keep the step size, restart its averaging
                    wf = welford_init(nc, dim, k.dense_mass, dtype, dev)
                if t == W - 1:
                    ss_final = torch.exp(da.log_step_avg) if k.adapt_step_size else ss
                    self._sync()
                    self.timings["warmup"] = time.perf_counter() - t_phase
                    t_phase = time.perf_counter()
            elif (t - W + 1) % self.thinning == 0:
                zs.append(state.z)
                extra["accept_prob"].append(state.accept_prob)
                extra["diverging"].append(state.diverging)
                extra["num_steps"].append(state.num_steps)
                extra["energy"].append(state.energy)
                extra["potential_energy"].append(state.pe)
                extra["tree_depth"].append(state.tree_depth)
        self._sync()
        self.timings["sample"] = time.perf_counter() - t_phase

        self._collected_z = torch.stack(zs) if zs else torch.zeros(0, nc, dim, dtype=dtype, device=dev)
        self._extra = {f: torch.stack(v) if v else torch.zeros(0, nc, device=dev) for f, v in extra.items()}
        return self

    def get_samples(self, group_by_chain=False):
        """Constrained samples ``{site: (num_samples * num_chains, *shape)}``
        in sample-major order, or ``(num_chains, num_samples, *shape)`` with
        ``group_by_chain``."""
        S, C, D = self._collected_z.shape
        flat = self._potential.constrain(self._collected_z.reshape(S * C, D))
        out = {}
        for name, v in flat.items():
            v = v.reshape((S, C) + v.shape[1:])
            out[name] = v.transpose(0, 1) if group_by_chain else v.reshape((S * C,) + v.shape[2:])
        return out

    def get_extra_fields(self, group_by_chain=False):
        if group_by_chain:
            return {k: v.transpose(0, 1) for k, v in self._extra.items()}
        return {k: v.reshape(-1) for k, v in self._extra.items()}

    def get_deterministic(self, site_names=None, batch_size=64):
        """Recompute the model's deterministic sites over the posterior
        samples, ``batch_size`` draws at a time (the model is chain-batched,
        so a batch of draws runs as a batch of chains).  Returns ``{name:
        (num_samples * num_chains, ...)}`` in :meth:`get_samples`' order;
        ``site_names`` keeps only those names, and the model computes its
        costly optional sites (the posterior-predictive draws) only when
        they are among them (:class:`~gwinferno_tpu_torch.ppl.handlers.collect_deterministic`).
        Prints nothing."""
        samples = self.get_samples()
        pot = self._potential
        n = next(iter(samples.values())).shape[0]
        chunks = []
        with torch.no_grad():
            for start in range(0, n, batch_size):
                chunk = {k: v[start : start + batch_size] for k, v in samples.items()}
                b = next(iter(chunk.values())).shape[0]
                with handlers.trace() as tr, handlers.substitute(data=chunk), \
                        handlers.collect_deterministic(site_names=site_names):
                    pot.model(*pot.model_args, **pot.model_kwargs)
                out = {}
                for name, site in tr.trace.items():
                    if site["type"] != "deterministic" or (site_names is not None and name not in site_names):
                        continue
                    v = torch.as_tensor(site["value"])
                    out[name] = v if v.ndim > 0 and v.shape[0] == b else v.expand((b,) + tuple(v.shape))
                chunks.append(out)
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]} if chunks else {}

    def print_summary(self, prob=0.9):
        """Print the posterior summary (mean, std, median, HPDI, ESS, split
        R-hat per site and element) and the number of divergences."""
        print_summary(self.get_samples(group_by_chain=True), prob=prob)
        print(f"\nNumber of divergences: {int(self._extra['diverging'].sum())}")
