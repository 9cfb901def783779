"""MCMC engine: warmup adaptation and sampling over a batched chain axis.

Counterpart of the synchronous vectorized engine of
``gwinferno_tpu/infer/mcmc.py``: every step runs one transition of the
kernel (:class:`~gwinferno_tpu_torch.infer.NUTS` or
:class:`~gwinferno_tpu_torch.infer.HMC`, through their ``make_init`` /
``make_transition``) for all chains, then per-chain adaptation during
warmup: dual-averaging step size, and a Welford mass matrix (diagonal or
dense) refreshed at the end of each Stan slow window.  With
``collective_adaptation`` the step size follows the chains' mean accept
probability and each window's mass matrix is the Chan-pooled covariance of
all chains.  A run resumes from ``post_warmup_state`` (a completed run's, or
:func:`~gwinferno_tpu_torch.utils.checkpoint.load_checkpoint`'s) without
warmup or step-size search.
"""

from __future__ import annotations

import sys
import time

import numpy as np
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
from .hmc_util import welford_pool
from .hmc_util import welford_update

__all__ = ["MCMC"]

_CHAIN_METHODS = ("vectorized", "parallel", "sequential")
_EXTRA_FIELDS = ("accept_prob", "diverging", "num_steps", "energy", "potential_energy", "tree_depth")


class MCMC:
    """Run an HMC or NUTS kernel: warmup (dual-averaging step size + Welford
    mass matrix in Stan windows), then sampling.

    ``run(rng_seed, *model_args, init_params=None, post_warmup_state=None,
    **model_kwargs)`` draws every random number from one ``torch.Generator``
    on ``device`` seeded with ``rng_seed``.  ``init_params`` maps site names
    to constrained values, site-shaped or with a leading ``(num_chains,)``
    axis; without it the chains start from :func:`find_valid_initial_params`.

    ``post_warmup_state`` resumes: the chains start from its positions,
    inverse mass matrix and step size, with no warmup and no step-size
    search, and its ``rng_key`` (a generator state this engine wrote)
    replaces the seed's stream, so a resumed run continues the saved one.
    A ``rng_key`` that is not such a state (the JAX package's PRNG key, from
    a checkpoint it wrote) gives way to ``rng_seed``.  Every run sets
    ``post_warmup_state`` for the next.

    ``chain_method``: ``"vectorized"`` (all chains in one batch), or
    ``"sequential"`` (one chain after another, each a whole run with its own
    adaptation); ``chain_batch_size=B`` runs the vectorized engine on
    batches of ``B`` chains one after another.  ``"parallel"`` runs
    vectorized on one device (it says so on stderr); sharding the chains
    over several devices is not ported (ROADMAP M11) and raises.

    ``max_steps_per_call`` (None or a positive int) is accepted because the
    configs set it.  In the JAX package it cuts the fused scan into host
    calls of that many transitions and leaves the results unchanged; this
    loop already takes one transition per host step, so it changes nothing.
    """

    def __init__(self, kernel, num_warmup=500, num_samples=1500, num_chains=1, thinning=1,
                 collective_adaptation=False, chain_method="vectorized", chain_batch_size=None,
                 device=None, dtype=torch.float32, max_steps_per_call=None):
        if max_steps_per_call is not None and (int(max_steps_per_call) != max_steps_per_call
                                               or max_steps_per_call < 1):
            raise ValueError(f"max_steps_per_call must be None or a positive integer, got {max_steps_per_call!r}")
        if chain_method not in _CHAIN_METHODS:
            raise ValueError(f"chain_method must be one of {_CHAIN_METHODS}, got {chain_method!r}")
        if chain_method == "sequential" and collective_adaptation:
            raise ValueError("collective_adaptation requires a batched chain axis (vectorized/parallel)")
        if chain_batch_size is not None:
            if chain_method != "vectorized":
                raise ValueError("chain_batch_size needs chain_method='vectorized'")
            if collective_adaptation:
                raise ValueError("chain_batch_size pools nothing across batches; collective_adaptation "
                                 "needs all chains in one batch")
            if int(num_chains) % int(chain_batch_size) != 0:
                raise ValueError(f"chain_batch_size={chain_batch_size} must divide num_chains={num_chains}")
        self.max_steps_per_call = max_steps_per_call
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thinning = int(thinning)
        self.collective_adaptation = bool(collective_adaptation)
        self.chain_method = chain_method
        self.chain_batch_size = None if chain_batch_size is None else int(chain_batch_size)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.timings = {}
        self.post_warmup_state = None
        self._adapt_info = None
        self._potential = None
        self._collected_z = None
        self._extra = None

    def _tick(self, key, t0):
        """Add the seconds since ``t0`` to ``timings[key]`` (the device
        synchronized first); returns now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - t0
        return now

    def _batch_size(self):
        if self.chain_method == "sequential":
            return 1
        if self.chain_method == "parallel" and self.device.type == "cuda":
            ndev = torch.cuda.device_count()
            if ndev > 1 and self.num_chains % ndev == 0:
                raise NotImplementedError(
                    f"chain_method='parallel' over {ndev} devices is not ported yet (ROADMAP M11)")
        if self.chain_method == "parallel":
            print(f"chain_method='parallel': {self.num_chains} chains on one device; running vectorized",
                  file=sys.stderr)
        return self.chain_batch_size or self.num_chains

    def _resume_inputs(self, saved, dim, generator):
        """Positions ``(C, dim)``, inverse mass matrices and step sizes
        ``(C,)`` of a saved ``post_warmup_state`` on this run's device and
        dtype; restores the generator from its ``rng_key`` when that is one
        of this engine's generator states."""
        def tensor(v):
            if isinstance(v, torch.Tensor):
                return v.detach().to(self.device, self.dtype)
            return torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)

        nc = self.num_chains
        z, inv, ss = tensor(saved["state"][0]), tensor(saved["inverse_mass_matrix"]), tensor(saved["step_size"])
        dense = bool(getattr(self.kernel, "dense_mass", False))
        want = (nc, dim, dim) if dense else (nc, dim)
        if tuple(z.shape) != (nc, dim) or tuple(inv.shape) != want or tuple(ss.shape) != (nc,):
            raise ValueError(f"post_warmup_state holds positions {tuple(z.shape)}, inverse mass matrix "
                             f"{tuple(inv.shape)} and step size {tuple(ss.shape)}; this run needs "
                             f"{(nc, dim)}, {want} and {(nc,)}")
        key = saved.get("rng_key")
        if key is not None:
            key = key.detach().cpu() if isinstance(key, torch.Tensor) else torch.from_numpy(np.array(key))
            if key.dtype == torch.uint8 and key.numel() == generator.get_state().numel():
                generator.set_state(key.contiguous())
        return z, inv, ss

    def run(self, rng_seed, *model_args, init_params=None, post_warmup_state=None, **model_kwargs):
        k = self.kernel
        nc, dev, dtype = self.num_chains, self.device, self.dtype
        self.timings = {}
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
        potential = ModelPotential(k.model, model_args, model_kwargs, device=dev, dtype=dtype)
        self._potential = potential
        dim = potential.dim
        batch = self._batch_size()

        resume = post_warmup_state is not None
        if resume:
            z0, inv0, ss0 = self._resume_inputs(post_warmup_state, dim, gen)
        else:
            if init_params is not None:
                z0 = potential.unconstrain(init_params, nc)
            else:
                z0 = find_valid_initial_params(potential, nc, gen)
            inv0 = identity_mass_matrix(nc, dim, k.dense_mass, dtype, dev).inverse
            ss0 = torch.full((nc,), float(k.step_size), dtype=dtype, device=dev)
        self._tick("init", t0)

        num_warmup = 0 if resume else self.num_warmup
        find_ss0 = k.adapt_step_size and not resume
        outs = [self._run_batch(potential, z0[c : c + batch], inv0[c : c + batch], ss0[c : c + batch], gen,
                                num_warmup, find_ss0)
                for c in range(0, nc, batch)]
        state = type(outs[0][0])(*(torch.cat(f) for f in zip(*(o[0] for o in outs))))
        inverse, mass_chol, step_size = (torch.cat([o[i] for o in outs]) for i in (1, 2, 3))
        self._collected_z = torch.cat([o[4] for o in outs], dim=1)
        self._extra = {f: torch.cat([o[5][f] for o in outs], dim=1) for f in _EXTRA_FIELDS}
        self._adapt_info = {"step_size": step_size, "inverse_mass_matrix": inverse}
        self.post_warmup_state = {
            "state": tuple(state),
            "inverse_mass_matrix": inverse,
            "mass_chol": mass_chol,
            "step_size": step_size,
            "rng_key": gen.get_state(),
        }
        return self

    def _run_batch(self, potential, z0, inv0, ss0, gen, num_warmup, find_ss0):
        """One whole run (warmup, if any, then sampling) of the chains
        ``z0``.  Returns ``(last state, inverse mass matrix, its mass
        Cholesky factor, final step size, positions (S, C, dim), extra
        fields {name: (S, C)})``."""
        k = self.kernel
        nc, dim, dev, dtype = z0.shape[0], z0.shape[1], self.device, self.dtype
        t0 = time.perf_counter()
        transition = k.make_transition(potential)
        state = k.make_init(potential)(z0)
        mm = mass_matrix_from_inverse(inv0)
        if find_ss0:
            step_size = find_reasonable_step_size(potential, mm, state.z, gen, k.step_size,
                                                  pe_grad=(state.pe, state.grad))
        else:
            step_size = ss0
        da = da_init(step_size)
        wf = welford_init(nc, dim, k.dense_mass, dtype, dev)
        ss_final = step_size
        t_phase = self._tick("init", t0)

        W = num_warmup
        window_end, in_slow = build_warmup_schedule(W, k.adapt_mass_matrix)
        total = self.num_samples * self.thinning
        zs, extra = [], {f: [] for f in _EXTRA_FIELDS}
        for t in range(W + total):
            warm = t < W
            ss = torch.exp(da.log_step) if warm else ss_final
            state = transition(state, mm, ss, gen)
            if warm:
                if k.adapt_step_size:
                    accept = state.accept_prob
                    if self.collective_adaptation:
                        accept = accept.mean().expand_as(accept)
                    da = da_update(da, accept, target=k.target_accept_prob)
                if k.adapt_mass_matrix and in_slow[t]:
                    wf = welford_update(wf, state.z)
                if k.adapt_mass_matrix and window_end[t]:
                    if self.collective_adaptation:
                        cov = welford_covariance(welford_pool(wf))  # one pooled chain
                        cov = cov.expand((nc,) + cov.shape[1:]).contiguous()
                    else:
                        cov = welford_covariance(wf)
                    mm = mass_matrix_from_inverse(cov)
                    da = da_init(torch.exp(da.log_step))  # keep the step size, restart its averaging
                    wf = welford_init(nc, dim, k.dense_mass, dtype, dev)
                if t == W - 1:
                    ss_final = torch.exp(da.log_step_avg) if k.adapt_step_size else ss
                    t_phase = self._tick("warmup", t_phase)
            elif (t - W + 1) % self.thinning == 0:
                zs.append(state.z)
                extra["accept_prob"].append(state.accept_prob)
                extra["diverging"].append(state.diverging)
                extra["num_steps"].append(state.num_steps)
                extra["energy"].append(state.energy)
                extra["potential_energy"].append(state.pe)
                extra["tree_depth"].append(state.tree_depth)
        self._tick("sample", t_phase)

        collected = torch.stack(zs) if zs else torch.zeros(0, nc, dim, dtype=dtype, device=dev)
        extra = {f: torch.stack(v) if v else torch.zeros(0, nc, device=dev) for f, v in extra.items()}
        return state, mm.inverse, mm.mass_chol, ss_final, collected, extra

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
