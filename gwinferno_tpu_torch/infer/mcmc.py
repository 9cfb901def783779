"""MCMC engine: warmup adaptation and sampling over a batched chain axis.

Counterpart of ``gwinferno_tpu/infer/mcmc.py``.  Every chain runs the
kernel's transitions (:class:`~gwinferno_tpu_torch.infer.NUTS` or
:class:`~gwinferno_tpu_torch.infer.HMC`) with per-chain adaptation during
warmup: dual-averaging step size, and a Welford mass matrix (diagonal or
dense) refreshed at the end of each Stan slow window.  With
``collective_adaptation`` the step size follows the chains' mean accept
probability and each window's mass matrix is the Chan-pooled covariance of
all chains.  A run resumes from ``post_warmup_state`` (a completed run's, or
:func:`~gwinferno_tpu_torch.utils.checkpoint.load_checkpoint`'s) without
warmup or step-size search.

Two schedulers run the transitions, with the same results bit for bit:

- **sync**: step ``t`` runs one transition of every chain (through the
  kernel's ``make_transition``), then the adaptation of step ``t``; a NUTS
  transition lasts as long as the batch's deepest tree.
- **async** (continuous batching, NUTS only, through
  :meth:`~gwinferno_tpu_torch.infer.NUTS.make_tree_ops`): each chain runs its
  own transition state machine on a masked lane and starts its next
  transition in the round in which it finishes.  A round is
  ``leapfrogs_per_round`` masked leapfrogs over all lanes, then one read of
  a few flags to the host, then, only when some chain finished, the
  bookkeeping of the finished chains at their own step indices.  Transition
  ``t``'s randomness is drawn for all chains (:func:`~gwinferno_tpu_torch.infer.nuts.tree_draws`)
  the first time a chain reaches ``t``, so the generator is consumed in the
  sync engine's order, and chain ``c`` starts from row ``c`` of it.

Over a mesh (``mesh=``, or ``chain_method="parallel"`` under a process group
of several ranks; ``parallel/``), each rank runs its block of the chains
through either scheduler.  Every rank makes the run's starts and step-size
search for all chains, and draws every transition's randomness for all
chains from the same generator, keeping its own rows
(:class:`~gwinferno_tpu_torch.infer.hmc_util.ChainRows`): the run is the
unsharded run, distributed.  Collective adaptation pools over the chain
axis's ranks (the mean accept probability; the Welford states gathered and
pooled identically on every rank), and the async scheduler's window barrier
waits for the slowest chain of any rank.  The data axis is the likelihood's
(``pipeline/analysis.py``).  At the end every rank gathers all chains in
rank order.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.mesh import Mesh
from ..parallel.mesh import create_mesh
from ..parallel.mesh import use_mesh
from ..parallel.sharding import gather_chains
from ..parallel.sharding import min_over
from ..ppl import handlers
from ..ppl.infer_util import ModelPotential
from ..ppl.infer_util import find_valid_initial_params
from .diagnostics import print_summary
from .hmc_util import ChainRows
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
from .nuts import TreeDraws
from .nuts import select_lanes
from .nuts import tree_draws

__all__ = ["MCMC"]

_CHAIN_METHODS = ("vectorized", "parallel", "sequential")
# the recorded fields and the state field each is read from
_STATE_OF_FIELD = {"z": "z", "accept_prob": "accept_prob", "diverging": "diverging", "num_steps": "num_steps",
                   "energy": "energy", "potential_energy": "pe", "tree_depth": "tree_depth"}
_EXTRA_FIELDS = tuple(_STATE_OF_FIELD)[1:]


def _rows(x, sl):
    """The lanes ``sl`` of a NamedTuple whose fields carry a chain axis."""
    return type(x)(*(f[sl] for f in x))


def _cat(parts):
    """Concatenate NamedTuples of one type along the chain axis."""
    return type(parts[0])(*(torch.cat(fs) for fs in zip(*parts)))


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
    batches of ``B`` chains one after another.  ``"parallel"`` shards the
    chains over the ranks of the process group (one process per card,
    ``torchrun``): with ``W`` ranks and ``num_chains % W == 0`` it makes a
    mesh of ``W`` ranks on the chain axis; otherwise it says so on stderr
    and runs vectorized, and in one process that sees several cards it
    raises rather than use one.  ``mesh`` (a
    :class:`~gwinferno_tpu_torch.parallel.Mesh`) shards the chains over its
    ``chain_axis`` and the likelihood's banks over its ``data`` axis (see
    the module docstring); every rank of the mesh runs ``run`` and
    ``get_deterministic`` with the same arguments.

    ``chain_scheduler``: ``"sync"``, ``"async"`` or ``"auto"`` (see the
    module docstring).  ``auto`` runs async when that is a pure reschedule:
    a kernel with ``make_tree_ops`` (NUTS), ``chain_method="vectorized"``,
    no collective adaptation and more than one chain in the batch.
    ``leapfrogs_per_round`` (async only; None means 1) sets the masked
    leapfrogs a round runs before its read; the results are the same for
    every value.  A value above 1 raises in ``run`` when the scheduler
    resolves to sync (``"auto"`` with one chain in the batch, say).
    ``chain_groups=G`` runs each transition (sync) or each round's
    leapfrogs (async) as ``G`` sub-batches of ``C / G`` lanes in turn; a
    sync sub-batch grows to its own deepest tree.  Under async,
    ``collective_adaptation`` parks a chain that has finished the next
    window-end step until every chain has, then runs one pooled window
    close; the step size's dual averaging stays per chain (each chain's own
    accept probability at its own step), where the sync collective engine
    averages the chains' accept probabilities: the JAX package's documented
    deviation, kept.

    ``max_steps_per_call`` and ``progress_bar`` cut the run into segments:
    at most ``max_steps_per_call`` transitions, and a tenth of the run with
    ``progress_bar``, which prints ``[mcmc] {phase} step {done}/{T} ...``
    to stderr after each.  Async chains wait for each other at a segment's
    end; the results are the same with or without segments.

    After a run, ``timings`` holds the wall seconds of ``init``, ``warmup``
    (until the last chain's last warmup transition) and ``sample``;
    ``host_reads`` the reads from the card to the host in the transition
    loop (sync: one a leapfrog round of NUTS, one a transition of HMC;
    async: one a round; one a segment for the progress line); and
    ``transition_steps`` the leapfrogs of every transition, warmup
    included, ``(num_warmup + num_samples * thinning, num_chains)``.
    ``jit_model_args=True`` raises, as in the JAX package; ``chain_axis``
    names the mesh axis the chains shard over.
    """

    def __init__(self, kernel, num_warmup=500, num_samples=1500, num_chains=1, thinning=1,
                 collective_adaptation=False, chain_method="vectorized", progress_bar=False,
                 jit_model_args=False, mesh=None, chain_axis="chain", max_steps_per_call=None, chain_groups=1,
                 chain_scheduler="auto", chain_batch_size=None, leapfrogs_per_round=None, device=None,
                 dtype=torch.float32):
        if chain_method not in _CHAIN_METHODS:
            raise ValueError(f"chain_method must be one of {_CHAIN_METHODS}, got {chain_method!r}")
        if chain_scheduler not in ("auto", "sync", "async"):
            raise ValueError(f"chain_scheduler must be auto/sync/async, got {chain_scheduler!r}")
        if jit_model_args:
            raise ValueError(
                "jit_model_args=True is not supported: model args are closed over "
                "and the compiled program is cached per (model, data, shapes) -- "
                "re-running with same-shaped data already reuses the executable"
            )
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.create_mesh), got {type(mesh).__name__}")
        if mesh is not None and int(chain_groups) > 1:
            raise ValueError(
                "chain_groups > 1 is a single-device tiling knob; with a sharded "
                "chain axis the mesh already bounds the per-device batch"
            )
        if max_steps_per_call is not None and (int(max_steps_per_call) != max_steps_per_call
                                               or max_steps_per_call < 1):
            raise ValueError(f"max_steps_per_call must be None or a positive integer, got {max_steps_per_call!r}")
        if chain_method == "sequential" and collective_adaptation:
            raise ValueError("collective_adaptation requires a batched chain axis (vectorized/parallel)")
        self.chain_groups = int(chain_groups)
        if self.chain_groups > 1 and int(num_chains) % self.chain_groups != 0:
            raise ValueError(f"chain_groups={chain_groups} must divide num_chains={num_chains}")
        if self.chain_groups > 1 and chain_method == "sequential":
            raise ValueError("chain_groups tiles a batched chain axis; chain_method='sequential' has none")
        if chain_batch_size is not None:
            if chain_method != "vectorized" or mesh is not None:
                raise ValueError("chain_batch_size needs chain_method='vectorized' without a mesh")
            if collective_adaptation:
                raise ValueError("chain_batch_size pools nothing across batches; collective_adaptation "
                                 "needs all chains in one batch")
            if int(num_chains) % int(chain_batch_size) != 0:
                raise ValueError(f"chain_batch_size={chain_batch_size} must divide num_chains={num_chains}")
            if self.chain_groups > 1:
                raise ValueError("chain_batch_size and chain_groups are alternative tilings; pick one")
        if leapfrogs_per_round is not None and int(leapfrogs_per_round) < 1:
            raise ValueError(f"leapfrogs_per_round must be >= 1, got {leapfrogs_per_round}")
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thinning = int(thinning)
        self.collective_adaptation = bool(collective_adaptation)
        self.chain_method = chain_method
        self.progress_bar = bool(progress_bar)
        self.chain_axis = chain_axis
        self.mesh = mesh
        self.max_steps_per_call = max_steps_per_call
        self.chain_scheduler = chain_scheduler
        self.chain_batch_size = None if chain_batch_size is None else int(chain_batch_size)
        self.leapfrogs_per_round = None if leapfrogs_per_round is None else int(leapfrogs_per_round)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.timings = {}
        self.host_reads = 0
        self.transition_steps = None
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

    def _count_read(self):
        self.host_reads += 1

    def _batch_size(self):
        if self.chain_method == "sequential":
            return 1
        return self.chain_batch_size or self.num_chains

    def _resolve_mesh(self):
        """The run's mesh: ``mesh``, or for ``chain_method="parallel"`` a
        chain-axis mesh over the process group's ``W`` ranks when ``W > 1``
        divides ``num_chains`` (kept for later runs), as the JAX engine
        builds one over its devices."""
        if self.mesh is not None or self.chain_method != "parallel":
            return self.mesh
        nc = self.num_chains
        if dist.is_initialized():
            ndev = dist.get_world_size()
            if ndev > 1 and nc % ndev == 0:
                self.mesh = create_mesh(ndev, chain_axis_size=ndev, axis_names=(self.chain_axis, "data"))
                return self.mesh
        elif self.device.type == "cuda" and torch.cuda.device_count() > 1:
            n = torch.cuda.device_count()
            raise ValueError(f"chain_method='parallel' over the {n} cards this process sees needs one process "
                             f"per card: run under torchrun --nproc-per-node={n} and call "
                             "parallel.distributed_initialize() before MCMC.run")
        else:
            ndev = 1
        print(f"chain_method='parallel': {nc} chains not shardable over {ndev} devices; running vectorized",
              file=sys.stderr)
        return None

    def _resolve_scheduler(self, nc):
        """True for the async (continuous-batching) scheduler, for a batch
        of ``nc`` chains."""
        if self.chain_scheduler == "sync":
            return False
        if self.chain_scheduler == "async":
            if not hasattr(self.kernel, "make_tree_ops"):
                raise ValueError("chain_scheduler='async' needs a kernel exposing make_tree_ops (NUTS)")
            if self.chain_method == "sequential":
                raise ValueError(
                    "chain_scheduler='async' needs a batched chain axis "
                    "(chain_method='vectorized' or 'parallel')"
                )
            return True
        return (
            hasattr(self.kernel, "make_tree_ops")
            and not self.collective_adaptation
            and self.chain_method == "vectorized"
            and self.mesh is None
            and nc > 1
        )

    def _resolve_leapfrogs_per_round(self, use_async):
        """Masked leapfrogs per async round: the explicit value, else 1.
        Under sync only 1 (or None) is accepted; with ``"auto"`` that is
        known only once ``run`` resolves the scheduler."""
        if not use_async:
            if self.leapfrogs_per_round not in (None, 1):
                raise ValueError(
                    "leapfrogs_per_round only applies to the continuous-batching "
                    "(async) chain scheduler"
                )
            return 1
        return self.leapfrogs_per_round or 1

    def _segment_length(self, T):
        seg = T
        if self.max_steps_per_call:
            seg = min(seg, int(self.max_steps_per_call))
        if self.progress_bar:
            seg = min(seg, max(1, T // 10))
        return max(seg, 1)

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
        mesh = self._resolve_mesh()
        with use_mesh(mesh):
            return self._run(mesh, rng_seed, model_args, init_params, post_warmup_state, model_kwargs)

    def _run(self, mesh, rng_seed, model_args, init_params, post_warmup_state, model_kwargs):
        k = self.kernel
        nc, dev, dtype = self.num_chains, self.device, self.dtype
        self.timings = {}
        self.host_reads = 0
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
        potential = ModelPotential(k.model, model_args, model_kwargs, device=dev, dtype=dtype)
        self._potential = potential
        dim = potential.dim
        batch = self._batch_size()
        use_async = self._resolve_scheduler(batch)
        leapfrogs = self._resolve_leapfrogs_per_round(use_async)

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
        # this rank's block of the chains (the whole batch without a mesh)
        rows = mesh.rows(self.chain_axis, nc) if mesh is not None and self.chain_method != "sequential" else None
        outs = [self._run_batch(potential, z0[c : c + batch], inv0[c : c + batch], ss0[c : c + batch], gen,
                                num_warmup, find_ss0, use_async, leapfrogs, rows)
                for c in range(0, nc, batch)]
        state = type(outs[0][0])(*(torch.cat(f) for f in zip(*(o[0] for o in outs))))
        inverse, mass_chol, step_size = (torch.cat([o[i] for o in outs]) for i in (1, 2, 3))
        collected = {f: torch.cat([o[4][f] for o in outs], dim=1) for f in _STATE_OF_FIELD}
        self.transition_steps = collected["num_steps"]
        # strip warmup, then thin
        collected = {f: v[num_warmup:][self.thinning - 1 :: self.thinning] for f, v in collected.items()}
        self._collected_z = collected.pop("z")
        self._extra = collected
        self._adapt_info = {"step_size": step_size, "inverse_mass_matrix": inverse}
        self.post_warmup_state = {
            "state": tuple(state),
            "inverse_mass_matrix": inverse,
            "mass_chol": mass_chol,
            "step_size": step_size,
            "rng_key": gen.get_state(),
        }
        return self

    def _run_batch(self, potential, z0, inv0, ss0, gen, num_warmup, find_ss0, use_async, leapfrogs, rows=None):
        """One whole run (warmup, if any, then sampling) of the chains
        ``z0``, segment by segment.  Returns ``(last state, inverse mass
        matrix, its mass Cholesky factor, final step size, {"z": (T, C, dim),
        extra field: (T, C)})`` over all ``T`` transitions.  With ``rows``
        (this rank's block of a mesh's chains) the starts and the step-size
        search cover every chain, the transitions this rank's, and the
        results are gathered from every rank of the chain axis."""
        k = self.kernel
        dim, dev, dtype = z0.shape[1], self.device, self.dtype
        t0 = time.perf_counter()
        state = k.make_init(potential)(z0)
        mm = mass_matrix_from_inverse(inv0)
        if find_ss0:
            step_size = find_reasonable_step_size(potential, mm, state.z, gen, k.step_size,
                                                  pe_grad=(state.pe, state.grad))
        else:
            step_size = ss0
        if rows is not None:
            state, mm, step_size = _rows(state, rows), _rows(mm, rows), step_size[rows]
            gen = ChainRows(gen, rows, z0.shape[0])
        nc = state.z.shape[0]
        carry = (state, da_init(step_size), welford_init(nc, dim, k.dense_mass, dtype, dev), mm, step_size)
        clock = {"t": self._tick("init", t0)}

        W = num_warmup
        T = W + self.num_samples * self.thinning
        window_end, in_slow = build_warmup_schedule(W, k.adapt_mass_matrix)
        flags = np.zeros((4, T), dtype=bool)  # is_warmup, in_slow, window_end, finalize
        flags[0, :W], flags[1, :W], flags[2, :W] = True, in_slow, window_end
        if W > 0:
            flags[3, W - 1] = True

        if use_async:
            run_segment = functools.partial(self._async_segment, k.make_tree_ops(potential), leapfrogs=leapfrogs)
        else:
            run_segment = functools.partial(self._sync_segment, k.make_transition(potential, on_read=self._count_read))

        def warmup_done():
            clock["t"] = self._tick("warmup", clock["t"])

        seg = self._segment_length(T)
        outs, t_start, ndiv = [], time.perf_counter(), 0
        for s0 in range(0, T, seg):
            n = min(seg, T - s0)
            # the segment that holds the last warmup transition ticks its end
            warm_end = W - s0 if 0 < W - s0 <= n else None
            carry, out = run_segment(carry, flags[:, s0 : s0 + n], gen, warm_end, warmup_done)
            outs.append(out)
            if self.progress_bar and seg < T:
                ndiv += int(out["diverging"].sum())
                self._count_read()
                done = s0 + n
                rate = done / max(time.perf_counter() - t_start, 1e-9)
                print(f"[mcmc] {'warmup' if done <= W else 'sample'} step {done}/{T}  ({rate:.2f} it/s, "
                      f"{ndiv} divergences)", file=sys.stderr, flush=True)
        self._tick("sample", clock["t"])

        state, _, _, mm, ss_final = carry
        if outs:
            collected = {f: torch.cat([o[f] for o in outs]) for f in outs[0]}
        else:
            collected = {"z": torch.zeros(0, nc, dim, dtype=dtype, device=dev)}
            collected.update({f: getattr(state, _STATE_OF_FIELD[f])[None][:0] for f in _EXTRA_FIELDS})
        out = (state, mm.inverse, mm.mass_chol, ss_final)
        if rows is not None:
            out = gather_chains(self.mesh, out, self.chain_axis)
            collected = gather_chains(self.mesh, collected, self.chain_axis, dim=1)
        return (*out, collected)

    # ------------------------------------------------------------ adaptation

    def _close_window(self, wf, da):
        """The end of a slow window: the mass matrix from the Welford
        covariance (Chan-pooled over the chains under collective
        adaptation), the step size's averaging restarted at its current
        value, and fresh Welford states.  Returns ``(mm, da, wf)``."""
        nc = wf.count.shape[0]
        if self.collective_adaptation:
            cov = welford_covariance(welford_pool(self._all_chains(wf)))  # one pooled chain
            cov = cov.expand((nc,) + cov.shape[1:]).contiguous()
        else:
            cov = welford_covariance(wf)
        return (mass_matrix_from_inverse(cov), da_init(torch.exp(da.log_step)),
                welford_init(nc, wf.mean.shape[1], self.kernel.dense_mass, self.dtype, self.device))

    def _all_chains(self, x):
        """``x`` (a tensor or NamedTuple of them, leading chain axis) for
        every chain of the run under collective adaptation (never
        sequential): gathered from the chain axis's ranks over a mesh, in
        rank order, the same on every rank."""
        return x if self.mesh is None else gather_chains(self.mesh, x, self.chain_axis)

    def _groups(self, nc):
        n = nc // self.chain_groups
        return [slice(g * n, (g + 1) * n) for g in range(self.chain_groups)]

    # ------------------------------------------------------------ sync

    def _sync_segment(self, transition, carry, flags, gen, warm_end, warmup_done):
        """Transitions of one segment in lockstep: step ``j`` runs every
        chain's transition, then the adaptation of step ``j``;
        ``warmup_done()`` is called after step ``warm_end - 1`` (None: no
        warmup ends in the segment).  Returns the carry and the outputs
        ``{field: (n, C, ...)}``."""
        k = self.kernel
        state, da, wf, mm, ss_final = carry
        is_warmup, in_slow, window_end, finalize = flags
        groups = self._groups(state.z.shape[0]) if self.chain_groups > 1 else None
        out = {f: [] for f in _STATE_OF_FIELD}
        for j in range(flags.shape[1]):
            ss = torch.exp(da.log_step) if is_warmup[j] else ss_final
            if groups is None:
                state = transition(state, mm, ss, gen)
            else:
                state = _cat([transition(_rows(state, g), _rows(mm, g), ss[g], gen) for g in groups])
            if is_warmup[j]:
                if k.adapt_step_size:
                    accept = state.accept_prob
                    if self.collective_adaptation:
                        accept = self._all_chains(accept).mean().expand_as(accept)
                    da = da_update(da, accept, target=k.target_accept_prob)
                if k.adapt_mass_matrix and in_slow[j]:
                    wf = welford_update(wf, state.z)
                if k.adapt_mass_matrix and window_end[j]:
                    mm, da, wf = self._close_window(wf, da)
            if finalize[j]:
                ss_final = torch.exp(da.log_step_avg) if k.adapt_step_size else ss
            for f, name in _STATE_OF_FIELD.items():
                out[f].append(getattr(state, name))
            if warm_end is not None and j == warm_end - 1:
                warmup_done()
        return (state, da, wf, mm, ss_final), {f: torch.stack(v) for f, v in out.items()}

    # ------------------------------------------------------------ async

    def _async_segment(self, ops, carry, flags, gen, warm_end, warmup_done, leapfrogs=1):
        """Transitions of one segment by continuous batching (the
        counterpart of the JAX engine's ``async_scan_fn``): every chain
        runs its ``K`` transitions back to back on its own lane, each
        adaptation update fires at the chain's own step index in the sync
        engine's order, and the outputs land in per-chain buffers with a
        spill row ``K`` for lanes that did not finish; ``warmup_done()`` is
        called once every chain has finished its step ``warm_end - 1``.
        Returns the carry and the outputs ``{field: (K, C, ...)}``."""
        k = self.kernel
        start, active, step, finish = ops
        state, da, wf, mm, ss_final = carry
        nc, dim = state.z.shape
        dev, dtype = state.z.device, state.z.dtype
        K = flags.shape[1]
        is_warmup, in_slow, window_end, finalize = torch.as_tensor(flags, device=dev)
        groups = self._groups(nc) if self.chain_groups > 1 else None
        collective = self.collective_adaptation and k.adapt_mass_matrix
        lanes = torch.arange(nc, device=dev)

        # transition t's draws for every chain, made the first time a chain
        # reaches t (so in increasing t, the sync engine's order) and freed
        # once every chain has started t
        blocks = {}

        def draws_for(t_lane, t_lo, t_hi):
            """Row c of transition ``t_lane[c]``'s draws, for ``t_lo <=
            t_lane <= t_hi``."""
            for b in range(len(blocks) and max(blocks) + 1, t_hi + 1):
                blocks[b] = tree_draws(nc, dim, k.max_tree_depth, dtype, dev, gen)
            for b in [b for b in blocks if b < t_lo]:
                del blocks[b]
            if t_lo == t_hi:
                return blocks[t_lo]
            stacked = (torch.stack(fs) for fs in zip(*(blocks[b] for b in range(t_lo, t_hi + 1))))
            return TreeDraws(*(f[t_lane - t_lo, lanes] for f in stacked))

        ss0 = torch.exp(da.log_step) if flags[0, 0] else ss_final
        tc = start(state, mm, ss0, draws_for(None, 0, 0))
        t = torch.zeros(nc, dtype=torch.int64, device=dev)
        started = torch.ones(nc, dtype=torch.bool, device=dev)
        bufs = {f: torch.zeros((nc, K + 1) + tuple(getattr(state, name).shape[1:]),
                               dtype=getattr(state, name).dtype, device=dev)
                for f, name in _STATE_OF_FIELD.items()}
        # the segment's window-end steps, for the collective barrier
        w_ends = [j for j in range(K) if flags[2, j]] + [K]
        w_ptr = 0

        while True:
            running = started & (t < K)
            for _ in range(leapfrogs):
                live = running & active(tc)
                if groups is None:
                    stepped = step(mm, tc)
                else:
                    stepped = _cat([step(_rows(mm, g), _rows(tc, g)) for g in groups])
                tc = select_lanes(live, stepped, tc)
            done = running & ~active(tc)
            ti = t.clamp_max(K - 1)
            close = done & window_end[ti]
            t_next = t + done.long()
            t_low = t_next.min()
            if collective:
                # the barrier and the loop's end wait for every rank's chains
                t_low = min_over(t_low, None if self.mesh is None else self.mesh.group(self.chain_axis))
            any_done, any_close, t_min, t_max = torch.stack(
                [done.any().long(), close.any().long(), t_low, t_next.max()]).tolist()
            self._count_read()
            # a pooled window close is due (over a mesh a rank may have no
            # chain finishing in the round that allows it)
            due = collective and w_ends[w_ptr] < K and t_min > w_ends[w_ptr]
            if any_done or due:
                state = select_lanes(done, finish(tc), state)
                if k.adapt_step_size:
                    da_new = da_update(da, state.accept_prob, target=k.target_accept_prob)
                    da = select_lanes(done & is_warmup[ti], da_new, da)
                if k.adapt_mass_matrix:
                    wf = select_lanes(done & is_warmup[ti] & in_slow[ti], welford_update(wf, state.z), wf)
                    if any_close and not self.collective_adaptation:
                        mm_c, da_c, wf_c = self._close_window(wf, da)
                        mm, da, wf = (select_lanes(close, mm_c, mm), select_lanes(close, da_c, da),
                                      select_lanes(close, wf_c, wf))
                ss_now = torch.exp(da.log_step_avg) if k.adapt_step_size else tc.step_size
                ss_final = torch.where(done & finalize[ti], ss_now, ss_final)
                widx = torch.where(done, t, K)
                for f, name in _STATE_OF_FIELD.items():
                    bufs[f][lanes, widx] = getattr(state, name)
                t = t_next
                started = started & ~done
                eligible = ~started & (t < K)
                if collective:
                    # the window barrier: once every chain has finished the
                    # pending window-end step, one pooled close; until then a
                    # chain does not start past it
                    if due:
                        mm, da, wf = self._close_window(wf, da)
                        w_ptr += 1
                    eligible = eligible & (t <= w_ends[w_ptr])
                ti = t.clamp_max(K - 1)
                lo, hi = min(t_min, K - 1), min(t_max, K - 1)
                ss_next = torch.where(is_warmup[ti], torch.exp(da.log_step), ss_final)
                tc = select_lanes(eligible, start(state, mm, ss_next, draws_for(ti, lo, hi)), tc)
                started = started | eligible
                if warm_end is not None and t_min >= warm_end:
                    warmup_done()
                    warm_end = None
            if t_min >= K:
                break
        return (state, da, wf, mm, ss_final), {f: v[:, :K].transpose(0, 1) for f, v in bufs.items()}

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
        with torch.no_grad(), use_mesh(self.mesh):
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
