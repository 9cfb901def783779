"""Multinomial NUTS as a flat iterative tree, batched over chains.

Counterpart of ``gwinferno_tpu/infer/nuts.py``: the whole tree of one
transition is a single loop over leapfrog steps.  Its schedule (doubling
``d`` occupies flat iterations ``[2^d - 1, 2^(d+1) - 2]``; the U-turn
checkpoint slot ranges; which leaf completes a subtree) is a static function
of the flat index, precomputed into tables, and all of a transition's
randomness is drawn when it starts.  The transition is a state machine over
:class:`TreeCarry`: :func:`tree_start` (:func:`tree_draws`, then the
deterministic :func:`tree_start_from`), then :func:`tree_step` while
:func:`tree_active`, then :func:`tree_finish`.

Every field carries a leading chain axis ``C``, and every operation is per
chain.  :func:`nuts_transition` steps all ``C`` lanes on every leapfrog and
keeps a lane whose tree has stopped unchanged (:func:`select_lanes`), as the
JAX engine's ``vmap`` of a ``while_loop`` does, so every potential call sees
the same ``(C, dim)`` batch; it reads one flag back to the host per
leapfrog.  The continuous-batching scheduler of
:class:`~gwinferno_tpu_torch.infer.MCMC` drives the same state machine
through :meth:`NUTS.make_tree_ops`.

Proposals: multinomial sampling within subtrees, biased progressive sampling
across doublings (as in Stan).  Termination: the generalized U-turn
criterion on momentum sums at every power-of-two internal node (the
checkpoint scheme), plus divergence at ``max_delta_energy``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .hmc_util import MassMatrix
from .hmc_util import chain_draw
from .hmc_util import kinetic_energy
from .hmc_util import leapfrog
from .hmc_util import momentum_from_normal
from .hmc_util import value_and_grad
from .hmc_util import velocity

__all__ = ["NUTS", "NUTSState", "TreeCarry", "TreeDraws", "nuts_init", "nuts_transition", "select_lanes",
           "tree_draws", "tree_start_from", "tree_start", "tree_active", "tree_step", "tree_finish"]


class NUTSState(NamedTuple):
    z: torch.Tensor  # (C, dim) unconstrained position
    pe: torch.Tensor  # (C,) potential energy at z
    grad: torch.Tensor  # (C, dim)
    energy: torch.Tensor  # (C,) Hamiltonian at the start of the last transition
    accept_prob: torch.Tensor  # (C,) mean Metropolis accept prob over the last tree
    num_steps: torch.Tensor  # (C,) leapfrog steps of the last transition
    diverging: torch.Tensor  # (C,) bool
    tree_depth: torch.Tensor  # (C,)


# rows of the packed (C, 15, dim) vector-state buffer
_Z_L, _R_L, _G_L = 0, 1, 2  # left trajectory edge (position, momentum, gradient)
_Z_R, _R_R, _G_R = 3, 4, 5  # right trajectory edge
_Z_P, _G_P = 6, 7  # current tree proposal
_R_SUM = 8  # momentum sum over the valid tree
_S_Z, _S_R, _S_G = 9, 10, 11  # subtree moving edge (leapfrog input)
_S_ZP, _S_GP = 12, 13  # subtree proposal
_S_RSUM = 14  # subtree momentum sum

# slots of the packed (C, 5) scalar-state buffer
_LOGW, _S_LOGW, _PE_P, _S_PE_P, _ACC = range(5)


def _is_turning(mm: MassMatrix, r_left, r_right, r_sum):
    """Generalized U-turn criterion: a span turns when either edge's
    velocity points back toward the span's centre of momentum."""
    v_left = velocity(mm, r_left)
    v_right = velocity(mm, r_right)
    rho = r_sum - 0.5 * (r_left + r_right)
    return ((v_left * rho).sum(-1) <= 0) | ((v_right * rho).sum(-1) <= 0)


def _iterative_turning_check(mm, r, r_sum, r_ckpts, r_sum_ckpts, idx_min, idx_max):
    """U-turns between the new (odd) leaf and every checkpointed span start
    in ``[idx_min, idx_max]``; all slots are evaluated and masked to the live
    range.  ``r_ckpts`` and ``r_sum_ckpts`` are ``(C, max_depth, dim)``."""
    span_r_sum = r_sum[:, None] - r_sum_ckpts + r_ckpts
    turning = _is_turning(mm, r_ckpts, r[:, None].expand_as(r_ckpts), span_r_sum)  # (C, md)
    slots = torch.arange(r_ckpts.shape[1], device=r.device)
    live = (slots >= idx_min[:, None]) & (slots <= idx_max[:, None])
    return (turning & live).any(-1)


@lru_cache(maxsize=None)
def _schedule_tables(max_depth):
    """Static schedule of the flat tree loop for ``2**max_depth - 1``
    iterations: ``(depth, idx_min, idx_max, is_even, complete)``."""
    total = (1 << max_depth) - 1
    i = np.arange(total)
    depth = np.floor(np.log2(i + 1)).astype(np.int64)
    leaf = i - ((1 << depth) - 1)

    def popcount(x):
        return np.array([bin(int(v)).count("1") for v in x], dtype=np.int64)

    idx_max = popcount(leaf >> 1)
    trailing_ones = popcount(leaf ^ (leaf + 1)) - 1
    idx_min = idx_max - trailing_ones + 1
    is_even = (leaf & 1) == 0
    complete = leaf == (1 << depth) - 1
    return depth, idx_min, idx_max, is_even, complete


@lru_cache(maxsize=None)
def _const_i_table(max_depth, device):
    _, idx_min, idx_max, even, complete = _schedule_tables(max_depth)
    return torch.as_tensor(np.stack([idx_min, idx_max, even, complete], axis=1), device=device)


def select_lanes(mask, new, old):
    """Per lane, ``new`` where ``mask`` ``(C,)`` holds and ``old`` elsewhere,
    for two NamedTuples of the same type whose fields all carry a leading
    chain axis."""
    return type(old)(*(torch.where(mask.reshape(mask.shape + (1,) * (o.ndim - 1)), n, o)
                       for n, o in zip(new, old)))


class TreeCarry(NamedTuple):
    """State of the in-flight transitions, one per chain."""

    i: torch.Tensor  # (C,) flat iteration index
    turning: torch.Tensor  # (C,) bool
    diverging: torch.Tensor  # (C,) bool
    vecs: torch.Tensor  # (C, 15, dim) packed vector state
    scal: torch.Tensor  # (C, 5) packed scalar state
    ckpts: torch.Tensor  # (C, 2, md, dim) U-turn checkpoints [r, r_sum]
    const_f: torch.Tensor  # (C, total, 4) the transition's randomness
    h0: torch.Tensor  # (C,) initial Hamiltonian
    step_size: torch.Tensor  # (C,)


class TreeDraws(NamedTuple):
    """One transition's randomness for ``C`` chains, as drawn."""

    eps: torch.Tensor  # (C, dim) unit normals; the momentum is mass_chol @ eps
    u_dirs: torch.Tensor  # (C, md + 1) per-doubling direction uniforms (one spare)
    u_mult: torch.Tensor  # (C, total) per-leaf multinomial uniforms
    u_merge: torch.Tensor  # (C, md) per-doubling biased-accept uniforms


def tree_draws(num_chains, dim, max_tree_depth, dtype, device, generator) -> TreeDraws:
    """Draw a transition's randomness for ``num_chains`` chains from
    ``generator``: ``randn(C, dim)``, then ``rand(C, md + 1)``, ``rand(C,
    total)`` and ``rand(C, md)``, in that order."""
    md = int(max_tree_depth)
    total = (1 << md) - 1
    def draw(fn, *shape):
        return chain_draw(fn, (num_chains,) + shape, generator, dtype, device)

    eps = draw(torch.randn, dim)
    return TreeDraws(eps, draw(torch.rand, md + 1), draw(torch.rand, total), draw(torch.rand, md))


def tree_start_from(state: NUTSState, mm: MassMatrix, step_size, draws: TreeDraws) -> TreeCarry:
    """Pack the initial tree state of every chain from its draws: the
    momentum ``mass_chol @ eps`` and the transition's randomness spread onto
    the flat iteration axis.  Deterministic."""
    z = state.z
    C, dtype, dev = z.shape[0], z.dtype, z.device
    md = draws.u_merge.shape[1]
    depth_tab = torch.as_tensor(_schedule_tables(md)[0], device=dev)

    r0 = momentum_from_normal(mm, draws.eps)
    h0 = state.pe + kinetic_energy(mm, r0)

    # per-doubling directions (one spare slot for the next-subtree lookup at
    # the last merge), per-leaf multinomial uniforms, per-doubling
    # biased-accept uniforms, spread onto the flat iteration axis
    dirs = torch.where(draws.u_dirs < 0.5, 1.0, -1.0).to(dtype)
    log_u_mult = torch.log(draws.u_mult)
    log_u_merge = torch.log(draws.u_merge)
    const_f = torch.stack([dirs[:, depth_tab], log_u_mult, log_u_merge[:, depth_tab], dirs[:, depth_tab + 1]], dim=2)

    g = state.grad
    vecs0 = torch.stack([z, r0, g, z, r0, g, z, g, r0, z, r0, g, z, g, torch.zeros_like(r0)], dim=1)
    zeros = torch.zeros(C, dtype=dtype, device=dev)
    scal0 = torch.stack([zeros, torch.full_like(zeros, -torch.inf), state.pe, state.pe, zeros], dim=1)
    flags = torch.zeros(C, dtype=torch.bool, device=dev)
    return TreeCarry(
        i=torch.zeros(C, dtype=torch.int64, device=dev),
        turning=flags,
        diverging=flags,
        vecs=vecs0,
        scal=scal0,
        ckpts=torch.zeros((C, 2, md) + z.shape[1:], dtype=dtype, device=dev),
        const_f=const_f,
        h0=h0,
        step_size=torch.as_tensor(step_size, dtype=dtype, device=dev).expand(C),
    )


def tree_start(state: NUTSState, mm: MassMatrix, step_size, generator, max_tree_depth) -> TreeCarry:
    """Draw momenta and the transition's randomness (:func:`tree_draws`),
    and pack the initial tree state (:func:`tree_start_from`)."""
    z = state.z
    draws = tree_draws(z.shape[0], z.shape[1], max_tree_depth, z.dtype, z.device, generator)
    return tree_start_from(state, mm, step_size, draws)


def tree_active(carry: TreeCarry, max_tree_depth):
    total = (1 << int(max_tree_depth)) - 1
    return (carry.i < total) & ~carry.turning & ~carry.diverging


def tree_step(potential_fn, mm: MassMatrix, carry: TreeCarry, max_tree_depth, max_delta_energy=1000.0) -> TreeCarry:
    """One flat tree iteration for every chain of ``carry``: one leapfrog
    and the tree bookkeeping.  A lane whose tree has stopped is stepped as
    well (its index held inside the tables); the caller discards its
    result."""
    md = int(max_tree_depth)
    vecs, scal, ckpts = carry.vecs, carry.scal, carry.ckpts
    i = carry.i
    C = i.shape[0]
    rows = torch.arange(C, device=i.device)
    ii = i.clamp_max((1 << md) - 2)
    f = carry.const_f[rows, ii]
    c = _const_i_table(md, i.device)[ii]
    direction, log_u, log_u_m, next_dir = f.unbind(1)
    idx_min, idx_max = c[:, 0], c[:, 1]
    is_even = c[:, 2] == 1
    complete = c[:, 3] == 1

    def col(mask):
        return mask[:, None]

    z, r, pe, grad = leapfrog(potential_fn)(
        vecs[:, _S_Z], vecs[:, _S_R], vecs[:, _S_G], direction * carry.step_size, mm
    )
    delta = pe + kinetic_energy(mm, r) - carry.h0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    diverging = delta > max_delta_energy
    leaf_logw = -delta
    accept = torch.clamp_max(torch.exp(-delta), 1.0)

    # progressive multinomial proposal within the subtree
    sub_logw = torch.logaddexp(scal[:, _S_LOGW], leaf_logw)
    take = log_u < leaf_logw - sub_logw
    sub_r_sum = vecs[:, _S_RSUM] + r

    # checkpointed U-turn bookkeeping: even leaves store, odd leaves test
    def store(ck, v):
        upd = ck.clone()
        upd[rows, idx_max] = v
        return torch.where(is_even[:, None, None], upd, ck)

    r_ck = store(ckpts[:, 0], r)
    rs_ck = store(ckpts[:, 1], sub_r_sum)
    sub_turn = ~(is_even | diverging) & _iterative_turning_check(mm, r, sub_r_sum, r_ck, rs_ck, idx_min, idx_max)

    merge = complete & ~(sub_turn | diverging)

    # merged tree edges: the subtree's far edge replaces the tree edge in
    # the subtree's direction
    right = col(direction > 0)
    zl = torch.where(right, vecs[:, _Z_L], z)
    rl = torch.where(right, vecs[:, _R_L], r)
    gl = torch.where(right, vecs[:, _G_L], grad)
    zr = torch.where(right, z, vecs[:, _Z_R])
    rr = torch.where(right, r, vecs[:, _R_R])
    gr = torch.where(right, grad, vecs[:, _G_R])
    r_sum_m = vecs[:, _R_SUM] + sub_r_sum
    turn_full = _is_turning(mm, rl, rr, r_sum_m)

    # biased progressive sampling across the doubling (Stan): favour the new
    # subtree
    take_m = merge & (log_u_m < sub_logw - scal[:, _LOGW])

    s_zp = torch.where(col(take), z, vecs[:, _S_ZP])
    s_gp = torch.where(col(take), grad, vecs[:, _S_GP])
    s_pep = torch.where(take, pe, scal[:, _S_PE_P])
    next_right = col(next_dir > 0)
    m = col(merge)
    tm = col(take_m)

    new_vecs = torch.stack(
        [
            torch.where(m, zl, vecs[:, _Z_L]),
            torch.where(m, rl, vecs[:, _R_L]),
            torch.where(m, gl, vecs[:, _G_L]),
            torch.where(m, zr, vecs[:, _Z_R]),
            torch.where(m, rr, vecs[:, _R_R]),
            torch.where(m, gr, vecs[:, _G_R]),
            torch.where(tm, s_zp, vecs[:, _Z_P]),
            torch.where(tm, s_gp, vecs[:, _G_P]),
            torch.where(m, r_sum_m, vecs[:, _R_SUM]),
            # next subtree's moving edge: the merged tree edge in the next
            # doubling's direction (mid-subtree: this leaf)
            torch.where(m, torch.where(next_right, zr, zl), z),
            torch.where(m, torch.where(next_right, rr, rl), r),
            torch.where(m, torch.where(next_right, gr, gl), grad),
            s_zp,
            s_gp,
            torch.where(m, 0.0, sub_r_sum),
        ],
        dim=1,
    )
    new_scal = torch.stack(
        [
            torch.where(merge, torch.logaddexp(scal[:, _LOGW], sub_logw), scal[:, _LOGW]),
            torch.where(merge, -torch.inf, sub_logw),
            torch.where(take_m, s_pep, scal[:, _PE_P]),
            s_pep,
            scal[:, _ACC] + accept,
        ],
        dim=1,
    )
    return TreeCarry(
        i=i + 1,
        turning=carry.turning | sub_turn | (merge & turn_full),
        diverging=carry.diverging | diverging,
        vecs=new_vecs,
        scal=new_scal,
        ckpts=torch.stack([r_ck, rs_ck], dim=1),
        const_f=carry.const_f,
        h0=carry.h0,
        step_size=carry.step_size,
    )


def tree_finish(carry: TreeCarry, max_tree_depth) -> NUTSState:
    """Read the transition result out of a terminated carry."""
    md = int(max_tree_depth)
    depth_of = torch.as_tensor(_schedule_tables(md)[0], device=carry.i.device)
    stopped = carry.turning | carry.diverging
    # a stop in the middle of a subtree still counts the doubling it was in
    tree_depth = torch.where(stopped, depth_of[(carry.i - 1).clamp_min(0)] + 1, md)
    num_steps = carry.i
    accept_prob = carry.scal[:, _ACC] / num_steps.clamp_min(1).to(carry.scal.dtype)
    return NUTSState(
        z=carry.vecs[:, _Z_P],
        pe=carry.scal[:, _PE_P],
        grad=carry.vecs[:, _G_P],
        energy=carry.h0,
        accept_prob=accept_prob,
        num_steps=num_steps,
        diverging=carry.diverging,
        tree_depth=tree_depth,
    )


def nuts_transition(potential_fn, state: NUTSState, mm: MassMatrix, step_size, generator,
                    max_tree_depth=10, max_delta_energy=1000.0, on_read=None):
    """One NUTS transition for every chain.  Each leapfrog round steps all
    lanes and keeps the stopped ones unchanged; the round's stop test is one
    read to the host (``on_read()`` is called for each)."""
    md = int(max_tree_depth)
    carry = tree_start(state, mm, step_size, generator, md)
    active = tree_active(carry, md)  # a fresh tree always takes its first leapfrog
    while True:
        carry = select_lanes(active, tree_step(potential_fn, mm, carry, md, max_delta_energy), carry)
        active = tree_active(carry, md)
        if on_read is not None:
            on_read()
        if not bool(active.any()):
            return tree_finish(carry, md)


def nuts_init(potential_fn, z):
    pe, grad = value_and_grad(potential_fn, z)
    C = z.shape[0]
    return NUTSState(
        z=z,
        pe=pe,
        grad=grad,
        energy=pe,
        accept_prob=torch.ones(C, dtype=z.dtype, device=z.device),
        num_steps=torch.zeros(C, dtype=torch.int64, device=z.device),
        diverging=torch.zeros(C, dtype=torch.bool, device=z.device),
        tree_depth=torch.zeros(C, dtype=torch.int64, device=z.device),
    )


class NUTS:
    """NUTS kernel configuration, consumed by :class:`~gwinferno_tpu_torch.infer.MCMC`.
    ``init_strategy`` is accepted and unused, as in the JAX package."""

    def __init__(
        self,
        model,
        step_size=1.0,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        max_tree_depth=10,
        max_delta_energy=1000.0,
        init_strategy=None,
    ):
        self.model = model
        self.step_size = step_size
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.dense_mass = dense_mass
        self.target_accept_prob = target_accept_prob
        self.max_tree_depth = max_tree_depth
        self.max_delta_energy = max_delta_energy
        self.init_strategy = init_strategy

    def make_transition(self, potential_fn, on_read=None):
        def transition(state, mm, step_size, generator):
            return nuts_transition(potential_fn, state, mm, step_size, generator,
                                   self.max_tree_depth, self.max_delta_energy, on_read=on_read)

        return transition

    def make_tree_ops(self, potential_fn):
        """``(start, active, step, finish)`` over the transition's state
        machine, for a scheduler that interleaves many chains' transitions:
        ``start(state, mm, step_size, draws)`` (draws from
        :func:`tree_draws` at this kernel's ``max_tree_depth``),
        ``active(carry)``, ``step(mm, carry)`` (one leapfrog on every lane)
        and ``finish(carry)``."""
        md = self.max_tree_depth

        def active(carry):
            return tree_active(carry, md)

        def step(mm, carry):
            return tree_step(potential_fn, mm, carry, md, self.max_delta_energy)

        def finish(carry):
            return tree_finish(carry, md)

        return tree_start_from, active, step, finish

    def make_init(self, potential_fn):
        return lambda z: nuts_init(potential_fn, z)
