"""K2, the streamed whole-chain likelihood of the bench model.

Counterpart of ``gwinferno_tpu/ops/streamed.py``.  The per-sample log-weight
chain of the bench model runs inside a kernel together with the paired
reduction, so a gradient never materialises a ``(C, N_bank)`` intermediate:
the forward writes only the per-row ``(logsumexp(lw), logsumexp(2 lw))`` and
the backward re-streams the bank.  These are the two sufficient statistics
that :func:`~gwinferno_tpu_torch.pipeline.analysis.hierarchical_likelihood`'s
summaries seam takes.

The JAX op takes any traced ``logw_fn`` and differentiates it with
``jax.vjp`` inside its kernels.  CUDA has no in-kernel autodiff, so this op
is written for ONE chain, the bench model's (``bench.py::streamed_logw``):
powerlaw+peak ``(m1, q)``, beta spin magnitudes, isotropic+aligned tilts and
the powerlaw-in-``(1+z)`` redshift term, with the hyperparameters ``THETA``.
Another chain needs its own hand-written derivative, in the kernels and in
the plain versions here.

The split of the work:

- :func:`chain_params` (plain torch, under autograd) maps the hyperparameters
  to a per-chain vector ``P`` of every term that depends on them alone (the
  truncated-normal denominators, the betaln, the m1 powerlaw norm,
  ``log lambda``, ...);
- :class:`StreamedBank` computes the data-only columns (``log m1``,
  ``log q``, ``log a``, ..., the support bits) once per dtype and device;
- the op evaluates the per-sample chain from ``P`` and the columns and
  returns ``d/dP`` in its backward.  On a CUDA tensor both directions are the
  hand-written kernels of ``csrc/streamed.cu`` (one launch covers all C
  chains, C = 1 included, with a geometry that :func:`device_geometry`
  takes from the card); on a CPU tensor they are the plain versions
  :func:`_streamed_fwd_torch` and :func:`_streamed_bwd_torch`, which run the
  same chain and the same analytic derivative in torch ops, in chunks over
  the bank.

Any other chain goes through :func:`make_streamed_double_logsumexp`, the
counterpart of the JAX function of that name: the caller's ``logw_fn`` in
torch, block of bank rows by block, each block reduced by K1
(``ops/fused.py``), with a backward that re-streams the banks, forms each
block's log-weight cotangent in the hand-written kernel ``csrc/lse_vjp.cu``
(:func:`lse_vjp`) and pulls it back with ``torch.autograd.grad``.  It is not
a port of K2 for other chains: CUDA has no in-kernel autodiff, so the
elementwise chain and its derivative are the caller's torch code, and the
hand-written kernels are the reduction (K1) and its pullback (``lse_vjp``).
It keeps what the JAX op is for, that no ``(C, N_bank)`` intermediate
survives: one block's ``(C, block_rows, S)`` log weights at a time.

The ops reduce what this process holds; under a mesh with a data axis the
likelihood's layer merges the ranks' pairs
(``pipeline/analysis.py::summaries_over_data``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..distributions import _betaln
from ..distributions import _norm_cdf
from ..distributions import _powerlaw_log_norm
from ._build import Kernel
from .chunked import summaries_from_pairs
from .fused import _sm_count
from .fused import double_logsumexp

__all__ = [
    "THETA",
    "StreamedBank",
    "K2Geometry",
    "chain_params",
    "k2_geometry",
    "k2_geometry_at",
    "device_geometry",
    "k2_kernel_info",
    "make_streamed_double_logsumexp",
    "lse_vjp",
    "LSE_VJP_KERNEL",
    "reshape_bank_rows",
    "streamed_pairs",
    "streamed_summaries",
    "STREAMED_FWD_KERNEL",
    "STREAMED_BWD_KERNEL",
]

# the bench chain's hyperparameters (bench.py::streamed_logw)
THETA = (
    "alpha", "beta", "mu_peak", "sig_peak", "lambda_m", "alpha_a1", "beta_a1", "alpha_a2", "beta_a2",
    "lambda_ct1", "lambda_ct2", "sig_ct1", "sig_ct2", "lamb", "z_lognorm",
)
# the bank's named inputs, each (rows, S)
BANK_KEYS = (
    "mass_1", "mass_ratio", "redshift", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2", "log_prior", "log_dvdz", "log1pz",
)

# data columns, support bits and parameter layout: must match csrc/streamed.cu
(M1, LOG_M1, LOG_Q, LOG_LOW, LOG_A1, LOG_1MA1, LOG_A2, LOG_1MA2, CT1M1, CT2M1, LOG1PZ, LOG_DVDZ, LOG_PRIOR) = range(13)
N_COL = 13
F_M1, F_Q, F_A1, F_A2, F_CT1, F_CT2, F_ZOK, F_VALID = (1 << k for k in range(8))
F_SUPPORT = F_M1 | F_Q | F_A1 | F_A2 | F_CT1 | F_CT2 | F_VALID
(P_BETA, P_AP1, P_LOGABS_AP1, P_IS_M1, P_ALPHA, P_C_PL, P_MU, P_INV_SIG, P_C_PEAK,
 P_A1, P_B1, P_N1, P_A2, P_B2, P_N2,
 P_ISO1, P_ALI1, P_INV_ST1, P_ISO2, P_ALI2, P_INV_ST2, P_LAMB1, P_ZL) = range(23)
N_P = 23
P_STRIDE = 24

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_CHUNK = 2048  # samples per chunk of the plain versions

# launch geometry (csrc/streamed.cu): threads and warps a block; the
# forward's samples a thread and the backward's samples a lane to choose
# from; a block's fixed cost (its staging and closing reduction) in samples a
# thread; the cap on the backward's staged tile; an SM's shared memory and
# what the card reserves of it per block
_THREADS = 256
_WARPS = _THREADS // 32
_FWD_PER_THREAD = range(1, 17)
_BWD_PER_LANE = (1, 2, 4, 8, 16, 32)
_BLOCK_COST = {"fwd": 1.5, "bwd": 4.0}
_MAX_SMEM = 64 * 1024
_SLOT = 32  # a backward warp's shared-memory slot, in values
_SM_SMEM, _SMEM_PER_BLOCK = 233472, 1024
# the most chains a forward block carries (the kernel's kMaxChains; the
# backward gives each warp one chain): the fastest choice on an H100, PERF.md
FWD_GROUP = 4

_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_INFO_ARGS = [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
# one source, one library; one Kernel (and launch count) per direction.  Each
# kernel has a chain axis, so it replaces both the one-chain and the
# chain-batched Pallas kernel: forward :115 and :234, backward :134 and :260.
STREAMED_FWD_KERNEL = Kernel(
    "gw_streamed",
    "streamed.cu",
    {"gw_k2_fwd_f32": _FWD_ARGS, "gw_k2_fwd_f64": _FWD_ARGS, "gw_k2_kernel_info": _INFO_ARGS},
    replaces="gwinferno_tpu/ops/streamed.py:234",
)
STREAMED_BWD_KERNEL = Kernel(
    "gw_streamed",
    "streamed.cu",
    {"gw_k2_bwd_f32": _BWD_ARGS, "gw_k2_bwd_f64": _BWD_ARGS},
    replaces="gwinferno_tpu/ops/streamed.py:260",
)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the generic op's backward (csrc/lse_vjp.cu): the reduction side of the
# Pallas backward kernels :134 and :260 for any chain
_VJP_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
LSE_VJP_KERNEL = Kernel(
    "gw_lse_vjp",
    "lse_vjp.cu",
    {"gw_lse_vjp_f32": _VJP_ARGS, "gw_lse_vjp_f64": _VJP_ARGS,
     "gw_lse_vjp_empty": [ctypes.c_longlong] * 2 + [ctypes.c_void_p]},
    replaces="gwinferno_tpu/ops/streamed.py:134",
)


# ----------------------------------------------------------------- parameters


def chain_params(theta, mmin, mmax):
    """The per-chain parameter vector ``P`` ``(C, P_STRIDE)`` of the bench
    chain from its hyperparameters ``theta`` (``{name: (C,)}``, ``THETA``).

    Plain torch: autograd carries the kernels' ``d/dP`` on to ``theta``.  The
    terms are those of the flat route's pdfs (``distributions.py``,
    ``models/parametric/parametric.py``) that do not depend on a sample.
    """
    th = {k: torch.as_tensor(theta[k]) for k in THETA}
    beta = th["beta"]
    is_m1 = beta == -1.0
    ap1 = 1.0 + torch.where(is_m1, 0.0, beta)
    lam, mu, sig = th["lambda_m"], th["mu_peak"], th["sig_peak"]
    peak_denom = _norm_cdf((mmax - mu) / sig) - _norm_cdf((mmin - mu) / sig)

    def tilt(xi, sig_t):
        denom = _norm_cdf((1.0 - 1.0) / sig_t) - _norm_cdf((-1.0 - 1.0) / sig_t)
        return (
            torch.log1p(-xi) - math.log(2.0),
            torch.log(xi) + (-torch.log(sig_t) - _LOG_SQRT_2PI - torch.log(denom)),
            1.0 / sig_t,
        )

    iso1, ali1, inv_st1 = tilt(th["lambda_ct1"], th["sig_ct1"])
    iso2, ali2, inv_st2 = tilt(th["lambda_ct2"], th["sig_ct2"])
    cols = [
        beta,
        ap1,
        torch.log(torch.abs(ap1)),
        is_m1.to(beta.dtype),
        th["alpha"],
        torch.log1p(-lam) + _powerlaw_log_norm(th["alpha"], mmin, mmax),
        mu,
        1.0 / sig,
        torch.log(lam) + (-torch.log(sig) - _LOG_SQRT_2PI - torch.log(peak_denom)),
        th["alpha_a1"] - 1.0,
        th["beta_a1"] - 1.0,
        -_betaln(th["alpha_a1"], th["beta_a1"]),
        th["alpha_a2"] - 1.0,
        th["beta_a2"] - 1.0,
        -_betaln(th["alpha_a2"], th["beta_a2"]),
        iso1, ali1, inv_st1,
        iso2, ali2, inv_st2,
        th["lamb"] - 1.0,
        th["z_lognorm"],
    ]
    cols = torch.broadcast_tensors(*cols)
    return torch.stack(list(cols) + [torch.zeros_like(beta)] * (P_STRIDE - N_P), dim=-1)


# ----------------------------------------------------------------- the bank


class StreamedBank:
    """One sample bank of the bench chain, ``(rows, S)`` samples, as the
    kernels read it.

    ``banks``: ``{name: (rows, S)}`` host arrays for every name in
    ``BANK_KEYS`` (the seven sample parameters plus ``log_prior``,
    ``log_dvdz`` and ``log1pz``, as ``bench.py`` builds them).  ``valid``
    (``(rows, S)``, optional) marks the real samples of a padded bank.
    ``zmax`` is the redshift model's upper bound.  Calling the bank with a
    hyperparameter dict ``theta`` (``{name: (C,)}``) returns the per-row
    ``(lse1, lse2)``, each ``(C, rows)``, differentiable in ``theta``.
    """

    def __init__(self, banks, mmin, mmax, zmax, valid=None):
        missing = set(BANK_KEYS) - set(banks)
        if missing:
            raise ValueError(f"bank misses {sorted(missing)}")
        self.host = {k: np.asarray(banks[k], np.float64) for k in BANK_KEYS}
        self.shape = self.host["mass_1"].shape
        if len(self.shape) != 2 or any(v.shape != self.shape for v in self.host.values()):
            raise ValueError(f"bank arrays must all have one 2-D shape, got {[v.shape for v in self.host.values()]}")
        self.valid = np.ones(self.shape, bool) if valid is None else np.asarray(valid) > 0
        if self.valid.shape != self.shape:
            raise ValueError(f"valid mask of shape {self.valid.shape} for a bank of shape {self.shape}")
        self.mmin, self.mmax, self.zmax = float(mmin), float(mmax), float(zmax)
        self._columns = {}

    def columns(self, dtype, device):
        """``(cols (N_COL, rows, S), flags (rows, S) int32)`` in ``dtype`` on
        ``device``, computed once per (dtype, device).  Each column is the
        same torch op on the same values as the flat route's pdfs evaluate,
        so the two routes see bit-identical data."""
        device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0", one key per card
        key = (dtype, device)
        if key not in self._columns:
            self._columns[key] = self._build(dtype, device)
        return self._columns[key]

    def _build(self, dtype, device):
        t = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in self.host.items()}
        m1, q = t["mass_1"], t["mass_ratio"]
        low = self.mmin / m1
        a1, a2, ct1, ct2 = t["a_1"], t["a_2"], t["cos_tilt_1"], t["cos_tilt_2"]
        cols = torch.stack([
            m1, torch.log(m1), torch.log(q), torch.log(low),
            torch.log(a1), torch.log(1.0 - a1), torch.log(a2), torch.log(1.0 - a2),
            ct1 - 1.0, ct2 - 1.0, t["log1pz"], t["log_dvdz"], t["log_prior"],
        ]).contiguous()
        bits = [
            (F_M1, ~((m1 < self.mmin) | (m1 > self.mmax))),
            (F_Q, ~((q < low) | (q > 1.0))),
            (F_A1, (a1 <= 1.0) & (a1 >= 0.0)),
            (F_A2, (a2 <= 1.0) & (a2 >= 0.0)),
            (F_CT1, ~((ct1 > 1.0) | (ct1 < -1.0))),
            (F_CT2, ~((ct2 > 1.0) | (ct2 < -1.0))),
            (F_ZOK, torch.as_tensor(self.host["redshift"] <= self.zmax, device=device)),
            (F_VALID, torch.as_tensor(self.valid, device=device)),
        ]
        flags = torch.zeros(self.shape, dtype=torch.int32, device=device)
        for bit, ok in bits:
            flags |= ok.to(torch.int32) * bit
        return cols, flags

    def __call__(self, theta):
        P = chain_params(theta, self.mmin, self.mmax)
        cols, flags = self.columns(P.dtype, P.device)
        return _StreamedDoubleLogSumExp.apply(P, cols, flags)


def reshape_bank_rows(bank_1d, cols=8192):
    """Reshape flat ``(N,)`` banks into ``(r, cols)`` rows for the streamed
    op, edge-padding the tail; returns ``(rows, valid)``, where ``valid``
    ``(r, cols)`` marks the real samples.

    Every bank must have one length (the JAX version takes it from the last
    key).  Values keep their dtype (float64 stays float64)."""
    lengths = {k: np.shape(v) for k, v in bank_1d.items()}
    if len(set(lengths.values())) != 1 or len(next(iter(lengths.values()))) != 1:
        raise ValueError(f"reshape_bank_rows needs 1-D banks of one length, got {lengths}")
    n = next(iter(lengths.values()))[0]
    r = -(-n // cols)
    out = {k: np.pad(np.asarray(v), (0, r * cols - n), mode="edge").reshape(r, cols) for k, v in bank_1d.items()}
    valid = np.zeros(r * cols, np.float32)
    valid[:n] = 1.0
    return out, valid.reshape(r, cols)


def streamed_pairs(pe_call, inj_call, theta):
    """The PE bank's per-event pair and the injection bank's pair (its rows'
    pairs merged) from two streamed ops (:class:`StreamedBank` or
    :func:`make_streamed_double_logsumexp`'s callables), with an optional
    leading chain axis."""
    il1, il2 = inj_call(theta)
    return pe_call(theta), (torch.logsumexp(il1, dim=-1), torch.logsumexp(il2, dim=-1))


def streamed_summaries(pe_call, inj_call, theta, n_samples, total_inj):
    """Assemble ``hierarchical_likelihood`` summaries from two streamed ops
    (the PE bank and the row-reshaped injection bank, see
    :func:`streamed_pairs`); the tail arithmetic of
    ``gwinferno_tpu/ops/streamed.py::streamed_summaries``, with an optional
    leading chain axis."""
    return summaries_from_pairs(*streamed_pairs(pe_call, inj_call, theta), n_samples, total_inj)


# ----------------------------------------------------------------- the generic op


class _Blocks:
    """The banks and row blocks of one generic streamed op, and its
    per-block log weights."""

    def __init__(self, logw_fn, banks, block_rows, valid):
        self.logw_fn = logw_fn
        self.names = sorted(banks)
        shapes = {np.shape(banks[k]) for k in self.names}
        if len(shapes) != 1 or len(next(iter(shapes))) != 2:
            raise ValueError(f"streamed banks must all have one 2-D shape, got {shapes}")
        self.rows, self.S = next(iter(shapes))
        R = int(block_rows)
        self.blocks = [(r, min(r + R, self.rows)) for r in range(0, self.rows, R)]
        self.host = banks
        self.valid = None if valid is None else np.asarray(valid) > 0
        self._on = {}

    def on(self, dtype, device):
        """The banks (floating ones in ``dtype``) and the valid mask on
        ``device``, made once per (dtype, device)."""
        device = torch.empty(0, device=device).device
        key = (dtype, device)
        if key not in self._on:
            def put(v):
                t = torch.as_tensor(v, device=device)
                return t.to(dtype) if t.is_floating_point() and isinstance(v, np.ndarray) else t
            banks = {k: put(self.host[k]) for k in self.names}
            valid = None if self.valid is None else torch.as_tensor(self.valid, device=device)
            self._on[key] = (banks, valid)
        return self._on[key]

    def block_lw(self, theta, banks, valid, r0, r1):
        """``logw_fn`` on rows ``r0:r1``, ``-inf`` where not valid."""
        lw = self.logw_fn({k: v[r0:r1] for k, v in banks.items()}, theta)
        if valid is not None:
            lw = torch.where(valid[r0:r1], lw, -torch.inf)
        return lw


def _theta_view(keys, leaves):
    """``theta`` as ``logw_fn`` sees it: a ``(C,)`` leaf as ``(C, 1, 1)``,
    so that it broadcasts against a ``(rows, S)`` block; a scalar as is."""
    return {k: (x[:, None, None] if x.ndim == 1 else x) for k, x in zip(keys, leaves)}


def _lse_vjp_torch(lw, g1, g2, l1, l2):
    """Plain version of :func:`lse_vjp`."""
    f1, f2 = torch.isfinite(l1), torch.isfinite(l2)
    g1, l1 = torch.where(f1, g1, 0.0), torch.where(f1, l1, 0.0)
    g2, l2 = torch.where(f2, g2, 0.0), torch.where(f2, l2, 0.0)
    return g1[..., None] * torch.exp(lw - l1[..., None]) + (2.0 * g2[..., None]) * torch.exp(2.0 * lw - l2[..., None])


def lse_vjp_cuda(lw, g1, g2, l1, l2):
    """Launch the generic op's backward kernel on a contiguous 2-D CUDA
    tensor ``lw`` ``(rows, n)`` with contiguous ``(rows,)`` ``g1, g2, l1,
    l2`` of its dtype; returns ``w`` ``(rows, n)``."""
    if not lw.is_cuda:
        raise ValueError("lse_vjp_cuda needs a CUDA tensor")
    if lw.dtype not in _SUFFIX:
        raise TypeError(f"lse_vjp_cuda supports float32 and float64, got {lw.dtype}")
    rows, n = lw.shape
    for t in (g1, g2, l1, l2):
        if t.shape != (rows,) or t.dtype != lw.dtype or t.device != lw.device or not t.is_contiguous():
            raise ValueError(f"lse_vjp_cuda needs contiguous ({rows},) {lw.dtype} row vectors on {lw.device}")
    if not lw.is_contiguous():
        raise ValueError("lse_vjp_cuda needs a contiguous lw")
    w = torch.empty_like(lw)
    with torch.cuda.device(lw.device):
        stream = torch.cuda.current_stream(lw.device).cuda_stream
        LSE_VJP_KERNEL.call(f"gw_lse_vjp_{_SUFFIX[lw.dtype]}", lw.data_ptr(), g1.data_ptr(), g2.data_ptr(),
                            l1.data_ptr(), l2.data_ptr(), w.data_ptr(), rows, n, stream)
    LSE_VJP_KERNEL.launches += 1
    return w


def lse_vjp_empty_cuda(rows, n):
    """Launch an empty kernel with lse_vjp's grid and threads on a ``(rows,
    n)`` block, on the current stream: the launch floor lse_vjp's time is
    read against."""
    LSE_VJP_KERNEL.call("gw_lse_vjp_empty", rows, n, torch.cuda.current_stream().cuda_stream)


def lse_vjp(lw, g1, g2, l1, l2):
    """The cotangent of log weights ``lw`` ``(..., n)`` from the cotangents
    ``g1, g2`` ``(...)`` of their rows' ``l1 = logsumexp(lw)`` and ``l2 =
    logsumexp(2 lw)``: ``g1 exp(lw - l1) + 2 g2 exp(2 lw - l2)``, a row whose
    ``l1`` (``l2``) is not finite taking a zero ``g1`` (``g2``) against a
    zero residual, as the JAX ``core_bwd`` sanitises them.  The kernel
    ``csrc/lse_vjp.cu`` on a CUDA tensor, the plain version on a CPU one."""
    if lw.is_cuda:
        lead, n = lw.shape[:-1], lw.shape[-1]
        rows = [t.to(lw.dtype).expand(lead).reshape(-1).contiguous() for t in (g1, g2, l1, l2)]
        return lse_vjp_cuda(lw.reshape(-1, n).contiguous(), *rows).reshape(lw.shape)
    if lw.device.type == "cpu":
        return _lse_vjp_torch(lw, g1, g2, l1, l2)
    raise ValueError(f"lse_vjp: no kernel for device {lw.device}")


class _GenericStreamed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, keys, *leaves):
        banks, valid = op.on(leaves[0].dtype, leaves[0].device)
        th = _theta_view(keys, leaves)
        pairs = [double_logsumexp(op.block_lw(th, banks, valid, r0, r1)) for r0, r1 in op.blocks]
        l1 = torch.cat([p[0] for p in pairs], dim=-1)
        l2 = torch.cat([p[1] for p in pairs], dim=-1)
        ctx.op, ctx.keys = op, keys
        ctx.save_for_backward(l1, l2, *leaves)
        return l1, l2

    @staticmethod
    def backward(ctx, g1, g2):
        op, keys = ctx.op, ctx.keys
        l1, l2, *leaves = ctx.saved_tensors
        banks, valid = op.on(leaves[0].dtype, leaves[0].device)
        need = [i for i, n in enumerate(ctx.needs_input_grad[2:]) if n]
        grads = [None] * len(leaves)
        with torch.enable_grad():
            req = [x.detach().requires_grad_(i in need) for i, x in enumerate(leaves)]
            th = _theta_view(keys, req)
            for r0, r1 in op.blocks:
                lw = op.block_lw(th, banks, valid, r0, r1)
                w = lse_vjp(lw.detach(), g1[..., r0:r1], g2[..., r0:r1], l1[..., r0:r1], l2[..., r0:r1])
                parts = torch.autograd.grad(lw, [req[i] for i in need], grad_outputs=w, allow_unused=True)
                for i, p in zip(need, parts):
                    if p is not None:
                        grads[i] = p if grads[i] is None else grads[i] + p
        grads = [torch.zeros_like(x) if g is None and i in need else g for i, (x, g) in enumerate(zip(leaves, grads))]
        return (None, None, *grads)


def make_streamed_double_logsumexp(logw_fn, banks, block_rows=8, interpret=None, valid=None):
    """Build ``f(theta) -> (lse1, lse2)`` over the sample banks, the
    counterpart of the JAX function of this name for any log-weight chain.

    ``banks``: dict name -> ``(rows, S)`` arrays or tensors, constants of
    the problem (numpy floating arrays are put on ``theta``'s device in its
    dtype at the first call; tensors are used as they are).
    ``logw_fn(block, theta)``: log weights of one ``(r, S)`` block of rows,
    written for a ``theta`` whose values are ``(C, 1, 1)`` (``theta`` a dict
    of ``(C,)`` tensors, C chains) or scalars (C = 1), so ``(C, r, S)`` or
    ``(r, S)``.  ``valid`` ``(rows, S)`` marks the real samples (the others
    get ``-inf``).  Returns the per-row ``logsumexp(logw)`` and
    ``logsumexp(2 logw)``, ``(C, rows)`` or ``(rows,)``.

    The forward reduces each block of ``block_rows`` rows with K1 (one
    launch a block on a CUDA tensor); the backward re-streams the banks,
    recomputes each block's log weights with autograd on, forms their
    cotangent ``g1 softmax(lw) + 2 g2 softmax(2 lw)`` with :func:`lse_vjp`
    (one launch of ``csrc/lse_vjp.cu`` a block) and pulls it back to
    ``theta`` with ``torch.autograd.grad``, so the live intermediates are
    one block's.
    Gradients flow to ``theta`` only; rows whose ``lse`` is not finite get
    a zero cotangent.  ``interpret`` (the JAX flag for Pallas's interpret
    mode) is accepted and ignored: nothing here is interpreted, the CPU
    runs K1's plain version."""
    op = _Blocks(logw_fn, banks, block_rows, valid)

    def call(theta):
        keys = tuple(sorted(theta))
        first = next(t for t in theta.values() if isinstance(t, torch.Tensor))
        leaves = [torch.as_tensor(theta[k], dtype=first.dtype, device=first.device) for k in keys]
        return _GenericStreamed.apply(op, keys, *leaves)

    return call


# ----------------------------------------------------------------- plain versions


def _chain_terms(x, f, P, grad):
    """The bench chain on a chunk: ``x`` ``(N_COL, rows, n)`` columns, ``f``
    ``(rows, n)`` flags, ``P`` ``(C, P_STRIDE)``.  Returns ``lw``
    ``(C, rows, n)`` and, with ``grad``, ``{j: d lw / d P_j}`` (NaN or inf
    allowed where ``lw`` is ``-inf``; the caller masks them)."""
    dtype = x.dtype
    eps = torch.finfo(dtype).eps

    def p(j):
        return P[:, j, None, None]

    def lae(a, b):
        r = torch.logaddexp(a, b)
        both = (a == -math.inf) & (b == -math.inf)
        return r, torch.where(both, 0.0, torch.exp(a - r)), torch.where(both, 0.0, torch.exp(b - r))

    support = (f & F_SUPPORT) == F_SUPPORT
    z_ok = (f & F_ZOK) != 0
    llow = x[LOG_LOW]
    is_m1 = p(P_IS_M1) != 0
    b = p(P_AP1) * llow
    d = torch.abs(b).clamp_min(eps)
    em = -torch.expm1(-d)
    generic = p(P_LOGABS_AP1) - (torch.clamp_min(b, 0.0) + torch.log(em))
    special = -torch.log(torch.abs(0.0 - llow).clamp_min(eps))
    log_p_q = p(P_BETA) * x[LOG_Q] + torch.where(is_m1, special, generic)

    t = (x[M1] - p(P_MU)) * p(P_INV_SIG)
    log_p_m1, r1, r2 = lae(p(P_C_PL) + p(P_ALPHA) * x[LOG_M1], p(P_C_PEAK) - 0.5 * t * t)
    mag = (p(P_A1) * x[LOG_A1] + p(P_B1) * x[LOG_1MA1] + p(P_N1)) + (
        p(P_A2) * x[LOG_A2] + p(P_B2) * x[LOG_1MA2] + p(P_N2)
    )
    t1 = x[CT1M1] * p(P_INV_ST1)
    t2 = x[CT2M1] * p(P_INV_ST2)
    tilt1, r3, r4 = lae(p(P_ISO1), p(P_ALI1) - 0.5 * t1 * t1)
    tilt2, r5, r6 = lae(p(P_ISO2), p(P_ALI2) - 0.5 * t2 * t2)
    zterm = torch.where(
        z_ok, (x[LOG_DVDZ] + p(P_LAMB1) * x[LOG1PZ]) - p(P_ZL), torch.finfo(dtype).min
    )
    lw = ((((log_p_q + log_p_m1) + mag) + (tilt1 + tilt2)) + zterm) - x[LOG_PRIOR]
    lw = torch.where(support & torch.isfinite(lw), lw, -math.inf)
    if not grad:
        return lw, None

    pos = b > 0
    dls = torch.where(pos, llow, 0.0) + torch.where(
        torch.abs(b) >= eps, torch.where(pos, llow, -llow) * torch.exp(-d) / em, 0.0
    )
    not_m1 = (~is_m1).to(dtype)
    zf = z_ok.to(dtype)
    parts = {
        P_BETA: x[LOG_Q],
        P_AP1: -dls * not_m1,
        P_LOGABS_AP1: not_m1.expand_as(lw),
        P_ALPHA: r1 * x[LOG_M1],
        P_C_PL: r1,
        P_MU: r2 * t * p(P_INV_SIG),
        P_INV_SIG: -(r2 * t * (x[M1] - p(P_MU))),
        P_C_PEAK: r2,
        P_A1: x[LOG_A1],
        P_B1: x[LOG_1MA1],
        P_N1: torch.ones_like(lw),
        P_A2: x[LOG_A2],
        P_B2: x[LOG_1MA2],
        P_N2: torch.ones_like(lw),
        P_ISO1: r3,
        P_ALI1: r4,
        P_INV_ST1: -(r4 * t1 * x[CT1M1]),
        P_ISO2: r5,
        P_ALI2: r6,
        P_INV_ST2: -(r6 * t2 * x[CT2M1]),
        P_LAMB1: zf * x[LOG1PZ],
        P_ZL: -zf,
    }
    return lw, parts


def _chunks(S, chunk):
    return [(j, min(j + chunk, S)) for j in range(0, S, chunk)]


def _streamed_fwd_torch(cols, flags, P, chunk=_CHUNK):
    """Plain version of the forward kernel: per chain and row,
    ``(logsumexp(lw), logsumexp(2 lw))`` of the bench chain, ``(C, rows)``
    each, combined over sample chunks with ``logaddexp``."""
    C, rows = P.shape[0], cols.shape[1]
    l1 = torch.full((C, rows), -math.inf, dtype=P.dtype, device=P.device)
    l2 = torch.full((C, rows), -math.inf, dtype=P.dtype, device=P.device)
    for j0, j1 in _chunks(cols.shape[2], chunk):
        lw, _ = _chain_terms(cols[:, :, j0:j1], flags[:, j0:j1], P, grad=False)
        l1 = torch.logaddexp(l1, torch.logsumexp(lw, dim=-1))
        l2 = torch.logaddexp(l2, torch.logsumexp(2.0 * lw, dim=-1))
    return l1, l2


def _streamed_bwd_torch(cols, flags, P, g1, g2, l1, l2, chunk=_CHUNK):
    """Plain version of the backward kernel: ``sum_s w_s d lw_s / d P``,
    ``(C, P_STRIDE)``, with ``w = g1 e^(lw - l1) + 2 g2 e^(2 lw - l2)`` and
    ``g``, ``l`` ``(C, rows)``.  Samples whose ``lw`` is ``-inf`` weigh
    exactly 0; a zero cotangent contributes nothing, whatever its ``l``."""
    dP = torch.zeros(P.shape, dtype=P.dtype, device=P.device)
    g1, g2, l1, l2 = (v[:, :, None] for v in (g1, g2, l1, l2))
    for j0, j1 in _chunks(cols.shape[2], chunk):
        lw, parts = _chain_terms(cols[:, :, j0:j1], flags[:, j0:j1], P, grad=True)
        live = lw > -math.inf
        w = torch.where(g1 != 0, torch.exp(lw - l1) * g1, 0.0) + torch.where(
            g2 != 0, torch.exp(2.0 * lw - l2) * (2.0 * g2), 0.0
        )
        w = torch.where(live, w, 0.0)
        for j, part in parts.items():
            dP[:, j] += torch.where(live, w * part, 0.0).sum(dim=(1, 2))
    return dP


# ----------------------------------------------------------------- kernels


class K2Geometry(NamedTuple):
    """One K2 launch's geometry.  A block owns ``tile`` samples of one row.
    Forward: ``group`` chains in its registers, ``chain_blocks`` blocks along
    the chains.  Backward: each warp owns one chain (``group`` is 1) over one
    of ``slices`` parts of the tile.  ``resident`` blocks fit on an SM at
    once, so the grid of ``blocks`` runs in ``waves`` (a fraction) of
    ``num_sms * resident``.  ``per_thread`` is the samples a thread (forward)
    or lane (backward) covers per (chain, reduction), ``smem`` the dynamic
    shared memory a block and ``part_shape`` the partials' shape."""

    direction: str
    tile: int
    n_tiles: int
    chain_blocks: int
    blocks: int
    resident: int
    waves: float
    per_thread: int
    slices: int
    group: int
    smem: int
    part_shape: tuple


def _bwd_split(C):
    """The backward's ``(slices, chains a warp carries in turn)``: the tile
    is split into slices only when there are fewer chains than warps."""
    slices = max(1, _WARPS // C)
    return slices, -(-(C * slices) // _WARPS)


def _fwd_group(C):
    """Chains a forward block carries: ``C`` split into equal groups of at
    most ``FWD_GROUP``."""
    return -(-C // -(-C // FWD_GROUP))


def k2_geometry_at(rows, S, C, num_sms, blocks_per_sm, dtype, direction, per_thread):
    """The :class:`K2Geometry` of K2's ``direction`` (``"fwd"`` or
    ``"bwd"``) on a ``(rows, S)`` bank for ``C`` chains, on a card of
    ``num_sms`` SMs where the kernel keeps ``blocks_per_sm`` blocks resident
    (its register limit), with ``per_thread`` samples a thread (forward) or
    lane (backward) per (chain, reduction)."""
    itemsize = torch.finfo(dtype).bits // 8
    if direction == "fwd":
        group = _fwd_group(C)
        tile, slices, chain_blocks, smem = _THREADS * per_thread, 1, -(-C // group), 0
    elif direction == "bwd":
        group, slices, chain_blocks = 1, _bwd_split(C)[0], 1
        tile = 32 * per_thread * slices
        # each warp's slot (its chain's parameters and cotangents), then the tile
        smem = (_WARPS * _SLOT + N_COL * tile) * itemsize + 4 * tile
    else:
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    resident = min(blocks_per_sm, _SM_SMEM // (smem + _SMEM_PER_BLOCK)) if smem else blocks_per_sm
    n_tiles = -(-S // tile)
    blocks = rows * n_tiles * chain_blocks
    part = (C, rows, n_tiles, 3) if direction == "fwd" else (C, rows, n_tiles, slices, P_STRIDE)
    return K2Geometry(direction, tile, n_tiles, chain_blocks, blocks, resident,
                      blocks / (num_sms * max(resident, 1)), per_thread, slices, group, smem, part)


def _model_cost(g, C):
    """A launch's time in the model of :func:`k2_geometry`, in chain
    evaluations a thread."""
    chains = g.group if g.direction == "fwd" else _bwd_split(C)[1]
    return (g.waves + 1.0) * chains * (g.per_thread + _BLOCK_COST[g.direction])


@functools.lru_cache(maxsize=None)
def k2_geometry(rows, S, C, num_sms, blocks_per_sm, dtype, direction):
    """The launch geometry of K2's ``direction`` on a ``(rows, S)`` bank for
    ``C`` chains, on a card of ``num_sms`` SMs where the kernel keeps
    ``blocks_per_sm`` blocks resident (see :func:`k2_geometry_at`).

    Blocks start as slots free up, so a launch takes about its ``waves`` of
    ``num_sms * resident`` blocks plus one block's time for the last block
    to finish; a block takes, per chain it (forward) or a warp (backward)
    carries, its samples a thread plus a fixed cost (``_BLOCK_COST``: the
    staging and the closing reduction).  Of the tiles that fit (the backward
    stages its tile and its warps' parameters in at most ``_MAX_SMEM``
    bytes; its shortest tile always qualifies), the one with the least
    ``(waves + 1) * block time`` wins; ties go to the longer tile.

    Forward: ``tile = 256 * per_thread``, partials ``(C, rows, n_tiles, 3)``.
    Backward: ``tile = 32 * per_thread * slices``, partials ``(C, rows,
    n_tiles, slices, 24)``."""
    per = _FWD_PER_THREAD if direction == "fwd" else _BWD_PER_LANE
    geos = [k2_geometry_at(rows, S, C, num_sms, blocks_per_sm, dtype, direction, n) for n in per]
    return min(
        (g for g in geos if g.smem <= _MAX_SMEM or g.per_thread == 1),
        key=lambda g: (_model_cost(g, C), -g.per_thread),
    )


def k2_kernel_info(dtype, direction, group, smem=0):
    """Registers and spill bytes a thread and resident blocks per SM (at
    ``smem`` bytes of dynamic shared memory) of one K2 kernel on the current
    card; ``group`` is the forward's chains a block (the backward ignores
    it)."""
    out = (ctypes.c_int * 3)()
    STREAMED_FWD_KERNEL.call(
        "gw_k2_kernel_info", int(dtype == torch.float64), int(direction == "bwd"), group, smem, out
    )
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(dtype, direction, group, device_index):
    with torch.cuda.device(device_index):
        return k2_kernel_info(dtype, direction, group)["blocks_per_sm"]


def device_geometry(cols, P, direction):
    """The geometry K2's ``direction`` launches with on ``P``'s card, which
    :func:`k2_geometry` picks from the card's SM count and the kernel's
    occupancy as the card reports it."""
    rows, S = cols.shape[1:]
    C = P.shape[0]
    dev = P.device.index if P.device.index is not None else torch.cuda.current_device()
    group = _fwd_group(C) if direction == "fwd" else 1
    return k2_geometry(rows, S, C, _sm_count(dev), _blocks_per_sm(P.dtype, direction, group, dev), P.dtype, direction)


def _check_cuda(name, cols, flags, P, *rest):
    if not (cols.is_cuda and flags.is_cuda and P.is_cuda and all(v.is_cuda for v in rest)):
        raise ValueError(f"{name} needs CUDA tensors")
    if P.dtype not in _SUFFIX or cols.dtype != P.dtype or any(v.dtype != P.dtype for v in rest):
        raise TypeError(f"{name} supports float32 and float64 (one dtype throughout), got {P.dtype} and {cols.dtype}")
    if flags.dtype != torch.int32:
        raise TypeError(f"{name} needs int32 flags, got {flags.dtype}")
    if cols.ndim != 3 or cols.shape[0] != N_COL or tuple(flags.shape) != tuple(cols.shape[1:]):
        raise ValueError(f"{name}: columns {tuple(cols.shape)} and flags {tuple(flags.shape)} do not fit")
    if P.ndim != 2 or P.shape[1] != P_STRIDE or P.shape[0] == 0:
        raise ValueError(f"{name}: parameters of shape {tuple(P.shape)}, want (C, {P_STRIDE}) with C >= 1")
    C, rows = P.shape[0], cols.shape[1]
    for v in rest:
        if tuple(v.shape) != (C, rows):
            raise ValueError(f"{name}: per-row input of shape {tuple(v.shape)}, want {(C, rows)}")
    if not all(v.is_contiguous() for v in (cols, flags, P, *rest)):
        raise ValueError(f"{name} needs contiguous tensors")


def streamed_fwd_cuda(cols, flags, P):
    """Launch the forward kernel (and its merge pass) with the geometry
    :func:`device_geometry` picks; returns ``(lse1, lse2)``, each ``(C,
    rows)``."""
    _check_cuda("streamed_fwd_cuda", cols, flags, P)
    C, (rows, S) = P.shape[0], cols.shape[1:]
    geo = device_geometry(cols, P, "fwd")
    part = torch.empty(geo.part_shape, dtype=P.dtype, device=P.device)
    lse1 = torch.empty((C, rows), dtype=P.dtype, device=P.device)
    lse2 = torch.empty((C, rows), dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        STREAMED_FWD_KERNEL.call(
            f"gw_k2_fwd_{_SUFFIX[P.dtype]}", cols.data_ptr(), flags.data_ptr(), P.data_ptr(), part.data_ptr(),
            lse1.data_ptr(), lse2.data_ptr(), C, rows, S, geo.tile, geo.group, stream,
        )
    STREAMED_FWD_KERNEL.launches += 1
    return lse1, lse2


def streamed_bwd_cuda(cols, flags, P, g1, g2, l1, l2):
    """Launch the backward kernel (and its merge pass) with the geometry
    :func:`device_geometry` picks; returns ``dP`` ``(C, P_STRIDE)``."""
    _check_cuda("streamed_bwd_cuda", cols, flags, P, g1, g2, l1, l2)
    C, (rows, S) = P.shape[0], cols.shape[1:]
    geo = device_geometry(cols, P, "bwd")
    part = torch.empty(geo.part_shape, dtype=P.dtype, device=P.device)
    dP = torch.empty((C, P_STRIDE), dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        STREAMED_BWD_KERNEL.call(
            f"gw_k2_bwd_{_SUFFIX[P.dtype]}", cols.data_ptr(), flags.data_ptr(), P.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), l1.data_ptr(), l2.data_ptr(), part.data_ptr(), dP.data_ptr(), C, rows, S, geo.tile,
            geo.slices, stream,
        )
    STREAMED_BWD_KERNEL.launches += 1
    return dP


class _StreamedDoubleLogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P, cols, flags):
        P = P.contiguous()
        if P.is_cuda:
            l1, l2 = streamed_fwd_cuda(cols, flags, P)
        elif P.device.type == "cpu":
            l1, l2 = _streamed_fwd_torch(cols, flags, P)
        else:
            raise ValueError(f"streamed double logsumexp: no kernel for device {P.device}")
        ctx.save_for_backward(P, cols, flags, l1, l2)
        return l1, l2

    @staticmethod
    def backward(ctx, g1, g2):
        P, cols, flags, l1, l2 = ctx.saved_tensors
        # rows whose lse is not finite get a zero cotangent and a finite
        # residual, so no NaN reaches the gradient (as the JAX core_bwd)
        f1, f2 = torch.isfinite(l1), torch.isfinite(l2)
        g1 = torch.where(f1, g1, 0.0).contiguous()
        g2 = torch.where(f2, g2, 0.0).contiguous()
        l1 = torch.where(f1, l1, 0.0).contiguous()
        l2 = torch.where(f2, l2, 0.0).contiguous()
        if P.is_cuda:
            dP = streamed_bwd_cuda(cols, flags, P, g1, g2, l1, l2)
        else:
            dP = _streamed_bwd_torch(cols, flags, P, g1, g2, l1, l2)
        return dP, None, None
