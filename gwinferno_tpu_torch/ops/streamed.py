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
  chains, C = 1 included); on a CPU tensor they are the plain versions
  :func:`_streamed_fwd_torch` and :func:`_streamed_bwd_torch`, which run the
  same chain and the same analytic derivative in torch ops, in chunks over
  the bank.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..distributions import _betaln
from ..distributions import _norm_cdf
from ..distributions import _powerlaw_log_norm
from ._build import Kernel

__all__ = [
    "THETA",
    "StreamedBank",
    "chain_params",
    "reshape_bank_rows",
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
_THREADS = 256
_N_SM = 132
_CHUNK = 2048  # samples per chunk of the plain versions

_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# one source, one library; one Kernel (and launch count) per direction.  Each
# kernel has a chain axis, so it replaces both the one-chain and the
# chain-batched Pallas kernel: forward :115 and :234, backward :134 and :260.
STREAMED_FWD_KERNEL = Kernel(
    "gw_streamed",
    "streamed.cu",
    {"gw_k2_fwd_f32": _FWD_ARGS, "gw_k2_fwd_f64": _FWD_ARGS},
    replaces="gwinferno_tpu/ops/streamed.py:234",
)
STREAMED_BWD_KERNEL = Kernel(
    "gw_streamed",
    "streamed.cu",
    {"gw_k2_bwd_f32": _BWD_ARGS, "gw_k2_bwd_f64": _BWD_ARGS},
    replaces="gwinferno_tpu/ops/streamed.py:260",
)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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


def streamed_summaries(pe_call, inj_call, theta, n_samples, total_inj):
    """Assemble ``hierarchical_likelihood`` summaries from two streamed ops
    (the PE bank and the row-reshaped injection bank); the tail arithmetic
    of ``gwinferno_tpu/ops/streamed.py::streamed_summaries`` line for line,
    with a leading chain axis."""
    lse1, lse2 = pe_call(theta)
    logBFs = lse1 - math.log(1.0 * n_samples)
    log_n_effs = 2.0 * lse1 - lse2

    il1, il2 = inj_call(theta)
    ilse1 = torch.logsumexp(il1, dim=-1)
    ilse2 = torch.logsumexp(il2, dim=-1)
    log_ninj = math.log(total_inj)
    log_mu = ilse1 - log_ninj
    A = ilse2 - 2.0 * log_ninj
    B = 2.0 * log_mu - log_ninj
    logvar = A + torch.log1p(-torch.exp(torch.clamp_max(B - A, -1e-6)))
    log_n_eff_inj = 2.0 * log_mu - logvar
    return (logBFs, log_n_effs, n_samples), (log_mu, log_n_eff_inj)


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


def _tile_for(rows, S):
    """Samples per block: the largest of 1024, 512, 256 that still gives two
    blocks per SM, else 256."""
    for tile in (1024, 512):
        if rows * -(-S // tile) >= 2 * _N_SM:
            return tile
    return _THREADS


def _check_cuda(name, cols, flags, P, *rest):
    if not (cols.is_cuda and flags.is_cuda and P.is_cuda and all(v.is_cuda for v in rest)):
        raise ValueError(f"{name} needs CUDA tensors")
    if P.dtype not in _SUFFIX or cols.dtype != P.dtype or any(v.dtype != P.dtype for v in rest):
        raise TypeError(f"{name} supports float32 and float64 (one dtype throughout), got {P.dtype} and {cols.dtype}")
    if flags.dtype != torch.int32:
        raise TypeError(f"{name} needs int32 flags, got {flags.dtype}")
    if cols.ndim != 3 or cols.shape[0] != N_COL or tuple(flags.shape) != tuple(cols.shape[1:]):
        raise ValueError(f"{name}: columns {tuple(cols.shape)} and flags {tuple(flags.shape)} do not fit")
    if P.ndim != 2 or P.shape[1] != P_STRIDE:
        raise ValueError(f"{name}: parameters of shape {tuple(P.shape)}, want (C, {P_STRIDE})")
    C, rows = P.shape[0], cols.shape[1]
    for v in rest:
        if tuple(v.shape) != (C, rows):
            raise ValueError(f"{name}: per-row input of shape {tuple(v.shape)}, want {(C, rows)}")
    if not all(v.is_contiguous() for v in (cols, flags, P, *rest)):
        raise ValueError(f"{name} needs contiguous tensors")


def streamed_fwd_cuda(cols, flags, P):
    """Launch the forward kernel (and its merge pass); returns ``(lse1,
    lse2)``, each ``(C, rows)``."""
    _check_cuda("streamed_fwd_cuda", cols, flags, P)
    C, (rows, S) = P.shape[0], cols.shape[1:]
    tile = _tile_for(rows, S)
    n_tiles = -(-S // tile)
    part = torch.empty((C, rows, n_tiles, 3), dtype=P.dtype, device=P.device)
    lse1 = torch.empty((C, rows), dtype=P.dtype, device=P.device)
    lse2 = torch.empty((C, rows), dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        STREAMED_FWD_KERNEL.call(
            f"gw_k2_fwd_{_SUFFIX[P.dtype]}", cols.data_ptr(), flags.data_ptr(), P.data_ptr(), part.data_ptr(),
            lse1.data_ptr(), lse2.data_ptr(), C, rows, S, tile, stream,
        )
    STREAMED_FWD_KERNEL.launches += 1
    return lse1, lse2


def streamed_bwd_cuda(cols, flags, P, g1, g2, l1, l2):
    """Launch the backward kernel (and its merge pass); returns ``dP``
    ``(C, P_STRIDE)``."""
    _check_cuda("streamed_bwd_cuda", cols, flags, P, g1, g2, l1, l2)
    C, (rows, S) = P.shape[0], cols.shape[1:]
    tile = _tile_for(rows, S)
    n_tiles = -(-S // tile)
    part = torch.empty((C, rows, n_tiles, P_STRIDE), dtype=P.dtype, device=P.device)
    dP = torch.empty((C, P_STRIDE), dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        STREAMED_BWD_KERNEL.call(
            f"gw_k2_bwd_{_SUFFIX[P.dtype]}", cols.data_ptr(), flags.data_ptr(), P.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), l1.data_ptr(), l2.data_ptr(), part.data_ptr(), dP.data_ptr(), C, rows, S, tile, stream,
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
