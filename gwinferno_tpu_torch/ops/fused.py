"""K1, the likelihood's paired importance-weight reduction, and K3, the
fused B-spline log-weight product with the same reduction.

K1 is the counterpart of ``gwinferno_tpu/ops/fused.py::double_logsumexp``.
``per_event_log_bayes_factors`` and ``detection_efficiency`` both need
``(logsumexp(w), logsumexp(2w))`` over the sample / injection axis at every
gradient.  On a CUDA tensor the forward is the hand-written kernel
``csrc/dlse.cu`` (one pass over the bank); on a CPU tensor it is the plain
version :func:`_dlse_torch`.  The backward is plain torch in both cases, as
the JAX package's ``_dlse_bwd`` is plain jnp.

K3 is the counterpart of ``fused_logweight_logsumexp`` (its Pallas kernel
``_fused_kernel``): ``logw = coefs (C, K) @ design (K, E*S) + nlp (E*S,)``
reduced per (chain, event) to ``(logsumexp(logw), logsumexp(2 logw))``
without writing ``logw`` out.  On a CUDA tensor the forward is the
hand-written kernel ``csrc/flw.cu``; on a CPU tensor it is the plain version
:func:`fused_logweight_logsumexp_torch`.  Its backward is plain torch, as
the JAX package's ``_flw_bwd`` is plain jnp: it rebuilds ``logw`` with a
matmul and takes the gradient to ``coefs`` and ``nlp`` (the design matrix
is a constant).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import Kernel

__all__ = [
    "double_logsumexp",
    "DLSE_KERNEL",
    "fused_logweight_logsumexp",
    "fused_logweight_logsumexp_torch",
    "fused_bspline_per_event_log_bayes_factors",
    "FLW_KERNEL",
]

_DLSE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
DLSE_KERNEL = Kernel(
    "gw_dlse",
    "dlse.cu",
    {"gw_dlse_f32": _DLSE_ARGS, "gw_dlse_f64": _DLSE_ARGS},
    replaces="gwinferno_tpu/ops/fused.py:57",
)
_DLSE_FN = {torch.float32: "gw_dlse_f32", torch.float64: "gw_dlse_f64"}


def _dlse_torch(x):
    """Plain version: two ``torch.logsumexp`` over the last axis."""
    return torch.logsumexp(x, dim=-1), torch.logsumexp(2.0 * x, dim=-1)


def dlse_cuda(x):
    """Launch K1 on a contiguous 2-D CUDA tensor ``(rows, n)``; returns the
    two ``(rows,)`` reductions."""
    if not x.is_cuda:
        raise ValueError("dlse_cuda needs a CUDA tensor")
    if x.dtype not in _DLSE_FN:
        raise TypeError(f"dlse_cuda supports float32 and float64, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"dlse_cuda needs a contiguous 2-D tensor, got shape {tuple(x.shape)}")
    rows, n = x.shape
    lse1 = torch.empty(rows, dtype=x.dtype, device=x.device)
    lse2 = torch.empty(rows, dtype=x.dtype, device=x.device)
    if rows == 0:
        return lse1, lse2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        DLSE_KERNEL.call(_DLSE_FN[x.dtype], x.data_ptr(), lse1.data_ptr(), lse2.data_ptr(), rows, n, stream)
    DLSE_KERNEL.launches += 1
    return lse1, lse2


class _DoubleLogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.is_cuda:
            lead, n = x.shape[:-1], x.shape[-1]
            l1, l2 = dlse_cuda(x.reshape(-1, n).contiguous())
            l1, l2 = l1.reshape(lead), l2.reshape(lead)
        elif x.device.type == "cpu":
            l1, l2 = _dlse_torch(x)
        else:
            raise ValueError(f"double_logsumexp: no kernel for device {x.device}")
        ctx.save_for_backward(x, l1, l2)
        return l1, l2

    @staticmethod
    def backward(ctx, g1, g2):
        x, l1, l2 = ctx.saved_tensors
        neg = x == -torch.inf
        # d lse1/dx = softmax(x); d lse2/dx = 2 softmax(2x); -inf entries
        # (and all--inf rows, where l = -inf) get exactly zero
        t1 = torch.where(neg, 0.0, torch.exp(x - l1[..., None])) * g1[..., None]
        t2 = torch.where(neg, 0.0, torch.exp(2.0 * x - l2[..., None])) * (2.0 * g2[..., None])
        return t1 + t2


def double_logsumexp(x, axis=-1):
    """``(logsumexp(x, axis), logsumexp(2x, axis))`` in one pass: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if axis not in (-1, x.ndim - 1):
        x = torch.movedim(x, axis, -1)
    return _DoubleLogSumExp.apply(x)


_FLW_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
FLW_KERNEL = Kernel(
    "gw_flw",
    "flw.cu",
    {"gw_flw_f32": _FLW_ARGS, "gw_flw_f64": _FLW_ARGS},
    replaces="gwinferno_tpu/ops/fused.py:184",
)
_FLW_FN = {torch.float32: "gw_flw_f32", torch.float64: "gw_flw_f64"}
_FLW_THREADS = 256  # threads per block of csrc/flw.cu


def _flw_torch(coefs, design, nlp, n_events, n_samples):
    """Plain version of K3's raw output: ``(lse1, lse2)``, each ``(C, E)``,
    of ``logw = coefs @ design + nlp`` over each event's samples."""
    logw = (coefs @ design + nlp).reshape(coefs.shape[0], n_events, n_samples)
    return torch.logsumexp(logw, dim=-1), torch.logsumexp(2.0 * logw, dim=-1)


def fused_logweight_logsumexp_torch(coefs, design, neg_log_prior, n_events, n_samples):
    """Plain version (counterpart of ``fused_logweight_logsumexp_xla``):
    ``(logBFs, log_n_effs)``, each ``(C, E)``, for coefficients ``(C, K)``,
    the stacked design ``(K, E*S)`` and the minus-log prior ``(E*S,)``."""
    lse1, lse2 = _flw_torch(coefs, design, neg_log_prior, n_events, n_samples)
    return lse1 - math.log(n_samples * 1.0), 2.0 * lse1 - lse2


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def flw_tile(n_events, n_samples, num_sms):
    """K3's samples per block: the largest power of two in [256, 4096] that
    still gives at least four blocks per SM, so that one long row (the
    injection bank) spreads over the card as the 69 PE events do."""
    tile = 4096
    while tile > _FLW_THREADS and n_events * -(-n_samples // tile) < 4 * num_sms:
        tile //= 2
    return tile


def flw_cuda(coefs, design, nlp, n_events, n_samples):
    """Launch K3 on contiguous CUDA tensors: ``coefs (C, K)``, ``design
    (K, E*S)``, ``nlp (E*S,)``; returns the raw ``(lse1, lse2)``, each
    ``(C, E)``."""
    tensors = (coefs, design, nlp)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flw_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flw_cuda needs its tensors on one device")
    if coefs.dtype not in _FLW_FN or design.dtype != coefs.dtype or nlp.dtype != coefs.dtype:
        raise TypeError(f"flw_cuda supports one dtype, float32 or float64, got {[t.dtype for t in tensors]}")
    E, S = int(n_events), int(n_samples)
    if coefs.ndim != 2 or design.ndim != 2 or design.shape != (coefs.shape[1], E * S) or nlp.shape != (E * S,):
        raise ValueError(
            f"flw_cuda: coefs {tuple(coefs.shape)}, design {tuple(design.shape)} and nlp {tuple(nlp.shape)} "
            f"do not fit {E} events x {S} samples"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flw_cuda needs contiguous tensors")
    C, K = coefs.shape
    dev = coefs.device
    lse1 = torch.empty(C, E, dtype=coefs.dtype, device=dev)
    lse2 = torch.empty(C, E, dtype=coefs.dtype, device=dev)
    if C == 0 or E == 0:
        return lse1, lse2
    tile = flw_tile(E, S, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    part = torch.empty(C * E * -(-S // tile) * 3, dtype=coefs.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        FLW_KERNEL.call(
            _FLW_FN[coefs.dtype], coefs.data_ptr(), design.data_ptr(), nlp.data_ptr(), part.data_ptr(),
            lse1.data_ptr(), lse2.data_ptr(), C, K, E, S, tile, stream,
        )
    FLW_KERNEL.launches += 1
    return lse1, lse2


class _FusedLogWeightLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coefs, design, nlp, n_events, n_samples):
        if coefs.is_cuda:
            l1, l2 = flw_cuda(coefs.contiguous(), design, nlp, n_events, n_samples)
        elif coefs.device.type == "cpu":
            l1, l2 = _flw_torch(coefs, design, nlp, n_events, n_samples)
        else:
            raise ValueError(f"fused_logweight_logsumexp: no kernel for device {coefs.device}")
        ctx.save_for_backward(coefs, design, nlp, l1, l2)
        ctx.bank = (n_events, n_samples)
        return l1, l2

    @staticmethod
    def backward(ctx, g1, g2):
        coefs, design, nlp, l1, l2 = ctx.saved_tensors
        E, S = ctx.bank
        C = coefs.shape[0]
        logw = (coefs @ design + nlp).reshape(C, E, S)
        neg = (nlp == -torch.inf).reshape(E, S)
        # masked samples (and fully masked events, where l = -inf) weigh exactly 0
        w1 = torch.where(neg, 0.0, torch.exp(logw - l1[..., None]))
        w2 = torch.where(neg, 0.0, torch.exp(2.0 * logw - l2[..., None]))
        dlogw = g1[..., None] * w1 + 2.0 * g2[..., None] * w2
        d_coefs = dlogw.reshape(C, E * S) @ design.T if ctx.needs_input_grad[0] else None
        d_nlp = dlogw.sum(0).reshape(E * S) if ctx.needs_input_grad[2] else None
        return d_coefs, None, d_nlp, None, None


def fused_logweight_logsumexp(coefs, design, neg_log_prior, n_events, n_samples):
    """``(logBFs, log_n_effs)``, each ``(C, E)``, of the log-weights
    ``coefs (C, K) @ design (K, E*S) + neg_log_prior (E*S,)`` in one pass:
    K3 for CUDA tensors, the plain version for CPU tensors.  Differentiable
    in ``coefs`` and ``neg_log_prior``; sample masks enter as ``-inf`` in
    ``neg_log_prior`` and weigh exactly 0."""
    C, K = coefs.shape
    if design.shape != (K, n_events * n_samples):
        raise ValueError(f"design {tuple(design.shape)} does not fit ({K}, {n_events} x {n_samples})")
    lse1, lse2 = _FusedLogWeightLSE.apply(coefs, design, neg_log_prior, n_events, n_samples)
    return lse1 - math.log(n_samples * 1.0), 2.0 * lse1 - lse2


def fused_bspline_per_event_log_bayes_factors(design_coef_pairs, neg_log_prior, n_events, n_samples, log_norms=None):
    """The B-spline likelihood's per-event reductions in one K3 pass over the
    stacked ``[(design (K_i, E*S), coefs (C, K_i) or (K_i,)), ...]``, with
    optional per-chain log normalizations ``[(C,) or scalar, ...]`` added to
    the log Bayes factors.  Returns ``(logBFs, log_n_effs)``, each ``(C, E)``
    (``(E,)`` when the coefficients carry no chain axis)."""
    unbatched = design_coef_pairs[0][1].ndim == 1
    coefs = torch.cat([torch.atleast_2d(c) for _, c in design_coef_pairs], dim=-1)
    design = torch.cat([d for d, _ in design_coef_pairs], dim=0)
    logBF, log_neff = fused_logweight_logsumexp(coefs, design, neg_log_prior, n_events, n_samples)
    if log_norms is not None:
        total = sum(torch.as_tensor(ln, dtype=logBF.dtype, device=logBF.device) for ln in log_norms)
        logBF = logBF + torch.atleast_1d(total)[:, None]
    if unbatched:
        return logBF[0], log_neff[0]
    return logBF, log_neff
