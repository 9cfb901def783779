"""K1, the likelihood's paired importance-weight reduction.

Counterpart of ``gwinferno_tpu/ops/fused.py::double_logsumexp``.
``per_event_log_bayes_factors`` and ``detection_efficiency`` both need
``(logsumexp(w), logsumexp(2w))`` over the sample / injection axis at every
gradient.  On a CUDA tensor the forward is the hand-written kernel
``csrc/dlse.cu`` (one pass over the bank); on a CPU tensor it is the plain
version :func:`_dlse_torch`.  The backward is plain torch in both cases, as
the JAX package's ``_dlse_bwd`` is plain jnp.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

__all__ = ["double_logsumexp", "DLSE_KERNEL"]

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
