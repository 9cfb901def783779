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

Both kernels cut each row (K3: each event) into tiles spread over the card
and merge a row's tile partials in the block that finishes it last, so a
call is one launch; :func:`dlse_geometry` and :func:`flw_geometry` pick the
tiles from the card's SM count and the kernel's occupancy as the card
reports it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import Kernel

__all__ = [
    "double_logsumexp",
    "logaddexp",
    "merge_pairs",
    "dlse_geometry",
    "DLSE_KERNEL",
    "fused_logweight_logsumexp",
    "fused_logweight_logsumexp_torch",
    "fused_bspline_per_event_log_bayes_factors",
    "flw_geometry",
    "FLW_KERNEL",
    "padded_rows",
]

# launch geometry (csrc/dlse.cu, csrc/flw.cu): threads a block; an SM's
# shared memory, what the card reserves of it per block, and the most a
# block may take
_THREADS = 256
_SM_SMEM, _SMEM_PER_BLOCK, _MAX_SMEM = 233472, 1024, 227 * 1024
_INFO = ctypes.POINTER(ctypes.c_int)

_DLSE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
DLSE_KERNEL = Kernel(
    "gw_dlse",
    "dlse.cu",
    {"gw_dlse_f32": _DLSE_ARGS, "gw_dlse_f64": _DLSE_ARGS, "gw_dlse_kernel_info": [ctypes.c_int, _INFO]},
    replaces="gwinferno_tpu/ops/fused.py:57",
)
_DLSE_FN = {torch.float32: "gw_dlse_f32", torch.float64: "gw_dlse_f64"}
# K1: 16-byte vectors a thread loads per round (the kernel's kVecs); the
# vectors a thread covers per tile to choose from; a block's fixed cost (its
# reductions and, for a split row, the merge) in rounds of loads
_DLSE_VECS = 4
_DLSE_PER_THREAD = (1, 2, 4, 8, 16, 32, 64)
_DLSE_BLOCK_COST = 2.0


def _vec(dtype):
    """Values of ``dtype`` in one 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_index(t):
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _ptr(t):
    """A tensor's device address for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _tickets(device_index, stream, n):
    """``n`` zeroed int32 tickets for the kernels' last-block merge on one
    device and stream.  A launch leaves its tickets zeroed, so one buffer
    per (device, stream, size) serves every launch; launches on one stream
    run in order, so they never share a ticket in flight."""
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda", device_index))


class DlseGeometry(NamedTuple):
    """One K1 launch's geometry: each block owns ``tile`` elements of one
    row (``per_thread`` 16-byte vectors a thread, loaded ``_DLSE_VECS`` at a
    time), ``n_tiles`` blocks a row; ``resident`` blocks fit on an SM, so the
    ``blocks`` run in ``waves`` (a fraction) of ``num_sms * resident``.
    ``part_shape`` is the partials' shape, None when a row is one tile."""

    tile: int
    n_tiles: int
    per_thread: int
    blocks: int
    resident: int
    waves: float
    part_shape: tuple | None


def dlse_geometry_at(rows, n, dtype, num_sms, blocks_per_sm, per_thread):
    """The :class:`DlseGeometry` of K1 on a ``(rows, n)`` array with
    ``per_thread`` vectors a thread, on a card of ``num_sms`` SMs where the
    kernel keeps ``blocks_per_sm`` blocks resident."""
    tile = _THREADS * _vec(dtype) * per_thread
    n_tiles = max(1, -(-n // tile))
    blocks = rows * n_tiles
    resident = max(1, blocks_per_sm)
    part = (rows, n_tiles, 3) if n_tiles > 1 else None
    return DlseGeometry(tile, n_tiles, per_thread, blocks, resident, blocks / (num_sms * resident), part)


def _dlse_cost(g):
    """A launch's time in the model of :func:`dlse_geometry`, in rounds of
    loads a thread."""
    return math.ceil(g.waves) * (-(-g.per_thread // _DLSE_VECS) + _DLSE_BLOCK_COST)


@functools.lru_cache(maxsize=None)
def dlse_geometry(rows, n, dtype, num_sms, blocks_per_sm):
    """The launch geometry of K1 on a ``(rows, n)`` array, on a card of
    ``num_sms`` SMs where the kernel keeps ``blocks_per_sm`` blocks resident.

    The grid runs in waves of ``num_sms * resident`` blocks, and a partial
    last wave takes as long as a whole one; a block takes its rounds of
    loads (``_DLSE_VECS`` vectors a thread each) plus a fixed cost.  Of the
    tiles up to the first that holds a whole row, the one with the least
    ``ceil(waves) * block time`` wins; ties go to the longer tile.  So long
    rows are split until their blocks spread over the card, and many short
    rows stay a block each unless splitting them fills whole waves."""
    geos = []
    for p in _DLSE_PER_THREAD:
        geos.append(dlse_geometry_at(rows, n, dtype, num_sms, blocks_per_sm, p))
        if geos[-1].n_tiles == 1:
            break
    return min(geos, key=lambda g: (_dlse_cost(g), -g.tile))


def dlse_kernel_info(dtype):
    """Registers and spill bytes a thread and resident blocks per SM of K1
    on the current card."""
    out = (ctypes.c_int * 3)()
    DLSE_KERNEL.call("gw_dlse_kernel_info", int(dtype == torch.float64), out)
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


@functools.lru_cache(maxsize=None)
def _dlse_blocks_per_sm(dtype, device_index):
    with torch.cuda.device(device_index):
        return dlse_kernel_info(dtype)["blocks_per_sm"]


def dlse_device_geometry(x):
    """The geometry K1 launches with on the 2-D ``x``, which
    :func:`dlse_geometry` picks from the card's SM count and the kernel's
    occupancy as the card reports it."""
    dev = _device_index(x)
    rows, n = x.shape
    return dlse_geometry(rows, n, x.dtype, _sm_count(dev), _dlse_blocks_per_sm(x.dtype, dev))


def _dlse_torch(x):
    """Plain version: two ``torch.logsumexp`` over the last axis."""
    return torch.logsumexp(x, dim=-1), torch.logsumexp(2.0 * x, dim=-1)


def dlse_cuda(x):
    """Launch K1 on a contiguous 2-D CUDA tensor ``(rows, n)`` with the
    geometry :func:`dlse_device_geometry` picks; returns the two ``(rows,)``
    reductions."""
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
    geo = dlse_device_geometry(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part = tickets = None  # a row of one tile writes its result directly
        if geo.part_shape is not None:
            part = torch.empty(geo.part_shape, dtype=x.dtype, device=x.device)
            tickets = _tickets(_device_index(x), stream, rows)
        DLSE_KERNEL.call(
            _DLSE_FN[x.dtype], x.data_ptr(), lse1.data_ptr(), lse2.data_ptr(), _ptr(part), _ptr(tickets), rows, n,
            geo.tile, stream,
        )
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


def logaddexp(a, b):
    """``log(exp(a) + exp(b))`` that is ``-inf`` with a zero gradient where
    both sides are ``-inf``, as K1's merge of tile partials is.
    ``torch.logaddexp`` gives ``nan`` to both inputs there, which would
    poison every gradient it reaches (a chunk or shard whose samples are all
    off support)."""
    m = torch.maximum(a, b).detach()
    both = m == -torch.inf
    m = torch.where(both, 0.0, m)
    s = torch.exp(a - m) + torch.exp(b - m)
    return torch.where(both, -torch.inf, m + torch.log(torch.where(both, 1.0, s)))


def merge_pairs(pairs):
    """Fold ``(logsumexp(x), logsumexp(2x))`` pairs of disjoint parts of a
    row (chunks, shards) into the row's pair, left to right."""
    l1, l2 = pairs[0]
    for c1, c2 in pairs[1:]:
        l1, l2 = logaddexp(l1, c1), logaddexp(l2, c2)
    return l1, l2


_FLW_ARGS = (
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5
    + [ctypes.c_int, ctypes.c_void_p]
)
FLW_KERNEL = Kernel(
    "gw_flw",
    "flw.cu",
    {
        "gw_flw_f32": _FLW_ARGS,
        "gw_flw_f64": _FLW_ARGS,
        "gw_flw_kernel_info": [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _INFO],
    },
    replaces="gwinferno_tpu/ops/fused.py:184",
)
_FLW_FN = {torch.float32: "gw_flw_f32", torch.float64: "gw_flw_f64"}
# K3: the most chains a launch carries (the kernel's kMaxChains); the
# design rows a thread has in flight (its cp.async ring, kRing); the row
# splits the kernel takes; the runs a lane per tile to choose from, and a
# block's fixed cost (staging, closing reductions) in design rows a thread,
# for a bank whose rows stay whole
FLW_MAX_CHAINS = 16
_FLW_RING = 16
_FLW_KSPLIT = (1, 2, 4)
_FLW_STEPS = (1, 2, 4, 8, 16, 32, 64)
_FLW_BLOCK_COST = 10.0
# the row split of a bank too short to fill a wave with every row in each
# thread: the fastest split on an H100 when there is one block per SM
# (PERF.md)
_FLW_SHORT_SPLIT = 4
# a bound on the kernel's static shared memory (its cross-warp merge), which
# a block's dynamic shared memory shares the per-block cap with
_FLW_STATIC_SMEM = 4096


def flw_width(C):
    """The instantiation (chains a block) that a group of ``C`` chains runs
    in: 1, 8 or 16."""
    return 1 if C <= 1 else (8 if C <= 8 else FLW_MAX_CHAINS)


def _flw_smem(K, width, ksplit, itemsize):
    """Dynamic shared memory of a K3 block: the coefficients, the slices'
    partial sums when the rows are split, and the threads' ring slots."""
    coef = -(-K * width * itemsize // 16) * 16
    return coef + (width * _THREADS * 16 if ksplit > 1 else 0) + _FLW_RING * _THREADS * 16


class FlwGeometry(NamedTuple):
    """One K3 bank's geometry.  A block owns ``tile`` samples of one event:
    ``ksplit`` slices of ``256 / ksplit`` lanes, each slice a share of the K
    design rows, each lane up to ``steps`` runs of one 16-byte vector of
    samples.  Chains run in ``groups`` launches of at most 16, instantiated
    for ``width`` chains; ``blocks`` is one launch's grid, of which
    ``resident`` fit on an SM, so it runs in ``waves`` (a fraction) of
    ``num_sms * resident``.  ``smem`` is a block's dynamic shared memory and
    ``part_shape`` the partials' shape, None when an event is one tile."""

    tile: int
    n_tiles: int
    ksplit: int
    steps: int
    width: int
    groups: int
    blocks: int
    resident: int
    waves: float
    smem: int
    part_shape: tuple | None


def flw_geometry_at(E, S, C, K, dtype, num_sms, blocks_per_sm, ksplit, tile):
    """The :class:`FlwGeometry` of K3 on a bank of ``E`` events of ``S``
    samples, ``K`` design rows and ``C`` chains, with the rows split
    ``ksplit`` ways and tiles of ``tile`` samples (a multiple of the 16-byte
    vector), on a card of ``num_sms`` SMs where the kernel keeps
    ``blocks_per_sm`` blocks resident (its register limit)."""
    itemsize = torch.finfo(dtype).bits // 8
    width = flw_width(min(C, FLW_MAX_CHAINS))
    steps = -(-tile // ((_THREADS // ksplit) * _vec(dtype)))
    n_tiles = -(-S // tile)
    smem = _flw_smem(K, width, ksplit, itemsize)
    resident = max(1, min(blocks_per_sm, _SM_SMEM // (smem + _FLW_STATIC_SMEM + _SMEM_PER_BLOCK)))
    blocks = E * n_tiles
    part = (C, E, n_tiles, 3) if n_tiles > 1 else None
    return FlwGeometry(tile, n_tiles, ksplit, steps, width, -(-C // FLW_MAX_CHAINS), blocks, resident,
                       blocks / (num_sms * resident), smem, part)


def _flw_cost(g, K):
    """A launch's time in the whole-wave model of :func:`flw_geometry` (rows
    whole), in design rows a thread."""
    return math.ceil(g.waves) * (g.steps * K + _FLW_BLOCK_COST)


@functools.lru_cache(maxsize=None)
def flw_geometry(E, S, C, K, dtype, num_sms, blocks_per_sm):
    """The launch geometry of K3 on a bank of ``E`` events of ``S`` samples,
    ``K`` design rows and ``C`` chains, on a card of ``num_sms`` SMs where
    the kernel keeps ``blocks_per_sm`` blocks resident (see
    :func:`flw_geometry_at`).

    A bank that fills at least a wave with every row in each thread (the PE
    bank) keeps the rows whole, and its tiles follow the whole-wave model:
    the grid runs in waves of ``num_sms * resident`` blocks, a partial last
    wave takes as long as a whole one, and a block takes its runs a lane
    times the K rows plus a fixed cost; of the tiles up to the first that
    holds a whole event, the least ``ceil(waves) * block time`` wins, ties
    to the longer tile.  A shorter bank (the injections' one row) gets one
    block per SM, each event cut into equal tiles, with the rows split
    ``_FLW_SHORT_SPLIT`` ways over the warps (or fewer, when the slices'
    partial sums would not fit in shared memory): there a second block on
    an SM shares its memory pipe rather than adding to it."""
    itemsize = torch.finfo(dtype).bits // 8
    width = flw_width(min(C, FLW_MAX_CHAINS))
    fits = [ks for ks in _FLW_KSPLIT if _flw_smem(K, width, ks, itemsize) <= _MAX_SMEM - _FLW_STATIC_SMEM]
    if not fits:
        raise ValueError(f"K3: the coefficients of {K} rows x {min(C, FLW_MAX_CHAINS)} chains exceed shared memory")
    full = []  # every row in each thread, tiles up to the first that holds a whole event
    for steps in _FLW_STEPS:
        full.append(flw_geometry_at(E, S, C, K, dtype, num_sms, blocks_per_sm, 1, steps * _THREADS * _vec(dtype)))
        if full[-1].n_tiles == 1:
            break
    if full[0].waves >= 1.0:
        return min(full, key=lambda g: (_flw_cost(g, K), -g.tile))
    ksplit = max(ks for ks in fits if ks <= _FLW_SHORT_SPLIT)
    vec = _vec(dtype)
    tile = -(-S // max(1, num_sms // E))
    return flw_geometry_at(E, S, C, K, dtype, num_sms, blocks_per_sm, ksplit, -(-tile // vec) * vec)


def k3_kernel_info(dtype, width, smem=0):
    """Registers and spill bytes a thread and resident blocks per SM (at
    ``smem`` bytes of dynamic shared memory) of K3's instantiation for
    ``width`` chains (1, 8 or 16) on the current card."""
    out = (ctypes.c_int * 3)()
    FLW_KERNEL.call("gw_flw_kernel_info", int(dtype == torch.float64), width, smem, out)
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


@functools.lru_cache(maxsize=None)
def _flw_blocks_per_sm(dtype, width, device_index):
    with torch.cuda.device(device_index):
        return k3_kernel_info(dtype, width)["blocks_per_sm"]


def flw_device_geometry(coefs, design, n_events, n_samples):
    """The geometry K3 launches with for ``coefs (C, K)`` on its card, which
    :func:`flw_geometry` picks from the card's SM count and the kernel's
    occupancy as the card reports it."""
    dev = _device_index(coefs)
    C, K = coefs.shape
    width = flw_width(min(C, FLW_MAX_CHAINS))
    return flw_geometry(int(n_events), int(n_samples), C, K, coefs.dtype, _sm_count(dev),
                        _flw_blocks_per_sm(coefs.dtype, width, dev))


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


def flw_cuda(coefs, design, nlp, n_events, n_samples):
    """Launch K3 on CUDA tensors with the geometry
    :func:`flw_device_geometry` picks: contiguous ``coefs (C, K)`` and ``nlp
    (E*S,)``, and ``design (K, E*S)`` contiguous or a view of rows with a
    longer stride (``design.stride() == (ld, 1)``, ``ld >= E*S``, as
    :func:`padded_rows` makes); returns the raw ``(lse1, lse2)``, each ``(C,
    E)``."""
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
    if not (coefs.is_contiguous() and nlp.is_contiguous()):
        raise ValueError("flw_cuda needs contiguous coefficients and nlp")
    ld = design.stride(0) if design.shape[0] > 1 else E * S
    if design.stride(1) != 1 or ld < E * S:
        raise ValueError(f"flw_cuda needs design rows of unit stride, got strides {design.stride()}")
    C, K = coefs.shape
    dev = coefs.device
    lse1 = torch.empty(C, E, dtype=coefs.dtype, device=dev)
    lse2 = torch.empty(C, E, dtype=coefs.dtype, device=dev)
    if C == 0 or E == 0:
        return lse1, lse2
    geo = flw_device_geometry(coefs, design, E, S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = tickets = None  # an event of one tile writes its result directly
        if geo.part_shape is not None:
            part = torch.empty(geo.part_shape, dtype=coefs.dtype, device=dev)
            tickets = _tickets(_device_index(coefs), stream, E)
        FLW_KERNEL.call(
            _FLW_FN[coefs.dtype], coefs.data_ptr(), design.data_ptr(), ld, nlp.data_ptr(), _ptr(part), lse1.data_ptr(),
            lse2.data_ptr(), _ptr(tickets), C, K, E, S, geo.tile, geo.ksplit, stream,
        )
    FLW_KERNEL.launches += 1
    return lse1, lse2


def padded_rows(design):
    """``design (K, N)`` as a view of a buffer whose rows are ``N`` rounded
    up to a whole 16-byte vector apart (``ld % V == 0``, which K3 needs to
    read every row in aligned vectors); the pad columns are zero and lie
    outside the view."""
    K, N = design.shape
    vec = _vec(design.dtype)
    ld = -(-N // vec) * vec
    buf = torch.zeros(K, ld, dtype=design.dtype, device=design.device)
    buf[:, :N] = design
    return buf[:, :N]


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
