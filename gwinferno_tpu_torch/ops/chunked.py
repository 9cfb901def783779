"""Sample-axis-chunked likelihood reductions.

Counterpart of ``gwinferno_tpu/ops/chunked.py``.  A flat gradient of a
chain-batched likelihood holds ``(C, N_bank)`` intermediates for every
factor of the log-weight chain until its backward pass.  Evaluating the bank
in ``n_chunks`` chunks of the sample axis, each under
``torch.utils.checkpoint`` (non-reentrant), keeps one chunk's intermediates
alive at a time in the forward and the backward: the backward recomputes the
chunk instead of storing it.  The JAX ``lax.scan`` + ``jax.checkpoint``
becomes a Python loop over the chunks.

Each chunk's pair ``(logsumexp(lw), logsumexp(2 lw))`` comes from
:func:`~gwinferno_tpu_torch.ops.fused.double_logsumexp`, so on a CUDA
tensor every chunk is one launch of K1 in the forward and one more in the
backward's recomputation: ``2 * n_chunks`` launches a bank per gradient,
``n_chunks`` without one.  The chunks' pairs are merged left to right with
:func:`~gwinferno_tpu_torch.ops.fused.logaddexp`, which keeps a chunk whose
samples are all ``-inf`` for a row from giving the gradient a NaN (as
``torch.logaddexp`` would).  Merging reorders the float reductions, so the
results match the flat path to roundoff, not bit for bit.

The outputs feed ``hierarchical_likelihood``'s summaries seam.  These
functions reduce what this process holds; under a mesh with a data axis the
likelihood's layer merges the ranks' pairs
(``pipeline/analysis.py::summaries_over_data``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .fused import double_logsumexp
from .fused import merge_pairs

__all__ = ["chunked_double_logsumexp", "chunked_pairs", "chunked_summaries", "summaries_from_pairs"]


def _chunk_pair(logw_fn, part):
    return double_logsumexp(logw_fn(part))


def chunked_double_logsumexp(logw_fn, banks, n_chunks):
    """Per-row ``(logsumexp(w), logsumexp(2w))`` of the implicit ``(rows,
    S)`` log-weight matrix ``logw_fn(banks)``, in ``n_chunks`` sample-axis
    chunks.

    ``banks``: dict name -> ``(rows, S)`` tensor (constants of the
    problem).  ``logw_fn(chunk_dict)`` returns the chunk's log weights,
    ``(C, rows, chunk)`` for ``C`` chains or ``(rows, chunk)``; parameters
    it closes over get their gradients.  ``S`` must be divisible by
    ``n_chunks``; ``n_chunks=1`` is one evaluation of the whole bank under
    the same checkpoint."""
    S = next(iter(banks.values())).shape[-1]
    if S % n_chunks:
        raise ValueError(f"sample axis {S} not divisible by n_chunks={n_chunks}")
    chunk = S // n_chunks
    pairs = []
    for i in range(n_chunks):
        part = {k: v[..., i * chunk : (i + 1) * chunk] for k, v in banks.items()}
        pairs.append(checkpoint(_chunk_pair, logw_fn, part, use_reentrant=False, preserve_rng_state=False))
    return merge_pairs(pairs)


def summaries_from_pairs(pe_pair, inj_pair, n_samples, total_inj):
    """``hierarchical_likelihood``'s summaries from the PE bank's per-event
    pair ``(..., E)`` over ``n_samples`` samples and the injection bank's
    pair ``(...)``: the log-path estimators of ``per_event_log_bayes_factors``
    and ``detection_efficiency`` (JAX ``chunked.py:79-100``)."""
    lse1, lse2 = pe_pair
    logBFs = lse1 - math.log(1.0 * n_samples)
    log_n_effs = 2.0 * lse1 - lse2
    ilse1, ilse2 = inj_pair
    log_ninj = math.log(total_inj)
    log_mu = ilse1 - log_ninj
    # shifted-log variance, exactly detection_efficiency's log branch
    A = ilse2 - 2.0 * log_ninj
    B = 2.0 * log_mu - log_ninj
    logvar = A + torch.log1p(-torch.exp(torch.clamp_max(B - A, -1e-6)))
    log_n_eff_inj = 2.0 * log_mu - logvar
    return (logBFs, log_n_effs, n_samples), (log_mu, log_n_eff_inj)


def chunked_pairs(pe_logw_fn, pe_banks, inj_logw_fn, inj_banks, n_chunks, inj_chunks=None):
    """The PE bank's per-event pair ``(..., E)`` and the injection bank's
    pair ``(...)`` of :func:`chunked_summaries`, before its tail: the
    injections in ``inj_chunks`` chunks (default ``n_chunks``), one when
    that does not divide ``N_found``."""
    pe_pair = chunked_double_logsumexp(pe_logw_fn, pe_banks, n_chunks)
    inj_rows = {k: v.reshape(1, -1) for k, v in inj_banks.items()}
    ichunks = inj_chunks if inj_chunks is not None else n_chunks
    n_found = next(iter(inj_rows.values())).shape[-1]
    if n_found % ichunks:
        ichunks = 1
    il1, il2 = chunked_double_logsumexp(
        lambda part: inj_logw_fn({k: v[0] for k, v in part.items()}).unsqueeze(-2), inj_rows, ichunks
    )
    return pe_pair, (il1[..., 0], il2[..., 0])


def chunked_summaries(pe_logw_fn, pe_banks, inj_logw_fn, inj_banks, total_inj, n_chunks, inj_chunks=None):
    """Chunked ``(pe_summaries, inj_summaries)`` for
    ``hierarchical_likelihood``.

    ``pe_banks``: dict name -> ``(E, S)``; ``inj_banks``: dict name ->
    ``(N_found,)``, reduced as one row.  ``pe_logw_fn`` maps a PE chunk to
    ``(C, E, chunk)`` (or ``(E, chunk)``), ``inj_logw_fn`` an injection chunk
    of 1-D banks to ``(C, chunk)`` (or ``(chunk,)``).  The injections take
    ``inj_chunks`` chunks (default ``n_chunks``), and one chunk when that
    does not divide ``N_found``.  Returns ``((logBFs, log_n_effs, S),
    (log_mu, log_n_eff_inj))``."""
    S = next(iter(pe_banks.values())).shape[-1]
    pairs = chunked_pairs(pe_logw_fn, pe_banks, inj_logw_fn, inj_banks, n_chunks, inj_chunks)
    return summaries_from_pairs(*pairs, S, total_inj)
