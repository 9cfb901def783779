"""The B-spline production model's likelihood reductions in one K3 pass per
bank.

Counterpart of ``gwinferno_tpu/models/bsplines/fused_path.py``.  The
example model's log-weights are affine in the stacked coefficient vector:
the log-range splines project as ``exp(B @ c)`` and the redshift powerlaw
adds ``lamb * log1p(z)``.  So the whole per-sample log-weight is
``coefs (C, K) @ design (K, E*S) + nlp``, and both banks' reductions are K3
launches (:func:`gwinferno_tpu_torch.ops.fused.fused_logweight_logsumexp`),
with the per-chain normalizations added after the reduction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.fused import fused_logweight_logsumexp
from ...ops.fused import padded_rows

__all__ = ["FusedBSplineLikelihood"]


class FusedBSplineLikelihood:
    """The stacked design matrices of the B-spline example model (LogXLogY
    m1, LogY q, IID LogY magnitudes and tilts, powerlaw-spline redshift) over
    both banks, on the models' device in their dtype.

    ``__call__(m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb)`` (coefficients
    ``(C, K_i)``, ``lamb (C,)``) returns ``(logBFs (C, E), log_n_effs (C, E),
    log_mu (C,), log_n_eff_inj (C,))``, as ``per_event_log_bayes_factors``
    and ``detection_efficiency`` give them in log mode.
    """

    def __init__(self, mass_models, mag_model, tilt_model, z_model, pedict, injdict, total_inj):
        self.total_inj = float(total_inj)
        self.mass_models = mass_models
        self.mag_model = mag_model
        self.tilt_model = tilt_model
        self.z_model = z_model
        E, S = np.shape(pedict["mass_1"])
        self.n_events, self.n_samples = int(E), int(S)
        self.n_found = int(np.shape(injdict["mass_1"])[0])
        self.pe_design, self.pe_nlp = self._build_bank(pedict, True)
        self.inj_design, self.inj_nlp = self._build_bank(injdict, False)

    def _build_bank(self, d, pe):
        """``(design (K, n), nlp (n,))`` of one bank: the models' cached
        design matrices stacked, plus the ``log1p(z)`` row of ``lamb``; the
        data-only terms are made in float64 and cast once.  The design is a
        view of rows padded to whole 16-byte vectors (:func:`padded_rows`), so
        K3 reads every row in aligned 16-byte vectors."""
        idx = 1 if pe else 0
        m1m, qm = self.mass_models.primary_model, self.mass_models.ratio_model
        a1m, a2m = self.mag_model.primary_model, self.mag_model.secondary_model
        t1m, t2m = self.tilt_model.primary_model, self.tilt_model.secondary_model
        zm = self.z_model
        ref = m1m.pe_design_matrix
        dev, dtype = ref.device, ref.dtype

        def dm(model):
            mat = model.pe_design_matrix if pe else model.inj_design_matrix
            return mat.reshape(mat.shape[0], -1)

        z = np.asarray(d["redshift"], dtype=np.float64)
        lamb_row = torch.as_tensor(np.log1p(z).reshape(1, -1), dtype=dtype, device=dev)
        design = torch.cat([dm(m1m), dm(qm), dm(a1m), dm(a2m), dm(t1m), dm(t2m), dm(zm), lamb_row], dim=0)

        valid = torch.as_tensor(z <= zm.zmax, device=dev)
        for model in (m1m, qm, a1m, a2m, t1m, t2m):
            valid = valid & (model._valid_xx if pe else model._valid_xx_inj)
        nlp = np.log(np.asarray(zm.dVdzs[idx], dtype=np.float64)) - np.log1p(z) - np.log(np.asarray(d["prior"], dtype=np.float64))
        nlp = torch.where(valid, torch.as_tensor(nlp, dtype=dtype, device=dev), -torch.inf).reshape(-1)
        return padded_rows(design), nlp.contiguous()

    def _coefs(self, m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb):
        """The stacked coefficients ``(C, K)``."""
        return torch.cat([m_cs, q_cs, a_cs, a_cs, tilt_cs, tilt_cs, z_cs, lamb.reshape(-1, 1)], dim=-1)

    def _log_norm(self, m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb):
        """Per chain ``(C,)``: the log of the splines' normalizations (the
        multipliers) minus the log of the redshift model's normalization."""
        mass, mag, tilt, zm = self.mass_models, self.mag_model, self.tilt_model, self.z_model
        return (
            torch.log(mass.primary_model.interpolator.norm(m_cs))
            + torch.log(mass.ratio_model.interpolator.norm(q_cs))
            + 2.0 * torch.log(mag.primary_model.interpolator.norm(a_cs))
            + 2.0 * torch.log(tilt.primary_model.interpolator.norm(tilt_cs))
            - torch.log(zm.normalization(lamb, z_cs))
        )

    def __call__(self, m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb):
        coefs = self._coefs(m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb)
        log_norm = self._log_norm(m_cs, q_cs, a_cs, tilt_cs, z_cs, lamb)

        logBF, log_neff = fused_logweight_logsumexp(coefs, self.pe_design, self.pe_nlp, self.n_events, self.n_samples)
        logBFs = logBF + log_norm[:, None]
        log_n_effs = log_neff

        inj_logbf, inj_log_neff_raw = fused_logweight_logsumexp(coefs, self.inj_design, self.inj_nlp, 1, self.n_found)
        # the helper subtracted log(n_found); undo to get raw logsumexp(logw)
        lse1_raw = inj_logbf[:, 0] + math.log(1.0 * self.n_found)
        log_ninj = math.log(self.total_inj)
        log_mu = lse1_raw + log_norm - log_ninj
        # detection_efficiency's n_eff = mu^2/var with var = s2/N^2 - mu^2/N;
        # in log space (norms cancel): n_eff_raw = (sum w)^2 / sum w^2 gives
        # log_n_eff_inj = log_n_eff_raw - log1p(-n_eff_raw/Ninj)
        log_neff_raw = inj_log_neff_raw[:, 0]
        delta = torch.clamp_max(log_neff_raw - log_ninj, -1e-6)
        log_n_eff_inj = log_neff_raw - torch.log1p(-torch.exp(delta))
        return logBFs, log_n_effs, log_mu, log_n_eff_inj
