"""Bolometric light-curve likelihood (the Arnett supernova path),
batch-first.

PyTorch counterpart of ``nmma_tpu/likelihood/bolometric.py`` (the
reference's ``BasicEMTransient`` with ``SimpleBolometricLightCurveModel``,
nmma/em/em_likelihood.py:140-276, nmma/em/analysis.py:72-108): Gaussian
chi^2 of the bolometric luminosities and upper limits as log-survival
terms. Luminosities are carried as L / 1e40 erg/s, the scale the models
emit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.base import DetectorLightCurveModel
from ..ops.interp import masked_interp_sorted_fill

_NEG_INF = -1e30
L_UNIT = 1e40


class BolometricLikelihood:
    def __init__(self, light_curve_model: DetectorLightCurveModel, times,
                 lbol, lbol_err, sys_error=1e-4):
        """times [N] days since trigger; lbol and lbol_err in erg/s (host
        side, put on the 1e40 scale here; an inf error marks an upper
        limit). The tensors live on the model's device."""
        self.model = light_curve_model
        dev = light_curve_model.device

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=dev)

        self.times = f32(np.asarray(times, dtype=np.float64))
        self.lbol40 = f32(np.asarray(lbol, dtype=np.float64) / L_UNIT)
        err = np.asarray(lbol_err, dtype=np.float64)
        self.sigma40 = f32(np.where(np.isfinite(err), err / L_UNIT, np.inf))
        self.sys_error = float(sys_error)

    def log_likelihood(self, parameters):
        """[B] log-likelihoods for a parameter dict {name: [B]}."""
        obs_times, lbol40_model = self.model(parameters)       # [B, T] x 2
        est = masked_interp_sorted_fill(self.times, obs_times,
                                             lbol40_model, math.inf)
        est_safe = torch.where(torch.isfinite(est), est, 1e30)

        is_det = torch.isfinite(self.sigma40)
        total_sigma = torch.sqrt(self.sigma40 ** 2 + self.sys_error ** 2)
        safe_sigma = torch.where(is_det, total_sigma, 1.0)
        u = (self.lbol40 - est_safe) / safe_sigma
        chi2_terms = (-0.5 * u * u - 0.5 * math.log(2.0 * math.pi)
                      - torch.log(safe_sigma))
        chi2 = torch.where(is_det, chi2_terms, 0.0).sum(-1)

        sf_terms = torch.special.log_ndtr(
            -(self.lbol40 - est_safe) / max(self.sys_error, 1e-10))
        logsf = torch.where(~is_det, sf_terms, 0.0).sum(-1)

        logl = chi2 + logsf
        ok = torch.isfinite(est).any(-1)
        logl = torch.where(ok, logl, _NEG_INF)
        return torch.where(torch.isnan(logl), _NEG_INF,
                           torch.clamp(logl, min=_NEG_INF))

    def __call__(self, parameters):
        return self.log_likelihood(parameters)
