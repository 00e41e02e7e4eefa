"""Me2017, the Metzger (2017) multi-shell analytic kilonova, batch-first.

PyTorch counterpart of the Me2017 part of ``nmma_tpu/models/kilonova.py``
(the reference's ``eff_metzger_lc``, nmma/em/lightcurve_generation.py
:566-652): the shell dynamics run through K2 (``ops/me2017_kernel.py``),
then the effective temperature of the photosphere is filled over the time
grid and turned into blackbody AB magnitudes, bandpass-integrated when the
detector model passes quadrature nodes. Luminosities are carried as
L / 1e40 so every intermediate stays inside f32 range.
"""

from __future__ import annotations

import math

import torch

from ..constants import sigSB
from ..ops.interp import masked_interp_linear_sorted
from ..ops.me2017_kernel import _L_SCALE, me2017_dynamics
from ..ops.photometry import blackbody_ab_mag, blackbody_ab_mag_banded
from .base import SourceModel, register_source_model


def _bb_mags(nu_host, inv_t, r_photo, nu_nodes=None, nu_weights=None):
    """Point-sampled or bandpass-integrated blackbody magnitudes [B, F, T]."""
    if nu_nodes is not None:
        return blackbody_ab_mag_banded(nu_nodes, nu_weights, inv_t, r_photo)
    return blackbody_ab_mag(nu_host, inv_t, r_photo)


def _me2017_photometry(ltot40, r_photo, t_days, nu_host, nu_nodes=None,
                       nu_weights=None):
    """Effective temperature of the photosphere, filled over the grid where
    it is undefined, then blackbody magnitudes [B, F, T]."""
    r_ok = r_photo > 0.0
    r_safe = torch.where(r_ok, r_photo, 1.0)
    q = ltot40.abs() * (_L_SCALE * 1e-20) / (4.0 * math.pi * sigSB) / (
        (r_safe * 1e-10) ** 2)
    t_obs = torch.where(r_ok & (q > 0.0), q ** 0.25, math.nan)
    t_obs = masked_interp_linear_sorted(t_days, t_days, t_obs)
    inv_t = torch.where(torch.isfinite(t_obs) & (t_obs > 0.0), 1.0 / t_obs,
                        math.inf)
    return _bb_mags(nu_host, inv_t, r_photo, nu_nodes, nu_weights)


def me2017_mags(params, t_days, nu_host, nu_nodes=None, nu_weights=None):
    """Me2017 absolute AB magnitudes [B, F, T] of parameters {name: [B]}
    on the source-frame grid ``t_days`` [T]."""
    ltot40, r_photo = me2017_dynamics(
        params["log10_mej"], params["log10_vej"], params["beta"],
        10.0 ** params["log10_kappa_r"], t_days)
    return _me2017_photometry(ltot40, r_photo, t_days, nu_host, nu_nodes,
                              nu_weights)


register_source_model(SourceModel(
    name="Me2017",
    parameter_names=("log10_mej", "log10_vej", "beta", "log10_kappa_r"),
    mags_fn=me2017_mags,
    citation="Metzger (2017), LRR 20, 3",
    banded=True,
))
