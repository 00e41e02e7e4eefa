"""Piro (2021) shock cooling of an extended envelope, batch-first.

PyTorch counterpart of ``nmma_tpu/models/shock_cooling.py`` (the
reference's ``sc_bol_lc``/``sc_lc``, nmma/em/lightcurve_generation.py
:314-363): an early power-law and a late exponential regime of the
luminosity and of the photospheric radius, joined by ``where``; the
magnitudes are the band-integrated blackbody of that photosphere.
Luminosity is carried as L / 1e40 erg/s so every intermediate stays in
f32's range.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import c_cgs, msun_cgs, seconds_a_day, sigSB
from ..ops.photometry import blackbody_ab_mag, blackbody_ab_mag_banded
from .base import SourceModel, register_source_model


def piro2021_bolometric(params, t_days):
    """(L / 1e40 erg/s [B, T], photospheric radius [cm] [B, T]) on the
    sample times ``t_days`` [T] (reference :314-355)."""
    t = (t_days * seconds_a_day)[None, :]
    col = (lambda v: v[:, None])
    menv = col(10.0 ** params["log10_Menv"] * msun_cgs)
    renv = col(10.0 ** params["log10_Renv"])
    # exponent arithmetic keeps 10^log10_Ee (~1e51) out of f32's range
    ee40 = col(10.0 ** (params["log10_Ee"] - 40.0))
    menv40 = col(10.0 ** params["log10_Menv"] * (msun_cgs * 1e-40))

    n, delta = 10.0, 1.1
    big_k = (n - 3.0) * (3.0 - delta) / (4.0 * math.pi * (n - delta))
    kappa = 0.2
    vt = torch.sqrt(((n - 5.0) * (5.0 - delta) / ((n - 3.0) * (3.0 - delta)))
                    * (2.0 * ee40 / menv40))
    td = torch.sqrt((3.0 * kappa * big_k * menv) / ((n - 1.0) * vt * c_cgs))

    prefactor40 = (math.pi * (n - 1.0) / (3.0 * (n - 5.0))
                   * (c_cgs * 1e-20) * renv * vt * vt / kappa * 1e-20)
    l40_early = prefactor40 * torch.pow(td / t, 4.0 / (n - 2.0))
    l40_late = prefactor40 * torch.exp(-0.5 * (t * t / (td * td) - 1.0))
    lbol40 = torch.where(t < td, l40_early, l40_late)

    tph = torch.sqrt(3.0 * kappa * big_k * menv
                     / (2.0 * (n - 1.0) * vt * vt))
    r_early = torch.pow(tph / t, 2.0 / (n - 1.0)) * vt * t
    r_late = (torch.pow(1.0 + (delta - 1.0) / (n - 1.0)
                        * ((t / tph) ** 2 - 1.0), -1.0 / (delta - 1.0))
              * vt * t)
    rs = torch.where(t < tph, r_early, r_late)
    return lbol40, rs


def piro2021_mags(params, t_days, nu_host, nu_nodes=None, nu_weights=None):
    """Piro2021 absolute magnitudes [B, F, T]: banded over the filters'
    quadrature when the detector passes it, else at ``nu_host``."""
    lbol40, rs = piro2021_bolometric(params, t_days)
    # T^4 = L / (4 pi R^2 sigma), assembled with f32-safe scaling
    q = (lbol40 * 1e20) / (4.0 * math.pi * sigSB) / ((rs * 1e-10) ** 2)
    good = (q > 0.0) & torch.isfinite(q)
    t_eff = torch.where(good, torch.pow(torch.where(good, q, 1.0), 0.25),
                        math.nan)
    inv_t = torch.where(torch.isfinite(t_eff) & (t_eff > 0.0), 1.0 / t_eff,
                        math.inf)
    if nu_nodes is not None:
        return blackbody_ab_mag_banded(nu_nodes, nu_weights, inv_t, rs)
    return blackbody_ab_mag(nu_host, inv_t, rs)


register_source_model(SourceModel(
    name="Piro2021",
    parameter_names=("log10_Menv", "log10_Renv", "log10_Ee"),
    mags_fn=piro2021_mags,
    default_time_grid=lambda: np.geomspace(1.0 / 24.0, 3.5, 100),
    banded=True,
    citation="Piro et al. (2021), ApJ 909, 209",
))
