"""The supernova family, batch-first: the Arnett bolometric models and the
Sr2023 host-galaxy power law.

PyTorch counterpart of ``nmma_tpu/models/supernova.py`` (the reference's
``arnett_lc``/``arnett_modified_lc`` and ``host_lc``,
nmma/em/lightcurve_generation.py:64-140, 284-294). The Arnett
energy-deposition integrals, one ``scipy.quad`` per time in the reference,
are a fixed 64-node Gauss-Legendre quadrature over the whole [B, T] grid.
Luminosity is carried as L / 1e40 erg/s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import msun_cgs
from ..ops.photometry import flux_to_ab_mag
from .base import SourceModel, register_source_model

# Arnett constants (reference :85-91)
_EPS_NI = 3.9e10      # erg/s/g
_EPS_CO = 6.78e9      # erg/s/g
_TAU_NI = 8.8         # days
_TAU_CO = 111.3       # days
_Y_SCALE = 2.0 * _TAU_NI
_S_SCALE = (2.0 * _TAU_CO * _TAU_NI) / (_TAU_CO - _TAU_NI)

_QUAD_ORDER = 64
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_QUAD_ORDER)


def _arnett_integral(x, y, s=0.0):
    """int_0^x 2 z exp(-2 z y + 2 z s + z^2) dz for x [B, T] and y, s [B]
    (``arnett_lc_get_int_A/B``, reference :65-84)."""
    nodes = torch.as_tensor(_GL_NODES, dtype=x.dtype, device=x.device)
    weights = torch.as_tensor(_GL_WEIGHTS, dtype=x.dtype, device=x.device)
    x = x[..., None]                                     # [B, T, 1]
    z = 0.5 * x * (nodes + 1.0)                          # [B, T, Q]
    w = 0.5 * x * weights
    if isinstance(s, torch.Tensor):
        s = s[:, None, None]
    integrand = 2.0 * z * torch.exp(-2.0 * z * y[:, None, None]
                                    + 2.0 * z * s + z * z)
    return torch.sum(w * integrand, dim=-1)


def arnett_lbol40(params, t_days):
    """Arnett bolometric light curve [B, T] in units of 1e40 erg/s
    (``arnett_lc``, reference :93-122)."""
    tau_m = params["tau_m"]
    mni40 = 10.0 ** params["log10_mni"] * (msun_cgs / 1e40)
    y = tau_m / _Y_SCALE
    s = tau_m / _S_SCALE
    x = t_days[None, :] / tau_m[:, None]
    int_a = _arnett_integral(x, y)
    int_b = _arnett_integral(x, y, s)
    return mni40[:, None] * torch.exp(-x * x) * (
        (_EPS_NI - _EPS_CO) * int_a + _EPS_CO * int_b)


def arnett_modified_lbol40(params, t_days):
    """Arnett with a leakage time-delay factor (reference :125-140)."""
    lbol = arnett_lbol40(params, t_days)
    return lbol * (1.0 - torch.exp(
        -((params["t_0"][:, None] / t_days[None, :]) ** 2)))


def _arnett_mags(params, t_days, nu_host):
    # a bolometric model: the "mags" slot carries L / 1e40
    return arnett_lbol40(params, t_days)


def _arnett_modified_mags(params, t_days, nu_host):
    return arnett_modified_lbol40(params, t_days)


def host_galaxy_mags(params, t_days, nu_host, filters=None):
    """Sr2023 afterglow + host power law [B, F, T] (``host_lc``, reference
    :284-294): per filter F = a_AG t^-alpha + f_nu [muJy], with the
    filter's host magnitude as the AB zero point."""
    alpha = params["alpha_AG"][:, None]
    rows = []
    for filt in filters:
        key = filt.replace(":", "_")
        a_ag = params[f"a_AG_{key}"][:, None]
        f_nu = params[f"f_nu_{key}"][:, None]
        host_mag = params[f"host_mag_{key}"][:, None]
        flux = a_ag * torch.pow(t_days[None, :], -alpha) + f_nu
        rows.append(flux_to_ab_mag(flux, residual_mag=host_mag))
    return torch.stack(rows, dim=1)


register_source_model(SourceModel(
    name="Arnett",
    parameter_names=("tau_m", "log10_mni"),
    mags_fn=_arnett_mags,
    default_time_grid=lambda: np.linspace(0.005, 20.0, 40),
    bolometric=True,
    citation="Arnett (1982), ApJ 253, 785",
))
register_source_model(SourceModel(
    name="Arnett_modified",
    parameter_names=("tau_m", "log10_mni", "t_0"),
    mags_fn=_arnett_modified_mags,
    default_time_grid=lambda: np.linspace(0.005, 20.0, 40),
    bolometric=True,
))
register_source_model(SourceModel(
    name="Sr2023",
    parameter_names=("a_AG", "alpha_AG", "f_nu_host"),
    mags_fn=host_galaxy_mags,
    needs_filters=True,
    citation="Srinivasaragavan et al. (2023)",
))
