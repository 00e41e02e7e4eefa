"""Flux -> AB magnitude and blackbody photometry in PyTorch.

Batch-first counterpart of ``nmma_tpu/ops/photometry.py`` (the reference's
``bb_flux_from_inv_temp``/``flux_to_ABmag``, nmma/em/lightcurve_generation.py
:40-58 and nmma/em/utils.py:793-811). Magnitudes are assembled in log space,
so the physical flux (values like 1e-18 with ``exp(700)`` intermediates)
never forms in f32; ``log(expm1(x))`` takes the stable branch
``x + log1p(-exp(-x))`` for large ``x``. Invalid photospheres (``1/T = inf``
or a radius <= 0) give ``inf`` magnitudes.

Shapes: ``inv_temp`` and ``radius`` are [B, T]; point-sampled frequencies
are [B, F]; band quadrature nodes are [B, F, K] with weights [F, K]; the
magnitudes come back as [B, F, T].
"""

from __future__ import annotations

import math

import torch

from ..constants import (AB_ZP_CGS, AB_ZP_JY, AB_ZP_MJY, LN10,
                         abs_mag_dist_factor, c_cgs, h, kb)
from . import bb_photometry_kernel

# Python floats: abs_mag_dist_factor (~9.5e38) overflows f32, so only its
# log ever meets a tensor
_LOG_BB_FACTOR = math.log(2.0) + math.log(h) - 2.0 * math.log(c_cgs)
_LOG_DIST2 = math.log(abs_mag_dist_factor)


def log_expm1(x):
    """log(e^x - 1), stable for all x > 0 (no exp overflow)."""
    x = torch.clamp(x, min=1e-30)
    small = torch.log(torch.expm1(torch.clamp(x, max=20.0)))
    large = x + torch.log1p(-torch.exp(-torch.clamp(x, max=80.0)))
    return torch.where(x < 20.0, small, large)


def ab_mag_from_log_flux(log_flux_cgs):
    """AB magnitude from ln(F_nu [erg s^-1 cm^-2 Hz^-1])."""
    return -2.5 / LN10 * log_flux_cgs + AB_ZP_CGS


def flux_to_ab_mag(flux, unit="cgs", residual_mag=None):
    """AB magnitude from linear flux; non-positive flux maps to +inf."""
    zp = {"cgs": AB_ZP_CGS, "Jy": AB_ZP_JY, "mJy": AB_ZP_MJY}[unit]
    if residual_mag is not None:
        zp = residual_mag
    good = flux > 0.0
    safe = torch.where(good, flux, 1.0)
    return torch.where(good, -2.5 * torch.log10(safe) + zp, math.inf)


def banded_ab_mag_from_log_flux(log_flux, weights):
    """Band AB magnitudes [B, F, T] from per-node ln F_nu [B, F, K, T]
    (``-inf`` marks no flux) and normalised band weights [F, K]: the
    transmission-weighted mean flux, ``-2.5/ln10 * logsumexp_k(ln w_k +
    ln F_k) + ZP`` (the reference's sncosmo ``bandmag`` integral,
    nmma/em/model.py:1121-1180)."""
    logw = torch.log(torch.clamp(weights, min=1e-30))
    log_mean = torch.logsumexp(log_flux + logw[:, :, None], dim=-2)
    return ab_mag_from_log_flux(log_mean)


def blackbody_ab_mag_banded(nu_nodes, weights, inv_temp, radius,
                            log_dist2=_LOG_DIST2):
    """Bandpass-integrated blackbody AB magnitudes [B, F, T]: the Planck
    spectrum at the [B, F, K] quadrature nodes, averaged with the [F, K]
    band weights. A (filter, time) is ``inf`` unless every node is valid.
    CPU tensors take :func:`blackbody_ab_mag_banded_plain`, all others K5
    (``ops/bb_photometry_kernel.py``), with the operands broadcast to B
    rows."""
    if nu_nodes.device.type == "cpu":
        return blackbody_ab_mag_banded_plain(nu_nodes, weights, inv_temp,
                                             radius, log_dist2)
    n_b = max(nu_nodes.shape[0], inv_temp.shape[0], radius.shape[0])
    n_t = max(inv_temp.shape[1], radius.shape[1])
    return bb_photometry_kernel.bb_mags(
        nu_nodes.expand(n_b, -1, -1).contiguous(), weights.contiguous(),
        inv_temp.expand(n_b, n_t).contiguous(),
        radius.expand(n_b, n_t).contiguous(), log_dist2)


def blackbody_ab_mag_banded_plain(nu_nodes, weights, inv_temp, radius,
                                  log_dist2=_LOG_DIST2):
    """:func:`blackbody_ab_mag_banded` as eager PyTorch over [B, F, K, T]
    tensors: the CPU path, and what K5 is held to on the card."""
    nu = nu_nodes[:, :, :, None]                     # [B, F, K, 1]
    inv_temp = inv_temp[:, None, None, :]            # [B, 1, 1, T]
    radius = radius[:, None, None, :]

    x = h * nu * inv_temp / kb                       # [B, F, K, T]
    good = torch.isfinite(x) & (x > 0.0) & (radius > 0.0)
    x_safe = torch.where(good, x, 1.0)
    r_safe = torch.where(radius > 0.0, radius, 1.0)
    log_flux = (_LOG_BB_FACTOR + 3.0 * torch.log(nu)
                - log_expm1(x_safe)
                + 2.0 * torch.log(r_safe) - log_dist2)
    log_flux = torch.where(good, log_flux, -math.inf)
    mag = banded_ab_mag_from_log_flux(log_flux, weights)
    return torch.where(good.all(dim=2), mag, math.inf)


def blackbody_ab_mag(nu, inv_temp, radius, log_dist2=_LOG_DIST2):
    """Point-sampled blackbody AB magnitudes [B, F, T] at host-frame
    frequencies ``nu`` [B, F]; ``inf`` where the photosphere is invalid."""
    nu = nu[:, :, None]                              # [B, F, 1]
    inv_temp = inv_temp[:, None, :]                  # [B, 1, T]
    radius = radius[:, None, :]

    x = h * nu * inv_temp / kb                       # [B, F, T]
    good = torch.isfinite(x) & (x > 0.0) & (radius > 0.0)
    x_safe = torch.where(good, x, 1.0)
    r_safe = torch.where(radius > 0.0, radius, 1.0)
    log_flux = (_LOG_BB_FACTOR + 3.0 * torch.log(nu)
                - log_expm1(x_safe)
                + 2.0 * torch.log(r_safe) - log_dist2)
    mag = ab_mag_from_log_flux(log_flux)
    return torch.where(good, mag, math.inf)
