"""Spectral time-series source models (the sncosmo-SN architecture),
batch-first.

PyTorch counterpart of ``nmma_tpu/models/spectral.py`` (the reference's
``SupernovaLightCurveModel``, nmma/em/model.py:1061-1227). Any (phase,
wavelength, flux) grid, such as a sncosmo-format 3-column ASCII template,
becomes a registered source model with
  * K-corrections: magnitudes come from the spectrum itself at the
    host-frame filter frequencies of each live point, band-integrated over
    the filters' quadrature;
  * peak anchoring: the template's amplitude is pinned so its rest-frame
    peak in the anchor band is M_REF = -19.35, offset by the sampled
    ``supernova_mag_boost``;
  * inf outside the template's phase range.
The SALT2 form ``x0 [M0 + x1 M1] 10^(-0.4 c CL)`` samples an apparent
amplitude and so takes no distance modulus. Everything static is computed
once on the host in float64, as the JAX package does; the per-sample work is
an interpolation in log frequency, then one in time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import c_cgs as C_CGS
from ..ops.interp import masked_interp_sorted_fill
from .base import SourceModel, register_source_model

_AB_ZP_CGS = 3631e-23      # erg/s/cm^2/Hz
M_REF = -19.35             # reference peak absolute magnitude anchor
_ANCHOR_WAVE_AA = 4380.0   # Bessell-B-like anchor wavelength
_LN10 = math.log(10.0)


def load_sncosmo_ascii_template(path):
    """(phase [T], wave_aa [W], flam [T, W]) from a sncosmo-style 3-column
    ASCII template (phase, wavelength [AA], f_lambda rows)."""
    raw = np.loadtxt(path)
    phases = np.unique(raw[:, 0])
    waves = np.unique(raw[:, 1])
    flam = np.full((len(phases), len(waves)), np.nan)
    pi = np.searchsorted(phases, raw[:, 0])
    wi = np.searchsorted(waves, raw[:, 1])
    flam[pi, wi] = raw[:, 2]
    if np.isnan(flam).any():
        raise ValueError(f"{path}: template grid is not rectangular")
    return phases, waves, flam


def interp_static_rows(xq, x, y, fill):
    """``masked_interp_sorted_fill`` of static rows ``y`` [R, N] on the
    ascending grid ``x`` [N] at per-sample queries ``xq`` [B, Q]: each query
    uses its row's nearest valid neighbours, and queries outside a row's
    valid range (or rows with fewer than 2 valid nodes) get ``fill``.
    Returns [B, R, Q]."""
    n_rows, n = y.shape
    valid = torch.isfinite(y)
    n_valid = valid.sum(-1)[:, None, None]
    idx = torch.arange(n, device=x.device).expand_as(y)
    left_of = torch.cummax(torch.where(valid, idx, -1), -1).values
    right_of = n - 1 - torch.flip(torch.cummax(
        torch.flip(torch.where(valid, n - 1 - idx, -1), (-1,)), -1).values,
        (-1,))
    pos = torch.clamp((xq[..., None] >= x).sum(-1) - 1, 0, n - 1)[None]
    rows = torch.arange(n_rows, device=x.device)[:, None, None]
    l_idx = left_of[rows, pos]                              # [R, B, Q]
    r_idx = right_of[rows, torch.clamp(pos + 1, 0, n - 1)]
    # a query beyond the last grid cell still needs the last valid point
    r_idx = torch.where(pos >= n - 1, left_of[:, n - 1][:, None, None],
                        r_idx)
    l_ok = l_idx >= 0
    r_ok = (r_idx >= 0) & (r_idx <= n - 1)
    l_c, r_c = l_idx.clamp(0, n - 1), r_idx.clamp(0, n - 1)
    x_l, y_l = x[l_c], y[rows, l_c]
    x_r, y_r = x[r_c], y[rows, r_c]
    span = torch.where(x_r > x_l, x_r - x_l, 1.0)
    w = torch.clamp((xq[None] - x_l) / span, 0.0, 1.0)
    est = torch.where(l_ok & r_ok, y_l + w * (y_r - y_l), fill)
    x_first = x[right_of[:, 0].clamp(0, n - 1)][:, None, None]
    x_last = x[left_of[:, n - 1].clamp(0, n - 1)][:, None, None]
    est = torch.where((xq[None] < x_first) | (xq[None] > x_last), fill, est)
    est = torch.where(n_valid >= 2, est, fill)
    return est.permute(1, 0, 2)


def _phase_time_grid(phase):
    """The detector's time grid: the template's positive phases (days since
    trigger are > 0), or a log grid when fewer than two are positive."""
    return (np.asarray(phase[phase > 0]) if (phase > 0).sum() >= 2
            else np.geomspace(1e-3, max(float(phase[-1]), 1.0), 32))


class _Tables:
    """The static [T_tpl, W] tables of a template, moved to a device on
    first use there and kept."""

    def __init__(self, **arrays):
        self._host = arrays
        self._on = {}

    def on(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: torch.as_tensor(v, dtype=torch.float32,
                                                device=device)
                             for k, v in self._host.items()}
        return self._on[key]


def _query_frequencies(nu_host, nu_nodes):
    """ln nu of each live point's queries [B, Q]: the band quadrature
    nodes [B, F, K] when given, else the host-frame frequencies [B, F]."""
    if nu_nodes is not None:
        return torch.log(nu_nodes.reshape(nu_nodes.shape[0], -1))
    return torch.log(nu_host)


def make_spectral_source_model(name, phase_days, wave_aa, flam,
                               anchor=True, extra_parameters=()):
    """Register a spectral time-series source model.

    phase_days [T] rest-frame phases (days), wave_aa [W] wavelengths (AA),
    flam [T, W] spectral flux density (erg/s/cm^2/AA at any distance; the
    amplitude is re-anchored unless ``anchor=False``).
    """
    phase = np.asarray(phase_days, dtype=np.float64)
    wave = np.asarray(wave_aa, dtype=np.float64)
    flam = np.asarray(flam, dtype=np.float64)

    # f_nu [T, W] and AB magnitudes on the template grid. Zero or negative
    # flux maps to a finite, absurdly faint magnitude (~+743 from the
    # 1e-300 floor), not +inf: in-coverage zeros stay data, distinct from
    # "outside the wavelength coverage"
    fnu = flam * (wave[None, :] ** 2 * 1e-8) / C_CGS
    with np.errstate(divide="ignore"):
        mag_grid = -2.5 * np.log10(np.maximum(fnu, 1e-300) / _AB_ZP_CGS)

    offset = 0.0
    if anchor:
        # np.interp clamps out-of-range queries to the edge value, which
        # would anchor an out-of-band template to its edge flux
        if not (wave[0] <= _ANCHOR_WAVE_AA <= wave[-1]):
            raise ValueError(
                f"anchor wavelength {_ANCHOR_WAVE_AA:.0f} AA outside the "
                f"template coverage [{wave[0]:.0f}, {wave[-1]:.0f}] AA; "
                f"pass anchor=False and calibrate the amplitude yourself")
        anchor_mags = np.array([
            np.interp(_ANCHOR_WAVE_AA, wave, row) for row in mag_grid])
        offset = M_REF - float(np.min(anchor_mags))
    mag_grid = mag_grid + offset

    # a NaN that slips through becomes "ignored" (inf), never a magnitude
    tables = _Tables(
        phase=phase, log_nu=np.log(C_CGS / (wave * 1e-8))[::-1].copy(),
        mag=np.nan_to_num(np.ascontiguousarray(mag_grid[:, ::-1]),
                          nan=np.inf, posinf=np.inf))

    def mags_fn(params, t_days, nu_host, nu_nodes=None, nu_weights=None):
        tab = tables.on(t_days.device)
        log_nu_q = _query_frequencies(nu_host, nu_nodes)        # [B, Q]
        mags_q = interp_static_rows(log_nu_q, tab["log_nu"], tab["mag"],
                                    math.inf)                   # [B, T, Q]
        n_b, n_tpl = mags_q.shape[:2]
        if nu_nodes is not None:
            # band integral (the reference's sncosmo bandmag, nmma/em/
            # model.py:1121-1180): the template's flux at every node,
            # averaged with the band weights in log space. Nodes outside
            # the template's coverage are dropped and the weights
            # renormalised over the rest; a band under half covered is inf
            n_f, n_k = nu_nodes.shape[1:]
            mag_nodes = mags_q.reshape(n_b, n_tpl, n_f, n_k).permute(
                0, 2, 3, 1)                                     # [B, F, K, T]
            finite = torch.isfinite(mag_nodes)
            log_flux = -0.4 * _LN10 * torch.where(finite, mag_nodes,
                                                  math.inf)
            logw = torch.log(torch.clamp(nu_weights, min=1e-30))[
                None, :, :, None].expand_as(mag_nodes)
            logw_fin = torch.where(finite, logw, -math.inf)
            log_mean = (torch.logsumexp(log_flux + logw_fin, dim=2)
                        - torch.logsumexp(logw_fin, dim=2))     # [B, F, T]
            covered = torch.where(finite, torch.exp(logw), 0.0).sum(dim=2)
            mag_ft = torch.where(covered > 0.5, -2.5 / _LN10 * log_mean,
                                 math.inf)
        else:
            mag_ft = mags_q.transpose(1, 2)                     # [B, F, T]
        boost = params.get("supernova_mag_boost", 0.0)
        if isinstance(boost, torch.Tensor):
            boost = boost[:, None, None]
        return masked_interp_sorted_fill(t_days, tab["phase"], mag_ft,
                                         math.inf) + boost

    model = SourceModel(
        name=name,
        parameter_names=("supernova_mag_boost",) + tuple(extra_parameters),
        mags_fn=mags_fn,
        default_time_grid=lambda: _phase_time_grid(phase),
        banded=True,
        citation="spectral time-series template (sncosmo-architecture "
                 "counterpart, nmma/em/model.py:1061-1227)",
    )
    register_source_model(model)
    return model


def make_salt2_source_model(name, phase_days, wave_aa, m0_flam, m1_flam,
                            color_law=None):
    """SALT2-architecture source model (the reference's ``salt2`` path via
    sncosmo.SALT2Source): F(p, lambda) = x0 [M0 + x1 M1] 10^(-0.4 c CL),
    with x0 an apparent amplitude (no distance modulus), x1 and c sampled;
    M0, M1 and the colour law CL (default zeros) on ``wave_aa`` are inputs.
    M1 can be negative, so the interpolation runs in linear flux and a
    non-positive total flux is an inf magnitude."""
    phase = np.asarray(phase_days, dtype=np.float64)
    wave = np.asarray(wave_aa, dtype=np.float64)
    m0 = np.asarray(m0_flam, dtype=np.float64)
    m1 = np.asarray(m1_flam, dtype=np.float64)
    cl = (np.zeros_like(wave) if color_law is None
          else np.asarray(color_law, dtype=np.float64))

    # f_lambda -> f_nu component surfaces on an ascending log-nu grid
    conv = (wave[None, :] ** 2 * 1e-8) / C_CGS
    tables = _Tables(
        phase=phase, log_nu=np.log(C_CGS / (wave * 1e-8))[::-1].copy(),
        f0=np.ascontiguousarray((m0 * conv)[:, ::-1]),
        f1=np.ascontiguousarray((m1 * conv)[:, ::-1]),
        cl=np.ascontiguousarray(cl[::-1])[None, :])

    def mags_fn(params, t_days, nu_host, nu_nodes=None, nu_weights=None):
        tab = tables.on(t_days.device)
        like = params["x0"] if "x0" in params else nu_host[:, 0]

        def sample(key, default):
            value = params.get(key, default)
            if not isinstance(value, torch.Tensor):
                value = torch.full_like(like, float(value))
            return value[:, None, None]

        x0, x1, c = sample("x0", 1e-5), sample("x1", 0.0), sample("c", 0.0)
        log_nu_q = _query_frequencies(nu_host, nu_nodes)        # [B, Q]
        cl_q = interp_static_rows(log_nu_q, tab["log_nu"], tab["cl"],
                                  0.0)                          # [B, 1, Q]
        flux_q = (interp_static_rows(log_nu_q, tab["log_nu"], tab["f0"],
                                     math.nan)
                  + x1 * interp_static_rows(log_nu_q, tab["log_nu"],
                                            tab["f1"], math.nan)) \
            * torch.pow(10.0, -0.4 * c * cl_q)                  # [B, T, Q]
        if nu_nodes is not None:
            # band average in linear flux (the components can be negative)
            n_f, n_k = nu_nodes.shape[1:]
            flux_q = torch.nan_to_num(flux_q, nan=0.0)
            flux_band = (flux_q.reshape(*flux_q.shape[:2], n_f, n_k)
                         * nu_weights).sum(-1) / nu_weights.sum(1)
        else:
            flux_band = flux_q                                  # [B, T, F]
        flux_band = x0 * flux_band.transpose(1, 2)              # [B, F, T]
        mag_ft = torch.where(
            flux_band > 0.0,
            -2.5 * torch.log10(torch.clamp(flux_band / _AB_ZP_CGS,
                                           min=1e-300)), math.inf)
        return masked_interp_sorted_fill(t_days, tab["phase"], mag_ft,
                                         math.inf)

    model = SourceModel(
        name=name,
        parameter_names=("x0", "x1", "c"),
        mags_fn=mags_fn,
        default_time_grid=lambda: _phase_time_grid(phase),
        banded=True,
        apparent_amplitude=True,
        citation="SALT2-architecture spectral surface "
                 "(nmma/em/model.py:1061-1227 salt2 path)",
    )
    register_source_model(model)
    return model


def spectral_model_from_file(name, path, anchor=True):
    """Template file -> registered model: a sncosmo 3-column ASCII
    template, or a POSSIS .h5 or ASCII spectrum, whose first viewing
    angle's I Stokes spectrum becomes the template
    (nmma_tpu/models/spectral.py:270-296)."""
    if path.endswith((".h5", ".hdf5")):
        from ..io.radiative import read_possis_h5
        time, _, wave, i_stokes, _ = read_possis_h5(path)
        return make_spectral_source_model(name, time, wave, i_stokes[0],
                                          anchor=anchor)
    try:
        phase, wave, flam = load_sncosmo_ascii_template(path)
    except ValueError as e:
        if "not rectangular" in str(e):
            # a malformed 3-column template: its own diagnostic, not the
            # POSSIS reader's parse error
            raise
        from ..io.radiative import read_possis_ascii
        time, _, wave, flux = read_possis_ascii(path)
        return make_spectral_source_model(name, time, wave[0], flux[0],
                                          anchor=anchor)
    return make_spectral_source_model(name, phase, wave, flam,
                                      anchor=anchor)
