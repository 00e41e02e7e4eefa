"""Semi-analytic kilonova models, batch-first.

PyTorch counterpart of ``nmma_tpu/models/kilonova.py`` (the reference's
``nmma/em/lightcurve_generation.py:365-812``):

* Me2017, the Metzger (2017) multi-shell kilonova (``eff_metzger_lc``,
  :566-652): the shell dynamics run through K2 (``ops/me2017_kernel.py``),
  then the effective temperature of the photosphere is filled over the time
  grid and turned into blackbody AB magnitudes, bandpass-integrated when the
  detector model passes quadrature nodes;
* HoNa2020, the Hotokezaka & Nakar velocity-shell kilonova (``HoNa_lc``,
  :654-771), with the JAX package's fixed-grid RK4 in log-time in place of
  the reference's adaptive solver: a Python loop over the time grid on
  ``[B, shells]`` tensors;
* the constant-temperature blackbody, blackbody + power law and synchrotron
  power-law models (:773-812).

Luminosities are carried as L / 1e40 so every intermediate stays inside f32
range. None of these models but Me2017 has a kernel of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import (AB_ZP_CGS, abs_mag_dist_factor, c_cgs, h, kb,
                         msun_cgs, seconds_a_day, sigSB)
from ..ops.interp import interp_rows, masked_interp_linear_sorted
from ..ops.me2017_kernel import _L_SCALE, me2017_dynamics
from ..ops.photometry import (blackbody_ab_mag, blackbody_ab_mag_banded,
                              flux_to_ab_mag, log_expm1)
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


def heating_rate_korobkin_rosswog(t_sec, eth=0.5):
    """Korobkin et al. 2012 r-process specific heating rate [erg/g/s]
    (``heating_rate_Korobkin_Rosswog``, reference :366-395), with
    ``0.5 - arctan(x)/pi`` taken as ``arctan(1/x)/pi`` for x > 1 against
    f32 cancellation."""
    eps0, t0, sig, alpha = 2e18, 1.3, 0.11, 1.3
    x = (t_sec - t0) / sig
    safe_x = torch.where(x > 1.0, x, 1.0)
    time_term = torch.where(
        x > 1.0,
        torch.arctan(1.0 / safe_x) / math.pi,
        0.5 - torch.arctan(torch.clamp(x, max=1.0)) / math.pi)
    return 2.0 * eps0 * eth * torch.pow(time_term, alpha)


# ---------------------------------------------------------------------------
# HoNa2020 — Hotokezaka & Nakar velocity-shell kilonova
# ---------------------------------------------------------------------------
_HONA_NSHELLS = 100
_HONA_STEPS = 300      # RK4 grid; replaces solve_ivp (reference :750-752)


def _hona_luminosity40(e40, t, td, be):
    """Shell luminosity / 1e40 (reference ``luminosity_HoNa`` :677-686)."""
    t_dif = td / t
    tesc = torch.minimum(t, t_dif) + be * t
    ymax = torch.sqrt(0.5 * t_dif / t)
    return torch.special.erfc(ymax) * e40 / tesc


def hona2020_mags(params, t_days, nu_host, nu_nodes=None, nu_weights=None):
    """HoNa2020 absolute AB magnitudes [B, F, T]: the shells' energy
    equation integrated by fixed-grid RK4 on a log grid over the sample
    times, the bolometric luminosity interpolated log-log onto them, the
    photosphere where tau = t^2 (reference :654-771)."""
    t = t_days * seconds_a_day                                  # [T]
    mej = 10.0 ** params["log10_mej"] * msun_cgs                # [B]
    vej_min, vej_max = params["vej_min"], params["vej_max"]
    vej = params["vej_frac"] * (vej_max - vej_min) + vej_min
    velocities = torch.stack([vej_min, vej, vej_max], dim=1)    # [B, 3]
    opacities = torch.stack([10.0 ** params["log10_kappa_low_vej"],
                             10.0 ** params["log10_kappa_high_vej"]], dim=1)
    n = params.get("n", 4.5)
    n_col = n[:, None] if isinstance(n, torch.Tensor) else n

    be_0, be_max = velocities[:, :1], velocities[:, 2:]          # [B, 1]
    # inverse-log-spaced velocity grid (reference :713-716)
    frac = torch.arange(_HONA_NSHELLS, device=t.device) / (_HONA_NSHELLS - 1)
    geo = be_0 * torch.pow(be_max / be_0, frac)
    bes = torch.flip(be_max + be_0 - geo, (1,))[:, :-1]          # [B, 99]
    dbe = torch.diff(torch.cat([bes, be_max], dim=1), dim=1)

    # shell index in the velocity bounds, as jnp.searchsorted (left)
    idx = torch.searchsorted(velocities.contiguous(), bes.contiguous())
    bej_power = torch.pow(velocities / be_0, 1.0 - n_col)        # [B, 3]
    bes_power = torch.pow(bes / be_0, 1.0 - n_col)

    tau_accum = -torch.cumsum(torch.flip(
        opacities * torch.diff(bej_power, dim=1), (1,)), dim=1)
    tau_accum = torch.cat([torch.flip(tau_accum, (1,)),
                           torch.zeros_like(tau_accum[:, :1])], dim=1)
    # an index of 0 takes the last opacity, as a -1 index does in JAX
    i_tau = torch.clamp(idx, 0, 2)
    taus = tau_accum.gather(1, i_tau) \
        + opacities.gather(1, torch.remainder(idx - 1, 2)) \
        * (bes_power - bej_power.gather(1, i_tau))

    vej_0 = be_0[:, 0] * c_cgs                                   # [B]
    rho_0 = mej * (n - 3.0) / (4.0 * math.pi * vej_0**3) / (
        1.0 - torch.pow(be_max[:, 0] / be_0[:, 0], 3.0 - n))
    taus = taus * vej_0[:, None] * rho_0[:, None] / (n_col - 1.0)

    bes_power_2n = torch.pow(bes / be_0, 2.0 - n_col)
    # shell masses / 1e40 g, the scale applied as two in-range f32 factors
    dms40 = (4.0 * math.pi * vej_0**3 * 1e-20)[:, None] * rho_0[:, None] \
        * bes_power_2n * dbe / be_0 * 1e-20
    tds = taus * bes

    # energy equation, RK4 on a log grid covering the sample times; the
    # luminosity at the end of a step is also the one k1 of the next needs
    sfrac = torch.arange(_HONA_STEPS, device=t.device) / (_HONA_STEPS - 1)
    tgrid = t[0] * torch.pow(t[-1] / t[0], sfrac)
    t0s, t1s = tgrid[:-1], tgrid[1:]
    hs = t1s - t0s
    tms = t0s + 0.5 * hs
    heat0 = heating_rate_korobkin_rosswog(t0s)
    heat_m = heating_rate_korobkin_rosswog(tms)
    heat1 = heating_rate_korobkin_rosswog(t1s)

    def rhs(e40, t_now, lum, rate):
        return -e40 / t_now - lum + dms40 * rate

    e40 = torch.zeros_like(tds)
    lum = _hona_luminosity40(e40, t0s[0], tds, bes)
    sums = []
    for j in range(_HONA_STEPS - 1):
        t0, tm, t1, step = t0s[j], tms[j], t1s[j], hs[j]
        k1 = rhs(e40, t0, lum, heat0[j])
        e_mid = e40 + 0.5 * step * k1
        k2 = rhs(e_mid, tm, _hona_luminosity40(e_mid, tm, tds, bes),
                 heat_m[j])
        e_mid = e40 + 0.5 * step * k2
        k3 = rhs(e_mid, tm, _hona_luminosity40(e_mid, tm, tds, bes),
                 heat_m[j])
        e_end = e40 + step * k3
        k4 = rhs(e_end, t1, _hona_luminosity40(e_end, t1, tds, bes),
                 heat1[j])
        e40 = e40 + step / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        lum = _hona_luminosity40(e40, t1, tds, bes)
        sums.append(lum.sum(dim=1))
    lum40_grid = torch.stack(sums, dim=1)                       # [B, S-1]

    # log-log interpolation of L(t) onto the sample times (reference
    # :758-763)
    log_l = torch.log(torch.clamp(lum40_grid, min=1e-30))
    lbol40 = torch.exp(interp_rows(torch.log(t), torch.log(t1s), log_l))

    # photosphere: tau(be) = t^2 in log-log space (reference :764-768)
    log_taus = torch.log(torch.flip(taus, (1,)))
    log_bes = torch.log(torch.flip(bes, (1,)))
    be_ph = torch.exp(interp_rows(2.0 * torch.log(t), log_taus, log_bes))
    r_photo = be_ph * t * c_cgs                                  # [B, T]

    # inverse temperature, f32-safe: 1/T = (sigSB 4 pi R^2 / L)^(1/4)
    q = (sigSB * 4.0 * math.pi / 1e20) * (r_photo * 1e-10) ** 2 \
        / torch.clamp(lbol40, min=1e-30)
    inv_t = torch.pow(q, 0.25)
    return _bb_mags(nu_host, inv_t, r_photo, nu_nodes, nu_weights)


# ---------------------------------------------------------------------------
# Blackbody family + synchrotron (reference :773-812)
# ---------------------------------------------------------------------------
def _inv_temp_photosphere_from_params(params):
    """Constant-T blackbody: 1/T and R from L and T (reference :786-793),
    both [B]. Luminosities ~1e41 erg/s overflow f32, so the radius is
    assembled in log space from 'log10_bb_luminosity' where it is sampled,
    else from a 'bb_luminosity' that fits in f32."""
    inv_temp = 1.0 / params["temperature"]
    if "log10_bb_luminosity" in params:
        log_l = params["log10_bb_luminosity"] * math.log(10.0)
    else:
        log_l = torch.log(params["bb_luminosity"])
    r_photo = torch.exp(0.5 * (log_l - math.log(4.0 * math.pi * sigSB))) \
        * inv_temp * inv_temp
    return inv_temp, r_photo


def blackbody_fixed_t_mags(params, t_days, nu_host, nu_nodes=None,
                           nu_weights=None):
    inv_temp, r_photo = _inv_temp_photosphere_from_params(params)
    shape = (inv_temp.shape[0], t_days.shape[0])
    return _bb_mags(nu_host, inv_temp[:, None].expand(shape),
                    r_photo[:, None].expand(shape), nu_nodes, nu_weights)


def powerlaw_blackbody_fixed_t_mags(params, t_days, nu_host, filters=None):
    """Blackbody + nu^-beta power law anchored at the 'g' band
    (``powerlaw_blackbody_constant_temperature_lc``, reference :800-813):
    the power-law amplitude is ``powerlaw_mag`` at the host-frame 'g'
    frequency (the first filter when there is no 'g')."""
    inv_temp, r_photo = _inv_temp_photosphere_from_params(params)
    beta = params["beta"][:, None, None]
    g_idx = filters.index("g") if filters is not None and "g" in filters \
        else 0
    nu = nu_host[:, :, None]                                    # [B, F, 1]
    nu_ref = nu_host[:, g_idx, None, None]

    prefactor = torch.pow(nu_ref, beta) * 10.0 ** (
        -0.4 * (params["powerlaw_mag"][:, None, None] - AB_ZP_CGS))
    f_pl = prefactor * torch.pow(nu, -beta)

    x = torch.clamp(h * nu * inv_temp[:, None, None] / kb, min=1e-30)
    log_bb = (math.log(2.0 * h) - 2.0 * math.log(c_cgs) + 3.0 * torch.log(nu)
              - log_expm1(x) + 2.0 * torch.log(r_photo[:, None, None])
              - math.log(abs_mag_dist_factor))
    f_total = torch.exp(torch.clamp(log_bb, max=80.0)) + f_pl
    mags = flux_to_ab_mag(f_total)
    return mags.expand(-1, -1, t_days.shape[0])


def synchrotron_powerlaw_mags(params, t_days, nu_host):
    """Synchrotron power law F = F_ref nu^-beta t^-alpha (reference
    :773-783). F_ref is defined at the observer, so the detector-frame
    distance modulus is removed here (the detector model adds it back)."""
    beta = params["beta_freq"][:, None, None]
    alpha = params["alpha_time"][:, None, None]
    nu = nu_host[:, :, None]
    f_pl = params["F_ref"][:, None, None] * torch.pow(nu, -beta) \
        * torch.pow(t_days[None, None, :], -alpha)
    return flux_to_ab_mag(f_pl, unit="mJy") \
        - params["distance_modulus"][:, None, None]


register_source_model(SourceModel(
    name="Me2017",
    parameter_names=("log10_mej", "log10_vej", "beta", "log10_kappa_r"),
    mags_fn=me2017_mags,
    citation="Metzger (2017), LRR 20, 3",
    banded=True,
))
register_source_model(SourceModel(
    name="HoNa2020",
    parameter_names=("log10_mej", "vej_max", "vej_min", "vej_frac",
                     "log10_kappa_low_vej", "log10_kappa_high_vej"),
    mags_fn=hona2020_mags,
    default_time_grid=lambda: np.geomspace(5e-2, 14.0, 150),
    citation="Hotokezaka & Nakar (2020), ApJ 891, 152",
    banded=True,
))
register_source_model(SourceModel(
    name="blackbody_fixedT",
    parameter_names=("bb_luminosity", "temperature"),
    mags_fn=blackbody_fixed_t_mags,
    banded=True,
))
register_source_model(SourceModel(
    name="PL_BB_fixedT",
    parameter_names=("bb_luminosity", "temperature", "beta", "powerlaw_mag"),
    mags_fn=powerlaw_blackbody_fixed_t_mags,
    needs_filters=True,
))
register_source_model(SourceModel(
    name="synchrotron_powerlaw",
    parameter_names=("alpha_time", "beta_freq", "F_ref",
                     "luminosity_distance"),
    mags_fn=synchrotron_powerlaw_mags,
))
