"""Plain reference of Me2017, the Metzger (2017) multi-shell kilonova.

A copy, frozen here, of the program's plain path: 299 ejecta mass shells
Euler-stepped through the model grid's intervals as a Python loop over
[B, 299] tensors (total luminosity and the radius of the shell whose optical
depth is nearest 1, the first on a tie), the effective temperature filled
over the grid by linear interpolation and extrapolation, and blackbody
magnitudes averaged over each filter's band quadrature in log space.
Every tensor is made in the working ``dtype``.
"""

from __future__ import annotations

import math

import torch

from . import em

N_SHELLS = 299
_MPREC = N_SHELLS + 1
_L_SCALE = 1e40
_LOG_BB = math.log(2.0) + math.log(em.H_CGS) - 2.0 * math.log(em.C_CGS)
_LOG_DIST2 = math.log(em.ABS_MAG_DIST2)


def operands(log10_mej, log10_vej, beta, kappa_r, t_days):
    """(shells [6, B, S], per_sample [2, B], per_step [7, T])."""
    dtype, dev = log10_mej.dtype, log10_mej.device
    log10_mej, log10_vej = log10_mej[:, None], log10_vej[:, None]
    beta = beta[:, None]
    frac = torch.arange(N_SHELLS, dtype=dtype, device=dev) / (_MPREC - 1)
    log_m = -8.0 + (log10_mej + 8.0) * frac
    m = torch.exp(em.LN10 * log_m)
    v0 = torch.exp(em.LN10 * log10_vej) * em.C_CGS
    vm = torch.clamp(v0 * torch.exp((-1.0 / beta) * em.LN10
                                    * (log_m - log10_mej)), max=em.C_CGS)
    xn0 = (0.8 * 2.0 / math.pi) * torch.atan(1e-8 / m)
    g_ratio = torch.exp(em.LN10 * (log10_mej + 8.0) / (_MPREC - 1))
    dm = m * (g_ratio - 1.0)
    shells = torch.stack([m / vm, m / (vm * vm), vm, xn0, 1.0 - xn0,
                          dm * (em.MSUN_CGS / _L_SCALE)])
    per_sample = torch.stack([kappa_r,
                              (0.24 * em.MSUN_CGS / em.C_CGS) / beta[:, 0]])
    t = t_days * em.SECONDS_A_DAY
    dt = torch.cat([t[1:] - t[:-1], torch.zeros_like(t[:1])])
    tsf = 2.0 * 0.17 * t_days ** 0.74
    eth = 0.36 * (torch.exp(-0.56 * t_days) + torch.log1p(tsf) / tsf)
    per_step = torch.stack([
        t, dt, torch.exp(-t / 900.0), 2.1e10 * eth * t_days ** (-1.3),
        (em.MSUN_CGS / (4.0 * math.pi)) / (t * t), t * (1.0 / em.C_CGS),
        dt / t])
    return shells, per_sample, per_step


def dynamics(shells, per_sample, per_step):
    """(L / 1e40 erg/s [B, T], photospheric radius [B, T]); the last time
    is 0."""
    mvm, mvm2, vm, xn0, xr, dm_eff = shells
    kappa_r, c_tdiff = per_sample[0][:, None], per_sample[1][:, None]
    n_b, n_t = mvm.shape[0], per_step.shape[1]
    ltot = torch.zeros((n_b, n_t), dtype=mvm.dtype, device=mvm.device)
    r_photo = torch.zeros_like(ltot)
    ene = torch.zeros_like(mvm)
    for j in range(n_t - 1):
        t_j, dt_j, exp_j, edotr_j, tauc_j, toc_j, dtt_j = per_step[:, j]
        xn = xn0 * exp_j
        edot = 3.2e14 * xn + edotr_j
        kappa = 0.4 * (1.0 - xn - xr) + kappa_r * xr
        tdiff = (c_tdiff / t_j) * kappa * mvm
        denom = tdiff + toc_j * vm
        ltot[:, j] = (ene / denom * dm_eff).sum(dim=1)
        dev = (tauc_j * kappa * mvm2 - 1.0).abs()
        first = torch.where(dev <= dev.amin(dim=1, keepdim=True), vm, 0.0)
        r_photo[:, j] = first.amax(dim=1) * t_j
        factor = torch.clamp(1.0 - dtt_j - dt_j / denom, 0.0, 1.0)
        ene = factor * ene + dt_j * edot
    return ltot, r_photo


def fill_linear(x, y):
    """Each row of y [B, T] on x [T] with its non-finite entries replaced:
    between the nearest finite neighbours linearly, beyond the finite span
    by the line through its two edge samples; inf for rows with fewer than
    two finite entries."""
    n = x.shape[0]
    valid = torch.isfinite(y)
    n_valid = valid.sum(dim=1, keepdim=True)
    idx = torch.arange(n, device=y.device).expand_as(y)
    left_of = torch.cummax(torch.where(valid, idx, -1), 1).values
    right_of = n - 1 - torch.flip(torch.cummax(torch.flip(
        torch.where(valid, n - 1 - idx, -1), (1,)), 1).values, (1,))
    pos = torch.clamp((x[:, None] >= x).sum(-1) - 1, 0, n - 1)
    l_idx = left_of[:, pos]
    r_idx = right_of[:, torch.clamp(pos + 1, 0, n - 1)]

    def rows(index):
        return torch.gather(y, 1, index)

    i0 = torch.clamp(right_of[:, :1], 0, n - 1)
    i1 = torch.clamp(torch.gather(right_of, 1, torch.clamp(i0 + 1, 0, n - 1)),
                     0, n - 1)
    i_last = torch.clamp(left_of[:, -1:], 0, n - 1)
    i_m = torch.clamp(torch.gather(
        left_of, 1, torch.clamp(i_last - 1, 0, n - 1)), 0, n - 1)
    l_safe, r_safe = torch.clamp(l_idx, 0, n - 1), torch.clamp(r_idx, 0, n - 1)
    x_l, y_l = x[l_safe], rows(l_safe)
    x_r, y_r = x[r_safe], rows(r_safe)
    span = torch.where(x_r > x_l, x_r - x_l, 1.0)
    w = torch.clamp((x - x_l) / span, 0.0, 1.0)
    res = y_l + w * (y_r - y_l)
    y0, y1, y_last, y_m = rows(i0), rows(i1), rows(i_last), rows(i_m)
    x0, x1, x_last, x_m = x[i0], x[i1], x[i_last], x[i_m]
    res = torch.where(l_idx < 0, y0, res)
    res = torch.where(r_idx > n - 1, y_last, res)
    lo_slope = (y1 - y0) / torch.where(x1 != x0, x1 - x0, 1.0)
    hi_slope = (y_last - y_m) / torch.where(x_last != x_m, x_last - x_m, 1.0)
    res = torch.where(x < x0, y0 + lo_slope * (x - x0), res)
    res = torch.where(x > x_last, y_last + hi_slope * (x - x_last), res)
    return torch.where(n_valid >= 2, res, math.inf)


def log_expm1(x):
    x = torch.clamp(x, min=1e-30)
    small = torch.log(torch.expm1(torch.clamp(x, max=20.0)))
    large = x + torch.log1p(-torch.exp(-torch.clamp(x, max=80.0)))
    return torch.where(x < 20.0, small, large)


def banded_blackbody(nu_nodes, weights, inv_temp, radius):
    """Band AB magnitudes [B, F, T] of a blackbody photosphere at 10 pc:
    the Planck spectrum at the [B, F, K] nodes, the weighted mean flux of
    each band in log space; inf unless every node is valid."""
    nu = nu_nodes[:, :, :, None]
    inv_temp = inv_temp[:, None, None, :]
    radius = radius[:, None, None, :]
    x = em.H_CGS * nu * inv_temp / em.KB_CGS
    good = torch.isfinite(x) & (x > 0.0) & (radius > 0.0)
    log_flux = (_LOG_BB + 3.0 * torch.log(nu)
                - log_expm1(torch.where(good, x, 1.0))
                + 2.0 * torch.log(torch.where(radius > 0.0, radius, 1.0))
                - _LOG_DIST2)
    log_flux = torch.where(good, log_flux, -math.inf)
    logw = torch.log(torch.clamp(weights, min=1e-30))
    log_mean = torch.logsumexp(log_flux + logw[:, :, None], dim=-2)
    mag = -2.5 / em.LN10 * log_mean + em.AB_ZP_CGS
    return torch.where(good.all(dim=2), mag, math.inf)


class Reference:
    """logL of unit-cube rows for the me2017 configuration."""

    def __init__(self, cfg, dtype=torch.float32, device="cpu", root="."):
        self.photometry = em.Photometry(cfg, dtype, device)

    def mags(self, p, t_days, nu_host, nu_nodes, nu_weights):
        ltot40, r_photo = dynamics(*operands(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], t_days))
        r_ok = r_photo > 0.0
        r_safe = torch.where(r_ok, r_photo, 1.0)
        q = ltot40.abs() * (_L_SCALE * 1e-20) / (4.0 * math.pi
                                                 * em.SIGMA_SB) / (
            (r_safe * 1e-10) ** 2)
        t_eff = torch.where(r_ok & (q > 0.0), q ** 0.25, math.nan)
        t_eff = fill_linear(t_days, t_eff)
        inv_t = torch.where(torch.isfinite(t_eff) & (t_eff > 0.0),
                            1.0 / t_eff, math.inf)
        return banded_blackbody(nu_nodes, nu_weights, inv_t, r_photo)

    def detector(self, p):
        return self.photometry.detector(p, self.mags, banded=True)

    def log_likelihood(self, u, block=2048):
        ph = self.photometry
        out = []
        for s in range(0, u.shape[0], block):
            p = ph.parameters(u[s:s + block])
            out.append(ph.log_likelihood(ph.at_epochs(*self.detector(p))))
        return torch.cat(out)
