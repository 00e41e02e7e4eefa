"""Plain reference of TrPi2018, the Gaussian structured-jet GRB afterglow.

A copy, frozen here, of the program's plain path for this configuration
(the Gaussian jet with lateral spreading and the trumpet treatment, no
energy injection): the blast-wave dynamics of every ring on a shared log-R
grid (stage 1), the equal-arrival-time surface in dense PyTorch (the hat
basis in log time, contracted over R, then the Doppler factor and the SPN98
spectrum, summed over phi) in chunks of (live point, ring) rows, the sum of
the rings, mJy to AB magnitudes and the interpolation onto the model grid.
Semantics: Ryan et al. (2020); no kernel, no cache, no batching beyond the
chunks. Every tensor is made in the working ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import em

_QE = 4.80320425e-10
_ME = 9.1093837015e-28
_MP = 1.67262192369e-24
_SIGMA_T = 6.6524587321e-25
_MJY = 1e-26
_C = em.C_CGS
_RDEC_COEF = 3.0 * 1e50 / (4.0 * np.pi * _MP * _C ** 2 * 1e4 * 1e51)
_MSW_COEF = (4.0 * np.pi / 3.0) * _MP * _C ** 2 * 1e51 / 1e50
_EM_C = np.sqrt(3.0) * _QE ** 3 / (2.0 * _ME * _C ** 2)
_FLUX_COEF = (1e50 / 1e52 / (4.0 * np.pi)) / _MJY
# elements of the dense hat per chunk of (live point, ring) rows
_HAT_ELEMENTS = 1 << 26
N_TRACKS = 5


def _cum_trapz(r_grid, dr, integrand):
    head = r_grid[:, :1, None] * integrand[..., :1]
    return torch.cat([head, head + torch.cumsum(
        0.5 * (integrand[..., 1:] + integrand[..., :-1]) * dr[:, None, :],
        dim=-1)], dim=-1)


def stage1(t_obs_day, nu_obs, p, n_theta, n_phi, n_r, dtype):
    """The dynamics of every ring up to the EATS operands: (t_delay
    [B, Th, R'], log_tracks [B, 5, Th, R'], r_grid [B, R'], scal [B, 8],
    log_q [T], cphi [Ph], wphi [Ph], nu_obs [B, F]), d_cos [B, Th],
    inv_dl26 [B]."""
    theta_core = p["thetaCore"]
    dev = theta_core.device
    n_b = theta_core.shape[0]
    e0 = 10.0 ** torch.clamp(p["log10_E0"] - 50.0, -20.0, 20.0)
    theta_wing = p["thetaWing"]
    theta_v = p["inclination_EM"]
    n0 = 10.0 ** torch.clamp(p["log10_n0"], -20.0, 20.0)
    pp = p["p"]
    eps_e = 10.0 ** torch.clamp(p["log10_epsilon_e"], -20.0, 0.0)
    eps_b = 10.0 ** torch.clamp(p["log10_epsilon_B"], -20.0, 0.0)
    xi_n = p["xi_N"]
    inv_dl26 = 1e26 / p["d_L"]
    z = p["redshift"]
    theta_max = theta_wing

    theta_edges = (torch.linspace(0.0, 1.0, n_theta + 1, dtype=dtype,
                                  device=dev) ** 1.3 * theta_max[:, None])
    theta = 0.5 * (theta_edges[:, 1:] + theta_edges[:, :-1])
    d_cos = -(torch.cos(theta_edges[:, 1:]) - torch.cos(theta_edges[:, :-1]))
    prof = torch.exp(-0.5 * torch.clamp(
        (theta / theta_core[:, None]) ** 2, max=80.0))
    e_iso50 = torch.clamp(torch.where(theta <= theta_wing[:, None],
                                      e0[:, None] * prof, 0.0), min=1e-12)

    e_ref = e_iso50.amax(dim=1)
    r_dec = 1e17 * torch.pow(e_ref * _RDEC_COEF / n0, 1.0 / 3.0)
    t_max_obs = t_obs_day.max() * em.SECONDS_A_DAY
    r17_rel = torch.pow(16.0 * e_ref * _C * t_max_obs
                        / (_MSW_COEF * n0 * 1e17), 0.25)
    r_max = 4.0 * torch.maximum(_C * t_max_obs, r17_rel * 1e17)
    r_min = r_dec * 1e-3
    frac = torch.arange(n_r, dtype=dtype, device=dev) / (n_r - 1)
    r_grid = r_min[:, None] * torch.pow((r_max / r_min)[:, None], frac)
    dr = r_grid[:, 1:] - r_grid[:, :-1]
    r17 = r_grid * 1e-17
    m_sw_c2_50 = _MSW_COEF * n0[:, None] * r17 ** 3

    def col(v):
        return v[:, None, None]

    u2 = torch.clamp(e_iso50[:, :, None] / m_sw_c2_50[:, None, :], max=1e8)
    gamma = torch.sqrt(1.0 + u2)
    beta = torch.sqrt(u2 / (1.0 + u2))

    # lateral spreading, trumpet treatment (exact solid angles)
    ghat = (4.0 * gamma + 1.0) / (3.0 * gamma)
    cs2 = (ghat * (ghat - 1.0) * (gamma - 1.0)) / (1.0 + ghat * (gamma - 1.0))
    cs = torch.sqrt(torch.clamp(cs2, 0.0, 1.0 / 3.0))
    dlnr = torch.log(r_grid[:, 1] / r_grid[:, 0])
    gate = gamma * col(theta_core) < 1.0
    integrand = torch.where(gate, cs / torch.clamp(gamma * beta, min=1e-6),
                            0.0)
    dtheta = torch.cat([
        torch.zeros_like(integrand[..., :1]),
        torch.cumsum(0.5 * (integrand[..., 1:] + integrand[..., :-1]),
                     dim=-1) * col(dlnr)], dim=-1)
    edge_eff = torch.clamp(col(theta_max) + dtheta, max=math.pi / 2.0)
    spread_factor = ((1.0 - torch.cos(edge_eff))
                     / col(1.0 - torch.cos(theta_max)))
    theta_dyn = theta[:, :, None] * (edge_eff / col(theta_max))

    r3 = r17 ** 3
    dr3 = r3[:, 1:] - r3[:, :-1]
    head = spread_factor[..., :1] * r3[:, None, :1]
    integ = torch.cat([head, torch.cumsum(
        0.5 * (spread_factor[..., 1:] + spread_factor[..., :-1])
        * dr3[:, None, :], dim=-1) + head], dim=-1)
    mass_factor = integ / r3[:, None, :]

    u2 = torch.clamp(e_iso50[:, :, None]
                     / (m_sw_c2_50[:, None, :] * mass_factor), max=1e8)
    gamma = torch.sqrt(1.0 + u2)
    s_sh = torch.sqrt(1.0 + 1.0 / torch.clamp(u2, min=1e-12))
    one_m_beta_sh = (3.0 - 4.0 / (s_sh + 1.0)) / (4.0 * u2 + 3.0)
    beta_sh = torch.clamp(1.0 - one_m_beta_sh, 1e-6, 1.0)
    inv_bc = 1.0 / (beta_sh * _C)
    t_b = _cum_trapz(r_grid, dr, inv_bc)
    t_delay = _cum_trapz(r_grid, dr, one_m_beta_sh * inv_bc)

    sub = slice(None, None, 2 if n_r >= 256 else 1)
    gamma, t_b, t_delay = gamma[..., sub], t_b[..., sub], t_delay[..., sub]
    theta_dyn, r_grid, r17 = theta_dyn[..., sub], r_grid[:, sub], r17[:, sub]
    mass_factor = mass_factor[..., sub]

    b_field = torch.sqrt(32.0 * math.pi * col(eps_b) * gamma
                         * (gamma - 1.0 + 1e-12) * col(n0) * _MP) * _C
    gamma_m = torch.clamp(
        col(eps_e) * (col(pp) - 2.0) / (col(pp) - 1.0) * (_MP / _ME)
        * (gamma - 1.0) / col(xi_n), min=1.0)
    gamma_c = 6.0 * math.pi * _ME * _C * gamma / (
        _SIGMA_T * b_field ** 2 * t_b + 1e-30)
    nu_m = 3.0 / (4.0 * math.pi) * gamma_m ** 2 * _QE * b_field / (_ME * _C)
    nu_c = 3.0 / (4.0 * math.pi) * gamma_c ** 2 * _QE * b_field / (_ME * _C)
    em50 = (_EM_C * (col(pp) - 1.0) * col(xi_n) * col(n0) * b_field
            * (1e51 / 3.0 / 1e50) * r17[:, None, :] ** 3 / gamma)
    em50 = em50 * mass_factor
    log_tracks = torch.stack([
        torch.log(gamma),
        torch.log(torch.clamp(nu_m, min=1e-30)),
        torch.log(torch.clamp(nu_c, min=1e-30)),
        torch.log(torch.clamp(em50, min=1e-38)),
        torch.log(torch.clamp(theta_dyn, min=1e-6)),
    ], dim=1)
    log_tracks = torch.clamp(torch.nan_to_num(
        log_tracks, nan=-88.0, posinf=88.0, neginf=-88.0), -88.0, 88.0)

    x_gl, w_gl = np.polynomial.legendre.leggauss(n_phi)
    phi = torch.tensor((x_gl + 1.0) * (np.pi / 2.0), dtype=dtype, device=dev)
    wphi = torch.tensor(w_gl * (n_phi / 2.0), dtype=dtype, device=dev)
    zeros = torch.zeros_like(z)
    scal = torch.stack([z, torch.cos(theta_v), torch.sin(theta_v), pp,
                        theta_v, zeros, zeros, zeros], dim=-1)
    log_q = torch.log(t_obs_day * em.SECONDS_A_DAY)
    nu_obs = nu_obs.expand(n_b, nu_obs.shape[-1]).contiguous()
    return (t_delay, log_tracks, r_grid, scal, log_q, torch.cos(phi), wphi,
            nu_obs), d_cos, inv_dl26


def one_minus_mu(theta_v, sin_tv, th, cphi):
    return (2.0 * torch.sin(0.5 * (theta_v - th)) ** 2
            + sin_tv * torch.sin(th) * (1.0 - cphi))


def synchrotron_shape(nu, nu_m, nu_c, p):
    slow = torch.where(
        nu < nu_m, torch.pow(nu / nu_m, 1.0 / 3.0),
        torch.where(nu < nu_c, torch.pow(nu / nu_m, -(p - 1.0) / 2.0),
                    torch.pow(nu_c / nu_m, -(p - 1.0) / 2.0)
                    * torch.pow(nu / nu_c, -p / 2.0)))
    fast = torch.where(
        nu < nu_c, torch.pow(nu / nu_c, 1.0 / 3.0),
        torch.where(nu < nu_m, torch.pow(nu / nu_c, -0.5),
                    torch.pow(nu_m / nu_c, -0.5)
                    * torch.pow(nu / nu_m, -p / 2.0)))
    return torch.where(nu_m <= nu_c, slow, fast)


def log_time_rows(t_delay, tracks, r_grid, scal, cphi):
    """Log arrival time of N rows at every (phi, R), its cummax along R,
    capped at 60: [N, Ph, R]."""
    col = scal[:, :, None, None]
    z, sin_tv, theta_v = col[:, 0], col[:, 2], col[:, 4]
    th_r = torch.exp(tracks[:, 4])[:, None, :]
    t_obs = (1.0 + z) * (t_delay[:, None, :] + one_minus_mu(
        theta_v, sin_tv, th_r, cphi[None, :, None])
        * r_grid[:, None, :] / _C)
    log_t = torch.log(torch.clamp(t_obs, min=1e-10))
    return torch.clamp(torch.cummax(log_t, dim=-1).values, max=60.0)


def _eats_rows(t_delay, tracks, r_grid, scal, log_q, cphi, wphi, nu_obs):
    n, n_r = t_delay.shape
    n_t, n_phi = log_q.shape[-1], cphi.shape[0]
    col = scal[:, :, None, None]
    z, sin_tv, p, theta_v = col[:, 0], col[:, 2], col[:, 3], col[:, 4]
    one_p_z = 1.0 + z
    log_t = log_time_rows(t_delay, tracks, r_grid, scal, cphi)
    x_l = torch.cat([log_t[..., :1], log_t[..., :-1]], dim=-1)
    x_r = torch.cat([log_t[..., 1:], log_t[..., -1:]], dim=-1)
    dl = torch.clamp(log_t - x_l, min=1e-12)[:, :, None, :]
    dr = torch.clamp(x_r - log_t, min=1e-12)[:, :, None, :]
    lq = log_q[None, None, :, None]
    hat = torch.clamp(torch.minimum((lq - x_l[:, :, None, :]) / dl,
                                    (x_r[:, :, None, :] - lq) / dr), 0.0, 1.0)
    tr1 = torch.cat([tracks, torch.ones_like(tracks[:, :1])], dim=1)
    raw = torch.bmm(hat.reshape(n, n_phi * n_t, n_r),
                    tr1.transpose(1, 2)).reshape(n, n_phi, n_t, N_TRACKS + 1)
    del hat
    denom = torch.clamp(raw[..., N_TRACKS], min=1.0)
    vals = torch.exp(raw[..., :N_TRACKS] / denom[..., None])
    g, num, nuc, em50, th_t = vals.unbind(-1)
    q = log_q[None, None, :]
    in_range = (q >= log_t[..., :1]) & (q <= log_t[..., -1:])
    em50 = torch.where(in_range, em50, 0.0)
    omm = one_minus_mu(theta_v, sin_tv, th_t, cphi[None, :, None])
    u2 = torch.clamp(g * g - 1.0, min=1e-12)
    be = torch.sqrt(u2) / g
    one_m_be = 1.0 / (g * g * (1.0 + be))
    a_fac = one_m_be + be * omm
    doppler = 1.0 / (g * a_fac)
    s_sh = torch.sqrt(1.0 + 1.0 / u2)
    one_m_bs = (3.0 - 4.0 / (s_sh + 1.0)) / (4.0 * u2 + 3.0)
    ashock = one_m_bs + (1.0 - one_m_bs) * omm
    nu_prime = (nu_obs[:, None, :, None] * one_p_z[..., None]
                * (g * a_fac)[:, :, None, :])
    shape = synchrotron_shape(nu_prime, num[:, :, None, :],
                              nuc[:, :, None, :], p[..., None])
    flux = (one_p_z[..., None] * (doppler * doppler / ashock)[:, :, None, :]
            * em50[:, :, None, :] * shape)
    return (wphi[None, :, None, None] * flux).sum(dim=1)


def eats_flux(t_delay, log_tracks, r_grid, scal, log_q, cphi, wphi, nu_obs):
    """The EATS stage in chunks of (live point, ring) rows: [B, Th, F, T]."""
    n_b, n_th, n_r = t_delay.shape
    n_t, n_phi, n_f = log_q.shape[-1], cphi.shape[0], nu_obs.shape[1]
    rows = n_b * n_th
    td = t_delay.reshape(rows, n_r)
    tracks = log_tracks.transpose(1, 2).reshape(rows, N_TRACKS, n_r)
    point = torch.arange(n_b, device=t_delay.device).repeat_interleave(n_th)
    out = t_delay.new_empty((rows, n_f, n_t))
    chunk = max(1, _HAT_ELEMENTS // (n_phi * n_t * n_r))
    for s in range(0, rows, chunk):
        e = min(rows, s + chunk)
        idx = point[s:e]
        out[s:e] = _eats_rows(td[s:e], tracks[s:e], r_grid[idx], scal[idx],
                              log_q, cphi, wphi, nu_obs[idx])
    return out.reshape(n_b, n_th, n_f, n_t)


def interp_fill(xq, x, y, fill):
    """Each row of y [B, N] on the ascending grid x [N] at the queries
    xq [Q], between the nearest finite samples; ``fill`` outside a row's
    finite span or where it has fewer than two."""
    n = x.shape[0]
    valid = torch.isfinite(y)
    n_valid = valid.sum(-1, keepdim=True)
    idx = torch.arange(n, device=x.device).expand_as(y)
    left_of = torch.cummax(torch.where(valid, idx, -1), -1).values
    right_of = n - 1 - torch.flip(torch.cummax(torch.flip(
        torch.where(valid, n - 1 - idx, -1), (-1,)), -1).values, (-1,))
    pos = (xq[..., None] >= x).sum(-1).expand(*y.shape[:-1], -1)
    pos = torch.clamp(pos - 1, 0, n - 1)
    xx = x.expand_as(y)

    def at(row, index):
        return torch.gather(row, -1, index.clamp(0, n - 1))

    l_idx = at(left_of, pos)
    r_idx = at(right_of, pos + 1)
    r_idx = torch.where(pos >= n - 1, left_of[..., n - 1:], r_idx)
    ok = (l_idx >= 0) & (r_idx >= 0) & (r_idx <= n - 1)
    x_l, y_l = at(xx, l_idx), at(y, l_idx)
    x_r, y_r = at(xx, r_idx), at(y, r_idx)
    span = torch.where(x_r > x_l, x_r - x_l, 1.0)
    w = torch.clamp((xq - x_l) / span, 0.0, 1.0)
    est = torch.where(ok, y_l + w * (y_r - y_l), fill)
    x_first = at(xx, right_of[..., :1])
    x_last = at(xx, left_of[..., n - 1:])
    est = torch.where((xq < x_first) | (xq > x_last), fill, est)
    return torch.where(n_valid >= 2, est, fill)


class Reference:
    """logL of unit-cube rows for the trpi2018 configuration."""

    banded = False

    def __init__(self, cfg, dtype=torch.float32, device="cpu", root="."):
        self.photometry = em.Photometry(cfg, dtype, device)
        res = cfg["resolution"]
        self.n_theta, self.n_phi, self.n_r = (res["n_theta"], res["n_phi"],
                                              res["n_r"])
        self.grb_resolution = float(cfg.get("grb_resolution", 12.0))

    def mags(self, p, t_days, nu_host):
        """Absolute AB magnitudes [B, F, T] at 10 pc on the model grid."""
        dtype = t_days.dtype
        p = dict(p)
        p["d_L"] = torch.full_like(p["thetaCore"], 3.086e19)
        theta_core, theta_wing = p["thetaCore"], p["thetaWing"]
        eps_tot = 10.0 ** p["log10_epsilon_e"] + 10.0 ** p["log10_epsilon_B"]
        ok = ((theta_wing <= math.pi / 2) & (theta_core > math.pi / 1800.0)
              & (eps_tot <= 1.0)
              & ((theta_wing / theta_core) <= self.grb_resolution))
        nu_obs = nu_host / (1.0 + p["redshift"][:, None])
        t_start = torch.clamp(t_days.min(), min=1e-5)
        t_end = t_days.max() + 1.0
        frac = torch.arange(64, dtype=dtype, device=t_days.device) / 63
        t_grid = t_start * torch.pow(t_end / t_start, frac)
        ops, d_cos, inv_dl26 = stage1(t_grid, nu_obs, p, self.n_theta,
                                      self.n_phi, self.n_r, dtype)
        elems = eats_flux(*ops)
        flux50 = elems * ((2.0 * math.pi / self.n_phi)
                          * d_cos[:, :, None, None])
        mjy = (flux50.sum(dim=1) * _FLUX_COEF
               * (inv_dl26 * inv_dl26)[:, None, None])
        good = mjy > 0.0
        grid_mags = torch.where(
            good, -2.5 * torch.log10(torch.where(good, mjy, 1.0))
            + em.AB_ZP_MJY, math.inf)
        mags = interp_fill(torch.log(t_days), torch.log(t_grid), grid_mags,
                           math.inf)
        return torch.where(ok[:, None, None], mags, math.inf)

    def detector(self, p):
        return self.photometry.detector(p, self.mags)

    def log_likelihood(self, u, block=1024):
        """[B] logL of unit-cube rows, computed ``block`` rows at a time."""
        ph = self.photometry
        out = []
        for s in range(0, u.shape[0], block):
            p = ph.parameters(u[s:s + block])
            out.append(ph.log_likelihood(ph.at_epochs(*self.detector(p))))
        return torch.cat(out)
