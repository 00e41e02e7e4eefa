"""TrPi2018, the structured-jet GRB afterglow, batch-first.

PyTorch counterpart of ``nmma_tpu/models/grb.py`` (the reference's
afterglowpy path, nmma/em/lightcurve_generation.py:221-280): the
semi-analytic model of Ryan et al. (2020) with SPN98 synchrotron emission.
Each of ``n_theta`` rings of the jet's energy profile decelerates as an
adiabatic blast wave on a shared log-R grid, with lateral spreading and the
trumpet treatment (on by default, afterglowpy's ``spread=True``); the
equal-arrival-time surface over (theta, phi) is then integrated by K3
(``ops/grb_kernel.py``).

The work is split in two. :func:`grb_stage1` computes the dynamics and
returns K3's operands (the JAX package hands the same operands to
``_eats_stage2``, grb.py:497); :func:`grb_afterglow_flux_density` calls K3
and sums the rings. Every quantity that would leave f32's range is carried
in the JAX package's scaled units: energies / 1e50, radii r17 = R / 1e17,
the distance as 1e26 / d_L, with the large constants folded into Python
floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import c_cgs, seconds_a_day
from ..ops import grb_kernel
from ..ops.interp import masked_interp_sorted_fill
from ..ops.photometry import flux_to_ab_mag
from .base import SourceModel, register_source_model

# cgs constants for synchrotron theory
_QE = 4.80320425e-10          # esu
_ME = 9.1093837015e-28        # g
_MP = 1.67262192369e-24       # g
_SIGMA_T = 6.6524587321e-25   # cm^2
_MPC_CM = 3.0856775814913673e24
_MJY = 1e-26                  # erg/s/cm^2/Hz

# default resolution of the JAX package (grb.py:58-60)
N_THETA = 48
N_PHI = 16
N_R = 256

JET_TOPHAT = -1
JET_GAUSSIAN = 0
JET_POWERLAW = 4

# R_dec in r17 units, swept-mass and emission coefficients: host floats
_RDEC_COEF = 3.0 * 1e50 / (4.0 * np.pi * _MP * c_cgs**2 * 1e4 * 1e51)
_MSW_COEF = (4.0 * np.pi / 3.0) * _MP * c_cgs**2 * 1e51 / 1e50
_EM_C = np.sqrt(3.0) * _QE**3 / (2.0 * _ME * c_cgs**2)
# F[mJy] = sum * 1e50 / (4 pi dL^2) / 1e-26 with dL^2 as (1e26/dL)^2 / 1e52
_FLUX_COEF = (1e50 / 1e52 / (4.0 * np.pi)) / _MJY

_E0_RAMP_KEYS = ("energy_exponential", "log10_Eend", "t_start",
                 "injection_duration")


def _energy_profile(theta, e0, theta_core, theta_wing, b, jet_type):
    """E_iso(theta) / 1e50 erg of a tophat, Gaussian or power-law jet."""
    if jet_type == JET_TOPHAT:
        return torch.where(theta <= theta_core, e0, 0.0)
    if jet_type == JET_GAUSSIAN:
        prof = torch.exp(-0.5 * torch.clamp((theta / theta_core) ** 2,
                                            max=80.0))
        return torch.where(theta <= theta_wing, e0 * prof, 0.0)
    if jet_type == JET_POWERLAW:
        prof = torch.pow(1.0 + (theta / theta_core) ** 2 / b, -b / 2.0)
        return torch.where(theta <= theta_wing, e0 * prof, 0.0)
    raise ValueError(f"unknown jet type {jet_type}")


def _static_flag(value, name):
    """A switch that steers control flow: a Python value, or a tensor that
    holds one value over the whole batch (a DeltaFunction prior)."""
    if isinstance(value, torch.Tensor):
        flat = value.reshape(-1)
        if flat.numel() and not bool((flat == flat[0]).all()):
            raise ValueError(f"{name!r} varies over the batch; it switches "
                             "code paths and must be one value")
        return bool(flat[0]) if flat.numel() else True
    return bool(value)


def _cum_trapz(r_grid, dr, integrand):
    """int_{R_0}^{R} integrand dR' + R_0 integrand(R_0) on the log-R grid:
    integrand [B, Th, R], r_grid [B, R], dr [B, R-1]."""
    head = r_grid[:, :1, None] * integrand[..., :1]
    return torch.cat([head, head + torch.cumsum(
        0.5 * (integrand[..., 1:] + integrand[..., :-1]) * dr[:, None, :],
        dim=-1)], dim=-1)


def grb_stage1(t_obs_day, nu_obs, params, jet_type=JET_GAUSSIAN,
               n_theta=N_THETA, n_phi=N_PHI, n_r=N_R, spread=None,
               trumpet=None):
    """Blast-wave dynamics of every ring, up to K3's operands.

    ``t_obs_day`` [T] observer times (days) shared by the batch, or
    [B, 1], one time a row (the energy ramp's folded nodes; a row's radius
    grid then reaches past its own time), ``nu_obs`` [B, F] or [F]
    observer-frame frequencies (Hz), ``params`` {name: [B] tensor or
    float} in afterglowpy naming (grb.py:102-106). Returns
    ``(operands, d_cos [B, Th], inv_dl26 [B])`` with operands = (t_delay
    [B, Th, R'], log_tracks [B, 5, Th, R'], r_grid [B, R'], scal [B, 8],
    log_q [T] or [B, 1], cphi [Ph], wphi [Ph], nu_obs [B, F]) on the
    stage-2 subgrid (every second radius when n_r >= 256), the arguments of
    :func:`grb_kernel.eats_flux`.
    """
    f32 = torch.float32
    theta_core = torch.as_tensor(params["thetaCore"], dtype=f32)
    dev = theta_core.device
    n_b = theta_core.shape[0]

    def param(key, default=None):
        value = params[key] if default is None else params.get(key, default)
        if isinstance(value, torch.Tensor):
            return value.to(device=dev, dtype=f32).expand(n_b)
        return torch.full((n_b,), float(value), dtype=f32, device=dev)

    # log-space ingestion clamps (grb.py:115-133): finite fluxes across the
    # reference's wide priors
    e0 = 10.0 ** torch.clamp(param("log10_E0") - 50.0, -20.0, 20.0)
    theta_wing = param("thetaWing", 4.0 * theta_core)
    theta_v = param("inclination_EM", 0.0)
    n0 = 10.0 ** torch.clamp(param("log10_n0"), -20.0, 20.0)
    p = param("p")
    eps_e = 10.0 ** torch.clamp(param("log10_epsilon_e"), -20.0, 0.0)
    eps_b = 10.0 ** torch.clamp(param("log10_epsilon_B"), -20.0, 0.0)
    xi_n = param("xi_N", 1.0)
    # the distance rides as inv_dl26 = 1e26/d_L, safe in f32 in any order
    if "d_L" in params:
        inv_dl26 = 1e26 / param("d_L")
    else:
        inv_dl26 = (1e26 / _MPC_CM) / param("luminosity_distance")
    z = param("redshift", 0.0)
    b_pl = param("b", 6.0)
    theta_max = theta_core if jet_type == JET_TOPHAT else theta_wing

    # ring grid (cell centres) and energy profile
    theta_edges = (torch.linspace(0.0, 1.0, n_theta + 1, dtype=f32,
                                  device=dev) ** 1.3 * theta_max[:, None])
    theta = 0.5 * (theta_edges[:, 1:] + theta_edges[:, :-1])      # [B, Th]
    d_cos = -(torch.cos(theta_edges[:, 1:]) - torch.cos(theta_edges[:, :-1]))
    e_iso50 = torch.clamp(_energy_profile(
        theta, e0[:, None], theta_core[:, None], theta_wing[:, None],
        b_pl[:, None], jet_type), min=1e-12)                       # [B, Th]

    # shared log-R grid from the deceleration radius to past the on-axis
    # EATS reach at the last observer time (grb.py:166-186)
    e_ref = e_iso50.amax(dim=1)
    r_dec = 1e17 * torch.pow(e_ref * _RDEC_COEF / n0, 1.0 / 3.0)
    t_max_obs = (t_obs_day.max() if t_obs_day.dim() == 1
                 else t_obs_day[:, 0]) * seconds_a_day
    r17_rel = torch.pow(16.0 * e_ref * c_cgs * t_max_obs
                        / (_MSW_COEF * n0 * 1e17), 0.25)
    r_max = 4.0 * torch.maximum(c_cgs * t_max_obs, r17_rel * 1e17)
    r_min = r_dec * 1e-3
    frac = torch.arange(n_r, dtype=f32, device=dev) / (n_r - 1)
    r_grid = r_min[:, None] * torch.pow((r_max / r_min)[:, None], frac)
    dr = r_grid[:, 1:] - r_grid[:, :-1]                            # [B, R-1]
    r17 = r_grid * 1e-17
    m_sw_c2_50 = _MSW_COEF * n0[:, None] * r17**3                 # [B, R]

    col = (lambda v: v[:, None, None])                          # [B, 1, 1]
    u2 = torch.clamp(e_iso50[:, :, None] / m_sw_c2_50[:, None, :], max=1e8)
    gamma = torch.sqrt(1.0 + u2)
    beta = torch.sqrt(u2 / (1.0 + u2))

    # magnetar-style energy injection L(t) = L0 (t/ts)^-q, with L0 / 1e50
    if "log10_L0" in params:
        l0_50 = 10.0 ** (param("log10_L0") - 50.0)
    else:
        l0_raw = params.get("L0", 0.0)
        l0_50 = (float(l0_raw) / 1e50 if isinstance(l0_raw, (int, float))
                 else param("L0") * 1e-25 * 1e-25)
    if isinstance(l0_50, float) and l0_50 <= 0.0:
        e_inj50 = 0.0
    else:
        q_inj = col(param("q", 0.0))
        ts_inj = col(torch.clamp(param("ts", 0.0), min=1.0))
        t_b = _cum_trapz(r_grid, dr, 1.0 / (beta * c_cgs))
        t_ratio = torch.clamp(t_b / ts_inj, min=1.0)
        one_m_q = 1.0 - q_inj
        power_ok = torch.abs(one_m_q) > 1e-3
        safe_denom = torch.where(power_ok, one_m_q, 1.0)
        powerlaw = (torch.pow(t_ratio, one_m_q) - 1.0) / safe_denom
        integral = torch.where(power_ok, powerlaw, torch.log(t_ratio))
        if isinstance(l0_50, torch.Tensor):
            l0_50 = col(l0_50)
            e_inj50 = torch.where(l0_50 > 0.0, l0_50 * ts_inj * integral, 0.0)
        else:
            e_inj50 = l0_50 * ts_inj * integral
        e_inj50 = torch.clamp(e_inj50, min=0.0)

    # lateral spreading and the trumpet treatment (grb.py:236-340); the
    # switches steer control flow, so they are single Python values
    spread_on = _static_flag(
        spread if spread is not None else params.get("spread", True),
        "spread")
    if trumpet is None:
        trumpet = _static_flag(params.get("trumpet", True), "trumpet")
    trumpet = bool(trumpet) and spread_on
    if spread_on:
        ghat = (4.0 * gamma + 1.0) / (3.0 * gamma)
        cs2 = (ghat * (ghat - 1.0) * (gamma - 1.0)) / \
            (1.0 + ghat * (gamma - 1.0))
        cs = torch.sqrt(torch.clamp(cs2, 0.0, 1.0 / 3.0))
        dlnr = torch.log(r_grid[:, 1] / r_grid[:, 0])
        # causal gate on the core's opening angle: Gamma < 1/theta_core
        gate = gamma * col(theta_core) < 1.0
        integrand = torch.where(
            gate, cs / torch.clamp(gamma * beta, min=1e-6), 0.0)
        dtheta = torch.cat([
            torch.zeros_like(integrand[..., :1]),
            torch.cumsum(0.5 * (integrand[..., 1:] + integrand[..., :-1]),
                         dim=-1) * col(dlnr)], dim=-1)
        edge_eff = torch.clamp(col(theta_max) + dtheta, max=math.pi / 2.0)
        if trumpet:      # exact solid angles
            spread_factor = ((1.0 - torch.cos(edge_eff))
                             / col(1.0 - torch.cos(theta_max)))
            theta_dyn = theta[:, :, None] * (edge_eff / col(theta_max))
        else:
            spread_factor = (edge_eff / col(theta_max)) ** 2
            theta_dyn = theta[:, :, None].expand_as(gamma)
    else:
        spread_factor = 1.0
        theta_dyn = theta[:, :, None].expand_as(gamma)

    if trumpet:
        # causal swept mass M_eff(R) = int rho omega(r) r^2 dr
        r3 = r17**3
        dr3 = r3[:, 1:] - r3[:, :-1]
        head = spread_factor[..., :1] * r3[:, None, :1]
        integ = torch.cat([head, torch.cumsum(
            0.5 * (spread_factor[..., 1:] + spread_factor[..., :-1])
            * dr3[:, None, :], dim=-1) + head], dim=-1)
        mass_factor = integ / r3[:, None, :]
    else:
        mass_factor = spread_factor

    u2 = torch.clamp((e_iso50[:, :, None] + e_inj50)
                     / (m_sw_c2_50[:, None, :] * mass_factor), max=1e8)
    gamma = torch.sqrt(1.0 + u2)
    # the radius advances at the shock speed, 1 - beta_sh in f32-stable form
    s_sh = torch.sqrt(1.0 + 1.0 / torch.clamp(u2, min=1e-12))
    one_m_beta_sh = (3.0 - 4.0 / (s_sh + 1.0)) / (4.0 * u2 + 3.0)
    beta_sh = torch.clamp(1.0 - one_m_beta_sh, 1e-6, 1.0)
    inv_bc = 1.0 / (beta_sh * c_cgs)
    t_b = _cum_trapz(r_grid, dr, inv_bc)
    # t_obs = t_delay + (1 - mu) R/c, t_delay = int (1 - beta_sh)/(beta_sh c)
    t_delay = _cum_trapz(r_grid, dr, one_m_beta_sh * inv_bc)

    # stage 2 interpolates smooth log-log tracks, so it runs on a strided
    # subgrid (grb.py:482-496); the elementwise quantities below are
    # computed on that subgrid only
    sub = slice(None, None, 2 if n_r >= 256 else 1)
    gamma, t_b, t_delay = gamma[..., sub], t_b[..., sub], t_delay[..., sub]
    theta_dyn, r_grid, r17 = theta_dyn[..., sub], r_grid[:, sub], r17[:, sub]
    if trumpet:
        mass_factor = mass_factor[..., sub]

    # synchrotron quantities (grb.py:384-418)
    b_field = torch.sqrt(32.0 * math.pi * col(eps_b) * gamma
                         * (gamma - 1.0 + 1e-12) * col(n0) * _MP) * c_cgs
    gamma_m = torch.clamp(
        col(eps_e) * (col(p) - 2.0) / (col(p) - 1.0) * (_MP / _ME)
        * (gamma - 1.0) / col(xi_n), min=1.0)
    gamma_c = 6.0 * math.pi * _ME * c_cgs * gamma / (
        _SIGMA_T * b_field**2 * t_b + 1e-30)
    nu_m_prime = 3.0 / (4.0 * math.pi) * gamma_m**2 * _QE * b_field / (
        _ME * c_cgs)
    nu_c_prime = 3.0 / (4.0 * math.pi) * gamma_c**2 * _QE * b_field / (
        _ME * c_cgs)
    em50 = (_EM_C * (col(p) - 1.0) * col(xi_n) * col(n0) * b_field
            * (1e51 / 3.0 / 1e50) * r17[:, None, :]**3 / gamma)
    if trumpet:      # emission from all swept electrons
        em50 = em50 * mass_factor
    log_tracks = torch.stack([
        torch.log(gamma),
        torch.log(torch.clamp(nu_m_prime, min=1e-30)),
        torch.log(torch.clamp(nu_c_prime, min=1e-30)),
        torch.log(torch.clamp(em50, min=1e-38)),
        torch.log(torch.clamp(theta_dyn, min=1e-6)),
    ], dim=1)                                                  # [B, 5, Th, R']
    # the hat contraction touches every lane: clamp non-finite values
    log_tracks = torch.clamp(torch.nan_to_num(
        log_tracks, nan=-88.0, posinf=88.0, neginf=-88.0), -88.0, 88.0)

    x_gl, w_gl = np.polynomial.legendre.leggauss(n_phi)
    phi = torch.tensor((x_gl + 1.0) * (np.pi / 2.0), dtype=f32, device=dev)
    wphi = torch.tensor(w_gl * (n_phi / 2.0), dtype=f32, device=dev)
    zeros = torch.zeros_like(z)
    scal = torch.stack([z, torch.cos(theta_v), torch.sin(theta_v), p,
                        theta_v, zeros, zeros, zeros], dim=-1)    # [B, 8]
    log_q = torch.log(t_obs_day.to(f32) * seconds_a_day)
    nu_obs = torch.as_tensor(nu_obs, dtype=f32, device=dev)
    nu_obs = nu_obs.expand(n_b, nu_obs.shape[-1]).contiguous()
    operands = (t_delay.contiguous(), log_tracks.contiguous(),
                r_grid.contiguous(), scal, log_q, torch.cos(phi), wphi,
                nu_obs)
    return operands, d_cos, inv_dl26


def grb_afterglow_flux_density(t_obs_day, nu_obs, params,
                               jet_type=JET_GAUSSIAN, n_theta=N_THETA,
                               n_phi=N_PHI, n_r=N_R, spread=None,
                               trumpet=None):
    """Observed flux density [mJy] on a (frequency, time) grid: [B, F, T].

    Arguments as :func:`grb_stage1`; the equal-arrival-time surface runs
    through K3, then the rings are summed with their solid angles."""
    operands, d_cos, inv_dl26 = grb_stage1(
        t_obs_day, nu_obs, params, jet_type=jet_type, n_theta=n_theta,
        n_phi=n_phi, n_r=n_r, spread=spread, trumpet=trumpet)
    flux_elems = grb_kernel.eats_flux(*operands)              # [B, Th, F, T]
    # each phi node covers dOmega = d_cos 2 pi / n_phi (weights normalised
    # to that convention)
    flux50 = flux_elems * ((2.0 * math.pi / n_phi)
                           * d_cos[:, :, None, None])
    return (flux50.sum(dim=1) * _FLUX_COEF
            * (inv_dl26 * inv_dl26)[:, None, None])


# device memory that one chunk of the energy ramp's folded rows may take in
# stage 1, in bytes, and the f32 [n_theta, n_r] tensors that stage 1 holds
# per row at its peak (11,708.6 MiB for 8192 rows at 48 x 256, PERF.md §5:
# about 30 of them)
RAMP_CHUNK_BYTES = 8 << 30
_STAGE1_ROW_TENSORS = 30


def ramp_chunk_rows(n_theta=N_THETA, n_r=N_R):
    """Folded (live point, node) rows that one ramp chunk takes: 5,825 at
    full resolution, so the sampler's B = 64 (4,096 rows) is one chunk."""
    return max(1, RAMP_CHUNK_BYTES // (_STAGE1_ROW_TENSORS * 4 * n_theta
                                       * n_r))


def _ramp_log10_e0(p, t_grid):
    """log10 E0 [B, Tg] of each live point at each node: the ramp
    ``log10_Eend + energy_exponential log10(t / injection_duration)``,
    held at its t_start value before t_start and at log10_Eend after
    injection_duration, times in seconds (nmma_tpu/models/grb.py:733-741)."""
    a, le, ts, te = (torch.as_tensor(p[k], dtype=torch.float32,
                                     device=t_grid.device).reshape(-1, 1)
                     for k in _E0_RAMP_KEYS)
    t_sec = (t_grid * seconds_a_day)[None, :]
    l_start = le + a * torch.log10(ts / te)
    ramp = le + a * torch.log10(t_sec / te)
    return torch.where(t_sec <= ts, l_start,
                       torch.where(t_sec >= te, le, ramp))


def ramp_rows(p, t_grid, nu_obs):
    """The energy ramp's B live points x Tg nodes folded into B Tg rows:
    (params {name: [rows] or float}, t_rows [rows, 1] days, nu_rows
    [rows, F]). Row b Tg + i carries live point b's parameters with
    log10_E0 from the ramp at node i, and the time t_grid[i]."""
    n_b, n_t = nu_obs.shape[0], t_grid.shape[0]
    folded = {k: (v.expand(n_b).repeat_interleave(n_t)
                  if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
              for k, v in p.items() if k not in _E0_RAMP_KEYS}
    folded["log10_E0"] = _ramp_log10_e0(p, t_grid).expand(
        n_b, n_t).reshape(-1)
    return folded, t_grid.repeat(n_b)[:, None], \
        nu_obs.repeat_interleave(n_t, dim=0)


def _e0_ramp_flux(t_grid, nu_obs, p, n_theta=N_THETA, n_r=N_R, **kw):
    """Flux density [B, F, Tg] under the quasi-static energy ramp
    (``_e0_ramp_flux``, nmma_tpu/models/grb.py:715-749; the reference's
    ``flux_density_on_E0_array``): every node has its own blast-wave
    energy, so it needs its own dynamics. The Tg nodes are folded into the
    batch (:func:`ramp_rows`), and each row asks for the flux at its own
    time alone (stage 1's per-row time, K3's per-row query). The B Tg rows
    run in chunks of :func:`ramp_chunk_rows`, one K3 launch each."""
    n_b, n_t = nu_obs.shape[0], t_grid.shape[0]
    rows = n_b * n_t
    folded, t_rows, nu_rows = ramp_rows(p, t_grid, nu_obs)
    chunk = ramp_chunk_rows(n_theta, n_r)
    flux = []
    for s in range(0, rows, chunk):
        e = min(rows, s + chunk)
        part = {k: (v[s:e] if isinstance(v, torch.Tensor) and v.dim() > 0
                    else v) for k, v in folded.items()}
        flux.append(grb_afterglow_flux_density(
            t_rows[s:e], nu_rows[s:e], part, n_theta=n_theta, n_r=n_r,
            **kw)[..., 0])                                      # [n, F]
    return torch.cat(flux).reshape(n_b, n_t, -1).transpose(1, 2)


def trpi2018_time_grid(t_days):
    """The 64 geometric nodes from max(1e-5, min t) to max t + 1 d on which
    :func:`trpi2018_mags` evaluates the flux (grb.py:795-799)."""
    t_start = torch.clamp(t_days.min(), min=1e-5)
    t_end = t_days.max() + 1.0
    frac = torch.arange(64, dtype=t_days.dtype, device=t_days.device) / 63
    return t_start * torch.pow(t_end / t_start, frac)


def trpi2018_mags(params, t_days, nu_host, jet_type=JET_GAUSSIAN,
                  grb_resolution=12.0, n_theta=N_THETA, n_phi=N_PHI,
                  n_r=N_R, spread=None, trumpet=None):
    """TrPi2018 absolute magnitudes [B, F, T] (``trpi2018_mags``,
    nmma_tpu/models/grb.py:752): flux on a 64-node geometric grid at
    d_L = 10 pc, observer-frame filter frequencies, mJy -> AB, interpolated
    onto ``t_days``; the GRBMixin sanity checks (nmma/em/model.py:833-843)
    make a live point all-inf."""
    p = dict(params)
    # reference prior files use the ksiN / dL spellings
    if "ksiN" in p and "xi_N" not in p:
        p["xi_N"] = p["ksiN"]
    if "dL" in p and "d_L" not in p:
        p["d_L"] = p["dL"]
    p.setdefault("d_L", 3.086e19)    # 10 pc in cm (reference default)
    theta_core = p["thetaCore"]
    if "alphaWing" in p:
        p["thetaWing"] = p["alphaWing"] * theta_core
    theta_wing = p.get("thetaWing", 4.0 * theta_core)
    if not isinstance(theta_wing, torch.Tensor):
        theta_wing = torch.full_like(theta_core, float(theta_wing))
    p["thetaWing"] = theta_wing
    eps_tot = (10.0 ** p["log10_epsilon_e"] + 10.0 ** p["log10_epsilon_B"])
    ok = ((theta_wing <= math.pi / 2) & (theta_core > math.pi / 1800.0)
          & (eps_tot <= 1.0))
    if "alphaWing" not in p:    # the static --grb-resolution bound
        ok &= (theta_wing / theta_core) <= grb_resolution

    # afterglowpy takes observer-frame frequencies: undo the host frame
    z = p.get("redshift", 0.0)
    nu_obs = nu_host / (1.0 + z[:, None] if isinstance(z, torch.Tensor)
                        else 1.0 + z)

    t_grid = trpi2018_time_grid(t_days)
    kern_kw = dict(jet_type=jet_type, n_theta=n_theta, n_phi=n_phi, n_r=n_r,
                   spread=spread, trumpet=trumpet)
    if all(k in p for k in _E0_RAMP_KEYS):      # selection as grb.py:803
        mjys = _e0_ramp_flux(t_grid, nu_obs, p, **kern_kw)      # [B, F, 64]
    else:
        mjys = grb_afterglow_flux_density(t_grid, nu_obs, p,
                                          **kern_kw)            # [B, F, 64]
    mags_grid = flux_to_ab_mag(mjys, unit="mJy")
    mags = masked_interp_sorted_fill(torch.log(t_days), torch.log(t_grid),
                                     mags_grid, math.inf)
    return torch.where(ok[:, None, None], mags, math.inf)


register_source_model(SourceModel(
    name="TrPi2018",
    parameter_names=("inclination_EM", "log10_E0", "thetaCore", "thetaWing",
                     "b", "L0", "q", "ts", "log10_n0", "p",
                     "log10_epsilon_e", "log10_epsilon_B", "xi_N", "d_L"),
    mags_fn=trpi2018_mags,
    default_time_grid=lambda: np.geomspace(0.01, 300.0, 150),
    citation="Troja et al. (2018); model: Ryan et al. (2020) semi-analytic",
))
