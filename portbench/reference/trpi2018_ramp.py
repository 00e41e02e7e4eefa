"""Plain reference of TrPi2018 on the quasi-static energy ramp.

The semantics are NMMA's ``flux_density_on_E0_array``
(nmma/em/lightcurve_generation.py:230-256 of NMMA v1.0.1), which NMMA
selects when all four of ``energy_exponential``, ``log10_Eend``,
``t_start`` and ``injection_duration`` are sampled (nmma/em/model.py:
960-968): each time of the model's grid is evaluated alone, with the
blast-wave energy of that time,

    log10 E0(t) = log10_Eend + energy_exponential log10(t / injection_duration)

held at its ``t_start`` value before ``t_start`` and at ``log10_Eend``
after ``injection_duration`` (times in seconds). Here, node by node of the
64-node grid: every row's log10 E0 from the ramp at that node, the frozen
stage 1 of ``trpi2018.py`` on that one node's time, its ``eats_flux`` with
one query (T = 1) and the sum of the rings; then mJy to AB magnitudes and
``interp_fill`` as in ``trpi2018.py``. The nodes are a loop, not folded
into the batch, and the rows are not split beyond ``eats_flux``'s own
chunks of (live point, ring) rows. Matrix products run in IEEE float32:
TF32 is off while the reference computes.

Departures from the upstream code, beyond those of ``trpi2018.py`` (the
semi-analytic dynamics and equal-arrival-time surface in place of
afterglowpy's):

* the ramp is evaluated on ``trpi2018.py``'s 64 geometric nodes from
  max(1e-5, min t) to max t + 1 d and interpolated onto the model grid,
  not on upstream's own time array;
* a node's log-R grid reaches past that node's time alone (its stage 1
  sees one time), as each of upstream's calls integrates to its own time;
* the jet's sanity checks (``trpi2018.py``) make a whole live point inf,
  whatever its energy at a node.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import em
from . import trpi2018 as base

N_NODES = 64


@contextlib.contextmanager
def ieee_matmul():
    """TF32 off for CUDA matrix products, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def node_grid(t_days):
    """The 64 geometric nodes [64] from max(1e-5, min t) to max t + 1 d."""
    t_start = torch.clamp(t_days.min(), min=1e-5)
    t_end = t_days.max() + 1.0
    frac = torch.arange(N_NODES, dtype=t_days.dtype,
                        device=t_days.device) / (N_NODES - 1)
    return t_start * torch.pow(t_end / t_start, frac)


def ramp_log10_e0(p, t_grid):
    """log10 E0 [B, Tg] of every row at every node [Tg] (days)."""
    a = p["energy_exponential"][:, None]
    le = p["log10_Eend"][:, None]
    ts = p["t_start"][:, None]
    te = p["injection_duration"][:, None]
    t_sec = t_grid[None, :] * em.SECONDS_A_DAY
    held = le + a * torch.log10(ts / te)
    ramp = le + a * torch.log10(t_sec / te)
    return torch.where(t_sec <= ts, held,
                       torch.where(t_sec >= te, le, ramp))


class Reference(base.Reference):
    """logL of unit-cube rows for the trpi2018_ramp configuration."""

    def mags(self, p, t_days, nu_host):
        """Absolute AB magnitudes [B, F, T] at 10 pc on the model grid."""
        with ieee_matmul():
            return self._mags(p, t_days, nu_host)

    def _mags(self, p, t_days, nu_host):
        dtype = t_days.dtype
        p = dict(p)
        p["d_L"] = torch.full_like(p["thetaCore"], 3.086e19)
        theta_core, theta_wing = p["thetaCore"], p["thetaWing"]
        eps_tot = 10.0 ** p["log10_epsilon_e"] + 10.0 ** p["log10_epsilon_B"]
        ok = ((theta_wing <= math.pi / 2) & (theta_core > math.pi / 1800.0)
              & (eps_tot <= 1.0)
              & ((theta_wing / theta_core) <= self.grb_resolution))
        nu_obs = nu_host / (1.0 + p["redshift"][:, None])
        t_grid = node_grid(t_days)
        log10_e0 = ramp_log10_e0(p, t_grid)
        mjy = []
        for i in range(N_NODES):
            p["log10_E0"] = log10_e0[:, i]
            ops, d_cos, inv_dl26 = base.stage1(
                t_grid[i:i + 1], nu_obs, p, self.n_theta, self.n_phi,
                self.n_r, dtype)
            elems = base.eats_flux(*ops)                    # [B, Th, F, 1]
            flux50 = elems * ((2.0 * math.pi / self.n_phi)
                              * d_cos[:, :, None, None])
            mjy.append(flux50.sum(dim=1) * base._FLUX_COEF
                       * (inv_dl26 * inv_dl26)[:, None, None])
        mjy = torch.cat(mjy, dim=-1)                        # [B, F, 64]
        good = mjy > 0.0
        grid_mags = torch.where(
            good, -2.5 * torch.log10(torch.where(good, mjy, 1.0))
            + em.AB_ZP_MJY, math.inf)
        mags = base.interp_fill(torch.log(t_days), torch.log(t_grid),
                                grid_mags, math.inf)
        return torch.where(ok[:, None, None], mags, math.inf)
