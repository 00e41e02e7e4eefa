"""Baryonic-mass tables from (macro, micro) EOS pairs.

Port of ``nmma_tpu/eos/baryonic.py`` (a numpy/scipy copy on the port's
``constants``): the host-side precompute of the maximum-mass (post-merger)
inference, the counterpart of ``baryonic_mass`` in
``nmma/post_processing/maximum_mass_constraint.py:21-62``. It integrates
the TOV structure equations with the baryon-number integral for a star of
given gravitational mass, per EOS; the batched likelihood then only
interpolates the stacked tables (``post_processing/maximum_mass.py``).
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import odeint, simpson

from ..constants import MeV_per_fm3_to_Msun_per_km3, geom_msun_km, particle_mass

_FM3_TO_KM3 = 1e54  # (1/fm^3) -> (1/km^3)


def baryonic_mass_single(grav_mass, macro, micro, dr=0.002):
    """Baryonic mass [Msun] of a star with the given gravitational mass.

    macro: (R[km], M[Msun], Lambda, P_central[MeV/fm^3]) table
    micro: (n[1/fm^3], eps, P[MeV/fm^3], cs2) table
    """
    r_t, m_t, _, p0_t = macro
    n_t, eps_t, p_t, _ = micro

    def tov(y, x):
        p, m = y
        eps = np.interp(p, p_t, eps_t)
        dp = (-geom_msun_km * m * eps / x**2 * (1 + p / eps)
              * (1 + 4 * np.pi * x**3 * p * MeV_per_fm3_to_Msun_per_km3 / m)
              / (1 - 2 * geom_msun_km * m / x))
        dm = 4 * np.pi * x**2 * eps * MeV_per_fm3_to_Msun_per_km3
        return [dp, dm]

    r_star = np.interp(grav_mass, m_t, r_t)
    p0 = np.interp(grav_mass, m_t, p0_t)
    eps0 = np.interp(p0, p_t, eps_t)
    m0 = eps0 * 4 * np.pi / 3 * dr**3 * MeV_per_fm3_to_Msun_per_km3
    x = np.arange(dr, r_star + dr, dr)
    with np.errstate(all="ignore"):
        p_sol, m_sol = odeint(tov, [p0, m0], x).T
    n_sol = np.interp(p_sol, p_t, n_t)

    bad = ~(np.isfinite(p_sol) & np.isfinite(m_sol)) | (p_sol <= 0)
    if bad.any():
        cut = int(np.argmax(bad))
        if cut < 2:
            return np.nan
        n_sol, m_sol, x = n_sol[:cut], m_sol[:cut], x[:cut]

    n_km3 = n_sol * _FM3_TO_KM3
    integrand = n_km3 * x**2 / np.sqrt(
        np.maximum(1 - 2 * geom_msun_km * m_sol / x, 1e-10))
    return particle_mass * 4 * np.pi * simpson(y=integrand, x=x)


def baryonic_mass_table(macro, micro, mass_grid):
    """Mb(Mg) on a mass grid for one EOS (nan above MTOV)."""
    m_t = macro[1]
    mtov = np.max(m_t)
    out = np.full(len(mass_grid), np.nan)
    for i, mg in enumerate(mass_grid):
        if mg <= mtov:
            out[i] = baryonic_mass_single(mg, macro, micro)
    return out


def stacked_baryonic_tables(macro_files, micro_files, mass_grid):
    """[N_eos, M] baryonic-mass tables + per-EOS Mb(MTOV)."""
    tables, mb_tov = [], []
    for mac_f, mic_f in zip(macro_files, micro_files):
        macro = np.loadtxt(mac_f, unpack=True)
        micro = np.loadtxt(mic_f, unpack=True)
        tables.append(baryonic_mass_table(macro, micro, mass_grid))
        mb_tov.append(baryonic_mass_single(np.max(macro[1]), macro, micro))
    return np.stack(tables), np.asarray(mb_tov)


def baryonic_kepler_mass(mtov, r_14, ratio_r, delta):
    """Baryonic Kepler-limit mass QUR (arXiv:2307.03225, 1905.03784)."""
    m_max = ratio_r * mtov
    return (m_max + 0.78 / r_14 * m_max**2) * (1.0 + delta)
