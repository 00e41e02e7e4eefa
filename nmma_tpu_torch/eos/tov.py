"""TOV and tidal-Love-number integration on a fixed enthalpy grid.

PyTorch counterpart of ``nmma_tpu/eos/tov.py`` (the reference's
``nmma/eos/tov.py``): the ODE system in the pseudo-enthalpy variable (r, m,
H, beta) integrated with 400 RK4 steps on a log-spaced enthalpy grid, then
one Euler step to the surface. ``tov_solve`` integrates every central
pressure of a ``[N]`` batch together, each row against its own table, so
``construct_families`` runs the families of many EOS tables in one loop of
``[rows, 4]`` tensors (the reference loops a solver per central pressure,
eos_gen.py:construct_family). f32 on the device, as the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..ops.interp import interp_rows

# e (elementary charge) * 1e51: MeV/fm^3 -> SI, then G/c^4: SI -> geometric
_E_CHARGE = 1.602176634e-19
_G_SI = 6.674_30e-11
_C_SI = 299_792_458.0
particle_to_SI = _E_CHARGE * 1e51
SI_to_geometric = _G_SI / _C_SI**4
particle_to_geometric = particle_to_SI * SI_to_geometric
_MSUN_GEOM = _G_SI * 1.988409870698051e30 / _C_SI**2    # [m]

_N_STEPS = 400   # RK4 steps in pseudo-enthalpy


class _RowTables:
    """The log-log tables of one EOS per integration row, ``[rows, L]``
    f32: shorter tables are padded by repeating their last entry, which
    leaves their interpolation and its constant extrapolation unchanged."""

    def __init__(self, tables, rows, device):
        width = max(len(t.log_p) for t in tables)

        def stack(name):
            out = np.empty((len(tables), width))
            for i, t in enumerate(tables):
                v = getattr(t, name)
                out[i, :len(v)] = v
                out[i, len(v):] = v[-1]
            return torch.as_tensor(out, dtype=torch.float32,
                                   device=device)[rows].contiguous()

        self.log_e = stack("log_e")
        self.log_p = stack("log_p")
        self.log_h = stack("log_h")
        self.dloge = stack("_dloge_dlogp")

    def at(self, xq, x, y):
        return interp_rows(xq[:, None], x, y)[:, 0]


def calc_k2(r, m, big_h, b):
    """Tidal Love number k2 from surface values (reference tov.py:37-71)."""
    y = r * b / big_h
    c = m / r
    num = ((8.0 / 5.0) * torch.pow(1 - 2 * c, 2.0) * torch.pow(c, 5.0)
           * (2 * c * (y - 1) - y + 2))
    den = (2 * c * (4 * (y + 1) * c**4 + (6 * y - 4) * c**3
                    + (26 - 22 * y) * c * c + 3 * (5 * y - 8) * c
                    - 3 * y + 6))
    den = den - (3 * torch.pow(1 - 2 * c, 2) * (2 * c * (y - 1) - y + 2)
                 * torch.log(1.0 / (1 - 2 * c)))
    return num / den


def _tov_rhs(h, y, tab):
    """d(r, m, H, beta)/dh, ``y`` [rows, 4]."""
    r, m, big_h, b = y.unbind(1)
    log_h = torch.log(h)
    e = torch.exp(tab.at(log_h, tab.log_h, tab.log_e)) * particle_to_geometric
    p = torch.exp(tab.at(log_h, tab.log_h, tab.log_p)) * particle_to_geometric
    dedp = e / p * tab.at(torch.log(p / particle_to_geometric), tab.log_p,
                          tab.dloge)

    a = 1.0 / (1.0 - 2.0 * m / r)
    c1 = 2.0 / r + a * (2.0 * m / (r * r) + 4.0 * math.pi * r * (p - e))
    c0 = a * (-6.0 / (r * r) + 4.0 * math.pi * (e + p) * dedp
              + 4.0 * math.pi * (5.0 * e + 9.0 * p)) - torch.pow(
        2.0 * (m + 4.0 * math.pi * r**3 * p) / (r * (r - 2.0 * m)), 2.0)

    drdh = -r * (r - 2.0 * m) / (m + 4.0 * math.pi * r**3 * p)
    dmdh = 4.0 * math.pi * r * r * e * drdh
    dhdh = b * drdh
    dbdh = -(c0 * big_h + c1 * b) * drdh
    return torch.stack([drdh, dmdh, dhdh, dbdh], dim=1)


def _solve_rows(tab, pc_pp):
    """(M, R [geometric], k2) ``[rows]`` for the central pressures
    ``pc_pp`` [rows] (MeV/fm^3), row i against row i of ``tab``."""
    hc = torch.exp(tab.at(torch.log(pc_pp), tab.log_p, tab.log_h))
    ec_pp = torch.exp(tab.at(torch.log(pc_pp), tab.log_p, tab.log_e))
    ec = ec_pp * particle_to_geometric
    pc = pc_pp * particle_to_geometric
    dedp_c = tab.at(torch.log(pc_pp), tab.log_p, tab.dloge) * ec_pp / pc_pp
    dhdp_c = 1.0 / (ec + pc)
    dedh_c = dedp_c / dhdp_c

    dh = -1e-3 * hc
    h0 = hc + dh
    h1 = -dh
    r0 = torch.sqrt(3.0 * (-dh) / (2.0 * math.pi * (ec + 3.0 * pc)))
    r0 = r0 * (1.0 - 0.25 * (ec - 3.0 * pc - 0.6 * dedh_c) * (-dh)
               / (ec + 3.0 * pc))
    m0 = 4.0 * math.pi * ec * r0**3 / 3.0 * (1.0 - 0.6 * dedh_c * (-dh) / ec)
    y = torch.stack([r0, m0, r0 * r0, 2.0 * r0], dim=1)

    # log-spaced grid from h0 down to h1 (resolves the steep surface)
    frac = torch.arange(_N_STEPS + 1, device=pc_pp.device) / _N_STEPS
    hs = h0[:, None] * torch.pow((h1 / h0)[:, None], frac)   # [rows, S+1]
    for k in range(_N_STEPS):
        h_a, h_b = hs[:, k], hs[:, k + 1]
        step = (h_b - h_a)[:, None]
        h_mid = h_a + 0.5 * step[:, 0]
        k1 = _tov_rhs(h_a, y, tab)
        k2_ = _tov_rhs(h_mid, y + 0.5 * step * k1, tab)
        k3 = _tov_rhs(h_mid, y + 0.5 * step * k2_, tab)
        k4 = _tov_rhs(h_b, y + step * k3, tab)
        y = y + step / 6.0 * (k1 + 2 * k2_ + 2 * k3 + k4)

    # final Euler step to the surface h = 0 (reference :98-105)
    y = y + _tov_rhs(h1, y, tab) * (0.0 - h1)[:, None]
    r, m, big_h, b = y.unbind(1)
    return m, r, calc_k2(r, m, big_h, b)


def tov_solve(eos, pc_pp):
    """(M [geom], R [geom], k2) ``[N]`` for the central pressures
    ``pc_pp`` [N] (MeV/fm^3) of one EOS (reference ``TOVSolver``, tov.py
    :74-109: a series start just below the centre, h -> 0, a final Euler
    step to the surface)."""
    rows = torch.zeros(pc_pp.shape[0], dtype=torch.long,
                       device=pc_pp.device)
    return _solve_rows(_RowTables([eos], rows, pc_pp.device), pc_pp)


def central_pressures(eos, n_points=64, pc_min=None, pc_max=None):
    """The family's log-spaced central pressures (MeV/fm^3, float64): from
    the reference's fixed 3.5 MeV/fm^3 (eos_gen.py construct_family) to
    0.99 of the table's highest pressure."""
    if pc_min is None:
        pc_min = max(3.5, float(eos.pressure_range[0]) * 1.01)
    if pc_max is None:
        pc_max = float(eos.pressure_range[1]) * 0.99
    return np.geomspace(pc_min, pc_max, n_points)


def construct_families(tables, n_points=64, pc_min=None, pc_max=None,
                       device=None):
    """[(R [km], M [Msun], Lambda, pcs)] ``[n_points]`` f32 tensors, one
    per EOS table, over log-spaced central pressures
    (``EOS_with_CSE.construct_family``, eos_gen.py), integrated together:
    every central pressure of every family is one row of one RK4 loop on
    ``device`` (default the CUDA card). The caller truncates each curve at
    its maximum mass."""
    device = resolve_device(device)
    pcs = np.stack([central_pressures(t, n_points, pc_min, pc_max)
                    for t in tables])
    rows = torch.arange(len(tables), device=device).repeat_interleave(
        n_points)
    pc = torch.as_tensor(pcs.reshape(-1), dtype=torch.float32,
                         device=device)
    m_geom, r_geom, k2 = _solve_rows(_RowTables(tables, rows, device), pc)
    radii, masses, lambdas = _curves(m_geom, r_geom, k2)
    shape = (len(tables), n_points)
    return [(radii.reshape(shape)[i], masses.reshape(shape)[i],
             lambdas.reshape(shape)[i], pc.reshape(shape)[i])
            for i in range(len(tables))]


def _curves(m_geom, r_geom, k2):
    # geometric units are metres: M [Msun] = m / (G Msun / c^2), R [km]
    masses = m_geom / _MSUN_GEOM
    radii = r_geom * 1e-3
    compactness = m_geom / r_geom
    lambdas = 2.0 / 3.0 * k2 / torch.pow(compactness, 5.0)
    return radii, masses, lambdas


def construct_family(eos, n_points=64, pc_min=None, pc_max=None,
                     device=None):
    """``construct_families`` of the one table ``eos``."""
    return construct_families([eos], n_points, pc_min, pc_max, device)[0]
