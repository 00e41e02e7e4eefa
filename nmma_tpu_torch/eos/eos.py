"""EOS tables: micro-physics interpolators and tabulated macro families.

PyTorch counterpart of ``nmma_tpu/eos/eos.py`` (the reference's
``nmma/eos/eos_processing.py`` tabulated mode and the table plumbing of
``EOS_with_CSE``, ``nmma/eos/eos_gen.py``):

* ``EOSTable``: log-log interpolators of an (n, e, p) micro table in
  MeV/fm^3, with the pseudo-enthalpy integral h(p) = int dp/(e+p); the
  input of the TOV solver. The tables are built on the host in float64;
  the interpolators take f32 tensors on any device.
* ``TabulatedEOSSet``: N macro curves (R, M, Lambda) resampled onto one
  mass grid and stacked [N, M]; the sampled ``EOS`` index gathers a
  ``[B, M]`` block of rows, and radius_1/2 and lambda_1/2 at the source
  masses are row-wise interpolations (``EoSConverter.system_props_from_eos``,
  eos_processing.py:334-362, with the categorical EOS prior of
  eos_likelihood.py:21-32).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..ops.interp import interp, interp_rows


class _DeviceTables:
    """f32 copies of named host arrays, made once per device."""

    def _tables(self, device):
        cache = self.__dict__.setdefault("_device_tables", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = {name: torch.as_tensor(
                np.asarray(value), dtype=torch.float32, device=device)
                for name, value in self._host_tables().items()}
        return cache[key]


class EOSTable(_DeviceTables):
    """Micro EOS (nuclear units, MeV/fm^3) with log-log interpolators.

    ``number_density`` [fm^-3], when given, is filtered and sorted with
    (e, p) and kept on ``self.number_density``."""

    def __init__(self, energy_density, pressure, number_density=None):
        e = np.asarray(energy_density, dtype=np.float64)
        p = np.asarray(pressure, dtype=np.float64)
        n = (np.asarray(number_density, dtype=np.float64)
             if number_density is not None else None)
        keep = (e > 0) & (p > 0)
        e, p = e[keep], p[keep]
        if n is not None:
            n = n[keep]
        order = np.argsort(p)
        e, p = e[order], p[order]
        self.number_density = n[order] if n is not None else None

        # pseudo-enthalpy h(p) = int dp'/(e + p'), the linear-in-p trapezoid
        # of the JAX package (its choice, measured against the reference's
        # macro table, is explained at nmma_tpu/eos/eos.py:51-59)
        integrand = 1.0 / (e + p)
        h = np.concatenate([
            [p[0] * integrand[0]],
            p[0] * integrand[0] + np.cumsum(
                0.5 * (integrand[1:] + integrand[:-1]) * np.diff(p)),
        ])
        self.log_e = np.log(e)
        self.log_p = np.log(p)
        self.log_h = np.log(h)
        self.pressure_range = (float(p[0]), float(p[-1]))
        # d(log e)/d(log p) by central differences, for de/dp
        self._dloge_dlogp = np.gradient(self.log_e, self.log_p)

    def _host_tables(self):
        return {"log_e": self.log_e, "log_p": self.log_p,
                "log_h": self.log_h, "dloge": self._dloge_dlogp}

    def _interp(self, xq, x_name, y_name):
        t = self._tables(xq.device)
        return interp(xq, t[x_name], t[y_name])

    def energy_density_from_pressure(self, p):
        return torch.exp(self._interp(torch.log(p), "log_p", "log_e"))

    def pseudo_enthalpy_from_pressure(self, p):
        return torch.exp(self._interp(torch.log(p), "log_p", "log_h"))

    def pressure_from_pseudo_enthalpy(self, h):
        return torch.exp(self._interp(torch.log(h), "log_h", "log_p"))

    def energy_density_from_pseudo_enthalpy(self, h):
        return torch.exp(self._interp(torch.log(h), "log_h", "log_e"))

    def log_dedp_from_log_pressure(self, log_p):
        return self._interp(log_p, "log_p", "dloge")

    def dedp_from_pressure(self, p):
        loge_over_logp = self.log_dedp_from_log_pressure(torch.log(p))
        e = self.energy_density_from_pressure(p)
        return loge_over_logp * e / p

    @classmethod
    def from_file(cls, path):
        """The reference's eos_micro format: density, e, p[, cs^2]."""
        arr = np.loadtxt(path)
        if arr.shape[1] >= 3:
            return cls(arr[:, 1], arr[:, 2], number_density=arr[:, 0])
        return cls(arr[:, 0], arr[:, 1])


_DEFAULT_MASS_GRID = np.linspace(0.5, 3.2, 256)
# log Lambda beyond the stable branch: exp(-745) is 0 in f32
_LOG_LAMBDA_FLOOR = -745.0


class TabulatedEOSSet(_DeviceTables):
    """Stacked macro EOS family with the categorical-index conversion."""

    def __init__(self, radii_list, masses_list, lambdas_list,
                 mass_grid=_DEFAULT_MASS_GRID, weights=None):
        n = len(masses_list)
        self.mass_grid = np.asarray(mass_grid)
        m_grid = self.mass_grid
        rad = np.zeros((n, len(m_grid)))
        log_lam = np.full((n, len(m_grid)), -np.inf)
        tov_mass = np.zeros(n)
        tov_radius = np.zeros(n)
        r14 = np.zeros(n)
        r16 = np.zeros(n)
        for i, (r, m, lam) in enumerate(zip(radii_list, masses_list,
                                            lambdas_list)):
            r, m, lam = map(np.asarray, (r, m, lam))
            # truncate at the maximum mass (the stable branch)
            imax = int(np.argmax(m))
            r, m, lam = r[:imax + 1], m[:imax + 1], lam[:imax + 1]
            order = np.argsort(m)
            r, m, lam = r[order], m[order], lam[order]
            tov_mass[i] = m[-1]
            tov_radius[i] = r[-1]
            r14[i] = np.interp(1.4, m, r, left=0.0, right=0.0)
            r16[i] = np.interp(1.6, m, r, left=0.0, right=0.0)
            rad[i] = np.interp(m_grid, m, r, left=0.0, right=0.0)
            with np.errstate(divide="ignore"):
                log_lam[i] = np.interp(
                    m_grid, m, np.log(np.maximum(lam, 1e-300)),
                    left=-np.inf, right=-np.inf)
            # beyond MTOV the object is a black hole: radius, lambda -> 0
            rad[i, m_grid > m[-1]] = 0.0
            log_lam[i, m_grid > m[-1]] = -np.inf

        # f32, as the JAX package holds them on the device (x64 off)
        self.radii = rad.astype(np.float32)
        self.log_lambdas = np.nan_to_num(
            log_lam, neginf=_LOG_LAMBDA_FLOOR).astype(np.float32)
        self.tov_mass = tov_mass.astype(np.float32)
        self.tov_radius = tov_radius.astype(np.float32)
        self.r14 = r14.astype(np.float32)
        self.r16 = r16.astype(np.float32)
        self.n_eos = n
        self.weights = np.asarray(weights) if weights is not None else \
            np.ones(n) / n

    def _host_tables(self):
        return {"radii": self.radii, "log_lambdas": self.log_lambdas,
                "tov_mass": self.tov_mass, "tov_radius": self.tov_radius,
                "r14": self.r14, "r16": self.r16,
                "mass_grid": self.mass_grid}

    def index(self, eos):
        """The categorical index of a (fractional) ``EOS`` sample: its
        floor, clipped to [0, n_eos - 1]."""
        return torch.clamp(torch.floor(eos).long(), 0, self.n_eos - 1)

    def rows(self, idx, name="radii"):
        """``[B, M]`` rows of the named table for the indices ``idx``."""
        return self._tables(idx.device)[name][idx]

    def __call__(self, parameters):
        """Add the EOS-derived parameters of a ``[B]`` 'EOS' sample: its
        index, TOV mass and radius, R_1.4 and R_1.6, and (given source
        masses) radius_1/2 and lambda_1/2 unless those are sampled."""
        p = dict(parameters)
        idx = self.index(p["EOS"])
        t = self._tables(idx.device)
        p["EOS_index"] = idx
        p["TOV_mass"] = t["tov_mass"][idx]
        p["TOV_radius"] = t["tov_radius"][idx]
        p["R_14"] = t["r14"][idx]
        p["R_16"] = t["r16"][idx]
        if "mass_1_source" in p:
            masses = torch.stack([p["mass_1_source"], p["mass_2_source"]],
                                 dim=1)                        # [B, 2]
            grid = t["mass_grid"]
            rad = interp_rows(masses, grid, t["radii"][idx],
                              left=0.0, right=0.0)
            lam = torch.exp(interp_rows(
                masses, grid, t["log_lambdas"][idx],
                left=_LOG_LAMBDA_FLOOR, right=_LOG_LAMBDA_FLOOR))
            p["radius_1"], p["radius_2"] = rad[:, 0], rad[:, 1]
            p.setdefault("lambda_1", lam[:, 0])
            p.setdefault("lambda_2", lam[:, 1])
        return p


def load_macro_eos_set(path_or_files, mass_grid=_DEFAULT_MASS_GRID,
                       weights=None) -> TabulatedEOSSet:
    """Load reference-format macro files (R [km], M [Msun], Lambda).

    Accepts a directory (its ``*.dat``, numerically sorted: the
    reference's `EOS-to-RAM` mode, eos_processing.py:366-454), a glob, or a
    list of files. Two-column (R, M) files (the reweighting's sorted/
    output) carry no tidal information: their Lambda is 0.
    """
    if isinstance(path_or_files, (list, tuple)):
        files = list(path_or_files)
    elif os.path.isdir(path_or_files):
        files = glob.glob(os.path.join(path_or_files, "*.dat"))
        files.sort(key=lambda f: _numeric_key(os.path.basename(f)))
    else:
        files = sorted(glob.glob(path_or_files))
    radii, masses, lambdas = [], [], []
    for path in files:
        arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
        radii.append(arr[:, 0])
        masses.append(arr[:, 1])
        lambdas.append(arr[:, 2] if arr.shape[1] > 2
                       else np.zeros(arr.shape[0]))
    return TabulatedEOSSet(radii, masses, lambdas, mass_grid=mass_grid,
                           weights=weights)


def _numeric_key(name):
    stem = os.path.splitext(name)[0]
    try:
        return (0, int(stem))
    except ValueError:
        return (1, stem)
