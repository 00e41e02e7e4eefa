"""Flat-LCDM cosmology with massive neutrinos, as precomputed grids.

PyTorch counterpart of ``nmma_tpu/cosmology.py``, which replaces the
reference's astropy-based distance/redshift conversions
(``nmma/core/conversion.py:36-102``, ``nmma/core/constants.py:44-72``): the
full ``E(z)`` integrand (including the Komatsu-et-al. massive-neutrino
fitting formula astropy uses) is tabulated once in float64 on a dense grid,
and every conversion is a batched interpolation of the f32 tables, as the
JAX package evaluates them.

Default cosmology: Planck18 (H0=67.66, Om0=0.30966, Tcmb0=2.7255 K,
Neff=3.046, m_nu=[0, 0, 0.06] eV) matching astropy's ``Planck18``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch

from .constants import Mpc, c_kms, G_cgs, arad, c_cgs
from .ops.interp import interp

# Boltzmann constant in eV/K (exact, CODATA 2018)
_KB_EV_PER_K = 8.617333262e-5
# (4/11)^(1/3): neutrino-to-photon temperature ratio
_TNU_RATIO = 0.7137658555036082
# 7/8 (4/11)^(4/3): relativistic neutrino energy-density prefactor
_NU_PREFAC = 0.22710731766023898
# Komatsu et al. (2011) massive-neutrino fitting constants (as in astropy)
_NU_P = 1.83
_NU_INVP = 1.0 / _NU_P
_NU_K = 0.3173


@dataclass(frozen=True)
class Cosmology:
    """Flat FLRW cosmology with radiation + (possibly massive) neutrinos."""

    H0: float = 67.66                 # [km/s/Mpc]
    Om0: float = 0.30966
    Tcmb0: float = 2.7255             # [K]
    Neff: float = 3.046
    m_nu: tuple = (0.0, 0.0, 0.06)    # [eV]
    name: str = "Planck18"

    # grid configuration for the precomputed z<->distance tables
    z_max: float = 4.0
    n_grid: int = 4096

    @functools.cached_property
    def hubble_distance(self) -> float:
        """c / H0 in Mpc."""
        return c_kms / self.H0

    @functools.cached_property
    def Ogamma0(self) -> float:
        H0_cgs = self.H0 * 1e5 / Mpc                       # [1/s]
        rho_crit0 = 3.0 * H0_cgs**2 / (8.0 * np.pi * G_cgs)  # [g/cm^3]
        rho_gamma0 = arad * self.Tcmb0**4 / c_cgs**2          # [g/cm^3]
        return rho_gamma0 / rho_crit0

    @functools.cached_property
    def _massive_nu_y0(self) -> np.ndarray:
        """m_nu c^2 / (k_B T_nu0) for the massive species."""
        Tnu0 = _TNU_RATIO * self.Tcmb0
        m = np.asarray([m for m in self.m_nu if m > 0.0], dtype=np.float64)
        return m / (_KB_EV_PER_K * Tnu0)

    @functools.cached_property
    def _n_massless_nu(self) -> int:
        return sum(1 for m in self.m_nu if m == 0.0)

    def _nu_relative_density(self, z):
        """rho_nu / rho_gamma at redshift z (astropy's fitting formula)."""
        neff_per = self.Neff / max(len(self.m_nu), 1)
        y0 = self._massive_nu_y0
        if y0.size == 0:
            return _NU_PREFAC * self.Neff * np.ones_like(np.asarray(z, dtype=np.float64))
        z = np.asarray(z, dtype=np.float64)
        y = y0[None, :] / (1.0 + z[..., None])
        rel_mass = np.power(1.0 + np.power(_NU_K * y, _NU_P), _NU_INVP)
        total = rel_mass.sum(axis=-1) + self._n_massless_nu
        return _NU_PREFAC * neff_per * total

    @functools.cached_property
    def Onu0(self) -> float:
        return float(self.Ogamma0 * self._nu_relative_density(np.array(0.0)).item())

    @functools.cached_property
    def Ode0(self) -> float:
        return 1.0 - self.Om0 - self.Ogamma0 - self.Onu0

    def _inv_efunc(self, z):
        z = np.asarray(z, dtype=np.float64)
        zp1 = 1.0 + z
        Or = self.Ogamma0 * (1.0 + self._nu_relative_density(z))
        E2 = self.Om0 * zp1**3 + self.Ode0 + Or * zp1**4
        return 1.0 / np.sqrt(E2)

    @functools.cached_property
    def _tables(self):
        """Dense (z, d_L, distmod) grids, float64 numpy, monotone in both axes."""
        # geometric-ish spacing that refines near z=0 where PE lives
        z = np.concatenate(
            [
                np.array([0.0]),
                np.geomspace(1e-7, self.z_max, self.n_grid - 1),
            ]
        )
        inv_e = self._inv_efunc(z)
        # cumulative trapezoid for the comoving distance integral
        dc = np.concatenate(
            [
                np.array([0.0]),
                np.cumsum(0.5 * (inv_e[1:] + inv_e[:-1]) * np.diff(z)),
            ]
        )
        dc *= self.hubble_distance
        dl = (1.0 + z) * dc
        return z, dl

    @functools.cached_property
    def z_grid(self) -> np.ndarray:
        return self._tables[0]

    @functools.cached_property
    def dl_grid(self) -> np.ndarray:
        return self._tables[1]

    def _grids(self, device):
        """(z, d_L) f32 tables on ``device``, cached per device."""
        cache = self.__dict__.setdefault("_device_grids", {})
        key = str(device)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(self.z_grid, dtype=torch.float32,
                                device=device),
                torch.as_tensor(self.dl_grid, dtype=torch.float32,
                                device=device))
        return cache[key]

    # -- batched conversions --------------------------------------------------
    def luminosity_distance(self, z):
        """d_L(z) in Mpc for a tensor of redshifts."""
        z_grid, dl_grid = self._grids(z.device)
        return interp(z, z_grid, dl_grid)

    def redshift_at_dl(self, d_lum):
        """z(d_L[Mpc]) by inverse interpolation of the monotone table."""
        z_grid, dl_grid = self._grids(d_lum.device)
        return interp(d_lum, dl_grid, z_grid)

    def clone(self, **changes) -> "Cosmology":
        """A copy with some fields changed (astropy's ``clone``); its tables
        are built anew."""
        return replace(self, **changes)


# the process-wide default cosmology, mirroring the reference's
# set_cosmology/get_cosmology singleton (nmma/core/constants.py:44-72)
PLANCK18 = Cosmology()
_COSMOLOGY = PLANCK18


def set_cosmology(cosmology: Cosmology | None = None) -> Cosmology:
    """Make ``cosmology`` (Planck18 when None) the default."""
    global _COSMOLOGY
    _COSMOLOGY = cosmology if cosmology is not None else PLANCK18
    return _COSMOLOGY


def get_cosmology() -> Cosmology:
    return _COSMOLOGY


def redshift_from_parameters(parameters, cosmology: Cosmology | None = None):
    """Redshift ``[B]`` from a parameter dict: an explicit ``redshift``
    wins, else z(luminosity_distance), else zeros (reference
    ``get_redshift``, nmma/core/conversion.py:57-64)."""
    cosmo = cosmology or get_cosmology()
    if "redshift" in parameters:
        return parameters["redshift"]
    if "luminosity_distance" in parameters:
        return cosmo.redshift_at_dl(parameters["luminosity_distance"])
    return torch.zeros_like(next(iter(parameters.values())))


def distance_modulus(d_lum_mpc):
    """Distance modulus for a luminosity distance in Mpc.

    Matches ``distance_modulus_nmma`` (nmma/core/conversion.py:30-34):
    mu = 5 (5 + log10(d/Mpc)).
    """
    return 5.0 * (5.0 + torch.log10(d_lum_mpc))
