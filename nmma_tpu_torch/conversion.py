"""Parameter conversions of the GW path, batch-first.

PyTorch counterpart of the GW part of ``nmma_tpu/conversion.py`` (the
reference's ``nmma/core/conversion.py``): the mass relations, the
cosmology-aware distance <-> redshift step, source-frame masses, the tidal
and ``chi_eff`` combinations, the posterior columns and the ordered
``MultimessengerConversion`` chain, over a dict of ``[B]`` tensors. The EOS
and ejecta steps (``radii_from_qur``, the EOS tables, ``KilonovaEjectaFitting``)
belong to the joint path with EOS and EM, ROADMAP item 16.
"""

from __future__ import annotations

import numpy as np
import torch

from .cosmology import get_cosmology
from .ops.interp import interp_rows


# ---------------------------------------------------------------------------
# mass conversions (bilby-compatible relations)
# ---------------------------------------------------------------------------
def component_masses_to_chirp_mass(m1, m2):
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def component_masses_to_symmetric_mass_ratio(m1, m2):
    return m1 * m2 / (m1 + m2) ** 2


def chirp_mass_and_mass_ratio_to_total_mass(mc, q):
    return mc * (1 + q) ** 1.2 / q**0.6


def chirp_mass_and_eta_to_component_masses(mc, eta):
    total = mc / torch.pow(eta, 3.0 / 5.0)
    q = (1 - torch.sqrt(1.0 - 4.0 * eta) - 2 * eta) / (2.0 * eta)
    m1 = total / (1.0 + q)
    return m1, total * q / (1.0 + q)


def generate_mass_parameters(parameters):
    """Complete m1/m2/chirp/q/total/eta (detector frame) from whatever
    subset is present (bilby's ``generate_mass_parameters``)."""
    p = dict(parameters)
    if "mass_1" not in p or "mass_2" not in p:
        if "chirp_mass" in p and "mass_ratio" in p:
            mc, q = p["chirp_mass"], p["mass_ratio"]
            total = chirp_mass_and_mass_ratio_to_total_mass(mc, q)
            p["mass_1"] = total / (1 + q)
            p["mass_2"] = total * q / (1 + q)
        elif "chirp_mass" in p and "symmetric_mass_ratio" in p:
            p["mass_1"], p["mass_2"] = chirp_mass_and_eta_to_component_masses(
                p["chirp_mass"], p["symmetric_mass_ratio"])
        elif "total_mass" in p and "mass_ratio" in p:
            total, q = p["total_mass"], p["mass_ratio"]
            p["mass_1"] = total / (1 + q)
            p["mass_2"] = total * q / (1 + q)
    m1, m2 = p["mass_1"], p["mass_2"]
    p.setdefault("mass_ratio", m2 / m1)
    p.setdefault("chirp_mass", component_masses_to_chirp_mass(m1, m2))
    p.setdefault("total_mass", m1 + m2)
    p.setdefault("symmetric_mass_ratio",
                 component_masses_to_symmetric_mass_ratio(m1, m2))
    return p


def _dl_grid_for_om0(cosmo, om0):
    """d_L(z) ``[B, N]`` on the fiducial z grid for a sampled Omega_matter
    (fiducial H0; radiation at its fiducial density, dark energy closing
    the budget, as astropy's ``clone(Om0=...)``)."""
    zg = cosmo.z_grid
    like = om0
    or_grid = torch.as_tensor(
        cosmo.Ogamma0 * (1.0 + cosmo._nu_relative_density(zg)) * (1.0 + zg)**4,
        dtype=torch.float32, device=like.device)
    zp1_cubed = torch.as_tensor((1.0 + zg)**3, dtype=torch.float32,
                                device=like.device)
    om0 = om0[:, None]
    ode0 = 1.0 - om0 - cosmo.Ogamma0 - cosmo.Onu0
    e2 = om0 * zp1_cubed + ode0 + or_grid
    inv_e = 1.0 / torch.sqrt(e2)
    dz = torch.as_tensor(np.diff(zg), dtype=torch.float32, device=like.device)
    dc = torch.cat([
        torch.zeros_like(inv_e[:, :1]),
        torch.cumsum(0.5 * (inv_e[:, 1:] + inv_e[:, :-1]) * dz, dim=-1)],
        dim=-1) * cosmo.hubble_distance
    zp1 = torch.as_tensor(1.0 + zg, dtype=torch.float32, device=like.device)
    return zp1 * dc


def cosmology_to_distance(parameters, cosmology=None):
    """Distance <-> redshift under a sampled ``Hubble_constant`` and/or
    ``Omega_matter`` (reference conversion.py:66-102): at fixed density
    parameters d_L H0 is H0-invariant, so z = z_fid(d_L H0 / H0_fid); a
    sampled Omega_matter rebuilds the d_L(z) grid per sample."""
    p = dict(parameters)
    if "Hubble_constant" not in p and "Omega_matter" not in p:
        return p
    cosmo = cosmology or get_cosmology()
    h_ratio = p.get("Hubble_constant", cosmo.H0) / cosmo.H0
    if "Omega_matter" in p:
        dl_grid = _dl_grid_for_om0(cosmo, p["Omega_matter"])   # [B, N]
        zg = torch.as_tensor(cosmo.z_grid, dtype=torch.float32,
                             device=dl_grid.device)
        if "luminosity_distance" in p:
            dl_q = p["luminosity_distance"] * h_ratio
            p["redshift"] = interp_rows(
                dl_q[:, None], dl_grid, zg.expand_as(dl_grid))[:, 0]
        elif "redshift" in p:
            p["luminosity_distance"] = interp_rows(
                p["redshift"][:, None], zg, dl_grid)[:, 0] / h_ratio
        return p
    if "luminosity_distance" in p:
        p["redshift"] = cosmo.redshift_at_dl(p["luminosity_distance"]
                                             * h_ratio)
    elif "redshift" in p:
        p["luminosity_distance"] = cosmo.luminosity_distance(
            p["redshift"]) / h_ratio
    return p


def source_frame_masses(parameters, cosmology=None):
    """Detector-frame -> source-frame masses via z(d_L) (reference
    ``source_frame_masses``, conversion.py:105-117)."""
    p = generate_mass_parameters(parameters)
    if "redshift" not in p:
        cosmo = cosmology or get_cosmology()
        p["redshift"] = cosmo.redshift_at_dl(p["luminosity_distance"])
    z = p["redshift"]
    p.setdefault("mass_1_source", p["mass_1"] / (1 + z))
    p.setdefault("mass_2_source", p["mass_2"] / (1 + z))
    return p


def bns_source_frame(parameters, cosmology=None):
    return source_frame_masses(parameters, cosmology)


bbh_source_frame = bns_source_frame


def lambda_1_lambda_2_to_lambda_tilde(lambda_1, lambda_2, m1, m2):
    """Favata (2014) effective tidal deformability (bilby formula)."""
    eta = component_masses_to_symmetric_mass_ratio(m1, m2)
    lam_plus = lambda_1 + lambda_2
    lam_minus = lambda_1 - lambda_2
    root = torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))
    return (8.0 / 13.0) * ((1.0 + 7.0 * eta - 31.0 * eta**2) * lam_plus
                           + root * (1.0 + 9.0 * eta - 11.0 * eta**2)
                           * lam_minus)


def tidal_deformabilities_and_mass_ratio_to_eff_tidal_deformabilities(
        lambda_1, lambda_2, q):
    """(lambdaT, dlambdaT) from component lambdas (conversion.py:163-172)."""
    eta = q / (1.0 + q) ** 2
    eta2, eta3 = eta * eta, eta**3
    root = torch.sqrt(torch.clamp(1.0 - 4 * eta, min=0.0))
    lam_t = (8.0 / 13.0) * ((1.0 + 7 * eta - 31 * eta2) * (lambda_1 + lambda_2)
                            + root * (1.0 + 9 * eta - 11.0 * eta2)
                            * (lambda_1 - lambda_2))
    dlam_t = 0.5 * (root * (1.0 - 13272.0 * eta / 1319.0
                            + 8944.0 * eta2 / 1319.0) * (lambda_1 + lambda_2)
                    + (1.0 - 15910.0 * eta / 1319.0 + 32850.0 * eta2 / 1319.0
                       + 3380.0 * eta3 / 1319.0) * (lambda_1 - lambda_2))
    return lam_t, dlam_t


def chi_eff(m1, m2, chi_1, chi_2):
    return (m1 * chi_1 + m2 * chi_2) / (m1 + m2)


def generate_posterior_parameters(posterior):
    """Add chi_eff, lambda_tilde, mass ratio and chirp mass to a posterior
    dict of tensors (reference posterior conversion,
    nmma/gw/gw_likelihood.py:214-235)."""
    p = dict(posterior)
    if "mass_1" in p and "mass_2" in p:
        m1, m2 = p["mass_1"], p["mass_2"]
        p.setdefault("mass_ratio", m2 / m1)
        p.setdefault("chirp_mass", component_masses_to_chirp_mass(m1, m2))
        if "chi_1" in p and "chi_2" in p:
            p.setdefault("chi_eff", chi_eff(m1, m2, p["chi_1"], p["chi_2"]))
        if "lambda_1" in p and "lambda_2" in p:
            p.setdefault("lambda_tilde", lambda_1_lambda_2_to_lambda_tilde(
                p["lambda_1"], p["lambda_2"], m1, m2))
    return p


def _joint_only(name):
    raise NotImplementedError(
        f"{name} belongs to the joint path with EOS and EM, which "
        "nmma_tpu_torch does not have yet (ROADMAP item 16)")


def radii_from_qur(parameters):
    """Radii from tidal deformabilities (quasi-universal relations): the
    EOS step of the joint path."""
    _joint_only("radii_from_qur")


class KilonovaEjectaFitting:
    """BNS/NSBH ejecta fits: the EM step of the joint path."""

    def __init__(self, *args, **kwargs):
        _joint_only("KilonovaEjectaFitting")


class MultimessengerConversion:
    """Ordered conversion pipeline (reference conversion.py:768-824)."""

    def __init__(self, *conversions):
        self._conversions = conversions

    def __call__(self, parameters):
        for conv in self._conversions:
            parameters = conv(parameters)
        return parameters
