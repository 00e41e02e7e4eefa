"""The multimessenger parameter-conversion chain, batch-first.

PyTorch counterpart of ``nmma_tpu/conversion.py`` (the reference's
``nmma/core/conversion.py``) over a dict of ``[B]`` tensors: the mass
relations, the cosmology-aware distance <-> redshift step, source-frame
masses, the tidal and ``chi_eff`` combinations, the EOS steps (quasi-
universal radii, curve interpolation), the pulsar-timing helpers, the jet
E_iso integrals, the BNS/NSBH/BBH ejecta fits with their row-wise branch
choice, the supernova mass conversion, the posterior columns and the
ordered ``MultimessengerConversion`` chain. The tabulated EOS step is
``eos.TabulatedEOSSet``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import (einstein_factor, geom_msun_km, msun_mus,
                        msun_to_ergs)
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


# ---------------------------------------------------------------------------
# EOS-related conversions (reference conversion.py:222-270)
# ---------------------------------------------------------------------------
def lambda_to_compactness(lambda_i):
    """Quasi-universal relation C(Lambda) (conversion.py:264-267)."""
    loglam = torch.log(lambda_i)
    return 0.371 - 0.0391 * loglam + 0.001056 * loglam * loglam


def mass_and_compactness_to_radius(mass, comp):
    return torch.where(comp < 0.5, mass / comp * geom_msun_km, 0.0)


def radii_from_qur(parameters):
    """Radii and R_16 from the tidal deformabilities through
    quasi-universal relations (conversion.py:239-262)."""
    p = dict(parameters)
    m1s, m2s = p["mass_1_source"], p["mass_2_source"]
    lam1, lam2 = p["lambda_1"], p["lambda_2"]
    p["radius_1"] = mass_and_compactness_to_radius(
        m1s, lambda_to_compactness(lam1))
    p["radius_2"] = mass_and_compactness_to_radius(
        m2s, lambda_to_compactness(lam2))
    mc_source = component_masses_to_chirp_mass(m1s, m2s)
    lam_t = lambda_1_lambda_2_to_lambda_tilde(lam1, lam2, m1s, m2s)
    p["R_16"] = mc_source * torch.pow(lam_t / 0.0042, 1.0 / 6.0) \
        * geom_msun_km
    return p


def eos_to_ns_parameters(radii, masses):
    """(TOV_mass, TOV_radius, R_14, R_16) ``[B]`` of (R, M) curves ``[B,
    M]`` with ascending masses (conversion.py:224-229)."""
    tov_mass, imax = torch.max(masses, dim=-1)
    tov_radius = torch.gather(radii, 1, imax[:, None])[:, 0]
    at = torch.tensor([1.4, 1.6], device=radii.device)
    r_14_16 = interp_rows(at, masses, radii, left=0.0, right=0.0)
    return tov_mass, tov_radius, r_14_16[:, 0], r_14_16[:, 1]


def eos_to_system_parameters(radii, masses, lambdas, m1_source, m2_source):
    """(lambda_1/2, radius_1/2) ``[B]`` by mass interpolation on each row's
    EOS curve ``[B, M]`` (conversion.py:231-237); beyond the curve lambda
    and radius are 0 (a black hole)."""
    ms = torch.stack([m1_source, m2_source], dim=1)
    log_lam = torch.log(torch.clamp(lambdas, min=1e-30))
    lam = torch.exp(interp_rows(ms, masses, log_lam, left=-math.inf,
                                right=-math.inf))
    rad = interp_rows(ms, masses, radii, left=0.0, right=0.0)
    return lam[:, 0], lam[:, 1], rad[:, 0], rad[:, 1]


# ---------------------------------------------------------------------------
# pulsar-timing conversions (conversion.py:194-216)
# ---------------------------------------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def binary_mass_function(m_obs, m_comp, sin_i):
    """f(M) = (m_c sin i)^3 / (m_p + m_c)^2 [Msun] (conversion.py:195-196)."""
    return (m_comp * sin_i) ** 3 / (m_obs + m_comp) ** 2


def shapiro_delay(m_comp, sin_i):
    """Orthometric Shapiro-delay amplitude h3 [microseconds]
    (conversion.py:198-202; Freire & Wex 2010, arXiv:1007.0933), with the
    JAX package's epsilon floor under the square root."""
    shapiro_range = msun_mus * m_comp
    ratio = sin_i / (1.0 + torch.sqrt(torch.clamp(1.0 - sin_i**2,
                                                  min=1e-30)))
    return shapiro_range * ratio**3


def einstein_delay_orbital_factor(orbital_period, eccentricity):
    """T_sun^{2/3} e (P_b / 2 pi)^{1/3}, P_b in seconds
    (conversion.py:204-206)."""
    return (einstein_factor * eccentricity
            * _cbrt(orbital_period / (2.0 * math.pi)))


def simplified_einstein_delay(m_psr, m_comp, einstein_delay_factor):
    """gamma [s] given the orbital prefactor (conversion.py:207-209)."""
    return (einstein_delay_factor * m_comp * (m_psr + 2.0 * m_comp)
            / (m_psr + m_comp) ** (4.0 / 3.0))


def einstein_delay(m_psr, m_comp, orbital_period, eccentricity):
    """Einstein-delay amplitude gamma [s] (conversion.py:211-214)."""
    return simplified_einstein_delay(
        m_psr, m_comp,
        einstein_delay_orbital_factor(orbital_period, eccentricity))


def mass_parameters_to_sini(total_mass, mass_function, m_comp):
    """sin(i) from the binary mass function (conversion.py:215-216)."""
    return _cbrt(mass_function * total_mass**2) / m_comp


# ---------------------------------------------------------------------------
# structured-jet energy conversions (conversion.py:274-316)
# ---------------------------------------------------------------------------
_JET_QUAD_N = 101   # odd: composite Simpson with exact weights
_JET_FRAC = np.linspace(0.0, 1.0, _JET_QUAD_N).astype(np.float32)
_JET_WEIGHTS = np.ones(_JET_QUAD_N, dtype=np.float32)
_JET_WEIGHTS[1:-1:2] = 4.0
_JET_WEIGHTS[2:-1:2] = 2.0


def _jet_integral(theta_core, alpha_wing, profile):
    """int_0^{alphaWing thetaCore} sin(x) profile(x) dx, composite Simpson
    on a trailing quadrature axis; ``profile`` takes x [B, N]."""
    theta_max = alpha_wing * theta_core
    dev = theta_max.device
    x = theta_max[:, None] * torch.as_tensor(_JET_FRAC, device=dev)
    y = torch.sin(x) * profile(x)
    h = theta_max / (_JET_QUAD_N - 1)
    return h / 3.0 * torch.sum(torch.as_tensor(_JET_WEIGHTS, device=dev) * y,
                               dim=-1)


def gaussian_jet_log10_eiso(log10_ejet, theta_core, alpha_wing):
    """log10 on-axis isotropic-equivalent energy of a gaussian jet,
    E_iso = 2 E_jet / integral, kept in log space (jet energies overflow
    f32; reference conversion.py:276-297)."""
    tc = theta_core[:, None]
    integral = _jet_integral(theta_core, alpha_wing,
                             lambda x: torch.exp(-0.5 * (x / tc) ** 2))
    return log10_ejet + math.log10(2.0) - torch.log10(integral)


def powerlaw_jet_log10_eiso(log10_ejet, theta_core, alpha_wing, b):
    tc = theta_core[:, None]
    b_ = b[:, None]
    integral = _jet_integral(
        theta_core, alpha_wing,
        lambda x: torch.pow(1.0 + (x / tc) ** 2 / b_, -b_ / 2.0))
    return log10_ejet + math.log10(2.0) - torch.log10(integral)


# ---------------------------------------------------------------------------
# ejecta fitting (conversion.py:332-766)
# ---------------------------------------------------------------------------
def chibh_to_risco(chi_bh):
    """ISCO radius / M_BH as a function of spin (arXiv:2011.08948 eq. 2-4)."""
    z1 = 1.0 + _cbrt(1.0 - chi_bh**2) * (_cbrt(1 + chi_bh)
                                         + _cbrt(1 - chi_bh))
    z2 = torch.sqrt(3.0 * chi_bh**2 + z1**2)
    return 3.0 + z2 - torch.sign(chi_bh) * torch.sqrt(
        torch.clamp((3.0 - z1) * (3.0 + z1 + 2.0 * z2), min=0.0))


def baryon_mass_ns(source_mass, compactness):
    return source_mass * (1.0 + 0.6 * compactness / (1.0 - 0.5 * compactness))


def nsbh_remnant_disk_mass(m1s, m2s, comp2, chi_bh, a=0.40642158,
                           b=0.13885773, c=0.25512517, d=0.761250847):
    q = m2s / m1s
    eta = q / (1.0 + q) ** 2
    risco = chibh_to_risco(chi_bh)
    mb2 = baryon_mass_ns(m2s, comp2)
    remnant = a * torch.pow(eta, -1.0 / 3.0) * (1.0 - 2.0 * comp2)
    remnant = remnant - b * risco / eta * comp2 + c
    remnant = torch.clamp(remnant, min=0.0)
    return torch.pow(remnant, 1.0 + d) * mb2


def nsbh_dynamic_mass(m1s, m2s, comp2, chi_bh, a1=7.11595154e-03,
                      a2=1.43636803e-03, a4=-2.76202990e-02,
                      n1=-8.63604211e-01, n2=-1.68399507):
    q = m2s / m1s
    risco = chibh_to_risco(chi_bh)
    mb2 = baryon_mass_ns(m2s, comp2)
    mdyn = a1 * q**n1 * (1.0 - 2.0 * comp2) / comp2
    mdyn = mdyn - a2 * q**n2 * risco + a4
    return torch.clamp(mdyn * mb2, min=0.0)


def bns_log10_disk_mass(total_mass, mass_ratio, mtov, r16,
                        a0=-1.725, delta_a=-2.337, b0=-0.564, delta_b=-0.437,
                        c=0.958, d=0.057, beta=5.879, q_trans=0.886):
    k = -3.606 * mtov / r16 + 2.38
    threshold_mass = k * mtov
    xi = 0.5 * torch.tanh(beta * (mass_ratio - q_trans))
    a = a0 + delta_a * xi
    b = b0 + delta_b * xi
    log10_mdisk = a * (1 + b * torch.tanh((c - total_mass / threshold_mass)
                                          / d))
    return torch.clamp(log10_mdisk, min=-3.0)


def bns_dynamic_mass_krfo(m1, m2, comp1, comp2, a=-9.3335, b=114.17,
                          c=-337.56, n=1.5465):
    mdyn = m1 * (a / comp1 + b * torch.pow(m2 / m1, n) + c * comp1)
    mdyn = mdyn + m2 * (a / comp2 + b * torch.pow(m1 / m2, n) + c * comp2)
    return torch.clamp(mdyn * 1e-3, min=0.0)


def bns_dynamic_vel_radice2018(m1, m2, comp1, comp2, a=-0.287, b=0.494,
                               c=-3.000):
    return (a * m1 / m2 * (1 + c * comp1) + a * m2 / m1 * (1 + c * comp2) + b)


def bns_prompt_collapse_dynamic_mass(m1, m2, lam1, lam2, a=1.25e-4,
                                     b=9.82e-1, c=-2.44):
    q = m2 / m1
    lam_t = lambda_1_lambda_2_to_lambda_tilde(lam1, lam2, m1, m2)
    return a * lam_t * (1.0 / q - b) * torch.exp(c / q)


def bns_prompt_collapse_dynamic_vel(m1, m2, comp1, comp2, a=-0.395,
                                    b=0.798, c=-1.627):
    return (a * m1 / m2 * (1 + c * comp1) + a * m2 / m1 * (1 + c * comp2) + b)


def bns_prompt_collapse_log10_disk_mass(m1, m2, lam1, lam2, a=7.70,
                                        b=-13.4, c=8.16e-3):
    q = m2 / m1
    lam_t = lambda_1_lambda_2_to_lambda_tilde(lam1, lam2, m1, m2)
    return torch.clamp(a + b * q + c * lam_t * q**2, max=-1.0)


def chibh_fitting(m1, m2, lam1, lam2, a=0.537, b=-0.185, c=-0.514):
    """BNS remnant BH spin (arXiv:1812.04803 Eq. D7)."""
    lam_t = lambda_1_lambda_2_to_lambda_tilde(lam1, lam2, m1, m2)
    total = m1 + m2
    nu = component_masses_to_symmetric_mass_ratio(m1, m2)
    return torch.tanh(a * (nu / 0.25) ** 2 * (total + b * lam_t / 400.0) + c)


def _safe_log10(x):
    """log10 of the positive entries, -inf elsewhere (NaN included)."""
    return torch.where(x > 0, torch.log10(torch.clamp(x, min=1e-300)),
                       -math.inf)


def _like(value, ref):
    """``value`` (a [B] tensor or a number) as a tensor shaped like
    ``ref``."""
    return torch.as_tensor(value, dtype=ref.dtype,
                           device=ref.device).expand_as(ref)


class KilonovaEjectaFitting:
    """BNS / NSBH / BBH ejecta conversion, the branch chosen row by row.

    ``KilonovaEjectaFitting`` of the reference (conversion.py:744-766):
    radius_1 > 0 selects the BNS fits, radius_1 == 0 < radius_2 the NSBH
    fits, both zero no ejecta (-inf). Every branch is computed on every row
    and ``torch.where`` picks one, so a branch's inf or NaN on a row it does
    not own never reaches the result; non-finite results become -inf.
    Sampled ejecta parameters win over the fits (``EjectaFitting.__call__``,
    :320-327).
    """

    mass_fitting_keys = ("log10_mej_dyn", "log10_mej_wind", "log10_mej",
                         "log10_E0")

    def _bns(self, p):
        m1s, m2s = p["mass_1_source"], p["mass_2_source"]
        total, q = m1s + m2s, m2s / m1s
        r1 = torch.clamp(p["radius_1"], min=1e-6)
        r2 = torch.clamp(p["radius_2"], min=1e-6)
        comp1 = m1s * geom_msun_km / r1
        comp2 = m2s * geom_msun_km / r2
        mdyn = bns_dynamic_mass_krfo(m1s, m2s, comp1, comp2)
        log10_mdisk = bns_log10_disk_mass(
            total, q, p["TOV_mass"], p["R_16"] / geom_msun_km)
        log10_mej_dyn = _safe_log10(mdyn + p.get("alpha", 0.0))
        log10_mej_wind = _safe_log10(p["ratio_zeta"]) + log10_mdisk
        log10_mej = _safe_log10(10.0**log10_mej_dyn + 10.0**log10_mej_wind)
        if "log10_E0" in p:
            log10_e0 = p["log10_E0"]
        else:
            log10_e0 = self._grb_energy(p, log10_mdisk)
        return torch.stack([log10_mej_dyn, log10_mej_wind, log10_mej,
                            log10_e0])

    def _grb_energy(self, p, log10_mdisk):
        """(conversion.py:699-726)"""
        ref = log10_mdisk
        log10_ejet = (_safe_log10(_like(p.get("ratio_epsilon", 2e-4), ref))
                      + _safe_log10(1.0 - p["ratio_zeta"])
                      + log10_mdisk + math.log10(msun_to_ergs))
        theta_core = _like(p.get("thetaCore", 0.105), ref)
        if not any(k in p for k in ("thetaWing", "alphaWing", "b")):
            return log10_ejet - _safe_log10(torch.sin(theta_core / 2.0) ** 2)
        if "alphaWing" in p:
            alpha_wing = _like(p["alphaWing"], ref)
        else:
            alpha_wing = p["thetaWing"] / theta_core
        if "b" in p:
            return powerlaw_jet_log10_eiso(log10_ejet, theta_core,
                                           alpha_wing, _like(p["b"], ref))
        return gaussian_jet_log10_eiso(log10_ejet, theta_core, alpha_wing)

    def _nsbh(self, p):
        """(conversion.py:421-466)"""
        m1s, m2s = p["mass_1_source"], p["mass_2_source"]
        r2 = torch.clamp(p["radius_2"], min=1e-6)
        comp2 = m2s * geom_msun_km / r2
        if "chi_1" in p:
            chi_1 = p["chi_1"]
        elif "cos_tilt_1" in p or "tilt_1" in p:
            cos_tilt = p["cos_tilt_1"] if "cos_tilt_1" in p else \
                torch.cos(p["tilt_1"])
            chi_1 = p["a_1"] * cos_tilt
        else:
            chi_1 = torch.zeros_like(m1s)
        mdyn_fit = nsbh_dynamic_mass(m1s, m2s, comp2, chi_1)
        remnant = nsbh_remnant_disk_mass(m1s, m2s, comp2, chi_1)
        mdisk = remnant - mdyn_fit
        mej_dyn = mdyn_fit + p.get("alpha", 0.0)
        disk_ok = mdisk > 0.0
        log10_mej_dyn = torch.where(disk_ok, _safe_log10(mej_dyn), -math.inf)
        log10_mej_wind = torch.where(
            disk_ok, _safe_log10(mdisk) + _safe_log10(p["ratio_zeta"]),
            -math.inf)
        log10_mej = _safe_log10(10.0**log10_mej_dyn + 10.0**log10_mej_wind)
        neg = torch.full_like(log10_mej, -math.inf)
        return torch.stack([log10_mej_dyn, log10_mej_wind, log10_mej, neg])

    def __call__(self, parameters):
        p = dict(parameters)
        r1, r2 = p["radius_1"], p["radius_2"]
        bns = self._bns(p)
        nsbh = self._nsbh(p)
        out = torch.where(r1 > 0.0, bns,
                          torch.where(r2 > 0.0, nsbh, -math.inf))
        out = torch.where(torch.isfinite(out), out, -math.inf)
        for i, key in enumerate(self.mass_fitting_keys):
            p.setdefault(key, out[i])
        return p


def convert_mtot_mni(parameters):
    """AnBa2022 supernova conversions (conversion.py:185-193): linear
    masses from log10 sampling, and the derived mni_c and mrp_c."""
    p = dict(parameters)
    for par in ("mni", "mtot", "mrp"):
        if par not in p and f"log10_{par}" in p:
            p[par] = 10.0 ** p[f"log10_{par}"]
    p["mni_c"] = p["mni"] / p["mtot"]
    p["mrp_c"] = p["xmix"] * (p["mtot"] - p["mni"]) - p["mrp"]
    return p


def reweight_to_flat_mass_prior(samples, frac=0.3, rng=None):
    """Resample a posterior to a flat-in-component-mass prior
    (reference conversion.py:176-183): ``frac`` of the draws without
    replacement, weighted by the Jacobian m1^2 / Mc of the flat (chirp
    mass, mass ratio) sampling prior. ``samples`` is a mapping of
    equal-length arrays; numpy on the host, ``rng`` a numpy seed or
    Generator."""
    rng = np.random.default_rng(rng)
    mc = np.asarray(samples["chirp_mass"], dtype=np.float64)
    q = np.asarray(samples["mass_ratio"], dtype=np.float64)
    total = chirp_mass_and_mass_ratio_to_total_mass(mc, q)
    m1 = total / (1.0 + q)
    weights = m1 * m1 / mc
    weights = weights / weights.sum()
    n = len(mc)
    n_out = max(int(round(frac * n)), 1)
    idx = rng.choice(n, size=n_out, replace=False, p=weights)
    return {k: np.asarray(samples[k])[idx] for k in samples.keys()}


class MultimessengerConversion:
    """Ordered conversion pipeline (reference conversion.py:768-824)."""

    def __init__(self, *conversions):
        self._conversions = conversions

    def __call__(self, parameters):
        for conv in self._conversions:
            parameters = conv(parameters)
        return parameters
