"""Frequency-domain BNS waveforms, batch-first.

PyTorch counterpart of ``nmma_tpu/gw/waveforms.py`` (the replacement of the
reference's LALSuite waveforms, ``nmma/gw/gw_likelihood.py:164-207``):
TaylorF2 with 3.5PN point-particle phasing, the leading aligned-spin terms
and the Wade et al. (2014) 5PN + 6PN tidal phase, in closed form over the
frequency grid.

Shapes: every parameter is a ``[B]`` tensor (or a Python number, broadcast
to the batch), the frequencies are ``[F]``, and a waveform returns
``(h_plus, h_cross)`` as complex64 ``[B, F]``. The arithmetic is f32 in the
JAX package's order, so the two agree to f32 rounding.

Conventions: SPA waveform
  h+(f) = A(f) (1 + cos^2 i)/2 exp(-i Psi),  hx = A cos(i) exp(-i(Psi + pi/2)).
"""

from __future__ import annotations

import cmath
import math

import numpy as np
import torch

# geometric solar mass in seconds and metres
MSUN_S = 4.925490947641267e-06
MSUN_M = 1476.6250380501248
MPC_M = 3.0856775814913673e22
_EULER_GAMMA = 0.5772156649015329

# exp(-i pi/2) as complex64, the JAX package's h_cross phase factor
_MINUS_I = complex(np.complex64(cmath.exp(-1j * math.pi / 2.0)))


def column(params, key, default, like):
    """``params[key]`` (or ``default``) as an f32 ``[B, 1]`` (or ``[1, 1]``)
    column on ``like``'s device, to broadcast against ``[F]``."""
    value = params.get(key, default)
    return torch.as_tensor(value, dtype=torch.float32,
                           device=like.device).reshape(-1, 1)


def polarize(amp, psi, iota):
    """(h_plus, h_cross) from the amplitude, phase ``[B, F]`` and
    inclination ``[B, 1]``."""
    h = torch.polar(amp, -psi)
    cos_i = torch.cos(iota)
    h_plus = h * ((1.0 + cos_i * cos_i) / 2.0)
    h_cross = h * cos_i * _MINUS_I
    return h_plus, h_cross


def taylorf2_tidal(frequencies, params):
    """(h_plus, h_cross) ``[B, F]`` on ``frequencies`` [Hz] for a BNS.

    params: mass_1, mass_2 [Msun, detector frame], lambda_1, lambda_2,
    luminosity_distance [Mpc], theta_jn, phase; optional chi_1, chi_2
    (aligned spins) and geocent_time_offset. The amplitude is zero above
    the ISCO frequency of the total mass.
    """
    f = torch.as_tensor(frequencies, dtype=torch.float32)
    m1 = column(params, "mass_1", None, f)
    m2 = column(params, "mass_2", None, f)
    chi1 = column(params, "chi_1", 0.0, f)
    chi2 = column(params, "chi_2", 0.0, f)
    lam1 = column(params, "lambda_1", 0.0, f)
    lam2 = column(params, "lambda_2", 0.0, f)
    d_l = column(params, "luminosity_distance", None, f) * MPC_M
    iota = column(params, "theta_jn", 0.0, f)
    phase_c = column(params, "phase", 0.0, f)
    t_off = column(params, "geocent_time_offset", 0.0, f)

    total = m1 + m2
    eta = m1 * m2 / total**2
    mc = total * torch.pow(eta, 3.0 / 5.0)
    m_sec = total * MSUN_S

    f_safe = torch.clamp(f, min=1e-3)
    v = torch.pow(math.pi * m_sec * f_safe, 1.0 / 3.0)
    v2, v3, v4, v5 = v * v, v**3, v**4, v**5
    v6, v7, v10, v12 = v**6, v**7, v**10, v**12
    log_v = torch.log(v)

    # 3.5PN point-particle phasing (TaylorF2, nonspinning)
    phi2 = 3715.0 / 756.0 + 55.0 / 9.0 * eta
    phi3 = -16.0 * math.pi
    phi4 = (15293365.0 / 508032.0 + 27145.0 / 504.0 * eta
            + 3085.0 / 72.0 * eta * eta)
    phi5_coeff = math.pi * (38645.0 / 756.0 - 65.0 / 9.0 * eta)
    # log term is -6848/63*ln(64 v^3) = -6848/21*(ln 4 + ln v)
    phi6 = (11583231236531.0 / 4694215680.0 - 640.0 / 3.0 * math.pi**2
            - 6848.0 / 21.0 * _EULER_GAMMA
            + eta * (-15737765635.0 / 3048192.0 + 2255.0 / 12.0 * math.pi**2)
            + 76055.0 / 1728.0 * eta**2 - 127825.0 / 1296.0 * eta**3
            - 6848.0 / 21.0 * float(np.log(np.float32(4.0))))
    phi6_log = -6848.0 / 21.0
    phi7 = math.pi * (77096675.0 / 254016.0 + 378515.0 / 1512.0 * eta
                      - 74045.0 / 756.0 * eta**2)

    # leading aligned-spin terms (1.5PN beta, 2PN sigma; Poisson & Will)
    delta = (m1 - m2) / total
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    beta = (113.0 / 12.0 - 19.0 / 3.0 * eta) * chi_s + \
        113.0 / 12.0 * delta * chi_a
    sigma = eta * (721.0 / 48.0 - 247.0 / 48.0) * (chi1 * chi2)

    psi_pp = (1.0
              + phi2 * v2
              + (phi3 + 4.0 * beta) * v3
              + (phi4 - 10.0 * sigma) * v4
              + phi5_coeff * (1.0 + 3.0 * log_v) * v5
              + (phi6 + phi6_log * log_v) * v6
              + phi7 * v7)

    # tidal phase (Wade et al. 2014 eq. 14-15)
    lam_t, dlam_t = tidal_combinations(lam1, lam2, m1, m2)
    root = torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))
    psi_tidal = (-39.0 / 2.0 * lam_t) * v10 + \
        (-3115.0 / 64.0 * lam_t + 6595.0 / 364.0 * root * dlam_t) * v12

    psi = (2.0 * math.pi * f * t_off
           - phase_c - math.pi / 4.0
           + 3.0 / (128.0 * eta * v5) * (psi_pp + psi_tidal))

    # SPA amplitude
    amp = (math.sqrt(5.0 / 24.0) * math.pow(math.pi, -2.0 / 3.0)
           * torch.pow(mc * MSUN_S, 5.0 / 6.0)
           * torch.pow(f_safe, -7.0 / 6.0)
           * 299792458.0 / d_l)

    f_isco = 1.0 / (6.0**1.5 * math.pi * m_sec)
    in_band = (f > 0.0) & (f < f_isco)
    amp = torch.where(in_band, amp, 0.0)
    return polarize(amp, psi, iota)


def tidal_combinations(lam1, lam2, m1, m2):
    """(lambda_tilde, delta_lambda_tilde) of the component lambdas."""
    total = m1 + m2
    eta = m1 * m2 / total**2
    eta2, eta3 = eta * eta, eta**3
    root = torch.sqrt(torch.clamp(1.0 - 4 * eta, min=0.0))
    lam_p, lam_m = lam1 + lam2, lam1 - lam2
    lam_t = (8.0 / 13.0) * ((1.0 + 7 * eta - 31 * eta2) * lam_p
                            + root * (1.0 + 9 * eta - 11 * eta2) * lam_m)
    dlam_t = 0.5 * (root * (1.0 - 13272.0 / 1319.0 * eta
                            + 8944.0 / 1319.0 * eta2) * lam_p
                    + (1.0 - 15910.0 / 1319.0 * eta
                       + 32850.0 / 1319.0 * eta2
                       + 3380.0 / 1319.0 * eta3) * lam_m)
    return lam_t, dlam_t


def aligo_design_psd(frequencies):
    """Analytic approximation to the aLIGO design PSD (zero-det high-P),
    float64 numpy; used when no PSD file is given."""
    f = np.asarray(frequencies, dtype=np.float64)
    x = f / 245.4
    with np.errstate(divide="ignore"):
        psd = 1e-48 * (0.0152 * x**-4 + 0.2935 * x**(9.0 / 4.0)
                       + 2.7951 * x**(3.0 / 2.0) - 6.5080 * x**(3.0 / 4.0)
                       + 17.7622)
    psd[f < 10.0] = np.inf
    return psd
