"""Pei (1992) SMC host-galaxy extinction, batched over live points.

PyTorch counterpart of the P92-SMC part of ``nmma_tpu/ops/extinction.py``
(the reference's ``extinctionFactorP92SMC``, ``nmma/em/utils.py:373-428``):
the published analytic curve (six Drude-like terms) evaluated elementwise,
and its transmission-weighted band average. The Milky-Way law (G23_MW)
waits for a later slice.
"""

from __future__ import annotations

import torch

from ..constants import c_cgs

# Pei (1992) SMC coefficients, converted from A_B to A_V normalisation with
# A_B/A_V = 1.32199 (the dust_extinction P92.AbAv constant the reference
# multiplies in, nmma/em/utils.py:392-421).
_P92_ABAV = 1.3219866307098898

# (amplitude*AbAv, lambda_i [micron], b_i, n_i) for BKG/FUV/NUV/SIL1/SIL2/FIR
_P92_TERMS = (
    (185.0 * _P92_ABAV, 0.042, 90.0, 2.0),
    (27.0 * _P92_ABAV, 0.08, 5.5, 4.0),
    (0.005 * _P92_ABAV, 0.22, -1.95, 2.0),
    (0.010 * _P92_ABAV, 9.7, -1.95, 2.0),
    (0.012 * _P92_ABAV, 18.0, -1.80, 2.0),
    (0.030 * _P92_ABAV, 25.0, 0.0, 2.0),
)

# dust_extinction P92 validity range, in 1/micron (x = 1/lambda)
_P92_X_RANGE = (1e-3, 1e3)
_RV_SMC = 2.93


def _p92_ax_over_av(lam_micron):
    """Pei 92 A(lambda)/A(V) = sum_i a_i / ((l/l_i)^n + (l_i/l)^n + b_i)."""
    total = 0.0
    for a_i, l_i, b_i, n_i in _P92_TERMS:
        ratio = lam_micron / l_i
        total = total + a_i / (ratio**n_i + ratio**(-n_i) + b_i)
    return total


def extinction_factor_p92_smc(nu, Ebv, z, cutoff_hi=2e16):
    """SMC flux factor ``10^(-0.4 A_lambda)`` at observer-frame ``nu`` [Hz];
    ``nu``, ``Ebv`` and ``z`` broadcast against each other. A_V = 2.93 Ebv,
    applied at the host-frame frequency ``nu (1 + z)``."""
    nu_lo = _P92_X_RANGE[0] * 1e4 * c_cgs
    nu_hi = min(cutoff_hi, _P92_X_RANGE[1] * 1e4 * c_cgs)
    nu_host = nu * (1.0 + z)
    in_range = (nu_host >= nu_lo) & (nu_host <= nu_hi)
    lam_micron = (c_cgs / torch.where(in_range, nu_host, nu_lo)) * 1e4
    factor = torch.pow(10.0, -0.4 * _p92_ax_over_av(lam_micron)
                       * (_RV_SMC * Ebv))
    return torch.where(in_range, factor, 1.0)


def band_extinction_mags_p92_smc(nu_nodes, weights, Ebv, z):
    """Band-averaged SMC host extinction [mag], ``[B, F]``.

    ``nu_nodes``/``weights`` ``[F, K]`` are the filters' frequency
    quadrature; ``Ebv``/``z`` ``[B]``. The band attenuation is the
    transmission-weighted mean of the flux factor (nmma_tpu
    ops/extinction.py:128-148)."""
    fac = extinction_factor_p92_smc(nu_nodes[None], Ebv[:, None, None],
                                    z[:, None, None])
    eff = torch.sum(weights * fac, dim=-1)
    return -2.5 * torch.log10(torch.clamp(eff, min=1e-30))
