"""Physical constants in CGS units (CODATA 2018 / IAU 2015 values).

Frozen copy of ``nmma_tpu/constants.py`` (the reference constant table,
``nmma/core/constants.py:1-72``): exact numbers as plain Python floats, so
the port needs neither astropy nor the JAX package.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# Fundamental constants (CODATA 2018, exact SI definitions where applicable)
# ---------------------------------------------------------------------------
c_SI = 299_792_458.0                    # speed of light [m/s], exact
c_cgs = c_SI * 100.0                    # [cm/s]
c_kms = c_SI / 1000.0                   # [km/s]

h_SI = 6.626_070_15e-34                 # Planck constant [J s], exact
h = h_SI * 1e7                          # [erg s]

kb_SI = 1.380_649e-23                   # Boltzmann constant [J/K], exact
kb = kb_SI * 1e7                        # [erg/K]

e_SI = 1.602_176_634e-19                # elementary charge [C], exact
eV_per_h_SI = e_SI / h_SI               # photon frequency per eV [Hz/eV]

G_SI = 6.674_30e-11                     # Newton constant [m^3 kg^-1 s^-2]
G_cgs = G_SI * 1e3                      # [cm^3 g^-1 s^-2]

sigSB_SI = 5.670_374_419e-8             # Stefan-Boltzmann [W m^-2 K^-4]
sigSB = sigSB_SI * 1e3                  # [erg cm^-2 s^-1 K^-4]
arad = 4.0 * sigSB / c_cgs              # radiation constant [erg cm^-3 K^-4]

m_p_SI = 1.672_621_923_69e-27           # proton mass [kg]

# ---------------------------------------------------------------------------
# Astronomical constants (IAU 2015 nominal values, as used by astropy)
# ---------------------------------------------------------------------------
M_sun_SI = 1.988_409_870_698_051e30     # solar mass [kg] (astropy const.M_sun)
msun_cgs = M_sun_SI * 1e3               # [g]

pc_cgs = 3.085_677_581_491_367e18       # parsec [cm] (astropy const.pc)
Mpc = pc_cgs * 1e6                      # [cm]
D = 10.0 * pc_cgs                       # absolute-magnitude reference distance [cm]
abs_mag_dist_factor = D * D             # [cm^2]

seconds_a_day = 86_400.0

# solar reference quantities
mc2_cgs = msun_cgs * c_cgs**2           # solar rest-mass energy [erg]
msun_to_ergs = mc2_cgs
particle_mass = m_p_SI / M_sun_SI       # proton mass in Msun
geom_msun_km = G_SI * M_sun_SI / c_SI**2 / 1e3   # geometrised Msun [km] ~1.47662504
msun_s = G_SI * M_sun_SI / c_SI**3      # geometrised Msun [s]
msun_mus = msun_s * 1e6
einstein_factor = msun_s ** (2.0 / 3.0)
G_in_ns_units = G_SI * M_sun_SI * 1e-9  # [km^3 Msun^-1 s^-2]
MeV_per_fm3_to_Msun_per_km3 = 1e54 / (mc2_cgs * 1e-7 / e_SI / 1e6)

# log-space helpers used by magnitude kernels (AB system zero points)
LN10 = math.log(10.0)
AB_ZP_CGS = -48.60       # mAB = -2.5 log10(F_cgs) - 48.60   [erg s^-1 cm^-2 Hz^-1]
AB_ZP_JY = 8.90          # mAB = -2.5 log10(F_Jy) + 8.90
AB_ZP_MJY = 16.40        # mAB = -2.5 log10(F_mJy) + 16.40
