"""EOS construction from nuclear empirical parameters (NEP).

The port's copy of ``nmma_tpu/eos/generation.py`` (numpy on the host, in
float64): ``eos_from_nep`` (``nmma/eos/eos_gen.py:9-63``) is a
metamodel Taylor expansion of the energy per particle around saturation
density for symmetric matter plus the symmetry energy,

  E/A(n, x) = E_SNM(n) + E_sym(n) (1 - 2x)|_{x fixed}
  (LINEAR in (1-2x) — the reference's EA_beta convention,
  eos_gen.py:47-49; the textbook metamodel uses delta^2 = (1-2x)^2,
  so this is a deliberate parity choice, not a typo),
  E_SNM = Esat + Ksat u^2/2 + Qsat u^3/6 + Zsat u^4/24,
  E_sym = S0 + L u + Ksym u^2/2 + Qsym u^3/6 + Zsym u^4/24,
  u = (n - nsat) / (3 nsat),

with pressure p = n^2 d(E/A)/dn obtained analytically (the reference
differentiates a spline; the expansion is polynomial so the derivative is
closed form). The crust is supplied as a low-density (n, p, eps) table —
e.g. the sub-saturation rows of any tabulated micro EOS — and
concatenated below the matched core, exactly the reference's layout.
"""

from __future__ import annotations

import numpy as np

M_NEUTRON = 939.565   # MeV


def nep_energy_per_particle(n, S0, L, nsat=0.16, Esat=-16.0, Ksat=220.0,
                            Qsat=0.0, Zsat=0.0, Ksym=-100.0, Qsym=0.0,
                            Zsym=0.0, x=0.02):
    u = (n - nsat) / (3.0 * nsat)
    e_snm = Esat + Ksat * u**2 / 2.0 + Qsat * u**3 / 6.0 + Zsat * u**4 / 24.0
    e_sym = S0 + L * u + Ksym * u**2 / 2.0 + Qsym * u**3 / 6.0 \
        + Zsym * u**4 / 24.0
    return e_snm + e_sym * (1.0 - 2.0 * x)


def nep_pressure(n, S0, L, nsat=0.16, Esat=-16.0, Ksat=220.0, Qsat=0.0,
                 Zsat=0.0, Ksym=-100.0, Qsym=0.0, Zsym=0.0, x=0.02):
    """p = n^2 d(E/A)/dn, analytic (derivative of the polynomial in u)."""
    u = (n - nsat) / (3.0 * nsat)
    dudn = 1.0 / (3.0 * nsat)
    de_snm = Ksat * u + Qsat * u**2 / 2.0 + Zsat * u**3 / 6.0
    de_sym = L + Ksym * u + Qsym * u**2 / 2.0 + Zsym * u**3 / 6.0
    dedn = (de_snm + de_sym * (1.0 - 2.0 * x)) * dudn
    return n**2 * dedn


def eos_from_nep(S0, L, crust_table, nsat=0.16, Esat=-16.0, Ksat=220.0,
                 Qsat=0.0, Zsat=0.0, Ksym=-100.0, Qsym=0.0, Zsym=0.0,
                 x=0.02, n_min=0.1, n_max=1.6, dn=0.002):
    """(n [fm^-3], p, eps [MeV/fm^3]) table: crust + NEP outer core.

    crust_table: array-like [(n, p, eps)] rows (or a path), used below the
    core matching density — e.g. the sub-saturation part of a tabulated
    micro EOS. Mirrors the reference's crust concatenation
    (eos_gen.py:14-63, reference column order n, p, eps).
    """
    if isinstance(crust_table, (str, bytes)):
        crust_table = np.loadtxt(crust_table)
    crust = np.asarray(crust_table, dtype=np.float64)

    kwargs = dict(nsat=nsat, Esat=Esat, Ksat=Ksat, Qsat=Qsat, Zsat=Zsat,
                  Ksym=Ksym, Qsym=Qsym, Zsym=Zsym, x=x)
    n = np.arange(n_min, n_max, dn)
    eps = n * (M_NEUTRON + nep_energy_per_particle(n, S0, L, **kwargs))
    p = nep_pressure(n, S0, L, **kwargs)
    core = np.column_stack([n, p, eps])

    crust = crust[crust[:, 0] < n_min]
    return np.concatenate([crust, core])


def crust_from_micro_table(micro_table, n_max=0.1):
    """Extract a crust table (n, p, eps) from a reference micro EOS file.

    The bundled eos_micro format is (n, eps, p, cs2)
    (tests/data/eos_micro); reorder to the (n, p, eps) crust convention.
    """
    if isinstance(micro_table, (str, bytes)):
        micro_table = np.loadtxt(micro_table)
    arr = np.asarray(micro_table, dtype=np.float64)
    low = arr[arr[:, 0] < n_max]
    return np.column_stack([low[:, 0], low[:, 2], low[:, 1]])


def nep_eos_table(S0, L, crust_table, **kwargs):
    """Build an ``EOSTable`` ready for the TOV kernel from NEP parameters."""
    from .eos import EOSTable
    table = eos_from_nep(S0, L, crust_table, **kwargs)
    n, p, eps = table[:, 0], table[:, 1], table[:, 2]
    return EOSTable(energy_density=eps, pressure=p, number_density=n)
