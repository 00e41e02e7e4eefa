"""LIGO-LW XML sim_inspiral ingestion (stdlib-only).

The port's copy of ``nmma_tpu/io/ligolw.py`` (numpy and the standard
library).

Counterpart of the legacy ``file_to_dataframe``
(``nmma/joint/injection_handling.py:361-418``), which needs gwpy +
python-ligo-lw + lalsimulation. Here the LIGO-LW table is parsed with
``xml.etree`` and the precessing-spin -> PE-angle conversion
(lalsimulation ``SimInspiralTransformPrecessingWvf2PE``) is implemented
directly with the Newtonian orbital angular momentum, which is the same
order lalsimulation uses in that function.
"""

from __future__ import annotations

import gzip
import xml.etree.ElementTree as ET

import numpy as np


def _coerce(tokens, col_type):
    t = col_type.lower()
    if "int" in t:
        return np.array([int(x) for x in tokens], dtype=np.int64)
    if "real" in t or "float" in t or "double" in t:
        return np.array([float(x) for x in tokens], dtype=np.float64)
    return np.array(tokens, dtype=object)


def _split_stream(text):
    """Split a LIGO-LW Stream on commas/newlines, respecting quotes."""
    out, cur, quoted = [], [], False
    for ch in text:
        if ch == '"':
            quoted = not quoted
        elif ch in ",\n" and not quoted:
            tok = "".join(cur).strip()
            if tok:
                out.append(tok)
            cur = []
        else:
            cur.append(ch)
    tok = "".join(cur).strip()
    if tok:
        out.append(tok)
    return out


def read_ligolw_table(path, tablename="sim_inspiral"):
    """-> dict of column-name -> array for one LIGO-LW <Table>.

    Handles .xml and .xml.gz, the old ``sim_inspiral:col`` prefixed
    column naming and the ligo.lw plain naming, and string row ids like
    'sim_inspiral:simulation_id:3' (coerced to their trailing integer).
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        text = fh.read()
    # the DOCTYPE references an external DTD; drop it for the stdlib parser
    if "<!DOCTYPE" in text:
        start = text.index("<!DOCTYPE")
        end = text.index(">", start) + 1
        text = text[:start] + text[end:]
    root = ET.fromstring(text)

    table = None
    for t in root.iter("Table"):
        name = t.get("Name", "")
        if tablename in name:
            table = t
            break
    if table is None:
        raise ValueError(f"no {tablename!r} table in {path}")

    col_names, col_types = [], []
    for c in table.iter("Column"):
        raw = c.get("Name", "")
        col_names.append(raw.split(":")[-1])
        col_types.append(c.get("Type", "real_8"))
    stream = table.find("Stream")
    tokens = _split_stream(stream.text or "")
    n_cols = len(col_names)
    if n_cols == 0 or len(tokens) % n_cols:
        raise ValueError(
            f"malformed stream: {len(tokens)} tokens for {n_cols} columns")
    rows = np.array(tokens, dtype=object).reshape(-1, n_cols)

    out = {}
    for j, (name, typ) in enumerate(zip(col_names, col_types)):
        col = rows[:, j]
        if "ilwd" in typ or name.endswith("_id"):
            # 'sim_inspiral:simulation_id:3' or plain int
            out[name] = np.array(
                [int(str(v).split(":")[-1]) for v in col], dtype=np.int64)
        else:
            out[name] = _coerce(col, typ)
    return out


_MSUN_S = 4.925491025543576e-06     # G Msun / c^3 [s]


def transform_precessing_wvf2pe(incl, s1x, s1y, s1z, s2x, s2y, s2z,
                                m1, m2, f_ref, phi_ref=0.0):
    """(theta_jn, phi_jl, tilt_1, tilt_2, phi_12, a_1, a_2).

    Spin components are dimensionless and given in the frame with the
    Newtonian orbital angular momentum along z and the orbital
    separation along x at ``f_ref`` (the lalsimulation input
    convention). L is taken at Newtonian order, as in the lalsimulation
    function this mirrors. Aligned-spin rows reduce exactly:
    theta_jn = incl, tilt = 0 or pi, a_i = |chi_z|.
    """
    incl = np.asarray(incl, dtype=np.float64)
    s1 = np.stack(np.broadcast_arrays(
        np.asarray(s1x, float), np.asarray(s1y, float),
        np.asarray(s1z, float)), axis=-1)
    s2 = np.stack(np.broadcast_arrays(
        np.asarray(s2x, float), np.asarray(s2y, float),
        np.asarray(s2z, float)), axis=-1)
    m1 = np.asarray(m1, dtype=np.float64)
    m2 = np.asarray(m2, dtype=np.float64)

    a1 = np.linalg.norm(s1, axis=-1)
    a2 = np.linalg.norm(s2, axis=-1)
    safe1 = np.where(a1 > 0, a1, 1.0)
    safe2 = np.where(a2 > 0, a2, 1.0)
    tilt1 = np.arccos(np.clip(s1[..., 2] / safe1, -1, 1))
    tilt2 = np.arccos(np.clip(s2[..., 2] / safe2, -1, 1))
    tilt1 = np.where(a1 > 0, tilt1, 0.0)
    tilt2 = np.where(a2 > 0, tilt2, 0.0)
    phi1 = np.arctan2(s1[..., 1], s1[..., 0])
    phi2 = np.arctan2(s2[..., 1], s2[..., 0])
    in_plane = (np.hypot(s1[..., 0], s1[..., 1]) > 1e-10) \
        & (np.hypot(s2[..., 0], s2[..., 1]) > 1e-10)
    phi12 = np.where(in_plane, np.mod(phi2 - phi1, 2 * np.pi), 0.0)

    # Newtonian L along z: |L| = m1 m2 / v,  v = (pi M f_ref)^(1/3) geom.
    m_total_s = (m1 + m2) * _MSUN_S
    v0 = (np.pi * m_total_s * f_ref) ** (1.0 / 3.0)
    l_mag = (m1 * m2) / v0                       # in Msun^2 * c units
    j_vec = m1[..., None] ** 2 * s1 + m2[..., None] ** 2 * s2
    j_vec = j_vec + np.stack([np.zeros_like(l_mag), np.zeros_like(l_mag),
                              l_mag], axis=-1)
    j_norm = np.linalg.norm(j_vec, axis=-1)
    j_hat = j_vec / np.where(j_norm > 0, j_norm, 1.0)[..., None]

    # line of sight in this frame (lalsim convention at phiRef):
    n_hat = np.stack([np.sin(incl) * np.cos(np.pi / 2 - phi_ref),
                      np.sin(incl) * np.sin(np.pi / 2 - phi_ref),
                      np.cos(incl) * np.ones_like(incl)], axis=-1)
    n_hat = np.broadcast_arrays(n_hat, j_hat)[0]
    theta_jn = np.arccos(np.clip(np.sum(j_hat * n_hat, axis=-1), -1, 1))

    # phi_JL: azimuth of L around J, measured from the J-N plane.
    # Build the frame with J along z and N in the x-z plane.
    z = j_hat
    x = n_hat - np.sum(n_hat * z, axis=-1, keepdims=True) * z
    x_norm = np.linalg.norm(x, axis=-1, keepdims=True)
    degenerate = (x_norm[..., 0] < 1e-10)
    x = np.where(x_norm > 1e-10, x / np.where(x_norm > 0, x_norm, 1.0),
                 np.stack([np.ones_like(z[..., 0]), np.zeros_like(
                     z[..., 0]), np.zeros_like(z[..., 0])], axis=-1))
    y = np.cross(z, x)
    l_hat = np.broadcast_arrays(
        np.stack([np.zeros_like(l_mag), np.zeros_like(l_mag),
                  np.ones_like(l_mag)], axis=-1), z)[0]
    phi_jl = np.mod(np.arctan2(np.sum(l_hat * y, axis=-1),
                               np.sum(l_hat * x, axis=-1)), 2 * np.pi)
    phi_jl = np.where(degenerate | (np.linalg.norm(
        l_hat - z, axis=-1) < 1e-10), 0.0, phi_jl)
    return theta_jn, phi_jl, tilt1, tilt2, phi12, a1, a2


def sim_inspiral_to_injections(path, reference_frequency=20.0,
                               trigger_time=0.0):
    """sim_inspiral table -> nmma injection dict of arrays.

    Key mapping follows file_to_dataframe
    (injection_handling.py:384-417): distance -> luminosity_distance,
    longitude/latitude -> ra/dec, polarization -> psi, masses sorted so
    mass_1 >= mass_2, geocent_end_time(+_ns) -> geocent_time, precessing
    spins -> (theta_jn, phi_jl, tilt_1, tilt_2, phi_12, a_1, a_2).
    """
    tbl = read_ligolw_table(path, "sim_inspiral")
    n = len(tbl["mass1"])

    def get(name, default=0.0):
        if name in tbl:
            return np.asarray(tbl[name], dtype=np.float64)
        return np.full(n, default)

    coa_phase = get("coa_phase")
    theta_jn, phi_jl, t1, t2, p12, a1, a2 = transform_precessing_wvf2pe(
        get("inclination"), get("spin1x"), get("spin1y"), get("spin1z"),
        get("spin2x"), get("spin2y"), get("spin2z"),
        tbl["mass1"], tbl["mass2"], reference_frequency, coa_phase)

    m1 = np.asarray(tbl["mass1"], dtype=np.float64)
    m2 = np.asarray(tbl["mass2"], dtype=np.float64)
    mass_1 = np.maximum(m1, m2)
    mass_2 = np.minimum(m1, m2)

    geocent = get("geocent_end_time", trigger_time) \
        + get("geocent_end_time_ns") * 1e-9

    return {
        "simulation_id": np.asarray(
            tbl.get("simulation_id", np.arange(n)), dtype=np.int64),
        "mass_1": mass_1, "mass_2": mass_2,
        "luminosity_distance": get("distance"),
        "psi": get("polarization"), "phase": coa_phase,
        "geocent_time": geocent,
        "ra": get("longitude"), "dec": get("latitude"),
        "theta_jn": theta_jn, "phi_jl": phi_jl,
        "tilt_1": t1, "tilt_2": t2, "phi_12": p12,
        "a_1": a1, "a_2": a2,
    }
