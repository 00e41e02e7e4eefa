"""Filter metadata: effective wavelengths, name mapping, composite averages.

Host-side copy of ``nmma_tpu/filters.py``, the counterpart of
``nmma/em/utils.py:680-592`` (``get_default_filts_lambdas``,
``get_filter_name_mapping``, ``average_mags``). The reference resolves
effective wavelengths at runtime through sncosmo's bandpass registry; here
the table is frozen to plain floats (sncosmo ``wave_eff`` values) so filter
resolution is a host-side dictionary lookup and the device only ever sees a
static ``nu_0`` vector.

Wavelengths in metres; ``nu = c / lambda`` in Hz. The port keeps the
optical/NIR tables; the radio and X-ray names of the GRB models wait for the
GRB slice.
"""

from __future__ import annotations

import numpy as np

from .constants import c_SI

# ---------------------------------------------------------------------------
# Core generic filters (values copied from the reference's frozen arrays,
# nmma/em/utils.py:714-719 — these are data tables, not code)
# ---------------------------------------------------------------------------
_ANGSTROM = 1e-10

_GENERIC_LAMBDAS_AA = {
    "u": 3561.8, "g": 4866.46, "r": 6214.6, "i": 7687.0, "z": 7127.0,
    "y": 7544.6, "J": 8679.5, "H": 9633.3, "K": 12350.0,
    # Bessell UBVRI
    "U": 3605.07, "B": 4413.08, "V": 5512.12, "R": 6585.91, "I": 8059.88,
}

# sncosmo bandpass effective wavelengths (Angstrom), frozen from the public
# sncosmo bandpass registry (transmission-curve means); used for survey-named
# filters appearing in nmma example data files.
_SNCOSMO_LAMBDAS_AA = {
    # SDSS (primed, airmass 1.3)
    "sdssu": 3561.8, "sdssg": 4718.9, "sdssr": 6185.2, "sdssi": 7499.7,
    "sdssz": 8961.5,
    # PanSTARRS-1
    "ps1::g": 4866.46, "ps1::r": 6214.62, "ps1::i": 7544.57, "ps1::z": 8679.47,
    "ps1::y": 9633.26, "ps1::w": 6389.74, "ps1::open": 6439.35,
    # 2MASS
    "2massj": 12350.0, "2massh": 16620.0, "2massks": 21590.0,
    # ZTF
    "ztfg": 4746.48, "ztfr": 6366.38, "ztfi": 7829.03,
    # ATLAS
    "atlasc": 5408.66, "atlaso": 6866.26,
    # Bessell (sncosmo names)
    "bessellux": 3605.07, "bessellb": 4413.08, "bessellv": 5512.12,
    "bessellr": 6585.91, "besselli": 8059.88,
    # Swift/UVOT
    "uvot::b": 4349.56, "uvot::u": 3467.05, "uvot::uvm2": 2245.78,
    "uvot::uvw1": 2580.75, "uvot::uvw2": 2057.01, "uvot::v": 5425.27,
    "uvot::white": 3491.69,
    # Rubin/LSST
    "lsstu": 3671.0, "lsstg": 4827.0, "lsstr": 6223.0, "lssti": 7546.0,
    "lsstz": 8691.0, "lssty": 9712.0,
    # GALEX
    "galex::fuv": 1528.1, "galex::nuv": 2271.1,
    # UVEX (m4opt)
    "FUV": 1550.0, "NUV": 2300.0,
    # Swope (natural system)
    "swope2::y": 10350.0, "swope2::j": 12660.0, "swope2::h": 16240.0,
    "swope2::J": 12660.0, "swope2::H": 16240.0,
    # DECam
    "desg": 4843.0, "desr": 6435.0, "desi": 7828.0, "desz": 9181.0,
    "desy": 9877.0,
    # CSP
    "cspjs": 12390.0, "csphs": 16300.0, "cspk": 21500.0,
    # HST common
    "f435w": 4329.2, "f475w": 4773.6, "f555w": 5308.4, "f606w": 5887.5,
    "f625w": 6295.5, "f775w": 7665.8, "f814w": 8059.8, "f850lp": 9036.9,
    "f105w": 10551.0, "f110w": 11534.0, "f125w": 12486.0, "f140w": 13923.0,
    "f160w": 15369.0,
    # Keplercam / misc survey aliases that show up in kilonova compilations
    "uks": 3561.8,
}

def effective_wavelength(name: str) -> float:
    """Effective wavelength [m] for a filter name. Raises KeyError if unknown."""
    lname = name
    if lname in _GENERIC_LAMBDAS_AA:
        return _GENERIC_LAMBDAS_AA[lname] * _ANGSTROM
    if lname in _SNCOSMO_LAMBDAS_AA:
        return _SNCOSMO_LAMBDAS_AA[lname] * _ANGSTROM
    low = lname.lower()
    if low in _SNCOSMO_LAMBDAS_AA:
        return _SNCOSMO_LAMBDAS_AA[low] * _ANGSTROM
    raise KeyError(f"Unknown filter {name!r}; extend nmma_tpu_torch.filters tables.")


def filters_to_frequencies(filters) -> np.ndarray:
    """nu_0 [Hz] per filter, observer frame (= model.nu_0s in the reference)."""
    return np.asarray([c_SI / effective_wavelength(f) for f in filters])


# ---------------------------------------------------------------------------
# Bandpass wavelength ranges [Angstrom] for transmission-weighted band
# magnitudes (the reference integrates through sncosmo bandpasses,
# nmma/em/model.py:1121-1180, bandpasses registered in em/utils.py:478-592).
# Values are the published band edges (SVO filter service / survey papers);
# the in-band transmission is modelled as a flat top with linear edge ramps
# — adequate for the tenth-of-a-magnitude-scale correction this captures
# relative to point sampling at the effective wavelength. Filters not
# listed here (narrow/odd bands, radio/X-ray deltas, and the reference's
# parity-frozen generic letters) fall back to a single-node delta at the
# effective wavelength, i.e. the previous behavior.
# ---------------------------------------------------------------------------
BANDPASS_RANGES_AA = {
    "ztfg": (4087.0, 5522.0), "ztfr": (5600.0, 7317.0),
    "ztfi": (7027.0, 8883.0),
    "sdssu": (3048.0, 4028.0), "sdssg": (3783.0, 5549.0),
    "sdssr": (5415.0, 6989.0), "sdssi": (6689.0, 8389.0),
    "sdssz": (7960.0, 10833.0),
    "ps1::g": (3943.0, 5593.0), "ps1::r": (5386.0, 7036.0),
    "ps1::i": (6778.0, 8304.0), "ps1::z": (8028.0, 9346.0),
    "ps1::y": (9100.0, 10838.0),
    "2massj": (10620.0, 14500.0), "2massh": (14787.0, 18231.0),
    "2massks": (19543.0, 23552.0),
    "lsstu": (3205.0, 4081.0), "lsstg": (3873.0, 5665.0),
    "lsstr": (5375.0, 7054.0), "lssti": (6765.0, 8325.0),
    "lsstz": (8035.0, 9375.0), "lssty": (9089.0, 10897.0),
    "desg": (3980.0, 5480.0), "desr": (5680.0, 7160.0),
    "desi": (7100.0, 8570.0), "desz": (8500.0, 10000.0),
    "desy": (9500.0, 10700.0),
    "atlasc": (4200.0, 6560.0), "atlaso": (5600.0, 8200.0),
    "bessellux": (3030.0, 4200.0), "bessellb": (3600.0, 5600.0),
    "bessellv": (4700.0, 7000.0), "bessellr": (5500.0, 9000.0),
    "besselli": (7000.0, 9200.0),
    "galex::fuv": (1340.0, 1810.0), "galex::nuv": (1690.0, 3000.0),
}

DEFAULT_BANDPASS_NODES = 9


def filters_to_quadrature(filters, n_nodes=DEFAULT_BANDPASS_NODES,
                          ramp_frac=0.12):
    """Per-filter frequency quadrature for AB band-magnitude integrals.

    Returns ``(nu_nodes [F, K], weights [F, K])`` such that the band AB
    magnitude of a spectrum F_nu is ``-2.5 log10(sum_k w_k F_nu(nu_k) /
    3631 Jy)`` — the transmission-weighted mean flux in the AB convention
    ``m = -2.5 log10( int T F_nu dnu/nu / int T 3631Jy dnu/nu )``. Nodes
    are log-spaced across the band, so the dnu/nu measure makes the
    weights proportional to the trapezoid transmission alone. Filters
    without bandpass data collapse to a delta at the effective wavelength
    (weight 1 on node 0), reproducing point sampling exactly.
    """
    f = len(filters)
    nu_nodes = np.zeros((f, n_nodes))
    weights = np.zeros((f, n_nodes))
    for i, name in enumerate(filters):
        rng_aa = BANDPASS_RANGES_AA.get(name) or \
            BANDPASS_RANGES_AA.get(name.lower())
        nu_eff = c_SI / effective_wavelength(name)
        if rng_aa is None:
            nu_nodes[i, :] = nu_eff
            weights[i, 0] = 1.0
            continue
        lo, hi = rng_aa
        lam = np.geomspace(lo, hi, n_nodes)
        ramp = ramp_frac * (hi - lo)
        t_up = np.clip((lam - lo) / ramp, 0.0, 1.0)
        t_dn = np.clip((hi - lam) / ramp, 0.0, 1.0)
        trans = np.minimum(t_up, t_dn)
        w = trans / trans.sum()
        nu = c_SI / (lam * _ANGSTROM)
        nu_nodes[i] = nu
        weights[i] = w
    return nu_nodes, weights


# ---------------------------------------------------------------------------
# Filter name mapping (observed name -> model filter) and composite averages
# (nmma/em/utils.py:478-592)
# ---------------------------------------------------------------------------
_SYNONYMS = {
    "B": "g", "R": "z", "F160W": "H", "U": "u",
    "UVW2": "u", "UVW1": "u", "UVM2": "u",
}

# composite observed filters evaluated as a mean of modelled magnitudes
# (geometric mean of flux; nmma/em/utils.py:549-585)
COMPOSITE_FILTERS = {
    "w": ("g", "r", "i"),
    "o": ("r", "i"),
    "c": ("g", "r"),
    "V": ("g", "r"),
    "F606W": ("g", "r"),
    "I": ("z", "y"),
    "F814W": ("z", "y"),
}

_GENERIC_MODEL_FILTERS = set(_GENERIC_LAMBDAS_AA) | set(_SNCOSMO_LAMBDAS_AA)


def _generic_band(name: str) -> str:
    """Generic band letter(s) behind a survey-prefixed filter name
    (ztfg -> g, ps1::z -> z, sdssu -> u, 2massj -> j)."""
    n = name.lower()
    for pre in ("ps1::", "ps1_", "sdss", "ztf", "atlas", "2mass",
                "lsst", "uvot::", "bessell"):
        if n.startswith(pre):
            return n[len(pre):].lstrip(":_")
    return n


def resolve_filter(observed: str, available=None):
    """Map an observed filter name to (kind, payload).

    kind == 'direct': payload is the model filter name.
    kind == 'average': payload is the tuple of model filters to average.

    ``available``: the source model's fixed filter set (surrogates), or
    None for models that compute any frequency (analytic kernels). The
    reference resolves per-model the same way (getFilteredMag,
    nmma/em/utils.py:549-585): direct when the model provides the band,
    else synonym, else composite average — for a ugrizy-trained
    surrogate, observed V is the (g, r) average, never a dead all-inf
    row.
    """
    if available is not None:
        avail = set(available)

        def find(band):
            """The trained filter providing generic band ``band``: an
            exact name, or a survey-prefixed equivalent (the reference's
            models are keyed by bare band letters, utils.py:552-560; our
            surrogate artifacts keep survey-prefixed names like ztfg)."""
            if band in avail:
                return band
            for f in available:
                if _generic_band(f) == band.lower():
                    return f
            return None

        if observed in avail:
            return "direct", observed
        syn = _SYNONYMS.get(observed)
        if syn is not None and find(syn) is not None:
            return "direct", find(syn)
        comp = COMPOSITE_FILTERS.get(observed)
        if comp is not None and all(find(h) is not None for h in comp):
            return "average", tuple(find(h) for h in comp)
        if observed.lower() in avail:
            return "direct", observed.lower()
        raise KeyError(
            f"filter {observed!r} not resolvable against the model's "
            f"trained set {sorted(avail)} (no direct/synonym/composite "
            f"mapping)")
    if observed in _GENERIC_MODEL_FILTERS:
        return "direct", observed
    if observed in _SYNONYMS:
        return "direct", _SYNONYMS[observed]
    if observed in COMPOSITE_FILTERS:
        return "average", COMPOSITE_FILTERS[observed]
    if observed.lower() in _GENERIC_MODEL_FILTERS:
        return "direct", observed.lower()
    raise KeyError(f"Unknown filter {observed!r}; cannot be processed.")
