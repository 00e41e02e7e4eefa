"""EM survey and detector configuration: filter sets and detection limits.

The port's copy of ``nmma_tpu/em_detectors.py`` (numpy only; the reference's
``set_filters`` and ``create_detection_limit``, nmma/em/utils.py:96-196):
detector names (ztf, lsst, rubin and the Rubin ToO tiers) expand to filter
lists and published single-visit limiting magnitudes.
"""

from __future__ import annotations

import numpy as np

RUBIN_TOO_FILTERS = {
    "platinum": ["ps1::g", "ps1::r", "ps1::i", "ps1::z", "ps1::y"],
    "gold": ["ps1::g", "ps1::r", "ps1::i"],
    "gold_z": ["ps1::g", "ps1::r", "ps1::z"],
    "silver": ["ps1::g", "ps1::i"],
    "silver_z": ["ps1::g", "ps1::z"],
}

# published single-visit limiting magnitudes (reference :142-196)
ZTF_LIMITS = {"ztfg": 21.7, "ztfr": 21.4, "ztfi": 20.9}
LSST_LIMITS = {"lsstu": 23.9, "lsstg": 25.0, "lsstr": 24.7, "lssti": 24.0,
               "lsstz": 23.3, "lssty": 22.1}
RUBIN_LIMITS = {"ps1::g": 25.8, "ps1::r": 25.5, "ps1::i": 24.8,
                "ps1::z": 24.1, "ps1::y": 22.9}


def set_filters(filters=None, em_detectors=None, rubin_too_type=None):
    """Resolve the analysis filter list (reference set_filters semantics)."""
    if filters:
        if isinstance(filters, str):
            filters = filters.split(",")
        flat = []
        for f in filters:
            flat.extend(x for x in f.replace(" ", "").split(",") if x)
        if not flat:
            raise ValueError("Need at least one valid filter.")
        return flat

    out = []
    dets = []
    if em_detectors:
        dets = (em_detectors.split(",") if isinstance(em_detectors, str)
                else list(em_detectors))
        dets = [d.strip().lower() for d in dets]
    if "ztf" in dets:
        dets.remove("ztf")
        out.extend(["ztfg", "ztfr", "ztfi"])
    if "lsst" in dets:
        dets.remove("lsst")
        out.extend(["lsstg", "lsstr", "lssti", "lsstz", "lssty"])
    elif rubin_too_type:
        out.extend(RUBIN_TOO_FILTERS[rubin_too_type])
        if "rubin" in dets:
            dets.remove("rubin")
    elif "rubin" in dets:
        dets.remove("rubin")
        out.extend(["ps1::g", "ps1::r", "ps1::i", "ps1::z", "ps1::y"])
    if dets:
        raise ValueError(
            f"unknown EM detectors {sorted(dets)}; supported: ztf, lsst, "
            f"rubin (reference detector sets, nmma/em/utils.py:96-196)")
    return out or None


def create_detection_limit(filters, detection_limit=None, em_detectors=None,
                           rubin_too_type=None, default_limit=np.inf):
    """Per-filter limiting magnitudes (reference create_detection_limit)."""
    if detection_limit is not None and not (
            isinstance(detection_limit, float) and np.isinf(detection_limit)):
        if np.isscalar(detection_limit):
            return {f: float(detection_limit) for f in filters}
        if isinstance(detection_limit, dict):
            return {f: float(detection_limit.get(f, default_limit))
                    for f in filters}
        return {f: float(v) for f, v in zip(filters, detection_limit)}

    limits = {f: default_limit for f in filters}
    dets = []
    if em_detectors:
        dets = (em_detectors.split(",") if isinstance(em_detectors, str)
                else list(em_detectors))
        dets = [d.strip().lower() for d in dets]
    if "lsst" in dets:
        limits.update(LSST_LIMITS)
    if "ztf" in dets:
        limits.update(ZTF_LIMITS)
    if "rubin" in dets or rubin_too_type:
        limits.update(RUBIN_LIMITS)
    return {f: limits.get(f, default_limit) for f in filters}
