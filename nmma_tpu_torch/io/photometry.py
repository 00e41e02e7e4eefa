"""Light-curve I/O: readers for the nmma-standard photometry formats.

Host-side (NumPy) port of ``nmma_tpu/io/photometry.py``, the counterpart
of ``nmma/em/io.py:16-144`` and the data windowing utilities in
``nmma/em/utils.py:233-349``. The device never sees
these dicts — ``likelihood.em.PhotometryData.from_dict`` pads them to dense
masked tensors. The pandas-based model-table reader, the SkyPortal
converter and the GPS trigger-time helpers wait for a later slice.

Standard in-memory format (identical to the reference):
``{filter_name: {"time": [...MJD], "mag": [...], "mag_error": [...]}}``
with non-detections encoded as (limiting mag, inf error).
"""

from __future__ import annotations

import datetime
import json

import numpy as np

_MJD_EPOCH = datetime.datetime(1858, 11, 17, tzinfo=datetime.timezone.utc)


def mjd_from_isot(stamp: str) -> float:
    """ISO-8601 timestamp -> Modified Julian Date (UTC).

    Replaces ``astropy.time.Time(...).mjd`` for the observation files.
    """
    s = stamp.strip()
    if s.endswith("Z"):
        s = s[:-1]
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    delta = dt - _MJD_EPOCH
    return delta.days + delta.seconds / 86400.0 + delta.microseconds / 86400e6


def _parse_time(token: str, time_format: str = "mjd") -> float:
    try:
        return float(token)
    except ValueError:
        return mjd_from_isot(token)


def _read_observations_csv(filename, time_format="mjd"):
    """Whitespace table: time filter mag mag_error (reference strict_read_csv)."""
    data: dict = {}
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith(("time", "mjd")):
                continue
            parts = line.split()
            mjd = _parse_time(parts[0], time_format)
            filt, mag, dmag = parts[1], float(parts[2]), float(parts[3])
            entry = data.setdefault(filt, {"time": [], "mag": [], "mag_error": []})
            entry["time"].append(mjd)
            entry["mag"].append(mag)
            entry["mag_error"].append(dmag)
    return data


def _read_json(filename):
    with open(filename) as f:
        data = json.load(f)
    # bilby-style encoded arrays: {"__array__": true, "content": [...]}
    def decode(obj):
        if isinstance(obj, dict):
            if obj.get("__array__"):
                return np.asarray(obj["content"])
            return {k: decode(v) for k, v in obj.items()}
        return obj
    data = decode(data)
    if "time" in data:  # model format
        new_data = {}
        for key, value in data.items():
            if key != "time" and not key.endswith("_error"):
                new_data[key] = {
                    "time": data["time"],
                    "mag": value,
                    "mag_error": data.get(f"{key}_error",
                                          np.zeros(len(data["time"]))),
                }
        data = new_data
    return data


def load_em_observations(filename, format="observations", time_format="mjd"):
    """Read photometry into the nmma-standard dict (arrays per filter)."""
    if isinstance(filename, dict):
        data = filename
    elif str(filename).endswith(".json"):
        data = _read_json(filename)
    elif "obs" in format:
        data = _read_observations_csv(filename, time_format)
    else:
        raise ValueError(f"Unknown photometry format {format!r}")
    return {
        filt: {k: np.asarray(v, dtype=np.float64) for k, v in sub.items()}
        for filt, sub in data.items()
    }


def cut_data_to_time_range(data, trigger_time, tmin=0.0, tmax=np.inf):
    """Keep samples with tmin <= t - trigger <= tmax; drop empty filters.

    Matches ``cut_data_to_time_range`` (nmma/em/utils.py:233-252).
    """
    out = {}
    for filt, sub in data.items():
        detector_time = sub["time"] - trigger_time
        mask = (detector_time >= tmin) & (detector_time <= tmax)
        if np.any(mask):
            out[filt] = {k: v[mask] for k, v in sub.items()}
    return out


def shift_to_trigger_time(data, trigger_time):
    """Times relative to trigger [days]. (``setup_filtered_lc_data``, :255-287)."""
    min_time = min(np.min(sub["time"]) for sub in data.values())
    if min_time - trigger_time < 0:
        raise ValueError(
            f"trigger_time is {trigger_time - min_time} days later than the "
            "earliest data point; provide a valid trigger time."
        )
    return {
        filt: {**sub, "time": sub["time"] - trigger_time}
        for filt, sub in data.items()
    }


def write_em_observations(path, data, fmt=None):
    """Write the nmma-standard photometry dict to .json or .dat.

    Counterpart of the reference writers (nmma/em/io.py:146-191): json
    stores the per-filter dict directly; dat writes
    'time filter mag mag_error' rows readable by load_em_observations.
    """
    path = str(path)
    fmt = fmt or ("json" if path.endswith(".json") else "dat")
    if fmt == "json":
        payload = {f: {k: np.asarray(v).tolist() for k, v in sub.items()}
                   for f, sub in data.items()}
        with open(path, "w") as fh:
            json.dump(payload, fh)
        return path
    with open(path, "w") as fh:
        for filt, sub in data.items():
            for t, m, e in zip(sub["time"], sub["mag"], sub["mag_error"]):
                fh.write(f"{t} {filt} {m} {e}\n")
    return path


def remove_nondetections(data):
    """Drop upper-limit samples (inf error); drop filters left empty."""
    out = {}
    for filt, sub in data.items():
        mask = np.isfinite(sub["mag_error"])
        if np.any(mask):
            out[filt] = {k: v[mask] for k, v in sub.items()}
    return out
