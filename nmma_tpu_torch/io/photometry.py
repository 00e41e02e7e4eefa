"""Light-curve I/O: readers for the nmma-standard photometry formats.

Host-side (NumPy) port of ``nmma_tpu/io/photometry.py``, the counterpart
of ``nmma/em/io.py:16-144`` and the data windowing utilities in
``nmma/em/utils.py:233-349``. The device never sees
these dicts — ``likelihood.em.PhotometryData.from_dict`` pads them to dense
masked tensors. pandas is imported only by the model-table reader and the
SkyPortal converter.

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


# leap seconds since the GPS epoch (UTC dates when TAI-UTC increased);
# GPS time = UTC + (leap seconds since 1980-01-06)
_LEAP_SECOND_MJDS = [
    44786, 45151, 45516, 46247, 47161, 47892, 48257, 48804, 49169, 49534,
    50083, 50630, 51179, 53736, 54832, 56109, 57204, 57754,
]
_GPS_EPOCH_MJD = 44244.0


def gps_to_mjd(gps_time: float) -> float:
    """GPS seconds -> MJD (UTC), with the leap-second table (the
    reference's astropy ``Time(format='gps').mjd`` in ``read_trigger_time``,
    nmma/core/utils.py:49-82)."""
    mjd_approx = _GPS_EPOCH_MJD + gps_time / 86400.0
    leap = sum(1 for m in _LEAP_SECOND_MJDS if m <= mjd_approx)
    return _GPS_EPOCH_MJD + (gps_time - leap) / 86400.0


def mjd_to_gps(mjd: float) -> float:
    leap = sum(1 for m in _LEAP_SECOND_MJDS if m <= mjd)
    return (mjd - _GPS_EPOCH_MJD) * 86400.0 + leap


def read_trigger_time(parameters=None, trigger_time=None, gps=None,
                      time_format="mjd", out_format="mjd"):
    """A trigger time in MJD (or GPS with ``out_format='gps'``); None when
    nothing gives one. Priority: parameters['trigger_time'] (mjd) >
    parameters['geocent_time_x'] / ['geocent_time'] (gps) > ``gps`` >
    ``trigger_time`` (mjd, ISO string, or gps with ``time_format='gps'``)."""
    value_mjd = None
    if parameters:
        if "trigger_time" in parameters:
            value_mjd = float(parameters["trigger_time"])
        elif "geocent_time_x" in parameters:
            value_mjd = gps_to_mjd(float(parameters["geocent_time_x"]))
        elif "geocent_time" in parameters:
            value_mjd = gps_to_mjd(float(parameters["geocent_time"]))
    if value_mjd is None and gps is not None:
        value_mjd = gps_to_mjd(float(gps))
    if value_mjd is None and trigger_time is not None:
        if isinstance(trigger_time, str):
            value_mjd = mjd_from_isot(trigger_time)
        elif time_format == "gps":
            value_mjd = gps_to_mjd(float(trigger_time))
        else:
            value_mjd = float(trigger_time)
    if value_mjd is None:
        return None
    return value_mjd if out_format == "mjd" else mjd_to_gps(value_mjd)


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


def _read_model_csv(filename):
    """Model table: columns time filt1 ... filtN [filt1_error ...]
    (reference :83-97), whitespace-separated or json."""
    import pandas as pd
    try:
        df = pd.read_csv(filename, sep=r"\s+")
    except Exception:
        df = pd.read_json(filename, orient="columns")
    cols = df.to_dict(orient="list")
    time = cols.pop("time")
    return {
        filt: {
            "time": time,
            "mag": mags,
            "mag_error": cols.get(filt + "_error", list(np.zeros(len(time)))),
        }
        for filt, mags in cols.items() if not filt.endswith("_error")
    }


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
    elif "model" in format:
        data = _read_model_csv(filename)
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


def convert_skyportal_lcs(csv_path, out_path=None):
    """SkyPortal photometry csv (columns mjd, filter, mag, magerr; a
    non-detection has no mag and a limiting_mag) -> nmma-standard
    whitespace .dat file (``convert_skyportal_lcs``, nmma/em/io.py:193-232).
    Returns the path written."""
    import pandas as pd
    df = pd.read_csv(csv_path)
    if out_path is None:
        out_path = str(csv_path).rsplit(".", 1)[0] + ".dat"
    with open(out_path, "w") as f:
        for _, row in df.iterrows():
            mag = row.get("mag")
            err = row.get("magerr")
            if mag is None or (isinstance(mag, float) and np.isnan(mag)):
                mag = row.get("limiting_mag", np.nan)
                err = np.inf
            f.write(f"{row['mjd']} {row['filter']} {mag} {err}\n")
    return out_path


def remove_nondetections(data):
    """Drop upper-limit samples (inf error); drop filters left empty."""
    out = {}
    for filt, sub in data.items():
        mask = np.isfinite(sub["mag_error"])
        if np.any(mask):
            out[filt] = {k: v[mask] for k, v in sub.items()}
    return out
