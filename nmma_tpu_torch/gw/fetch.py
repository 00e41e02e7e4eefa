"""GWOSC open-data strain fetching (stdlib urllib, no gwpy).

The port's copy of ``nmma_tpu/gw/fetch.py``, with its own copy of the JAX
package's length-checked download (``nmma_tpu/registry.py:_fetch``).

The reference obtains real interferometer data through bilby_pipe's
``DataGenerationInput`` (``nmma/gw/gw_inputs.py:4``), which ultimately
calls gwpy's ``TimeSeries.fetch_open_data`` against the GWOSC event API.
This module implements that client directly on ``urllib``:

- :func:`event_strain_catalog` — query ``/eventapi/json/event/{name}/``
  and return the per-detector strain-file entries (detector, GPS start,
  duration, sampling rate, format, URL);
- :func:`fetch_event_strain` — download the matching HDF5 files into a
  cache directory (atomic writes, re-used on later calls) and parse them
  with :func:`nmma_tpu_torch.gw.strain.read_strain_file`.

The base URL is overridable via ``$NMMA_TPU_GWOSC_URL`` (the JAX package's
variable) so air-gapped deployments can point at a mirror; the tests run
the client against a localhost server serving the documented eventapi JSON
schema.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .strain import read_strain_file

GWOSC_URL_ENV = "NMMA_TPU_GWOSC_URL"
DEFAULT_GWOSC_URL = "https://gwosc.org"


def gwosc_url(base_url=None) -> str:
    return (base_url or os.environ.get(GWOSC_URL_ENV)
            or DEFAULT_GWOSC_URL)


def _get(url, timeout=60.0):
    """The body at ``url``, checked against its content-length: a truncated
    body cached into the strain dir would poison every later call (the
    file exists, so it is never re-fetched)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        expect = resp.headers.get("content-length")
        data = resp.read()
    if expect is not None and len(data) != int(expect):
        raise OSError(f"incomplete download from {url}: "
                      f"{len(data)} of {expect} bytes")
    return data


def event_strain_catalog(event, base_url=None, version=None, timeout=60.0):
    """Strain-file entries for a named event from the GWOSC event API.

    ``GET {base}/eventapi/json/event/{event}/`` returns
    ``{"events": {"GW170817-v3": {..., "strain": [entry, ...]}}}`` where
    each entry carries ``detector``, ``GPSstart``, ``duration``,
    ``sampling_rate``, ``format`` and ``url``. Returns the strain list of
    the requested ``version`` (highest available when None).
    """
    payload = json.loads(_get(
        f"{gwosc_url(base_url)}/eventapi/json/event/{event}/",
        timeout=timeout))
    events = payload.get("events", {})
    if not events:
        raise ValueError(f"event {event!r} not found in GWOSC event API")

    def _version(key):
        tail = key.rsplit("-v", 1)
        return int(tail[1]) if len(tail) == 2 and tail[1].isdigit() else -1

    if version is not None:
        matches = [k for k in events if _version(k) == version]
        if not matches:
            raise ValueError(f"event {event!r} has no version v{version} "
                             f"(available: {sorted(events)})")
        key = matches[0]
    else:
        key = max(events, key=_version)
    strain = events[key].get("strain", [])
    if not strain:
        raise ValueError(f"event API entry {key} lists no strain files")
    return strain


def fetch_event_strain(event, detectors, duration=32, sample_rate=4096,
                       cache_dir=None, base_url=None, version=None,
                       timeout=300.0):
    """Download + parse an event's strain files -> {detector: StrainSeries}.

    Picks the hdf5 entry per detector matching ``duration`` [s] and
    ``sample_rate`` [Hz] (GWOSC publishes 32/4096 and 4096/16384
    variants). Files land in ``cache_dir`` (default
    ``~/.cache/nmma_tpu_torch/gwosc``) and are not re-fetched when present.
    """
    cache = Path(cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "nmma_tpu_torch", "gwosc"))
    cache.mkdir(parents=True, exist_ok=True)
    catalog = event_strain_catalog(event, base_url=base_url,
                                   version=version, timeout=timeout)
    out = {}
    for det in detectors:
        entry = _select_entry(catalog, det, duration, sample_rate)
        name = entry["url"].rstrip("/").rsplit("/", 1)[-1]
        dest = cache / name
        if not dest.exists():
            data = _get(entry["url"], timeout=timeout)
            tmp = dest.with_name(dest.name + ".part")
            tmp.write_bytes(data)
            os.replace(tmp, dest)
        out[det] = read_strain_file(str(dest))
    return out


def _select_entry(catalog, detector, duration, sample_rate):
    candidates = [
        e for e in catalog
        if e.get("detector") == detector
        and str(e.get("format", "hdf5")).lower() in ("hdf5", "h5")]
    if not candidates:
        raise ValueError(f"no hdf5 strain entry for detector {detector}")
    matched = [e for e in candidates
               if int(e.get("duration", -1)) == int(duration)
               and int(e.get("sampling_rate", -1)) == int(sample_rate)]
    if matched:
        return matched[0]
    # fall back to the closest duration at the requested rate, then any —
    # loudly: the 4096 s bulk files are hundreds of MB and 100x longer
    # than the 32 s variant callers usually expect
    rate_ok = [e for e in candidates
               if int(e.get("sampling_rate", -1)) == int(sample_rate)]
    pool = rate_ok or candidates
    pick = min(pool, key=lambda e: abs(int(e.get("duration", 0))
                                       - int(duration)))
    print(f"WARNING: no {duration}s/{sample_rate}Hz strain file for "
          f"{detector}; falling back to the "
          f"{pick.get('duration')}s/{pick.get('sampling_rate')}Hz "
          f"variant", flush=True)
    return pick


def interferometers_from_gwosc(names, event, trigger_time,
                               file_duration=32, file_sample_rate=4096,
                               cache_dir=None, base_url=None, **kwargs):
    """Event fetch + conditioning -> list of analysis-ready ifos.

    The one-call analogue of bilby_pipe's open-data channel: fetch each
    detector's strain (``file_duration``/``file_sample_rate`` select the
    GWOSC bulk-file variant), then hand it to
    :func:`nmma_tpu_torch.gw.strain.interferometer_from_data` for PSD
    estimation (off-source median Welch) and FFT segment selection —
    analysis-segment options (``duration``, ``post_trigger``, ``f_min``,
    ``f_max``, ``psd_duration``, ...) pass through as ``kwargs``.
    """
    from .strain import interferometer_from_data
    series = fetch_event_strain(event, names, duration=file_duration,
                                sample_rate=file_sample_rate,
                                cache_dir=cache_dir, base_url=base_url)
    return [interferometer_from_data(name, series[name], trigger_time,
                                     **kwargs)
            for name in names]
