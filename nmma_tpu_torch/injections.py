"""Injection files and forward synthesis of photometry.

Port of the json and plain-cadence parts of ``nmma_tpu/injections.py``
(the reference's bilby-style injection files, ``nmma/core/utils.py:84-96``,
and ``create_light_curve_data``, ``nmma/em/lightcurve_generation.py
:816-917``): the detector-frame model light curve at the injection, Gaussian
noise from ``np.random.default_rng(seed)`` drawn in the JAX package's order
(so a seed gives both packages the same noise), and detections below the
limit with (limit, inf) pairs above it.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import resolve_device


def read_injection_file(path):
    """Injection json (bilby dataframe format) -> dict of parameter
    arrays."""
    path = str(path)
    if path.endswith((".xml", ".xml.gz")):
        raise NotImplementedError(
            "LIGO-LW xml injections need io/ligolw.py, which nmma_tpu_torch "
            "does not have yet (ROADMAP item 17)")
    with open(path) as f:
        data = json.load(f)
    content = data["injections"]["content"] if "injections" in data else data
    return {k: np.asarray(v) for k, v in content.items()}


def read_injection_entry(path, index=0):
    table = read_injection_file(path)
    return {k: float(v[index]) if np.ndim(v[index]) == 0 else v[index]
            for k, v in table.items()}


def write_injection_file(path, parameters: dict):
    """Write a reference-compatible injection json."""
    n = len(next(iter(parameters.values())))
    content = {k: list(np.asarray(v).tolist()) for k, v in parameters.items()}
    content.setdefault("simulation_id", list(range(n)))
    payload = {"injections": {"__dataframe__": True, "content": content}}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def _per_filter(value, filters, default):
    if np.isscalar(value) or value is None:
        return {f: float(default if value is None else value)
                for f in filters}
    return dict(value)


def create_light_curve_data(injection_parameters, model, filters,
                            tmin=0.01, tmax=14.0, n_tsteps=150,
                            sample_times=None, seed=42,
                            injection_error_budget=0.1,
                            detection_limit=np.inf,
                            keep_infinite_data=False,
                            trigger_time=None,
                            ztf_sampling=False, rubin_too_type=None,
                            ztf_uncertainties=False, ztf_too=None,
                            device=None):
    """Synthetic photometry ``{filter: {time, mag, mag_error}}`` from one
    injection: the model on ``device`` (the CUDA card unless the caller
    passes one), noise and detection limits on the host."""
    if ztf_sampling or ztf_uncertainties or ztf_too or rubin_too_type:
        raise NotImplementedError(
            "survey cadences (ztf_sampling, ztf_uncertainties, ztf_too, "
            "rubin_too_type) need strategies.py, which nmma_tpu_torch does "
            "not have yet (ROADMAP item 19)")
    from .models import DetectorLightCurveModel

    rng = np.random.default_rng(seed)
    if sample_times is None:
        sample_times = np.geomspace(tmin, tmax, n_tsteps)
    lc_model = model if isinstance(model, DetectorLightCurveModel) else \
        DetectorLightCurveModel(model, filters, sample_times=sample_times,
                                device=resolve_device(device))
    params = {k: torch.tensor([float(v)], device=lc_model.device)
              for k, v in injection_parameters.items()
              if not isinstance(v, str) and np.ndim(v) == 0}
    with torch.no_grad():
        obs_times, mags = lc_model(params)
    obs_times = obs_times[0].cpu().numpy()
    mags = mags[0].cpu().numpy()

    if trigger_time is None:
        trigger_time = injection_parameters.get("trigger_time", 0.0)
    limits = _per_filter(detection_limit, filters, np.inf)
    dmag = _per_filter(injection_error_budget, filters, 0.1)

    data = {}
    for i, filt in enumerate(filters):
        keep = obs_times >= 0.0
        times = obs_times[keep] + trigger_time
        true_mag = mags[i][keep]
        noisy = true_mag + rng.normal(scale=dmag[filt], size=len(true_mag))
        det_lim = limits.get(filt, np.inf)
        detected = noisy < det_lim
        mag_out = np.where(detected, noisy, det_lim)
        err_out = np.where(detected, dmag[filt], np.inf)
        if not keep_infinite_data:
            finite = np.isfinite(mag_out)
            times, mag_out, err_out = times[finite], mag_out[finite], \
                err_out[finite]
        data[filt] = {"time": times, "mag": mag_out, "mag_error": err_out}
    return data


class InjectionCreator:
    """Prior-draw injection sets with test-and-redraw loops: part of the
    joint path, which is not in the port yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "InjectionCreator belongs to the joint path, which "
            "nmma_tpu_torch does not have yet (ROADMAP item 16)")
