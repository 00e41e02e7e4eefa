"""Injection files and forward synthesis of photometry.

Port of the json, LIGO-LW xml, plain-cadence and injection-set parts of
``nmma_tpu/injections.py`` (the reference's bilby-style injection files,
``nmma/core/utils.py:84-96``,
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


def read_injection_file(path, reference_frequency=20.0):
    """Injection file -> dict of parameter arrays: json in the bilby
    dataframe format, or a LIGO-LW sim_inspiral table (.xml, .xml.gz;
    the reference's file_to_dataframe, nmma/joint/injection_handling.py
    :361-418) read with the standard library."""
    path = str(path)
    if path.endswith((".xml", ".xml.gz")):
        from .io.ligolw import sim_inspiral_to_injections
        return sim_inspiral_to_injections(
            path, reference_frequency=reference_frequency)
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
    """Prior-draw injection sets with test-and-redraw loops.

    Counterpart of ``InjectionCreator`` (nmma_tpu/injections.py:198-251;
    the reference's ``NMMAInjectionCreator``,
    nmma/joint/injection_handling.py:18-228): draw from the prior, run the
    conversion chain, apply the tests (finite ejecta, an SNR threshold,
    custom predicates) and redraw the failures up to ``max_redraws``
    times. The unit-cube draws come from an explicit ``torch.Generator``
    seeded with ``seed`` on ``device``.
    """

    def __init__(self, priors, conversion=None, tests=(), max_redraws=100,
                 seed=42, device=None):
        self.priors = priors
        self.conversion = conversion
        self.tests = list(tests)
        self.max_redraws = max_redraws
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _units(self, n):
        return torch.rand((n, self.priors.ndim), generator=self.generator,
                          device=self.device)

    def _draw(self, n):
        with torch.no_grad():
            params = self.priors.transform(self._units(n))
            if self.conversion is not None:
                params = self.conversion(params)
        return {k: v.cpu().numpy() for k, v in params.items()}

    def _passes(self, params):
        ok = np.ones(len(next(iter(params.values()))), dtype=bool)
        for test in self.tests:
            ok &= np.asarray(test(params))
        return ok

    def generate(self, n_injection):
        """{parameter: [n_injection] array} of draws that pass every
        test."""
        params = self._draw(n_injection)
        ok = self._passes(params)
        redraws = 0
        while not ok.all() and redraws < self.max_redraws:
            fresh = self._draw(int((~ok).sum()))
            fresh_ok = self._passes(fresh)
            take = np.flatnonzero(~ok)[:fresh_ok.sum()]
            src_idx = np.flatnonzero(fresh_ok)[:len(take)]
            for k in params:
                if k in fresh:
                    params[k][take] = fresh[k][src_idx]
            ok[take] = True
            redraws += 1
        if not ok.all():
            raise RuntimeError(
                f"{(~ok).sum()} injections still failing after "
                f"{self.max_redraws} redraws")
        return params


def finite_ejecta_test(params):
    """Reject draws whose conversion gave no ejecta (reference :274-280)."""
    mej = np.asarray(params["log10_mej"])
    return np.isfinite(mej) & (mej > -1e29)


def snr_test(gw_likelihood, threshold=8.0):
    """Network-SNR threshold test (reference test_snr, :283-344): the GW
    likelihood's optimal SNR of every draw, in one batch."""
    def test(params):
        batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                    device=gw_likelihood.device)
                 for k, v in params.items() if np.ndim(v) >= 1}
        with torch.no_grad():
            snr = gw_likelihood.optimal_snr(batch)
        return snr.cpu().numpy() >= threshold
    return test
