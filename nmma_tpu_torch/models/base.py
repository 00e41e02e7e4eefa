"""Light-curve model layer: source models + batched detector-frame assembly.

PyTorch counterpart of ``nmma_tpu/models/base.py`` (the reference's
``gen_detector_lc``/``combine_detector_data``, nmma/em/model.py:352-404).
A source model is a function

    ``mags = mags_fn(params, t_days, nu_host) -> [B, F, T]``

of a struct-of-arrays parameter dict ``{name: [B]}`` (absolute AB
magnitudes on a static source-frame time grid), and
``DetectorLightCurveModel.__call__`` maps ``params -> (obs_times [B, T],
apparent mags [B, F, T])`` with redshift stretch, timeshift, distance
modulus, K-ish correction and extinction, in two steps: ``frame`` (the
parameters and the source) and ``observe`` (the rest), which the
likelihood's kernel replaces on the card. The batch is an explicit first
dimension where the JAX package vmaps a per-sample function.
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device, tracing
from ..cosmology import distance_modulus, get_cosmology
from ..filters import (filters_to_frequencies, filters_to_quadrature,
                       resolve_filter)
from ..ops.extinction import (band_extinction_mags_mw,
                              band_extinction_mags_p92_smc)

def observation_angle_conversion(parameters):
    """KNtheta [deg] <-> inclination_EM [rad] <-> theta_jn completion
    (``observation_angle_conversion``, nmma/core/conversion.py:119-126)."""
    parameters = dict(parameters)
    like = next(iter(parameters.values()))
    if "theta_jn" in parameters:
        theta_jn = parameters["theta_jn"]
    elif "cos_theta_jn" in parameters:
        theta_jn = torch.arccos(parameters["cos_theta_jn"])
    else:
        theta_jn = torch.zeros_like(like)
    theta_jn = torch.minimum(theta_jn, math.pi - theta_jn)
    if "KNtheta" not in parameters:
        parameters["KNtheta"] = (
            parameters.get("inclination_EM", theta_jn) * 180.0 / math.pi)
    if "inclination_EM" not in parameters:
        parameters["inclination_EM"] = parameters["KNtheta"] / 180.0 * math.pi
    return parameters


def complete_log_parameters(parameters, model_parameter_names):
    """log10_x <-> x autocompletion for a model's canonical parameters
    (``LightCurveModelContainer.parameter_conversion``,
    nmma/em/model.py:272-286)."""
    parameters = dict(parameters)
    for key in model_parameter_names:
        if key in parameters:
            continue
        stripped = key[len("log10_"):] if key.startswith("log10_") else None
        if stripped and stripped in parameters:
            parameters[key] = torch.log10(parameters[stripped])
        elif "log10_" + key in parameters:
            parameters[key] = 10.0 ** parameters["log10_" + key]
    return parameters


@dataclass(frozen=True)
class SourceModel:
    """A batched source-frame light-curve function plus its metadata."""

    name: str
    parameter_names: tuple
    mags_fn: Callable  # (params, t_days[T], nu_host[B, F]) -> [B, F, T]
    default_time_grid: Callable = None  # () -> np.ndarray[T]
    citation: str = ""
    # bandpass-integrated: mags_fn also takes the host-frame quadrature
    # nu_nodes [B, F, K] and nu_weights [F, K] (transmission-weighted band
    # magnitudes instead of point sampling at the effective wavelength;
    # the reference integrates via sncosmo, nmma/em/model.py:1121-1180)
    banded: bool = False
    # mags_fn also takes the detector's filter names (``filters=``)
    needs_filters: bool = False
    # filter rows the function emits; None => it follows the requested
    # filters. SVD surrogates are trained per filter, so their rows are fixed
    # and get gathered/inf-filled to the requested set (reference
    # calc_svd_lc null-output, :166-168).
    filter_names: tuple = None
    # bolometric: mags_fn returns L / 1e40 erg/s [B, T], not magnitudes
    bolometric: bool = False
    # SALT-style models sample an apparent amplitude (x0 already holds the
    # distance), so no distance modulus is added (reference
    # SupernovaLightCurveModel.gen_detector_lc, nmma/em/model.py:1216-1222)
    apparent_amplitude: bool = False

    def time_grid(self):
        if self.default_time_grid is not None:
            return self.default_time_grid()
        return np.geomspace(0.01, 14.0, 150)


def _filter_kwargs(fn, kwargs: dict) -> dict:
    """Keep only the kwargs ``fn``'s signature accepts (or all on **kw)."""
    if not kwargs:
        return {}
    sig = inspect.signature(fn)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


_SOURCE_MODELS: dict[str, SourceModel] = {}


def register_source_model(model: SourceModel):
    _SOURCE_MODELS[model.name] = model
    return model


def get_source_model(name: str) -> SourceModel:
    if name not in _SOURCE_MODELS:
        raise KeyError(
            f"Unknown source model {name!r}; known: {sorted(_SOURCE_MODELS)} "
            "(surrogates register through models.svd.make_svd_source_model)")
    return _SOURCE_MODELS[name]


class DetectorFrame(NamedTuple):
    """What :meth:`DetectorLightCurveModel.frame` hands on: the completed
    parameters {name: [B]} and the source's rows [B, F, T]."""

    parameters: dict
    mags: torch.Tensor


class DetectorLightCurveModel:
    """Batched detector-frame light-curve map for one source model.

    Static configuration (filters, time grid, cosmology tables, quadrature)
    lives on the object as tensors on ``device`` (the CUDA card unless the
    caller passes one). ``model_kwargs`` are static options of the source
    model (e.g. ``jet_type`` or ``n_theta`` of TrPi2018); only those its
    ``mags_fn`` accepts are forwarded, so one config can drive mixed models.
    """

    def __init__(self, model, filters: Sequence[str], sample_times=None,
                 cosmology=None, extinction_law: str = "P92_SMC_host",
                 model_kwargs: dict | None = None, device=None):
        self.device = resolve_device(device)
        if isinstance(model, str):
            model = get_source_model(model)
        self.source: SourceModel = model
        self.filters = list(filters)
        # auto-append the helper model filters that synonym/composite
        # resolution of the requested set needs (observed V on a ugrizy
        # surrogate averages g and r); they ride as EXTRA trailing rows so
        # requested-filter row indices are unchanged
        extra = []
        for f in list(self.filters):
            try:
                kind, payload = resolve_filter(
                    f, available=self.source.filter_names)
            except KeyError:
                continue   # surfaced with full context by the likelihood
            needed = payload if kind == "average" else (payload,)
            for h in needed:
                if h not in self.filters and h not in extra:
                    extra.append(h)
        self.filters += extra
        self.model_kwargs = _filter_kwargs(self.source.mags_fn,
                                           model_kwargs or {})

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device)

        self.nu_0s = f32(filters_to_frequencies(self.filters))
        # extinction is band-averaged over each filter's quadrature, which
        # banded source models also integrate their spectrum over
        nodes, weights = filters_to_quadrature(self.filters)
        self.nu_nodes = f32(nodes)
        self.nu_weights = f32(weights)
        self.sample_times = f32(sample_times if sample_times is not None
                                else self.source.time_grid())
        self.cosmology = cosmology or get_cosmology()
        if extinction_law not in ("P92_SMC_host", "G23_MW"):
            raise ValueError(
                f"unknown extinction_law {extinction_law!r}; use "
                "'P92_SMC_host' or 'G23_MW'")
        self.extinction_law = extinction_law
        # kernel rows -> requested rows; untrained filters become inf rows
        self._rows = self._untrained = None
        if self.source.filter_names is not None:
            src = list(self.source.filter_names)
            self._rows = torch.tensor(
                [src.index(f) if f in src else 0 for f in self.filters],
                device=self.device)
            self._untrained = [i for i, f in enumerate(self.filters)
                               if f not in src]

    def prepare_parameters(self, parameters):
        p = observation_angle_conversion(parameters)
        p = complete_log_parameters(p, self.source.parameter_names)
        like = next(iter(p.values()))
        for key, value in (("luminosity_distance", 1e-5),  # 10 pc
                           ("timeshift", 0.0), ("Ebv", 0.0)):
            if key not in p:
                p[key] = torch.full_like(like, value)
        if "redshift" not in p:
            p["redshift"] = self.cosmology.redshift_at_dl(
                p["luminosity_distance"])
        return p

    def frame(self, parameters):
        """The detector frame up to the source: params {name: [B]} ->
        :class:`DetectorFrame`, the completed parameters (with
        ``redshift`` and ``distance_modulus``) and the source's rows
        [B, F, T] in this detector's filter order, untrained filters inf
        (L / 1e40 erg/s [B, T] for a bolometric source)."""
        with tracing.span("model.detector"):
            t = self.sample_times
            p = self.prepare_parameters(parameters)
            z = p["redshift"]
            p["distance_modulus"] = distance_modulus(p["luminosity_distance"])
            nu_host = self.nu_0s[None, :] * (1.0 + z)[:, None]
            extra = dict(self.model_kwargs)
            if self.source.banded:
                extra["nu_nodes"] = \
                    self.nu_nodes[None] * (1.0 + z)[:, None, None]
                extra["nu_weights"] = self.nu_weights
            if self.source.needs_filters:
                extra["filters"] = self.filters
            with tracing.span("model.source"):
                mags = self.source.mags_fn(p, t, nu_host,
                                           **extra)          # [B, F_src, T]

            if self._rows is not None:
                mags = mags[:, self._rows]
                if self._untrained:
                    mags[:, self._untrained] = math.inf
            return DetectorFrame(p, mags)

    def observe(self, frame):
        """The rest of the detector frame: a :class:`DetectorFrame` ->
        (observable_times [B, T], apparent mags [B, F, T]) with redshift
        stretch, timeshift, extinction, distance modulus and redshift
        correction; a bolometric source gives L / 1e40 erg/s [B, T]."""
        with tracing.span("model.detector"):
            p, mags = frame
            t = self.sample_times
            z = p["redshift"]
            observable_times = t[None, :] * (1.0 + z)[:, None] \
                + p["timeshift"][:, None]
            if self.source.bolometric:
                # energy and time-bin correction (nmma/em/model.py:526-529)
                return observable_times, mags / ((1.0 + z) ** 2)[:, None]

            if self.extinction_law == "G23_MW":
                ext_mag = band_extinction_mags_mw(
                    self.nu_nodes, self.nu_weights, p["Ebv"])       # [B, F]
            else:
                ext_mag = band_extinction_mags_p92_smc(
                    self.nu_nodes, self.nu_weights, p["Ebv"], z)
            redshift_correction = -2.5 * torch.log10(1.0 + z)
            dist_corr = (0.0 if self.source.apparent_amplitude
                         else p["distance_modulus"][:, None, None])
            apparent = (mags + ext_mag[:, :, None] + dist_corr
                        + redshift_correction[:, None, None])

            # rows with <2 finite samples are unusable -> all-inf
            # (nmma/em/model.py:389-396)
            finite_count = torch.isfinite(apparent).sum(dim=2, keepdim=True)
            apparent = torch.where(finite_count >= 2, apparent, math.inf)
            return observable_times, apparent

    def __call__(self, parameters):
        """params {name: [B]} -> (observable_times [B, T], mags [B, F, T]);
        a bolometric model gives L / 1e40 erg/s [B, T] in place of mags."""
        return self.observe(self.frame(parameters))
