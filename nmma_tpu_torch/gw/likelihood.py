"""Gravitational-wave transient likelihood: batched Whittle inner products.

PyTorch counterpart of ``nmma_tpu/gw/likelihood.py`` (the reference's
``GravitationalWaveTransientLikelihood``, ``nmma/gw/gw_likelihood.py
:164-247``, bilby's ``GravitationalWaveTransient`` around LAL waveforms).
Strain, PSD and frequency grids are static tensors on the device; a call
takes a ``[B]`` batch of parameters and returns ``[B]`` log-likelihood
ratios

    log L = sum_ifo [ <d, h> - <h, h>/2 ],   <a, b> = 4 Re sum a* b / PSD df

(the noise evidence dropped, as the reference's samplers use
``log_likelihood_ratio``), with the phase (analytic ln I0), distance
(a static grid), time (one zero-padded FFT per detector) and calibration
(joint response draws) marginalisations. The templates are ``[B, F]``
complex64; the batch runs in chunks of ``chunk_rows`` live points so that
each chunk's largest ``[rows, F]`` (or ``[rows, n_fft]``) intermediate stays
within ``DENSE_CHUNK_BYTES``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .detectors import (Detector, antenna_patterns, get_detector,
                        gmst_from_gps, site_tensors, source_direction,
                        time_delays, wave_frame)
from .waveforms import aligo_design_psd, taylorf2_tidal

# bytes of one complex64 [rows, F] (or [rows, n_fft], or [rows, draws, F])
# array of a chunk: the template and its products are a few such arrays,
# the waveform's f32 intermediates a few tens of half that size
DENSE_CHUNK_BYTES = 1 << 30


def batch_parameter(parameters, key, default, like):
    """``parameters[key]`` (or ``default``) as an f32 ``[B]`` (or ``[1]``)
    tensor on ``like``'s device."""
    value = parameters.get(key, default)
    return torch.as_tensor(value, dtype=torch.float32,
                           device=like.device).reshape(-1)


def as_batch(parameters, device):
    """A dict of numbers or arrays -> f32 ``[B]`` tensors on ``device``
    (strings dropped)."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=torch.float32, device=device).reshape(-1)
            for k, v in parameters.items()
            if not isinstance(v, str)}


def batch_size(parameters):
    return max((v.shape[0] for v in parameters.values()
                if isinstance(v, torch.Tensor) and v.ndim >= 1), default=1)


def slice_batch(parameters, start, stop, size):
    """The rows ``start:stop`` of every ``[size]`` entry; others as they
    are."""
    return {k: v[start:stop] if isinstance(v, torch.Tensor) and v.ndim >= 1
            and v.shape[0] == size else v for k, v in parameters.items()}


def log_i0(x):
    """ln I0(x), overflow-safe."""
    return torch.log(torch.special.i0e(x)) + torch.abs(x)


@dataclass
class InterferometerData:
    """Frequency-domain strain and PSD of one interferometer (numpy, as the
    JAX package's: a dump or a test hands the same arrays to both)."""

    name: str
    frequencies: np.ndarray      # [F]
    strain: np.ndarray           # complex [F]
    psd: np.ndarray              # [F]
    duration: float

    @property
    def detector(self) -> Detector:
        return get_detector(self.name)

    @classmethod
    def zero_noise_injection(cls, name, injection_parameters, duration=128.0,
                             sampling_frequency=4096.0, f_min=20.0,
                             f_max=2048.0, psd=None,
                             waveform=taylorf2_tidal, trigger_time=0.0,
                             device=None):
        """Synthetic data: the projected signal with a zero noise
        realisation (reference zero-noise injections,
        nmma/joint/injection_handling.py:283-344), computed on ``device``
        (the CUDA card unless the caller passes one)."""
        device = resolve_device(device)
        df = 1.0 / duration
        freqs = np.arange(0.0, sampling_frequency / 2.0 + df, df)
        band = (freqs >= f_min) & (freqs <= f_max)
        freqs = freqs[band]
        if psd is None:
            psd = aligo_design_psd(freqs)
        f = torch.as_tensor(freqs, dtype=torch.float32, device=device)
        with torch.no_grad():
            projected = project_signal(
                get_detector(name), waveform, f,
                as_batch(injection_parameters, device), trigger_time)[0]
        strain = projected.cpu().numpy().astype(np.complex128)
        return cls(name=name, frequencies=freqs, strain=strain, psd=psd,
                   duration=duration)


def project_signals(detectors, waveform, grid, sizes, parameters,
                    trigger_time):
    """Detector-frame strain ``[B, F_i]`` of a ``[B]`` parameter batch for
    each detector, on its frequencies: ``grid`` is the detectors' ``[F_i]``
    grids concatenated (``sizes`` their lengths), so the waveform, which is
    elementwise in frequency, is evaluated once for all of them, and the
    sky's wave frame once for all the detectors."""
    h_plus, h_cross = waveform(grid, parameters)
    geocent = batch_parameter(parameters, "geocent_time", 0.0, grid)
    # f32 GPS time, as the reference: an ulp is 128 s at 1.2e9 s
    gmst = gmst_from_gps(trigger_time + geocent)
    ra = batch_parameter(parameters, "ra", 0.0, grid)
    dec = batch_parameter(parameters, "dec", 0.0, grid)
    psi = batch_parameter(parameters, "psi", 0.0, grid)
    responses, vertices = site_tensors(tuple(d.name for d in detectors),
                                       grid.device)
    f_plus, f_cross = antenna_patterns(responses,
                                       *wave_frame(ra, dec, psi, gmst))
    dt = time_delays(vertices, source_direction(ra, dec, gmst)) + \
        geocent[:, None]                                       # [B, I]
    one = torch.ones((), device=grid.device)
    out = []
    for i, (f, hp, hc) in enumerate(zip(grid.split(sizes),
                                        h_plus.split(sizes, dim=-1),
                                        h_cross.split(sizes, dim=-1))):
        shift = torch.polar(one, (-2.0 * math.pi * f)[None, :]
                            * dt[:, i:i + 1])
        out.append((f_plus[:, i:i + 1] * hp + f_cross[:, i:i + 1] * hc)
                   * shift)
    return out


def project_signal(detector, waveform, frequencies, parameters,
                   trigger_time):
    """Detector-frame strain ``[B, F]`` of a ``[B]`` parameter batch on the
    ``[F]`` frequencies."""
    return project_signals([detector], waveform, frequencies,
                           [frequencies.shape[0]], parameters,
                           trigger_time)[0]


def distance_marginalized_logl(d_inner_h, h_inner_h, ref_distance,
                               distance_grid, log_prior_weights,
                               phase_marginalization=False):
    """Marginalise over luminosity distance on a static grid: with inner
    products at ``ref_distance`` ``[B]``, <d,h>(d) = <d,h> ref/d and
    <h,h>(d) = <h,h> (ref/d)^2; logsumexp over the ``[G]`` grid."""
    ratio = ref_distance[:, None] / distance_grid[None, :]
    if phase_marginalization:
        kernel = log_i0(torch.abs(d_inner_h)[:, None] * ratio)
    else:
        kernel = d_inner_h.real[:, None] * ratio
    logl = kernel - 0.5 * h_inner_h[:, None] * ratio**2 + log_prior_weights
    return torch.logsumexp(logl, dim=-1)


class GWTransientLikelihood:
    """Coherent multi-detector matched-filter likelihood on ``device`` (the
    CUDA card unless the caller passes one).

    Phase marginalisation is analytic (ln I0), distance a static grid, and
    time an FFT over the coalescence-time shift: the zero-padded band
    integrand is FFT'd once per call, giving <d|h>(dt) on a grid of spacing
    <= 1/(2 f_max), and the logsumexp runs over ``time_prior_bounds``."""

    def __init__(self, interferometers, waveform=taylorf2_tidal,
                 trigger_time=0.0, phase_marginalization=False,
                 distance_marginalization=False,
                 distance_prior=None, distance_bounds=(10.0, 500.0),
                 n_distance=256, time_marginalization=False,
                 time_prior_bounds=(-0.1, 0.1), calibration_draws=None,
                 device=None):
        self.device = device = resolve_device(device)
        self.ifos = list(interferometers)
        self.waveform = waveform
        self.trigger_time = float(trigger_time)
        self.phase_marginalization = bool(phase_marginalization)
        self.distance_marginalization = bool(distance_marginalization)
        self.time_marginalization = bool(time_marginalization)
        # calibration marginalisation: per-ifo complex response draws
        # [D, F]; the likelihood is the logmeanexp over the D joint draws
        self.calibration_marginalization = calibration_draws is not None
        if self.calibration_marginalization and self.time_marginalization:
            raise ValueError(
                "time_marginalization together with calibration_draws is "
                "not supported: marginalize time numerically via the prior "
                "or drop one of the two")

        def put(array, dtype=torch.float32):
            return torch.as_tensor(np.asarray(array), dtype=dtype,
                                   device=device)

        self._cal = []
        self.n_cal_draws = 1
        if calibration_draws is not None:
            matched = [ifo.name for ifo in self.ifos
                       if ifo.name in calibration_draws]
            if calibration_draws and not matched:
                raise ValueError(
                    f"calibration_draws keys {sorted(calibration_draws)} "
                    f"match no interferometer "
                    f"({[i.name for i in self.ifos]})")
            n_draws = {np.asarray(calibration_draws[name]).shape[0]
                       for name in matched}
            if len(n_draws) > 1:
                raise ValueError("calibration draws must share a draw count")
            self.n_cal_draws = n_draws.pop() if n_draws else 1
            for ifo in self.ifos:
                draws = calibration_draws.get(ifo.name)
                if draws is None:
                    cal = np.ones((self.n_cal_draws, len(ifo.frequencies)),
                                  dtype=np.complex128)
                else:
                    cal = np.asarray(draws, dtype=np.complex128)
                    if cal.shape[1] != len(ifo.frequencies):
                        raise ValueError(
                            f"{ifo.name}: {cal.shape[1]} calibration "
                            f"frequencies != {len(ifo.frequencies)}")
                self._cal.append(put(cal, torch.complex64))
        if self.distance_marginalization:
            grid = np.linspace(distance_bounds[0], distance_bounds[1],
                               n_distance)
            if distance_prior is None:
                dens = grid**2          # uniform-in-volume default
            else:
                dens = np.asarray([distance_prior(d) for d in grid])
            weights = dens / dens.sum()
            self._dist_grid = put(grid)
            self._dist_log_w = put(np.log(weights + 1e-300))
        n_fft = 0
        if self.time_marginalization:
            # each ifo's band integrand is scattered into a full [0, f_max]
            # grid; the FFT length is the next power of two with
            # dt = duration / n fine enough to resolve f_max
            self._tm_offsets, self._tm_n = [], []
            t_lo, t_hi = time_prior_bounds
            for ifo in self.ifos:
                df = 1.0 / ifo.duration
                m0 = int(round(float(ifo.frequencies[0]) / df))
                m_max = int(round(float(ifo.frequencies[-1]) / df))
                self._tm_offsets.append(m0)
                self._tm_n.append(1 << int(np.ceil(np.log2(2 * m_max + 2))))
            if len(set(self._tm_n)) != 1 or \
                    len({ifo.duration for ifo in self.ifos}) != 1:
                raise ValueError("time marginalization needs matching "
                                 "durations/frequency grids across ifos")
            n_fft = self._tm_n[0]
            dur = self.ifos[0].duration
            dt_grid = np.arange(n_fft) / n_fft * dur
            dt_grid = np.where(dt_grid > dur / 2, dt_grid - dur, dt_grid)
            sel = np.where((dt_grid >= t_lo) & (dt_grid <= t_hi))[0]
            self._tm_idx = torch.as_tensor(sel, device=device)
            self._tm_log_w = -float(np.float32(np.log(np.float32(len(sel)))))
        self._detectors = [ifo.detector for ifo in self.ifos]
        self._sizes = [len(ifo.frequencies) for ifo in self.ifos]
        self._grid = put(np.concatenate([ifo.frequencies
                                         for ifo in self.ifos]))
        # float32 cannot hold 1/PSD (~1e48): whiten with the inverse ASD
        # (~1e24), so strains become O(10) whitened amplitudes
        self._inv_asd, self._white_data = [], []
        self._df = [1.0 / ifo.duration for ifo in self.ifos]
        for ifo in self.ifos:
            psd = np.asarray(ifo.psd, dtype=np.float64)
            inv_asd = np.where(np.isfinite(psd) & (psd > 0),
                               1.0 / np.sqrt(psd), 0.0)
            self._inv_asd.append(put(inv_asd))
            white = np.asarray(ifo.strain) * inv_asd
            # the JAX package ships real and imaginary parts as f32
            self._white_data.append(torch.complex(put(white.real),
                                                  put(white.imag)))
        # the widest complex64 row of a chunk: the templates of all the
        # detectors (times the calibration draws), or one padded FFT row
        widest = max(sum(self._sizes) * self.n_cal_draws, n_fft)
        self.chunk_rows = max(1, DENSE_CHUNK_BYTES // (8 * widest))

    # -- per-chunk pieces ----------------------------------------------------
    def _whitened_templates(self, parameters):
        """The whitened templates ``[b, F_i]`` of every detector."""
        templates = project_signals(self._detectors, self.waveform,
                                    self._grid, self._sizes, parameters,
                                    self.trigger_time)
        return [h * inv_asd for h, inv_asd in zip(templates, self._inv_asd)]

    def _inner_products(self, parameters):
        """(<d,h> complex [b], <h,h> [b]) summed over the detectors."""
        d_inner_h = h_inner_h = 0.0
        for h_w, d_w, df in zip(self._whitened_templates(parameters),
                                self._white_data, self._df):
            d_inner_h = d_inner_h + 4.0 * df * torch.sum(
                torch.conj(d_w) * h_w, dim=-1)
            h_inner_h = h_inner_h + 4.0 * df * torch.sum(
                (torch.conj(h_w) * h_w).real, dim=-1)
        return d_inner_h, h_inner_h

    def _chunk_logl(self, parameters):
        if self.time_marginalization:
            return self._time_marginalized_logl(parameters)
        if self.calibration_marginalization:
            return self._calibration_marginalized_logl(parameters)
        d_inner_h, h_inner_h = self._inner_products(parameters)
        if self.distance_marginalization:
            return distance_marginalized_logl(
                d_inner_h, h_inner_h,
                batch_parameter(parameters, "luminosity_distance", None,
                                self._dist_grid),
                self._dist_grid, self._dist_log_w,
                self.phase_marginalization)
        if self.phase_marginalization:
            # ln int dphi/2pi exp(Re[<d,h> e^{2i phi}]) = ln I0(|<d,h>|)
            return log_i0(torch.abs(d_inner_h)) - 0.5 * h_inner_h
        return d_inner_h.real - 0.5 * h_inner_h

    def time_series(self, parameters):
        """(<d|h>(dt) ``[b, n_t]`` on the time-prior grid, <h|h> ``[b]``)."""
        dh_t = h_inner_h = 0.0
        for i, h_w in enumerate(self._whitened_templates(parameters)):
            df = self._df[i]
            integrand = 4.0 * df * torch.conj(self._white_data[i]) * h_w
            h_inner_h = h_inner_h + 4.0 * df * torch.sum(
                (torch.conj(h_w) * h_w).real, dim=-1)
            m0 = self._tm_offsets[i]
            padded = torch.zeros((integrand.shape[0], self._tm_n[i]),
                                 dtype=integrand.dtype,
                                 device=integrand.device)
            padded[:, m0:m0 + integrand.shape[1]] = integrand
            series = torch.fft.fft(padded, dim=-1)
            dh_t = dh_t + series[:, self._tm_idx]
        return dh_t, h_inner_h

    def _time_marginalized_logl(self, parameters):
        """<d|h>(dt) via one zero-padded FFT per ifo, then logsumexp over
        the coalescence-time window (x the phase/distance marginals)."""
        dh_t, h_inner_h = self.time_series(parameters)
        if self.distance_marginalization:
            ratio = (batch_parameter(parameters, "luminosity_distance", None,
                                     self._dist_grid)[:, None]
                     / self._dist_grid[None, :])              # [b, G]
            dh_td = dh_t[:, :, None] * ratio[:, None, :]      # [b, T, G]
            if self.phase_marginalization:
                kernel = log_i0(torch.abs(dh_td))
            else:
                kernel = dh_td.real
            logl = (kernel - 0.5 * h_inner_h[:, None, None]
                    * ratio[:, None, :] ** 2
                    + self._dist_log_w + self._tm_log_w)
            return torch.logsumexp(logl.flatten(1), dim=-1)
        if self.phase_marginalization:
            kernel = log_i0(torch.abs(dh_t))
        else:
            kernel = dh_t.real
        return torch.logsumexp(kernel + self._tm_log_w, dim=-1) - \
            0.5 * h_inner_h

    def _calibration_marginalized_logl(self, parameters):
        """logmeanexp over joint calibration-response draws; the phase and
        distance marginalisations broadcast over the draw axis."""
        n_d = self.n_cal_draws
        d_inner_h = h_inner_h = 0.0
        for i, h_w in enumerate(self._whitened_templates(parameters)):
            df = self._df[i]
            h_cal = h_w[:, None, :] * self._cal[i][None]       # [b, D, F]
            d_inner_h = d_inner_h + 4.0 * df * torch.sum(
                torch.conj(self._white_data[i]) * h_cal, dim=-1)
            h_inner_h = h_inner_h + 4.0 * df * torch.sum(
                (torch.conj(h_cal) * h_cal).real, dim=-1)
        log_w = -float(np.float32(np.log(np.float32(n_d))))
        if self.distance_marginalization:
            ratio = (batch_parameter(parameters, "luminosity_distance", None,
                                     self._dist_grid)[:, None]
                     / self._dist_grid[None, :])              # [b, G]
            dh = d_inner_h[:, :, None] * ratio[:, None, :]    # [b, D, G]
            if self.phase_marginalization:
                kernel = log_i0(torch.abs(dh))
            else:
                kernel = dh.real
            logl = (kernel - 0.5 * h_inner_h[:, :, None]
                    * ratio[:, None, :] ** 2 + self._dist_log_w + log_w)
            return torch.logsumexp(logl.flatten(1), dim=-1)
        if self.phase_marginalization:
            kernel = log_i0(torch.abs(d_inner_h))
        else:
            kernel = d_inner_h.real
        return torch.logsumexp(kernel - 0.5 * h_inner_h + log_w, dim=-1)

    # -- public ----------------------------------------------------------------
    def n_chunks(self, batch):
        return -(-batch // self.chunk_rows)

    def _chunked(self, fn, parameters):
        size = batch_size(parameters)
        return torch.cat([
            fn(slice_batch(parameters, s, s + self.chunk_rows, size))
            for s in range(0, size, self.chunk_rows)])

    def log_likelihood_ratio(self, parameters):
        """``[B]`` log-likelihood ratios of a ``[B]`` parameter batch."""
        return self._chunked(self._chunk_logl, parameters)

    def log_likelihood(self, parameters):
        return self.log_likelihood_ratio(parameters)

    def __call__(self, parameters):
        return self.log_likelihood_ratio(parameters)

    def optimal_snr(self, parameters):
        """Quadrature network SNR ``[B]``."""
        return self._chunked(
            lambda p: torch.sqrt(self._inner_products(p)[1]), parameters)
