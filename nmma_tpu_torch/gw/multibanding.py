"""Multibanded GW likelihood: per-band decimated inner products.

PyTorch counterpart of ``nmma_tpu/gw/multibanding.py`` (the reference's
``MBGravitationalWaveTransient``, ``nmma/gw/gw_likelihood.py:164-207``,
bilby's implementation of Morisaki 2021, PRD 104, 044062). The remaining
inspiral duration

    tau(f) = 5/(256 pi^(8/3)) (G Mc / c^3)^(-5/3) f^(-8/3)

shrinks fast with frequency, so the band [f_min, f_max] is split at
geometric break points and band b is decimated by
d_b = max(1, floor(T / (gamma (tau(f_b^lo) + t_buffer)))); each inner product
becomes a short decimated sum. The strides and the windowed, decimated data
are built once on the host in float64 (numpy); a call evaluates the ``[B]``
templates at the ~sum_b N_b kept frequencies.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .likelihood import log_i0, project_signal
from .waveforms import MSUN_S, taylorf2_tidal


def remaining_duration(f, chirp_mass):
    """Newtonian time-to-merger [s] from frequency f [Hz]."""
    mc_s = chirp_mass * MSUN_S
    return (5.0 / 256.0 * np.pi ** (-8.0 / 3.0)
            * mc_s ** (-5.0 / 3.0) * np.asarray(f) ** (-8.0 / 3.0))


def build_bands(frequencies, duration, chirp_mass_min, n_bands=8,
                t_buffer=0.5, gamma=4.0):
    """Stride layout for the coarse-grained quadrature.

    Returns ``(starts [K], counts [K])``: stride j covers grid indices
    ``starts[j] : starts[j] + counts[j]``. Band edges are geometric in
    frequency; the stride (decimation factor) per band follows the
    remaining-duration criterion at the band's LOW edge evaluated for
    the smallest chirp mass in the prior (longest signal).
    """
    f = np.asarray(frequencies, dtype=np.float64)
    duration = float(duration)
    edges = np.geomspace(f[0], f[-1], n_bands + 1)
    starts, counts, decs = [], [], []
    for b in range(n_bands):
        lo, hi = edges[b], edges[b + 1]
        sel = np.flatnonzero((f >= lo) & (f < hi if b < n_bands - 1
                                          else f <= hi))
        if not len(sel):
            continue
        tau = remaining_duration(lo, chirp_mass_min) + t_buffer
        dec = max(1, int(duration / (gamma * tau)))
        take = sel[::dec]
        starts.append(take)
        cnt = np.full(len(take), dec, dtype=np.int64)
        # the last stride may overhang the band edge: shrink to the
        # actual number of grid bins it covers (its NOMINAL decimation,
        # carried in decs, still governs the alias-safe window width)
        cnt[-1] = sel[-1] + 1 - take[-1]
        counts.append(cnt)
        decs.append(np.full(len(take), dec, dtype=np.int64))
    return (np.concatenate(starts), np.concatenate(counts),
            np.concatenate(decs))


class MBGWLikelihood:
    """Multibanded matched-filter likelihood (drop-in beside
    GWTransientLikelihood for the non-marginalized + phase-marginalized
    paths)."""

    def __init__(self, interferometers, chirp_mass_min,
                 waveform=taylorf2_tidal, trigger_time=0.0,
                 n_bands=8, t_buffer=0.5, gamma=4.0,
                 phase_marginalization=False, device=None):
        self.device = device = resolve_device(device)
        self.ifos = list(interferometers)
        self.waveform = waveform
        self.trigger_time = float(trigger_time)
        self.phase_marginalization = bool(phase_marginalization)
        self._bands = []
        self.n_kept = 0

        def put(array, dtype=torch.float32):
            return torch.as_tensor(np.asarray(array), dtype=dtype,
                                   device=device)

        for ifo in self.ifos:
            starts, counts, decs = build_bands(
                ifo.frequencies, ifo.duration, chirp_mass_min,
                n_bands=n_bands, t_buffer=t_buffer, gamma=gamma)
            f = np.asarray(ifo.frequencies, dtype=np.float64)
            psd = np.asarray(ifo.psd, dtype=np.float64)
            inv_psd = np.where(np.isfinite(psd) & (psd > 0), 1.0 / psd,
                               0.0)
            d_over_psd = np.asarray(ifo.strain) * inv_psd
            # coarse-grain WITHIN each stride (Morisaki 2021 / bilby
            # convention): noise bins are independent, so the data must
            # be SUMMED over the stride, never subsampled-and-rescaled
            # (that inflates the <n|h> variance by the stride length)
            p_sum = np.add.reduceat(inv_psd, starts)
            # Linear term: smooth d/psd by TIME-WINDOWING around the
            # signal epoch before decimating (Morisaki 2021 §II.B / the
            # bilby MB construction). The band-b content of any template
            # within the time prior occupies a window of length
            # ~tau(f_b_lo) + buffer around t_c, so windowing the data
            # keeps <d|h> exact — signal AND noise parts — while making
            # the integrand bandlimited to the stride rate (a strided
            # SUM of the raw data instead cancels the rapidly rotating
            # signal phase, and subsampling inflates the noise term).
            df_ = 1.0 / float(ifo.duration)
            m = np.round(f / df_).astype(int)     # global grid bins
            n_fft = 2 * (m.max() + 1)
            d_smooth = np.zeros(len(f), dtype=np.complex128)
            # window per distinct NOMINAL decimation factor: a band's
            # shortened final stride (leftover bins at the band edge)
            # must use its band's alias-safe window, not the much wider
            # window its raw leftover count would imply
            for dec in np.unique(decs):
                sel_strides = np.flatnonzero(decs == dec)
                covered = np.concatenate(
                    [np.arange(starts[j], starts[j] + counts[j])
                     for j in sel_strides])
                full = np.zeros(n_fft // 2 + 1, dtype=np.complex128)
                full[m[covered]] = d_over_psd[covered]
                x = np.fft.irfft(full, n_fft)
                # total window = the stride-implied duration 1/(dec df):
                # frequency samples at spacing dec*df exactly represent a
                # time window of that length (wider windows ALIAS the
                # windowed noise back into the decimated sum). The band
                # construction guarantees the signal content
                # (tau + buffer = window/gamma) fits inside.
                n_keep = max(int(np.ceil(n_fft / (2.0 * max(dec, 1)))), 4)
                w = np.zeros(n_fft)
                w[:min(n_keep, n_fft)] = 1.0
                w[-min(n_keep, n_fft):] = 1.0
                sm = np.fft.rfft(x * w)
                d_smooth[covered] = sm[m[covered]]
            # decimated linear weights: D_j = dec_j * d_smooth(f_center)
            centers = starts + counts // 2
            d_sum = counts * d_smooth[np.minimum(centers, len(f) - 1)]
            f_center = f[np.minimum(centers, len(f) - 1)]
            good = inv_psd[inv_psd > 0]
            psd_ref = 1.0 / float(np.median(good)) if good.size else 1.0
            asd_ref = float(np.sqrt(psd_ref))
            # stored normalised by a reference ASD so every array is
            # O(1)-O(100) in f32 (1/PSD alone is ~1e46 and overflows)
            self._bands.append(dict(
                freqs=put(f_center),
                d_norm=put(d_sum * asd_ref, torch.complex64),
                p_norm=put(p_sum * psd_ref),
                inv_asd_ref=1.0 / asd_ref,
                df=1.0 / float(ifo.duration)))
            self.n_kept += len(starts)

    def log_likelihood_ratio(self, parameters):
        """``[B]`` log-likelihood ratios: <d|h> ~ 4 df sum_j conj(D_j)
        h(f_j), D_j = sum_stride d/psd; <h|h> ~ 4 df sum_j |h(f_j)|^2 P_j,
        P_j = sum_stride 1/psd (the waveform is smooth over a stride by
        the band construction)."""
        d_inner_h = h_inner_h = 0.0
        for ifo, band in zip(self.ifos, self._bands):
            h = project_signal(ifo.detector, self.waveform, band["freqs"],
                               parameters, self.trigger_time)
            h_w = h * band["inv_asd_ref"]
            d_inner_h = d_inner_h + 4.0 * band["df"] * torch.sum(
                torch.conj(band["d_norm"]) * h_w, dim=-1)
            h_inner_h = h_inner_h + 4.0 * band["df"] * torch.sum(
                band["p_norm"] * (torch.conj(h_w) * h_w).real, dim=-1)
        if self.phase_marginalization:
            return log_i0(torch.abs(d_inner_h)) - 0.5 * h_inner_h
        return d_inner_h.real - 0.5 * h_inner_h

    def log_likelihood(self, parameters):
        return self.log_likelihood_ratio(parameters)

    def __call__(self, parameters):
        return self.log_likelihood_ratio(parameters)
