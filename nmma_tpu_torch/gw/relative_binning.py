"""Relative-binning (heterodyned) GW likelihood.

PyTorch counterpart of ``nmma_tpu/gw/relative_binning.py`` (the reference's
``RelativeBinningGravitationalWaveTransient`` option,
``nmma/gw/gw_likelihood.py:164-207``, via bilby; Zackay, Dai & Venumadhav
2018): the ratio r(f) = h(f)/h0(f) against a fiducial h0 is smooth, so the
full-band inner products collapse onto a few hundred bins with a per-bin
linear r. The summary data A0, A1, B0, B1 are built once on the host in
float64 from the fiducial (evaluated in f32 on the device, as the reference
does); a call evaluates the ``[B]`` templates at the ``[E]`` bin edges only.

Bin edges follow the power-law phase-difference criterion with PN
exponents gamma = (-5/3, -2/3, 1, 5/3, 7/3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .likelihood import as_batch, log_i0, project_signal, project_signals
from .waveforms import taylorf2_tidal

_GAMMA = np.array([-5.0 / 3.0, -2.0 / 3.0, 1.0, 5.0 / 3.0, 7.0 / 3.0])


def setup_bins(f_min, f_max, chi=1.0, eps=0.5):
    """Frequency bin edges with bounded heterodyne phase error: the level
    sets of delta_psi(f) = chi 2pi sum_i sign(g_i) (f/f*)^{g_i} spaced by
    ``eps`` (Zackay+ 2018 eq. 10-12)."""
    f = np.linspace(f_min, f_max, 10000)
    f_star = np.where(_GAMMA >= 0, f_max, f_min)
    d_psi = chi * 2.0 * np.pi * np.sum(
        np.sign(_GAMMA)[None, :] * (f[:, None] / f_star[None, :])
        ** _GAMMA[None, :], axis=1)
    d_psi = d_psi - d_psi[0]
    n_bins = max(int(np.ceil(d_psi[-1] / eps)), 8)
    targets = np.linspace(0.0, d_psi[-1], n_bins + 1)
    edges = np.interp(targets, d_psi, f)
    edges[0], edges[-1] = f_min, f_max
    return np.unique(edges)


class RelativeBinningGWLikelihood:
    """Heterodyned multi-detector likelihood around a fiducial waveform,
    on ``device`` (the CUDA card unless the caller passes one)."""

    def __init__(self, interferometers, fiducial_parameters,
                 waveform=taylorf2_tidal, trigger_time=0.0, chi=1.0,
                 eps=0.5, phase_marginalization=False, device=None):
        self.device = device = resolve_device(device)
        self.ifos = list(interferometers)
        self.waveform = waveform
        self.trigger_time = float(trigger_time)
        self.phase_marginalization = bool(phase_marginalization)
        self.fiducial_parameters = dict(fiducial_parameters)
        fiducial = as_batch(self.fiducial_parameters, device)

        def host_fiducial(det, freqs):
            f = torch.as_tensor(freqs, dtype=torch.float32, device=device)
            with torch.no_grad():
                h0 = project_signal(det, waveform, f, fiducial,
                                    self.trigger_time)[0]
            return h0.cpu().numpy().astype(np.complex128)

        def put(array, dtype=torch.float32):
            return torch.as_tensor(np.asarray(array), dtype=dtype,
                                   device=device)

        self._summary = []
        for ifo in self.ifos:
            freqs = np.asarray(ifo.frequencies, dtype=np.float64)
            psd = np.asarray(ifo.psd, dtype=np.float64)
            good = np.isfinite(psd) & (psd > 0)
            df = 1.0 / ifo.duration
            h0 = host_fiducial(ifo.detector, freqs)
            data = np.asarray(ifo.strain, dtype=np.complex128)

            edges = setup_bins(freqs[good].min(), freqs[good].max(), chi, eps)
            # each frequency sample's bin
            bin_idx = np.clip(np.searchsorted(edges, freqs, side="right") - 1,
                              0, len(edges) - 2)
            f_mid = 0.5 * (edges[1:] + edges[:-1])

            w = np.where(good & (np.abs(h0) > 0), 4.0 * df / psd, 0.0)
            dh0 = data * np.conj(h0) * w
            hh0 = (np.abs(h0) ** 2) * w
            d_f = freqs - f_mid[bin_idx]

            n_b = len(edges) - 1
            a0 = np.zeros(n_b, dtype=np.complex128)
            a1 = np.zeros(n_b, dtype=np.complex128)
            b0 = np.zeros(n_b)
            b1 = np.zeros(n_b)
            np.add.at(a0, bin_idx, dh0)
            np.add.at(a1, bin_idx, dh0 * d_f)
            np.add.at(b0, bin_idx, hh0)
            np.add.at(b1, bin_idx, hh0 * d_f)

            # the fiducial at the f32 bin edges, for the runtime ratio
            edges_t = put(edges)
            h0_edges = host_fiducial(ifo.detector, edges_t)
            safe = np.where(np.abs(h0_edges) > 0, h0_edges, 1.0)
            self._summary.append(dict(
                edges=edges_t, widths=torch.diff(edges_t),
                a0=put(a0, torch.complex64), a1=put(a1, torch.complex64),
                b0=put(b0), b1=put(b1),
                inv_h0=put(1.0 / safe, torch.complex64),
                h0_ok=put(np.abs(h0_edges) > 0, torch.bool),
            ))
        self._detectors = [ifo.detector for ifo in self.ifos]
        self._sizes = [len(s["edges"]) for s in self._summary]
        self._grid = torch.cat([s["edges"] for s in self._summary])

    @property
    def n_bins(self):
        return [size - 1 for size in self._sizes]

    def log_likelihood_ratio(self, parameters):
        """``[B]`` log-likelihood ratios of a ``[B]`` parameter batch."""
        d_inner_h = h_inner_h = 0.0
        templates = project_signals(self._detectors, self.waveform,
                                    self._grid, self._sizes, parameters,
                                    self.trigger_time)
        for h_edges, s in zip(templates, self._summary):
            r_edges = torch.where(s["h0_ok"], h_edges * s["inv_h0"], 0.0)
            r0 = 0.5 * (r_edges[:, 1:] + r_edges[:, :-1])
            dr = (r_edges[:, 1:] - r_edges[:, :-1]) / s["widths"]
            d_inner_h = d_inner_h + torch.sum(
                s["a0"] * torch.conj(r0) + s["a1"] * torch.conj(dr), dim=-1)
            h_inner_h = h_inner_h + torch.sum(
                s["b0"] * torch.abs(r0) ** 2
                + 2.0 * s["b1"] * (r0 * torch.conj(dr)).real, dim=-1)
        if self.phase_marginalization:
            return log_i0(torch.abs(d_inner_h)) - 0.5 * h_inner_h
        return d_inner_h.real - 0.5 * h_inner_h

    def log_likelihood(self, parameters):
        return self.log_likelihood_ratio(parameters)

    def __call__(self, parameters):
        return self.log_likelihood_ratio(parameters)
