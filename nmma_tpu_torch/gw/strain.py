"""Local strain-data ingestion, conditioning, and PSD estimation.

The port's copy of ``nmma_tpu/gw/strain.py`` (numpy, float64, on the host);
``h5py`` is imported only to read HDF5 files.

Counterpart of the reference's ``gw/gw_inputs.py`` (bilby_pipe
``DataGenerationInput``: strain fetch, PSD estimation, interferometer
setup — ``nmma/gw/gw_inputs.py:5-36``). The network fetch (GWOSC) is
``fetch.py``; this module is the local path: read time-domain strain
from disk (GWOSC-style HDF5, one/two-column ASCII, npy/npz, gwf), estimate
a PSD from off-source data with the median-Welch method, Tukey-window +
FFT the analysis segment, and assemble ``InterferometerData`` ready for
the likelihoods.

All of this is host-side, one-time preparation (NumPy, float64); the
frequency-domain products it emits are the static tensors the batched
likelihood moves to the device.
"""

from __future__ import annotations

import os

import numpy as np


class StrainSeries:
    """Minimal time-series container: start GPS time, sample rate, data."""

    def __init__(self, data, t0, sample_rate):
        self.data = np.asarray(data, dtype=np.float64)
        self.t0 = float(t0)
        self.sample_rate = float(sample_rate)

    @property
    def duration(self):
        return len(self.data) / self.sample_rate

    @property
    def times(self):
        return self.t0 + np.arange(len(self.data)) / self.sample_rate

    def crop(self, start, end):
        i0 = int(round((start - self.t0) * self.sample_rate))
        i1 = int(round((end - self.t0) * self.sample_rate))
        if i0 < 0 or i1 > len(self.data):
            raise ValueError(
                f"requested [{start}, {end}] outside data span "
                f"[{self.t0}, {self.t0 + self.duration}]")
        return StrainSeries(self.data[i0:i1], self.t0 + i0 / self.sample_rate,
                            self.sample_rate)


def read_strain_file(path, channel=None, t0=None, sample_rate=None):
    """Read time-domain strain from disk -> :class:`StrainSeries`.

    Formats (by extension):

    - ``.hdf5/.h5``: GWOSC bulk-data layout (``strain/Strain`` with
      ``Xspacing``/``Xstart`` attrs, ``meta/GPSstart``) or any file with a
      single 1-D dataset named by ``channel``.
    - ``.txt/.dat/.csv/.gz``: two columns (time, strain), or one column
      with ``t0``/``sample_rate`` given explicitly or parseable from
      GWOSC-style ``# GPS start``/``# sample rate`` header comments.
    - ``.npy/.npz``: 1-D array (needs ``t0``+``sample_rate``) or an
      archive with ``strain``/``data``, ``t0``, ``sample_rate`` entries.

    - ``.gwf``: IGWD binary frames via :mod:`nmma_tpu_torch.gw.gwf` (the
      reference reads these through gwpy/frameCPP).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gz":
        ext = os.path.splitext(path[:-3])[1].lower()
    if ext in (".hdf5", ".h5", ".hdf"):
        return _read_hdf5(path, channel, t0, sample_rate)
    if ext in (".npy",):
        if t0 is None or sample_rate is None:
            raise ValueError(".npy strain needs t0= and sample_rate=")
        return StrainSeries(np.load(path), t0, sample_rate)
    if ext in (".npz",):
        archive = np.load(path)
        data = archive[channel] if channel and channel in archive else \
            archive[[k for k in ("strain", "data")
                     if k in archive][0]]
        return StrainSeries(
            data,
            t0 if t0 is not None else float(archive["t0"]),
            sample_rate if sample_rate is not None
            else float(archive["sample_rate"]))
    if ext == ".gwf":
        from .gwf import read_gwf
        return read_gwf(path, channel=channel)
    return _read_ascii(path, t0, sample_rate)


def _read_hdf5(path, channel, t0=None, sample_rate=None):
    import h5py
    with h5py.File(path, "r") as f:
        if channel and channel in f:
            node = f[channel]
            data = np.asarray(node)
            dx = node.attrs.get("Xspacing")
            x0 = node.attrs.get("Xstart")
            # caller-supplied metadata backs up missing GWOSC attrs
            # (generic 1-D datasets are valid with explicit t0/rate)
            if dx is None and sample_rate is not None:
                dx = 1.0 / float(sample_rate)
            if x0 is None:
                x0 = t0
            if dx is None:
                raise ValueError(f"dataset {channel} lacks Xspacing attr "
                                 f"(pass sample_rate=)")
            return StrainSeries(data, 0.0 if x0 is None else float(x0),
                                1.0 / float(dx))
        if "strain" in f and "Strain" in f["strain"]:
            node = f["strain"]["Strain"]
            data = np.asarray(node)
            dx = float(node.attrs["Xspacing"])
            t0 = float(node.attrs.get("Xstart",
                                      f["meta"]["GPSstart"][()]
                                      if "meta" in f else 0.0))
            return StrainSeries(data, t0, 1.0 / dx)
    raise ValueError(f"no strain dataset found in {path} "
                     f"(pass channel=<dataset path>)")


def _read_ascii(path, t0, sample_rate):
    header_t0, header_rate = None, None
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rt") as f:
        head = [f.readline() for _ in range(10)]
    for line in head:
        if not line.startswith("#"):
            continue
        low = line.lower()
        for token in ("gps start", "gpsstart", "starting gps"):
            if token in low:
                vals = [w for w in line.replace("=", " ").split()
                        if _is_number(w)]
                if vals:
                    header_t0 = float(vals[0])
        if "sample" in low and ("rate" in low or "frequency" in low):
            vals = [w for w in line.replace("=", " ").split()
                    if _is_number(w)]
            if vals:
                header_rate = float(vals[-1])
    base = path[:-3] if path.endswith(".gz") else path
    raw = np.loadtxt(path, comments="#",
                     delimiter="," if base.endswith(".csv") else None)
    if raw.ndim == 2 and raw.shape[1] >= 2:
        times, data = raw[:, 0], raw[:, 1]
        dt = np.median(np.diff(times))
        return StrainSeries(data, times[0], 1.0 / dt)
    t0 = t0 if t0 is not None else header_t0
    sample_rate = sample_rate if sample_rate is not None else header_rate
    if t0 is None or sample_rate is None:
        raise ValueError(
            f"single-column strain file {path} needs t0 and sample_rate "
            f"(flags or GWOSC-style header comments)")
    return StrainSeries(raw.ravel(), t0, sample_rate)


def _is_number(w):
    try:
        float(w)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# PSD estimation
# ---------------------------------------------------------------------------

def median_bias(n):
    """Bias of the median of ``n`` exponentially-distributed periodograms
    relative to the mean (Allen et al. 2005): sum_{k=1}^{n} (-1)^{k+1}/k."""
    k = np.arange(1, int(n) + 1)
    return np.sum((-1.0) ** (k + 1) / k)


def welch_psd(series: StrainSeries, segment_duration, overlap=0.5,
              method="median", window="hann"):
    """One-sided PSD via (median-)Welch averaging of Hann-windowed
    periodograms — the standard strain PSD estimator (gwpy/bilby_pipe
    ``median`` method used by the reference's data generation).

    Returns ``(frequencies, psd)`` with ``df = 1/segment_duration``.
    """
    fs = series.sample_rate
    nper = int(round(segment_duration * fs))
    step = max(int(round(nper * (1.0 - overlap))), 1)
    data = series.data
    n_seg = 1 + max((len(data) - nper) // step, 0)
    if len(data) < nper:
        raise ValueError("data shorter than one PSD segment")
    if window == "hann":
        win = np.hanning(nper)
    else:
        win = np.ones(nper)
    scale = 2.0 / (fs * np.sum(win ** 2))
    periodograms = np.empty((n_seg, nper // 2 + 1))
    for i in range(n_seg):
        seg = data[i * step:i * step + nper] * win
        spec = np.fft.rfft(seg)
        periodograms[i] = scale * np.abs(spec) ** 2
    freqs = np.fft.rfftfreq(nper, d=1.0 / fs)
    if method == "median" and n_seg > 1:
        psd = np.median(periodograms, axis=0) / median_bias(n_seg)
    else:
        psd = np.mean(periodograms, axis=0)
    # DC and Nyquist bins are half-counted in the one-sided convention
    # (the last rfft bin IS Nyquist only for even segment lengths)
    psd[0] *= 0.5
    if nper % 2 == 0:
        psd[-1] *= 0.5
    return freqs, psd


def tukey_window(n, alpha):
    """Tukey (tapered-cosine) window, the standard strain analysis
    window (bilby_pipe default roll-off 0.4 s)."""
    if alpha <= 0:
        return np.ones(n)
    if alpha >= 1:
        return np.hanning(n)
    t = np.arange(n) / (n - 1.0)
    w = np.ones(n)
    left = t < alpha / 2.0
    right = t >= 1.0 - alpha / 2.0
    w[left] = 0.5 * (1 + np.cos(np.pi * (2 * t[left] / alpha - 1)))
    w[right] = 0.5 * (1 + np.cos(np.pi * (2 * t[right] / alpha - 2 / alpha
                                          + 1)))
    return w


def fft_analysis_segment(series: StrainSeries, roll_off=0.4):
    """Tukey-window and FFT one analysis segment to the frequency domain.

    Returns ``(frequencies, fd_strain)`` with the continuous-FT
    normalization ``h(f) = dt * FFT`` used by the Whittle likelihood.
    """
    n = len(series.data)
    alpha = 2.0 * roll_off / series.duration
    win = tukey_window(n, alpha)
    fd = np.fft.rfft(series.data * win) / series.sample_rate
    freqs = np.fft.rfftfreq(n, d=1.0 / series.sample_rate)
    return freqs, fd


def interferometer_from_data(name, series: StrainSeries, trigger_time,
                             duration=128.0, post_trigger=2.0,
                             f_min=20.0, f_max=1024.0, psd=None,
                             psd_series=None, psd_duration=None,
                             roll_off=0.4):
    """Build :class:`InterferometerData` from time-domain strain.

    The analysis segment is ``[trigger + post_trigger - duration,
    trigger + post_trigger]`` (bilby_pipe convention). The PSD comes
    from, in order of preference: an explicit ``psd`` (freqs, psd) tuple,
    a dedicated off-source ``psd_series``, or the data preceding the
    analysis segment (``psd_duration`` seconds, default ``4 x duration``),
    median-Welch averaged in segments of the analysis duration.
    """
    from .likelihood import InterferometerData

    seg_start = trigger_time + post_trigger - duration
    segment = series.crop(seg_start, trigger_time + post_trigger)
    freqs, fd = fft_analysis_segment(segment, roll_off=roll_off)

    if psd is not None:
        psd_f, psd_v = np.asarray(psd[0]), np.asarray(psd[1])
    else:
        if psd_series is None:
            psd_duration = psd_duration or min(
                4.0 * duration, seg_start - series.t0)
            if psd_duration < 2.0 * duration:
                raise ValueError(
                    f"not enough off-source data for PSD estimation "
                    f"({psd_duration:.0f}s available, need >= "
                    f"{2 * duration:.0f}s); pass psd= or psd_series=")
            psd_series = series.crop(seg_start - psd_duration, seg_start)
        psd_f, psd_v = welch_psd(psd_series, segment_duration=duration,
                                 method="median")

    band = (freqs >= f_min) & (freqs <= f_max)
    psd_interp = np.interp(freqs[band], psd_f, psd_v)
    # Tukey window factor (bilby strain_data.window_factor): the
    # analysis segment is windowed, so its NOISE power is the
    # unwindowed-noise PSD times mean(w^2) — without this every inner
    # product is biased high by 1/mean(w^2) (~0.4% at the 128 s
    # default, ~14% at duration=4 s with the 0.4 s roll-off)
    alpha = 2.0 * roll_off / segment.duration
    win = tukey_window(len(segment.data), alpha)
    psd_interp = psd_interp * float(np.mean(win ** 2))
    # rotate to the template convention: the likelihood's waveforms put
    # the merger at zero time offset, while in the segment the trigger
    # sits (duration - post_trigger) after the start — undo that linear
    # phase so geocent_time is measured relative to the trigger
    t_rel = duration - post_trigger
    rotated = fd[band] * np.exp(2j * np.pi * freqs[band] * t_rel)
    return InterferometerData(
        name=name, frequencies=freqs[band], strain=rotated,
        psd=psd_interp, duration=segment.duration)


def interferometer_from_files(name, strain_file, trigger_time,
                              channel=None, psd_file=None, **kwargs):
    """File-level convenience wrapper around
    :func:`interferometer_from_data`. ``psd_file`` is a two-column
    (frequency, PSD) ASCII file (the standard detector-PSD format)."""
    series = read_strain_file(strain_file, channel=channel)
    psd = None
    if psd_file:
        tab = np.loadtxt(psd_file)
        psd = (tab[:, 0], tab[:, 1])
    return interferometer_from_data(name, series, trigger_time, psd=psd,
                                    **kwargs)


def calibration_draws_from_envelope(envelope, frequencies, n_draws=100,
                                    n_nodes=10, seed=0):
    """Complex calibration-response draws [n_draws, F] from an
    uncertainty envelope (the standard LVK calibration-envelope table:
    frequency, amplitude median/lower/upper, phase median/lower/upper —
    bilby's spline-calibration input).

    Smooth draws: Gaussian node samples at ``n_nodes`` log-spaced
    frequencies (sigma from the 68% envelope half-width), linearly
    interpolated across the band — the draw set feeds
    ``GWTransientLikelihood(calibration_draws=...)``.
    """
    if isinstance(envelope, str):
        table = np.loadtxt(envelope)
    else:
        table = np.asarray(envelope)
    f_env = table[:, 0]
    amp_med, phase_med = table[:, 1], table[:, 2]
    if table.shape[1] >= 7:
        amp_sig = 0.5 * (table[:, 5] - table[:, 3])
        phase_sig = 0.5 * (table[:, 6] - table[:, 4])
    else:
        amp_sig = np.full_like(amp_med, 0.05)
        phase_sig = np.full_like(phase_med, 0.05)

    freqs = np.asarray(frequencies)
    nodes = np.geomspace(freqs[0], freqs[-1], n_nodes)
    rng = np.random.default_rng(seed)
    draws = np.empty((n_draws, len(freqs)), dtype=np.complex128)
    for d in range(n_draws):
        a_nodes = np.interp(nodes, f_env, amp_med) + \
            rng.normal(size=n_nodes) * np.interp(nodes, f_env, amp_sig)
        p_nodes = np.interp(nodes, f_env, phase_med) + \
            rng.normal(size=n_nodes) * np.interp(nodes, f_env, phase_sig)
        amp = np.interp(freqs, nodes, a_nodes)
        phase = np.interp(freqs, nodes, p_nodes)
        draws[d] = amp * np.exp(1j * phase)
    return draws
