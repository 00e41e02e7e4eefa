"""Survey cadences and light-curve validation (host numpy).

Port of ``nmma_tpu/strategies.py``: the reference's ``ztf_strategy``,
``rubin_strategy`` and ``adjust_lc_for_telescopes``
(``nmma/em/lightcurve_generation.py:899-963``), ``validate_lightcurve``
(``nmma/em/lightcurve_handling.py:540-581``) and the data-driven ZTF
observing model (``adjust_data_for_ztf``, :968-1128). Everything here runs
on the host: epochs, limiting magnitudes and uncertainties are drawn from
numpy and scipy generators in the JAX package's order, so one seed gives
both packages the same epochs, limits and errors.
"""

from __future__ import annotations

import os

import numpy as np

ZTF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "ztf_observing.npz")


def ztf_strategy(rng):
    """Ad hoc ZTF cadence (reference :920-926): first epoch 1-12 h after
    trigger, revisits over the first week, ~1 h jitter per epoch."""
    t0 = rng.uniform(1 / 24.0, 12.0 / 24.0)
    filts = ["ztfg", "ztfr", "ztfi"]
    times = [t0, t0 + 0.2, t0 + 0.2, t0 + 0.4, t0 + 0.4, t0 + 1.0,
             t0 + 2.0, t0 + 3.0, t0 + 5.0, t0 + 7.0]
    return [(t + rng.normal(scale=1.0 / 24.0), filts) for t in times]


def rubin_strategy(rubin_too):
    """Rubin ToO tiers (reference :928-963, Rubin 2024 workshop naming)."""
    gold_times = [1 / 24.0, 2 / 24.0, 4 / 24.0, 1.0, 2.0, 3.0]
    if rubin_too == "platinum":
        filts = ["ps1::g", "ps1::r", "ps1::i", "ps1::z", "ps1::y"]
        return [(t, filts) for t in gold_times]
    if "gold" in rubin_too:
        init = ["ps1::g", "ps1::r",
                "ps1::z" if rubin_too == "gold_z" else "ps1::i"]
        filt_lists = [init] * 3 + [["ps1::r", "ps1::i"]] * 3
        return list(zip(gold_times, filt_lists))
    if "silver" in rubin_too:
        filts = ["ps1::g", "ps1::z"] if rubin_too == "silver_z" else \
            ["ps1::g", "ps1::i"]
        return [(t, filts) for t in [1 / 24.0, 1.0, 2.0, 3.0]]
    raise ValueError("rubin_ToO_type should be platinum, gold[_z] or "
                     "silver[_z]")


def apply_strategy(true_data, strategy, trigger_time=0.0):
    """Resample dense per-filter light curves onto strategy epochs.

    ``true_data``: {filt: {'time': [...], 'mag': [...]}} (absolute times).
    Epochs outside a curve's range get inf magnitudes (missed detections),
    as the reference's left/right=inf interpolation (:893-897); filters
    the curves lack are skipped.
    """
    epochs: dict[str, list] = {}
    for obstime, filts in strategy:
        for filt in filts:
            epochs.setdefault(filt, []).append(obstime + trigger_time)
    out = {}
    for filt, times in epochs.items():
        if filt not in true_data:
            continue
        src = true_data[filt]
        times = np.asarray(sorted(times))
        mags = np.interp(times, np.asarray(src["time"]),
                         np.asarray(src["mag"]), left=np.inf, right=np.inf)
        out[filt] = {"time": times, "mag": mags}
    return out


def validate_lightcurve(data, filters=None, min_obs=3, cutoff_time=0,
                        verbose=False):
    """True when every filter has at least ``min_obs`` detections within
    ``cutoff_time`` days of the first epoch (all epochs when 0)."""
    from .io import load_em_observations
    if isinstance(data, (str, bytes)):
        data = load_em_observations(data)
    filters = filters.split(",") if isinstance(filters, str) else \
        (filters or list(data.keys()))

    min_time = min(np.min(d["time"]) for d in data.values())
    if cutoff_time > 0:
        max_time = min_time + cutoff_time
    else:
        max_time = max(np.max(d["time"]) for d in data.values())

    for filt in filters:
        if filt not in data:
            if verbose:
                print(f"{filt} not in data file")
            return False
        mask = np.asarray(data[filt]["time"]) <= max_time
        detections = np.sum(np.isfinite(
            np.asarray(data[filt]["mag_error"])[mask]))
        if detections < min_obs:
            if verbose:
                print(f"{filt}: only {detections} detections, "
                      f"required: {min_obs}")
            return False
    return True


_ZTF_BAND = {1: "ztfg", 2: "ztfr", 3: "ztfi"}


class ZTFObservingModel:
    """Realistic ZTF survey epochs, limiting magnitudes and skew-normal
    photometric uncertainties from the reference's observing statistics,
    converted to plain arrays (Gaussian KDEs as (points, bandwidth) pairs,
    the observing logs as flattened per-night tables) in
    ``data/ztf_observing.npz``."""

    def __init__(self, npz_path=None):
        npz_path = npz_path or ZTF_NPZ
        if not os.path.exists(npz_path):
            raise FileNotFoundError(
                f"{npz_path} missing: the ZTF observing statistics are "
                "converted from the reference's data files")
        self._z = np.load(npz_path)

    def _kde(self, rng, tag, n=1):
        pts = self._z[f"{tag}_points"]
        bw = float(self._z[f"{tag}_bandwidth"])
        centres = pts[rng.integers(0, len(pts), n)]
        return centres + rng.normal(0.0, bw, n)

    def _night(self, rng, prefix):
        offsets = self._z[f"{prefix}_offsets"]
        i = rng.integers(0, len(offsets) - 1)
        sl = slice(offsets[i], offsets[i + 1])
        return self._z[f"{prefix}_t"][sl], self._z[f"{prefix}_band"][sl]

    def simulate_epochs(self, rng, t_last, trigger_time=0.0, too=None):
        """-> (mjd [N], band names [N], is_too [N]) observation epochs."""
        mjd, bands, is_too = [], [], []
        # public survey: nights drawn from the observing log, revisit gaps
        # from the revisit-time KDE
        t = rng.uniform(trigger_time, trigger_time + 2.0)
        while t < t_last + trigger_time:
            dt_row, band_row = self._night(rng, "sampling")
            mjd.extend(t + dt_row)
            bands.extend(_ZTF_BAND[int(b)] for b in band_row)
            is_too.extend([False] * len(dt_row))
            t += float(self._kde(rng, "revisit")[0])
        # the i band starts later, with its own cadence
        t = rng.uniform(trigger_time, trigger_time + 4.0)
        while t < t_last + trigger_time:
            mjd.append(t)
            bands.append("ztfi")
            is_too.append(False)
            t += float(self._kde(rng, "revisit_i")[0])
        # target-of-opportunity nights (180 s or 300 s exposures)
        if too:
            t = rng.uniform(trigger_time, trigger_time + 1.0)
            for _ in range(int(rng.integers(1, 3))):
                dt_row, band_row = self._night(rng, f"sampling_too{too}")
                mjd.extend(t + dt_row)
                bands.extend(_ZTF_BAND[int(b)] for b in band_row)
                is_too.extend([True] * len(dt_row))
                t += 1.0
        order = np.argsort(mjd)
        return (np.asarray(mjd)[order], np.asarray(bands)[order],
                np.asarray(is_too)[order])

    def _limiting_mag(self, rng, band, too):
        if band == "ztfi":
            return float(self._kde(rng, "lim_i")[0])
        suffix = "g" if band == "ztfg" else "r"
        tag = f"lim_too{too}_{suffix}" if too else f"lim_{suffix}"
        if too and f"{tag}_points" not in self._z:
            tag = f"lim_{suffix}"
        return float(self._kde(rng, tag)[0])

    def uncertainty_row(self, band, mag):
        """Row of the uncertainty table for (band, magnitude): the
        interval (left, right] holding ``mag``, else the band's interval
        with the nearest midpoint."""
        code = {"ztfg": 1, "ztfr": 2, "ztfi": 3}[band]
        sel = (self._z["uncer_band"] == code) & \
            (mag > self._z["uncer_left"]) & (mag <= self._z["uncer_right"])
        idx = np.flatnonzero(sel)
        if len(idx):
            return int(idx[0])
        band_rows = np.flatnonzero(self._z["uncer_band"] == code)
        mid = 0.5 * (self._z["uncer_left"][band_rows]
                     + self._z["uncer_right"][band_rows])
        return int(band_rows[int(np.argmin(np.abs(mid - mag)))])

    def interval_edges(self):
        """Every edge of the uncertainty intervals (the magnitudes where
        the drawn error's distribution changes)."""
        return np.unique(np.concatenate([self._z["uncer_left"],
                                         self._z["uncer_right"]]))

    def _mag_error(self, rng, band, mag):
        """Skew-normal uncertainty draw for (band, magnitude interval)."""
        from scipy.stats import skewnorm
        i = self.uncertainty_row(band, mag)
        return float(skewnorm.rvs(self._z["uncer_a"][i],
                                  self._z["uncer_loc"][i],
                                  self._z["uncer_scale"][i],
                                  random_state=rng))

    def apply(self, data, filters, rng, t_last, trigger_time=0.0,
              uncertainties=True, too=None, limits=None):
        """Resample a dense light-curve dict onto simulated ZTF epochs.

        ``data``: {filt: {'time' (absolute), 'mag', 'mag_error'}}. With
        ``uncertainties``, an epoch fainter than its drawn limiting
        magnitude becomes a (limit, inf) non-detection and a detection gets
        a skew-normal error; without, the interpolated values pass through
        (the reference's censoring block sits under ``ztf_uncertainties``,
        lightcurve_generation.py:1073-1087). A dict ``limits`` receives
        each filter's drawn limits.

        The draws depend only on the seed, the epochs and the flags, never
        on magnitudes: every epoch's limit is drawn up front in epoch
        order, then the errors come from a child stream, one per epoch
        whether or not it is detected.
        """
        mjd, bands, is_too = self.simulate_epochs(rng, t_last, trigger_time,
                                                  too=too)
        if uncertainties:
            lims = np.array([
                self._limiting_mag(rng, bands[k],
                                   too if is_too[k] else None)
                for k in range(len(mjd))])
            err_rng = np.random.default_rng(int(rng.integers(0, 2**63)))
        out = {}
        for filt in map(str, sorted(set(bands))):
            if filt not in filters or filt not in data:
                continue
            sel = bands == filt
            times = mjd[sel]
            src = data[filt]
            mags = np.interp(times, np.asarray(src["time"]),
                             np.asarray(src["mag"]),
                             left=np.inf, right=np.inf)
            errs = np.interp(times, np.asarray(src["time"]),
                             np.asarray(src["mag_error"]),
                             left=np.inf, right=np.inf)
            if not uncertainties:
                out[filt] = {"time": times, "mag": mags, "mag_error": errs}
                continue
            lims_f = lims[sel]
            if limits is not None:
                limits[filt] = lims_f
            for k in range(len(times)):
                lim = lims_f[k]
                err_draw = self._mag_error(
                    err_rng, filt, mags[k] if np.isfinite(mags[k]) else lim)
                if mags[k] > lim:
                    mags[k] = lim
                    errs[k] = np.inf
                elif np.isfinite(errs[k]):
                    errs[k] = err_draw
            out[filt] = {"time": times, "mag": mags, "mag_error": errs}
        return out
