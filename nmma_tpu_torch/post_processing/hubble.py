"""Hubble-constant estimation from EM/GW distance posteriors.

Port of ``nmma_tpu/post_processing/hubble.py`` (numpy on the port's
``cosmology``), the counterpart of ``gwem-Hubble-estimate``
(``nmma/post_processing/hubble_estimates.py:14-169``): per-event H0
posteriors from luminosity-distance posteriors at known redshift, KDE
combination across events, and an H0^3 volume selection correction.

At fixed z and fixed other cosmological parameters, d_L is proportional to
1/H0, so each distance sample maps to H0 = H0_fid * d_L^fid(z) / d_L.
Everything here runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cosmology import get_cosmology

# numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def hubble_posterior_from_distance_samples(distance_samples, redshift,
                                           cosmology=None):
    """H0 samples [km/s/Mpc] from d_L posterior samples at known z."""
    cosmo = cosmology or get_cosmology()
    # the cosmology's f32 table, as in the JAX package
    d_fid = float(cosmo.luminosity_distance(
        torch.tensor(float(redshift), dtype=torch.float32)))
    return cosmo.H0 * d_fid / np.asarray(distance_samples)


def combine_hubble_posteriors(event_h0_samples, h0_grid=None,
                              selection_correction=True):
    """Product of per-event H0 KDEs on a grid, optional H0^3 correction.

    Returns (h0_grid, combined_pdf, (median, lower68, upper68)).
    Reference: cumulative KDE product + selection effect + HDI
    (hubble_estimates.py:76-169).
    """
    if h0_grid is None:
        h0_grid = np.linspace(20.0, 140.0, 601)
    event_h0_samples = list(event_h0_samples)
    log_pdf = np.zeros_like(h0_grid)
    for samples in event_h0_samples:
        # vectorized KDE over the whole grid (a per-point loop costs one
        # dispatch per grid node)
        log_pdf += _H0KDE(np.asarray(samples)).logpdf_batch(h0_grid)
    if selection_correction and len(event_h0_samples) > 1:
        # observable volume scales as d^3 ~ H0^-3: divide it out, once
        # per event PAST THE FIRST — the same convention as the
        # cumulative trend machinery below and the reference
        # (generate_logprob, hubble_estimates.py:18-28)
        log_pdf += 3.0 * (len(event_h0_samples) - 1) * np.log(h0_grid)
    log_pdf -= log_pdf.max()
    pdf = np.exp(log_pdf)
    pdf /= _trapezoid(pdf, h0_grid)

    cdf = np.concatenate([[0.0], np.cumsum(
        0.5 * (pdf[1:] + pdf[:-1]) * np.diff(h0_grid))])
    cdf /= cdf[-1]
    median = np.interp(0.5, cdf, h0_grid)
    lo = np.interp(0.16, cdf, h0_grid)
    hi = np.interp(0.84, cdf, h0_grid)
    return h0_grid, pdf, (median, lo, hi)


# ---------------------------------------------------------------------------
# Full per-ordering cumulative combination + HDI machinery
# (reference hubble_estimates.py:14-169)
# ---------------------------------------------------------------------------

def hdi(samples, prob=0.95):
    """Highest-density interval: the minimal-width window containing
    ``prob`` of the sorted samples (arviz.hdi equivalent, used by the
    reference's find_spread_from_resampling, resampling.py:18-33)."""
    x = np.sort(np.asarray(samples, dtype=np.float64))
    n = len(x)
    k = max(int(np.ceil(prob * n)), 2)
    widths = x[k - 1:] - x[:n - k + 1]
    i = int(np.argmin(widths))
    return x[i], x[i + k - 1]


def _weighted_kde_resample(prior_samples, weights, size, rng):
    """gaussian_kde(prior, weights=w).resample(size) equivalent
    (reference H0_resampling, hubble_estimates.py:14-16)."""
    prior_samples = np.asarray(prior_samples, dtype=np.float64)
    w = np.maximum(np.asarray(weights, dtype=np.float64), 0.0)
    w = w / w.sum()
    neff = 1.0 / np.sum(w**2)
    bw = neff ** (-1.0 / 5.0)
    mean = np.sum(w * prior_samples)
    var = np.sum(w * (prior_samples - mean) ** 2)
    idx = rng.choice(len(prior_samples), size=size, p=w)
    return prior_samples[idx] + rng.normal(0.0, bw * np.sqrt(var), size)


def generate_cumulative_logprob(kdes, h0_sample, index):
    """Cumulative per-event combination of H0 KDE log-densities.

    Row k is the (normalized) log posterior after the first k+1 events in
    ``index``, each event past the first carrying the H0^3 selection
    correction (reference generate_logprob, hubble_estimates.py:18-28).
    """
    out = []
    combined = np.zeros_like(h0_sample)
    for pos, i in enumerate(index):
        combined = combined + kdes[i].logpdf_batch(h0_sample)
        if pos != 0:
            combined = combined + 3.0 * np.log(h0_sample)
        from scipy.special import logsumexp
        combined = combined - logsumexp(combined)
        out.append(combined.copy())
    return np.array(out)


def h0_trend_from_kdes(gw_kdes, em_kdes, h0_prior_samples, index,
                       n_reordering=10, n_posterior_samples=3000,
                       cred_interval=0.95, rng=None):
    """Median-over-orderings H0 trend with event count.

    For each random event ordering: cumulative GW-only / EM-only / joint
    posteriors on the prior sample grid, resampled to (median, HDI upper,
    HDI lower) per event count; the final estimate is the median across
    orderings (reference H0_means_from_probs, hubble_estimates.py:42-76;
    joint row carries one extra 3 ln H0 on the first event, :33-39).

    Returns {"GW": (med[N], up[N], low[N]), "EM": ..., "total": ...}.
    """
    from scipy.special import logsumexp

    rng = np.random.default_rng(rng)
    index = np.array(list(index))
    acc = {k: ([], [], []) for k in ("GW", "EM", "total")}
    for _ in range(n_reordering):
        rng.shuffle(index)
        gw_lp = generate_cumulative_logprob(gw_kdes, h0_prior_samples,
                                            index)
        em_lp = generate_cumulative_logprob(em_kdes, h0_prior_samples,
                                            index)
        tot_lp = gw_lp + em_lp
        tot_lp[0, :] = tot_lp[0, :] + 3.0 * np.log(h0_prior_samples)
        tot_lp = np.array([row - logsumexp(row) for row in tot_lp])
        for key, lp in (("GW", gw_lp), ("EM", em_lp), ("total", tot_lp)):
            meds, ups, lows = [], [], []
            for row in lp:
                draws = _weighted_kde_resample(
                    h0_prior_samples, np.exp(row), n_posterior_samples,
                    rng)
                lo, hi = hdi(draws, cred_interval)
                meds.append(np.median(draws))
                ups.append(hi)
                lows.append(lo)
            acc[key][0].append(meds)
            acc[key][1].append(ups)
            acc[key][2].append(lows)
    return {k: tuple(np.median(np.asarray(v), axis=0) for v in lists)
            for k, lists in acc.items()}


class _H0KDE:
    """1-D weighted KDE with a vectorized logpdf (host-side numpy)."""

    def __init__(self, samples, weights=None):
        x = np.asarray(samples, dtype=np.float64)
        if weights is None:
            w = np.full(len(x), 1.0 / len(x))
        else:
            w = np.asarray(weights, dtype=np.float64)
            w = w / w.sum()
        neff = 1.0 / np.sum(w**2)
        mean = np.sum(w * x)
        var = np.sum(w * (x - mean) ** 2) * neff / max(neff - 1.0, 1.0)
        self._x = x
        self._logw = np.log(w + 1e-300)
        self._bw = max(np.sqrt(var) * neff ** (-1.0 / 5.0), 1e-12)

    def logpdf_batch(self, q):
        from scipy.special import logsumexp
        q = np.asarray(q, dtype=np.float64)
        z = (q[:, None] - self._x[None, :]) / self._bw
        return logsumexp(-0.5 * z * z + self._logw[None, :], axis=1) \
            - 0.5 * np.log(2 * np.pi) - np.log(self._bw)


def event_h0_kdes(em_distance_samples, gw_samples, z_true, rng=None,
                  p_value_threshold=None, injected_distance=None,
                  z_scatter=1e-3, cosmology=None):
    """Per-event (EM KDE, GW KDE) pair for the trend machinery.

    Mirrors load_in_posteriors (hubble_estimates.py:78-123): the GW
    posterior is reweighted to a flat component-mass prior first, the EM
    H0 KDE carries d^2 weights (back to uniform-in-volume so the known
    H0^-3 selection applies), redshift scatter is folded in, and an
    optional two-sided p-value cut drops unconverged GW runs. Returns
    None when the event fails the cut.
    """
    from ..constants import c_SI
    from ..conversion import reweight_to_flat_mass_prior

    rng = np.random.default_rng(rng)
    c_kms = c_SI / 1e3
    d_em = np.asarray(em_distance_samples, dtype=np.float64)
    gw = reweight_to_flat_mass_prior(gw_samples, rng=rng)
    d_gw = np.asarray(gw["luminosity_distance"], dtype=np.float64)

    if p_value_threshold and injected_distance is not None:
        p = np.mean(d_gw <= injected_distance)
        p = 2.0 * min(p, 1.0 - p)
        if p < p_value_threshold:
            return None

    z_em = rng.normal(float(z_true), z_scatter, size=len(d_em))
    em_kde = _H0KDE(z_em * c_kms / d_em, weights=d_em * d_em)
    z_gw = rng.normal(float(z_true), z_scatter, size=len(d_gw))
    gw_kde = _H0KDE(z_gw * c_kms / d_gw)
    return em_kde, gw_kde
