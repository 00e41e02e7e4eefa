"""Combined EOS inference across events (``combine-EOS``).

Port of ``nmma_tpu/post_processing/ns_characteristics.py`` (numpy, on the
port's ``conversion``), the counterpart of
``nmma/post_processing/ns_characteristics.py:17-104``: stack per-event
EOS-index posteriors into combined per-EOS weights and report the R_14 (and
MTOV) trend with event count, with the pdet(MTOV) selection correction
hook. Everything here runs on the host.
"""

from __future__ import annotations

import numpy as np


def eos_index_weights(eos_samples, n_eos):
    """Per-EOS posterior weights from sampled (fractional) EOS indices."""
    idx = np.floor(np.asarray(eos_samples)).astype(int)
    idx = np.clip(idx, 0, n_eos - 1)
    counts = np.bincount(idx, minlength=n_eos).astype(float)
    return counts / counts.sum()


def combine_eos_posteriors(event_eos_samples, eos_set, pdet=None,
                           as_probabilities=False):
    """Cumulative combined EOS weights + R14 credible trend.

    ``event_eos_samples``: per event, either sampled (fractional) EOS
    indices, or — with ``as_probabilities=True`` — an already-normalized
    probability vector of length n_eos (exact; no pseudo-sample
    round-trip). Returns (combined_weights [N_eos], trend list of
    (median R14, lo68, hi68) after each event).
    """
    n_eos = eos_set.n_eos
    r14 = np.asarray(eos_set.r14)
    prior_w = np.asarray(eos_set.weights, dtype=np.float64)
    prior_w = prior_w / prior_w.sum()
    log_prior = np.log(prior_w + 1e-300)
    log_w = log_prior.copy()
    trend = []
    for samples in event_eos_samples:
        if as_probabilities:
            w_event = np.asarray(samples, dtype=np.float64)
            if w_event.shape != (n_eos,):
                raise ValueError(
                    f"probability vector has shape {w_event.shape}, "
                    f"expected ({n_eos},)")
            w_event = w_event / w_event.sum()
        else:
            w_event = eos_index_weights(samples, n_eos)
        if pdet is not None:
            w_event = w_event / np.maximum(pdet(np.asarray(eos_set.tov_mass)),
                                           1e-10)
        # each event's posterior was sampled UNDER the EOS prior: divide
        # it out so the combination is prior x product(likelihoods) —
        # not prior^(N+1) (reference generate_EOS_cumprods and this
        # file's generate_eos_cumprods both divide per event)
        log_w = log_w + np.log(w_event + 1e-300) - log_prior
        weights = np.exp(log_w - log_w.max())
        weights /= weights.sum()
        order = np.argsort(r14)
        cdf = np.cumsum(weights[order])
        med = np.interp(0.5, cdf, r14[order])
        lo = np.interp(0.16, cdf, r14[order])
        hi = np.interp(0.84, cdf, r14[order])
        trend.append((med, lo, hi))
    weights = np.exp(log_w - log_w.max())
    weights /= weights.sum()
    return weights, trend


# ---------------------------------------------------------------------------
# Reference-exact combine-EOS machinery: flat-mass reweighting, per-ordering
# cumulative products, HDI spreads (nmma/post_processing/
# ns_characteristics.py:17-66)
# ---------------------------------------------------------------------------

def eos_probs_from_posterior(samples, n_eos, reweight=True, rng=None):
    """Per-event EOS probability vector from a posterior table.

    Applies the flat-component-mass reweighting the reference applies
    before counting (ns_characteristics.py:42: reweight_to_flat_mass_prior)
    whenever the mass columns are present, then converts the continuous
    EOS column to integer counts.
    """
    from ..conversion import reweight_to_flat_mass_prior

    if reweight and "chirp_mass" in samples and "mass_ratio" in samples:
        samples = reweight_to_flat_mass_prior(samples, rng=rng)
    idx = np.floor(np.asarray(samples["EOS"])).astype(int)
    idx = np.clip(idx, 0, n_eos - 1)
    counts = np.bincount(idx, minlength=n_eos).astype(float)
    return counts / counts.sum()


def generate_eos_cumprods(probs, prior_prob):
    """Cumulative posterior products over events
    (reference generate_EOS_cumprods, ns_characteristics.py:57-66)."""
    out = []
    combined = np.asarray(prior_prob, dtype=np.float64).copy()
    for prob in probs:
        combined = combined * np.asarray(prob) / np.asarray(prior_prob)
        combined = combined / combined.sum()
        out.append(combined.copy())
    return out


def estimate_observable_trend(prior_dist, posterior_probs, prior_prob,
                              n_reordering=10, n_posterior_samples=3000,
                              cred_interval=0.95, rng=None):
    """Median-over-orderings observable trend (e.g. R14 vs event count).

    Reference estimate_observable_trend (ns_characteristics.py:17-32):
    shuffle the event ordering, build cumulative EOS-probability products,
    draw posterior samples of the observable per event count, record the
    median + HDI bounds, and report the medians across orderings.
    Returns (median[N], upper[N], lower[N]).
    """
    from .hubble import hdi

    rng = np.random.default_rng(rng)
    probs = list(posterior_probs)
    meds, ups, lows = [], [], []
    prior_dist = np.asarray(prior_dist, dtype=np.float64)
    for _ in range(n_reordering):
        rng.shuffle(probs)
        row_m, row_u, row_l = [], [], []
        for weights in generate_eos_cumprods(probs, prior_prob):
            draws = rng.choice(prior_dist, p=weights,
                               size=n_posterior_samples, replace=True)
            lo, hi = hdi(draws, cred_interval)
            row_m.append(np.median(draws))
            row_u.append(hi)
            row_l.append(lo)
        meds.append(row_m)
        ups.append(row_u)
        lows.append(row_l)
    return (np.median(np.asarray(meds), axis=0),
            np.median(np.asarray(ups), axis=0),
            np.median(np.asarray(lows), axis=0))
