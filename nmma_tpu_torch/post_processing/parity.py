"""Posterior parity: Jensen-Shannon divergence between posterior sets.

The port's copy of ``nmma_tpu/post_processing/parity.py`` (numpy only): the
BASELINE target is a JS divergence below 0.01 per parameter against a
reference posterior. 1-D marginals are histogram-binned on a shared
support; the value is the JS divergence in nats.
"""

from __future__ import annotations

import numpy as np


def js_divergence_1d(samples_a, samples_b, n_bins=60):
    a = np.asarray(samples_a, dtype=np.float64)
    b = np.asarray(samples_b, dtype=np.float64)
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if hi <= lo:
        return 0.0
    bins = np.linspace(lo, hi, n_bins + 1)
    pa, _ = np.histogram(a, bins=bins, density=True)
    pb, _ = np.histogram(b, bins=bins, density=True)
    pa = pa / pa.sum() + 1e-12
    pb = pb / pb.sum() + 1e-12
    m = 0.5 * (pa + pb)
    kl_am = np.sum(pa * np.log(pa / m))
    kl_bm = np.sum(pb * np.log(pb / m))
    return 0.5 * (kl_am + kl_bm)


def posterior_js_divergences(post_a: dict, post_b: dict, parameters=None):
    """Per-parameter JS divergence between two posterior dicts."""
    if parameters is None:
        parameters = [k for k in post_a
                      if k in post_b and np.ndim(post_a[k]) == 1
                      and np.std(post_a[k]) > 0]
    return {k: js_divergence_1d(post_a[k], post_b[k]) for k in parameters}
