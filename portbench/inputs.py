"""The run's inputs, made from its seed: the photometry of the injection
through the benchmark's own reference model, with seeded noise and upper
limits, written as the ``.dat`` file and the prior file that the program
and the reference both read."""

from __future__ import annotations

import numpy as np
import torch

from .reference import em

SEED_SPACE = 2 ** 63


def derived_seed(seed, k):
    """The k-th seed drawn from ``seed`` (k = 0 is ``seed`` itself), for
    the sampler runs that follow one that converged."""
    if k == 0:
        return seed % SEED_SPACE
    return int(np.random.default_rng([seed % SEED_SPACE, k]).integers(
        SEED_SPACE))


def photometry(cfg, reference, seed, path, device, root):
    """Write the injection's photometry to ``path``: per filter
    ``per_filter`` epochs drawn uniformly in ``epochs`` days, the model
    light curve there plus Gaussian noise, and the last epoch of every
    ``upper_limit_every``-th filter an upper limit 1 mag brighter. The same
    seed gives the same file. Returns the number of rows written."""
    data = cfg["data"]
    ref = reference.Reference(cfg, dtype=torch.float32, device=device,
                              root=root)
    t_det, app = em.injection_light_curve(ref.photometry, ref.detector,
                                          cfg["injection"])
    rng = np.random.default_rng(seed % SEED_SPACE)
    lo, hi = data["epochs"]
    rows = []
    for i, f in enumerate(ref.photometry.filters):
        t = np.sort(rng.uniform(lo, hi, data["per_filter"]))
        m = np.interp(t, t_det, app[i]) + rng.normal(0.0, data["noise_mag"],
                                                     t.size)
        err = np.full(t.size, data["noise_mag"])
        if i % data["upper_limit_every"] == 0:
            m[-1] -= 1.0
            err[-1] = np.inf
        if not np.all(np.isfinite(m)):
            raise RuntimeError(f"the injection's light curve is not finite "
                               f"in {f}")
        rows += [f"{float(tt) + data['trigger_mjd']!r} {f} {float(mm)!r} "
                 f"{float(ee)!r}" for tt, mm, ee in zip(t, m, err)]
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return len(rows)


def prior_file(cfg, path):
    with open(path, "w") as f:
        f.write("\n".join(cfg["prior"]) + "\n")
