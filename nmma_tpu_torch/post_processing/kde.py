"""Gaussian kernel density estimation, batched over query points.

PyTorch counterpart of ``nmma_tpu/post_processing/kde.py``: the reference
builds ``scipy.stats.gaussian_kde`` objects inside its resampling
likelihoods (``nmma/post_processing/resampling.py:53-171``); here the
log-density is a logsumexp over the kernel centres with a Scott's-rule
bandwidth (weighted effective sample size), set up once on the host in
float64 as the JAX package does, and evaluated in f32 for ``[N]`` query
points at once on the device of the queries.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of the [chunk, N_samples, D] difference tensor per evaluation step
_CHUNK_BYTES = 256 * 2**20


class GaussianKDE:
    def __init__(self, samples, weights=None, bw_factor=1.0):
        """samples: [N, D] (or [N] for 1-D)."""
        samples = np.atleast_2d(np.asarray(samples, dtype=np.float64))
        if samples.shape[0] < samples.shape[1]:
            samples = samples.T
        self.n, self.d = samples.shape
        if weights is None:
            weights = np.full(self.n, 1.0 / self.n)
        weights = np.asarray(weights, dtype=np.float64)
        weights = weights / weights.sum()

        # Scott's rule with the weighted effective sample size
        neff = 1.0 / np.sum(weights**2)
        factor = bw_factor * neff ** (-1.0 / (self.d + 4))
        mean = np.average(samples, axis=0, weights=weights)
        centred = samples - mean
        cov = (centred * weights[:, None]).T @ centred \
            / (1 - np.sum(weights**2))
        chol = np.linalg.cholesky(cov * factor**2 + 1e-12 * np.eye(self.d))
        self.samples = samples
        self.log_norm = (np.log(weights) - 0.5 * self.d * np.log(2 * np.pi)
                         - np.sum(np.log(np.diag(chol))))
        self.inv_chol = np.linalg.inv(chol)
        self._on = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(
                torch.as_tensor(a, dtype=torch.float32, device=device)
                for a in (self.samples, self.log_norm, self.inv_chol.T))
        return self._on[key]

    def log_prob(self, x):
        """log density at ``x`` [B, D] (or [B] for 1-D) -> [B]."""
        x = x.reshape(x.shape[0], -1) if x.dim() > 1 else x[:, None]
        samples, log_norm, inv_chol_t = self._tables(x.device)
        step = max(1, _CHUNK_BYTES // (4 * self.n * self.d))
        out = []
        for xs in torch.split(x, step):
            z = (xs[:, None, :] - samples) @ inv_chol_t          # [b, N, D]
            sq = (z * z).sum(-1)
            out.append(torch.logsumexp(log_norm - 0.5 * sq, dim=1))
        return torch.cat(out) if out else x.new_zeros(0)

    __call__ = log_prob

