"""Neutron-star mass-population likelihood (Landry & Read models).

PyTorch counterpart of ``nmma_tpu/population/likelihood.py`` (the
reference's ``nmma/population/pop_likelihood.py:5-28``): a flat or
truncated-Gaussian ('peak') source-frame mass population and a ``q^beta``
pairing term, on ``[B]`` batches.
"""

from __future__ import annotations

import math

import torch


class NeutronStarPopulation:
    def __init__(self, model_name: str, beta: float = 0.0):
        self.beta = float(beta)
        self.model_name = model_name.lower()
        if self.model_name == "flat":
            self.m_min, self.m_max = 1.1, 2.0
            # scipy's uniform(loc, scale) spans [loc, loc + scale]; the
            # reference passes scale=m_max, and this is its support
            self.support = (self.m_min, self.m_min + self.m_max)
            self._log_norm = -math.log(self.m_max)
        elif self.model_name == "peak":
            self.m_min, self.m_max = 1.1, 2.1
            self.loc, self.scale = 1.5, 1.0

            def ndtr(x):
                return 0.5 * math.erfc(-x / math.sqrt(2.0))

            a = (self.m_min - self.loc) / self.scale
            b = (self.m_max - self.loc) / self.scale
            self._log_z = math.log(ndtr(b) - ndtr(a))
        else:
            raise ValueError(f"unknown population model {model_name!r}")

    def _logpdf(self, m):
        if self.model_name == "flat":
            lo, hi = self.support
            return torch.where((m >= lo) & (m <= hi), self._log_norm,
                               -math.inf)
        in_range = (m >= self.m_min) & (m <= self.m_max)
        z = (m - self.loc) / self.scale
        lp = (-0.5 * z * z - math.log(self.scale)
              - 0.5 * math.log(2.0 * math.pi)) - self._log_z
        return torch.where(in_range, lp, -math.inf)

    def log_likelihood(self, parameters):
        return (self._logpdf(parameters["mass_1_source"])
                + self._logpdf(parameters["mass_2_source"])
                + self.beta * torch.log(parameters["mass_ratio"]))

    def __call__(self, parameters):
        return self.log_likelihood(parameters)
