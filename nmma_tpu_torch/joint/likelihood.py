"""Joint multimessenger likelihood: one conversion chain, summed messengers.

PyTorch counterpart of ``nmma_tpu/joint/likelihood.py`` (the reference's
``MultiMessengerLikelihood``, ``nmma/joint/joint_likelihood.py:20-87``):
the conversion chain runs once on a ``[B]`` parameter batch, then every
messenger's ``[B]`` log-likelihood is evaluated on the converted dict and
summed. Non-finite results become the sampler's -1e30 sentinel, and finite
ones are floored there, so the nested sampler's sentinel contract holds.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


class MultiMessengerLikelihood:
    """Sum of messenger likelihoods behind one conversion chain.

    ``conversion`` maps a parameter dict to a parameter dict (e.g.
    ``MultimessengerConversion``); each of ``likelihoods`` maps the
    converted dict of ``[B]`` tensors to ``[B]`` log-likelihoods; a
    non-finite value of any of ``sanity_keys`` in the converted dict gives
    the sentinel.
    """

    def __init__(self, conversion, likelihoods, sanity_keys=()):
        self.conversion = conversion
        self.likelihoods = list(likelihoods)
        self.sanity_keys = tuple(sanity_keys)

    def log_likelihood(self, parameters):
        p = self.conversion(parameters) if self.conversion else dict(parameters)
        total = 0.0
        for lk in self.likelihoods:
            total = total + lk(p)
        for key in self.sanity_keys:
            total = torch.where(torch.isfinite(p[key]), total, NEG_INF)
        return torch.where(torch.isnan(total), NEG_INF,
                           torch.clamp(total, min=NEG_INF))

    def __call__(self, parameters):
        return self.log_likelihood(parameters)
