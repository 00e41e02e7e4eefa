"""Astrophysical prior helpers: ``adjust_priors_for_nmma`` only.

Port of ``nmma_tpu/priors/astro.py:167`` (reference
``adjust_priors_for_nmma``, nmma/core/base.py:198-231). The '*hubble*'
rule is ported; the '*h5*' rule needs the multivariate-Gaussian prior
block, which waits for a later slice, and raises here.
"""

from __future__ import annotations

import numpy as np

from .core import Interped, NMMADummyPrior, PriorDict


def adjust_priors_for_nmma(priors):
    """Replace NMMADummyPrior placeholders: '*hubble*' keys become an
    Interped prior from a two-column Hubble weight table. Returns a
    PriorDict."""
    pd = dict(priors.priors) if isinstance(priors, PriorDict) else \
        dict(priors)
    for key in list(pd):
        prior = pd[key]
        if not isinstance(prior, NMMADummyPrior):
            continue
        setup = prior.setup_props
        pd.pop(key)
        if "h5" in key.lower():
            raise NotImplementedError(
                f"NMMADummyPrior key {key!r}: HDF5 multivariate priors are "
                "not in nmma_tpu_torch yet")
        if "hubble" in key.lower():
            table = np.loadtxt(setup)
            if table.ndim != 2:
                raise ValueError(f"bad Hubble weight table {setup}")
            pd["Hubble_constant"] = Interped(
                table[:, 0], table[:, 1], name="Hubble_constant")
        else:
            raise ValueError(
                f"NMMADummyPrior key {key!r} matches no replacement rule "
                "(expected 'h5' or 'hubble' in the name)")
    return PriorDict(pd)
