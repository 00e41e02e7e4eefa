"""Parser for bilby-style ``.prior`` files (port of ``nmma_tpu/priors/parser.py``).

Reads the reference's prior files (``priors/*.prior``) unchanged: each line
is ``key = PriorClass(kwargs...)`` or ``key = <float>``. Expressions are
evaluated in a restricted namespace exposing only the prior classes, numpy
(as ``np``) and basic constants — the same effective surface bilby's
``PriorDict.from_file`` offers. A class the port has not taken over yet
(conditional and comoving-volume priors) fails as an undefined name.
"""

from __future__ import annotations

import numpy as np

from . import core
from .core import DeltaFunction, Prior, PriorDict

_NAMESPACE = {
    "np": np,
    "pi": np.pi,
    "inf": np.inf,
    # prior classes under their bilby names
    "Uniform": core.Uniform,
    "DeltaFunction": core.DeltaFunction,
    "LogUniform": core.LogUniform,
    "PowerLaw": core.PowerLaw,
    "Sine": core.Sine,
    "Cosine": core.Cosine,
    "Gaussian": core.Gaussian,
    "Normal": core.Gaussian,
    "TruncatedGaussian": core.TruncatedGaussian,
    "TruncatedNormal": core.TruncatedGaussian,
    "LogNormal": core.LogNormal,
    "LogGaussian": core.LogNormal,
    "Interped": core.Interped,
    "Constraint": core.Constraint,
    "NMMADummyPrior": core.NMMADummyPrior,
}


class _Namespace:
    """Attribute bag so reference prior files can say
    ``bilby.gw.prior.UniformComovingVolume(...)`` verbatim
    (example_files/prior/GW170817_AT2017gfo_GRB170817A.prior:11)."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)


_BILBY_PRIOR_NS = _Namespace(**{k: v for k, v in _NAMESPACE.items()
                                if isinstance(v, type)})
_NAMESPACE["bilby"] = _Namespace(
    gw=_Namespace(prior=_BILBY_PRIOR_NS),
    core=_Namespace(prior=_BILBY_PRIOR_NS),
)


def _eval_rhs(rhs: str):
    return eval(rhs, {"__builtins__": {}}, dict(_NAMESPACE))  # noqa: S307


def parse_prior_dict(text: str) -> PriorDict:
    priors: dict[str, Prior] = {}
    for raw_line in text.splitlines():
        line = raw_line.split("#")[0].strip()
        if not line:
            continue
        key, _, rhs = line.partition("=")
        key, rhs = key.strip(), rhs.strip()
        if not rhs:
            continue
        value = _eval_rhs(rhs)
        if isinstance(value, Prior):
            # the dict key is authoritative (bilby semantics), even when the
            # file sets a different name= inside the call
            value.name = key
            priors[key] = value
        else:
            priors[key] = DeltaFunction(peak=float(value), name=key)
    return PriorDict(priors)


def load_prior_file(path: str) -> PriorDict:
    with open(path) as f:
        return parse_prior_dict(f.read())
