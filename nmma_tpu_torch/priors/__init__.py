from .astro import adjust_priors_for_nmma
from .core import (Constraint, Cosine, DeltaFunction, Gaussian, Interped,
                   LogNormal, LogUniform, NMMADummyPrior, PowerLaw, Prior,
                   PriorDict, Sine, TruncatedGaussian, Uniform)
from .parser import load_prior_file, parse_prior_dict

__all__ = [
    "Prior", "PriorDict", "Uniform", "DeltaFunction", "Sine", "Cosine",
    "PowerLaw", "Gaussian", "TruncatedGaussian", "LogNormal", "LogUniform",
    "Interped", "Constraint", "NMMADummyPrior", "load_prior_file",
    "parse_prior_dict", "adjust_priors_for_nmma",
]
