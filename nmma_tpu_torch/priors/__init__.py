from .astro import (adjust_priors_for_nmma, create_prior_from_args,
                    extinction_prior, h5_to_multivar_prior, hubble_prior)
from .core import (ConditionalGaussianIotaGivenThetaCore, Constraint, Cosine,
                   DeltaFunction, Gaussian, Interped, LogNormal, LogUniform,
                   MultivariateGaussianComponent, NMMADummyPrior, PowerLaw,
                   Prior, PriorDict, Sine, TruncatedGaussian, Uniform,
                   UniformComovingVolume, UniformSourceFrame,
                   WeightedCategorical, multivariate_gaussian_priors)
from .parser import load_prior_file, parse_prior_dict

__all__ = [
    "Prior", "PriorDict", "Uniform", "DeltaFunction", "Sine", "Cosine",
    "PowerLaw", "Gaussian", "TruncatedGaussian", "LogNormal", "LogUniform",
    "Interped", "Constraint", "NMMADummyPrior", "UniformComovingVolume",
    "UniformSourceFrame", "WeightedCategorical",
    "ConditionalGaussianIotaGivenThetaCore", "MultivariateGaussianComponent",
    "multivariate_gaussian_priors", "load_prior_file", "parse_prior_dict",
    "adjust_priors_for_nmma", "create_prior_from_args", "extinction_prior",
    "hubble_prior", "h5_to_multivar_prior",
]
