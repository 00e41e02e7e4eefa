from .mcmc import EnsembleMCMC, EnsembleMCMCConfig, EnsembleMCMCResult
from .nested import NestedSampler, NestedSamplerConfig, NestedSamplerResult

__all__ = ["NestedSampler", "NestedSamplerConfig", "NestedSamplerResult",
           "EnsembleMCMC", "EnsembleMCMCConfig", "EnsembleMCMCResult"]
