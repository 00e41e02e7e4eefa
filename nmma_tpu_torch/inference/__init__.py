from .nested import NestedSampler, NestedSamplerConfig, NestedSamplerResult

__all__ = ["NestedSampler", "NestedSamplerConfig", "NestedSamplerResult"]
