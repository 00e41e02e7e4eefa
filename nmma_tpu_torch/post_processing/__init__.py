from .parity import js_divergence_1d, posterior_js_divergences

__all__ = ["js_divergence_1d", "posterior_js_divergences"]
