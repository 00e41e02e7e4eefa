"""Post-processing: the posterior JS divergences, KDEs, the Hubble and EOS
combinations, the GW x EM and maximum-mass resamplers, and the
marginalised light curves of ``lightcurve-marginalisation``, and the
posterior comparison plots of ``plotting_routines`` (imported as a
module, not re-exported)."""

from .hubble import (combine_hubble_posteriors, event_h0_kdes,
                     h0_trend_from_kdes, hdi,
                     hubble_posterior_from_distance_samples)
from .kde import GaussianKDE
from .marginalisation import (load_gw_samples,
                              marginalised_lightcurve_expectation)
from .maximum_mass import MaximumMassResampler
from .ns_characteristics import (combine_eos_posteriors,
                                 eos_probs_from_posterior,
                                 estimate_observable_trend)
from .parity import js_divergence_1d, posterior_js_divergences
from .resampling import GWEMResampler

__all__ = [
    "js_divergence_1d", "posterior_js_divergences", "GaussianKDE",
    "hubble_posterior_from_distance_samples", "combine_hubble_posteriors",
    "hdi", "h0_trend_from_kdes", "event_h0_kdes", "GWEMResampler",
    "MaximumMassResampler", "combine_eos_posteriors",
    "eos_probs_from_posterior", "estimate_observable_trend",
    "load_gw_samples", "marginalised_lightcurve_expectation",
]
