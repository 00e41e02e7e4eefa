"""Prior system: analytic unit-cube transforms on batched tensors.

PyTorch counterpart of ``nmma_tpu/priors/core.py`` (the bilby prior layer
the reference leans on, ``bilby.core.prior`` + ``nmma/em/prior.py``): every
prior is a closed-form inverse-CDF transform ``u in [0,1] -> x`` on a
``[B]`` tensor, so a whole live-point batch ``[B, ndim]`` maps through
``PriorDict.transform`` at once. Conditional priors and the astrophysical
distance priors (UniformComovingVolume, ...) wait for a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.interp import interp

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _ndtr(a: float) -> float:
    return 0.5 * math.erfc(-a / math.sqrt(2.0))


def _normal_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma) - _LOG_SQRT_2PI


class Prior:
    """Base prior: named 1-D distribution with a unit-cube transform."""

    sampled = True       # participates in the unit-cube vector

    def __init__(self, name=None, latex_label=None, minimum=-np.inf,
                 maximum=np.inf, unit=None, boundary=None):
        self.name = name
        self.latex_label = latex_label
        self.minimum = float(minimum)
        self.maximum = float(maximum)
        self.unit = unit
        self.boundary = boundary

    def transform(self, u):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def _in_range(self, x):
        return (x >= self.minimum) & (x <= self.maximum)

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"minimum={self.minimum}, maximum={self.maximum})")


class Uniform(Prior):
    def transform(self, u):
        return self.minimum + u * (self.maximum - self.minimum)

    def log_prob(self, x):
        return torch.where(self._in_range(x),
                           -math.log(self.maximum - self.minimum), -math.inf)


class DeltaFunction(Prior):
    sampled = False

    def __init__(self, peak=None, value=None, name=None, latex_label=None,
                 **kwargs):
        peak = peak if peak is not None else value
        super().__init__(name=name, latex_label=latex_label, minimum=peak,
                         maximum=peak)
        self.peak = float(peak)

    def transform(self, u=None):
        return self.peak

    def log_prob(self, x):
        return torch.where(x == self.peak, 0.0, -math.inf)


class LogUniform(Prior):
    def transform(self, u):
        lo, hi = math.log(self.minimum), math.log(self.maximum)
        return torch.exp(lo + u * (hi - lo))

    def log_prob(self, x):
        norm_c = math.log(self.maximum) - math.log(self.minimum)
        return torch.where(self._in_range(x), -torch.log(x) - math.log(norm_c),
                           -math.inf)


class PowerLaw(Prior):
    def __init__(self, alpha, minimum, maximum, name=None, latex_label=None,
                 **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=minimum,
                         maximum=maximum)
        self.alpha = float(alpha)

    def transform(self, u):
        if self.alpha == -1.0:
            lo, hi = math.log(self.minimum), math.log(self.maximum)
            return torch.exp(lo + u * (hi - lo))
        ap1 = self.alpha + 1.0
        lo, hi = self.minimum**ap1, self.maximum**ap1
        return torch.pow(lo + u * (hi - lo), 1.0 / ap1)

    def log_prob(self, x):
        if self.alpha == -1.0:
            lp = -torch.log(x) - math.log(math.log(self.maximum / self.minimum))
        else:
            ap1 = self.alpha + 1.0
            norm_c = (self.maximum**ap1 - self.minimum**ap1) / ap1
            lp = self.alpha * torch.log(x) - math.log(norm_c)
        return torch.where(self._in_range(x), lp, -math.inf)


class Sine(Prior):
    """p(x) ~ sin(x) on [minimum, maximum] (default [0, pi])."""

    def __init__(self, name=None, latex_label=None, minimum=0.0,
                 maximum=np.pi, **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=minimum,
                         maximum=maximum)

    def transform(self, u):
        c_lo, c_hi = math.cos(self.minimum), math.cos(self.maximum)
        return torch.arccos(c_lo + u * (c_hi - c_lo))

    def log_prob(self, x):
        norm_c = math.cos(self.minimum) - math.cos(self.maximum)
        return torch.where(self._in_range(x),
                           torch.log(torch.sin(x)) - math.log(norm_c),
                           -math.inf)


class Cosine(Prior):
    """p(x) ~ cos(x) on [minimum, maximum] (default [-pi/2, pi/2])."""

    def __init__(self, name=None, latex_label=None, minimum=-np.pi / 2,
                 maximum=np.pi / 2, **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=minimum,
                         maximum=maximum)

    def transform(self, u):
        s_lo, s_hi = math.sin(self.minimum), math.sin(self.maximum)
        return torch.arcsin(s_lo + u * (s_hi - s_lo))

    def log_prob(self, x):
        norm_c = math.sin(self.maximum) - math.sin(self.minimum)
        return torch.where(self._in_range(x),
                           torch.log(torch.cos(x)) - math.log(norm_c),
                           -math.inf)


class Gaussian(Prior):
    def __init__(self, mu, sigma, name=None, latex_label=None, **kwargs):
        super().__init__(name=name, latex_label=latex_label)
        self.mu, self.sigma = float(mu), float(sigma)

    def transform(self, u):
        return self.mu + self.sigma * torch.special.ndtri(u)

    def log_prob(self, x):
        return _normal_logpdf(x, self.mu, self.sigma)


class TruncatedGaussian(Prior):
    def __init__(self, mu, sigma, minimum, maximum, name=None,
                 latex_label=None, **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=minimum,
                         maximum=maximum)
        self.mu, self.sigma = float(mu), float(sigma)

    def _cdf_bounds(self):
        return (_ndtr((self.minimum - self.mu) / self.sigma),
                _ndtr((self.maximum - self.mu) / self.sigma))

    def transform(self, u):
        phi_a, phi_b = self._cdf_bounds()
        return self.mu + self.sigma * torch.special.ndtri(
            phi_a + u * (phi_b - phi_a))

    def log_prob(self, x):
        phi_a, phi_b = self._cdf_bounds()
        return torch.where(
            self._in_range(x),
            _normal_logpdf(x, self.mu, self.sigma) - math.log(phi_b - phi_a),
            -math.inf)


class LogNormal(Prior):
    def __init__(self, mu, sigma, name=None, latex_label=None, **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=0.0)
        self.mu, self.sigma = float(mu), float(sigma)

    def transform(self, u):
        return torch.exp(self.mu + self.sigma * torch.special.ndtri(u))

    def log_prob(self, x):
        lx = torch.log(torch.clamp(x, min=1e-30))
        return torch.where(x > 0.0,
                           _normal_logpdf(lx, self.mu, self.sigma) - lx,
                           -math.inf)


class Interped(Prior):
    """Tabulated density: the CDF is built host-side in float64 and
    inverted by interpolation (bilby's Interped, used for the Hubble prior,
    nmma/em/prior.py:172-218)."""

    def __init__(self, xx, yy, minimum=None, maximum=None, name=None,
                 latex_label=None, **kwargs):
        xx = np.asarray(xx, dtype=np.float64)
        yy = np.asarray(yy, dtype=np.float64)
        order = np.argsort(xx)
        xx, yy = xx[order], np.maximum(yy[order], 0.0)
        if minimum is not None or maximum is not None:
            lo = minimum if minimum is not None else xx[0]
            hi = maximum if maximum is not None else xx[-1]
            mask = (xx >= lo) & (xx <= hi)
            xx, yy = xx[mask], yy[mask]
        # densify so the trapezoid CDF resolves the interpolated density
        # (a 2-node linear density would otherwise invert to uniform)
        if len(xx) < 256:
            dense_x = np.linspace(xx[0], xx[-1], 1024)
            yy = np.interp(dense_x, xx, yy)
            xx = dense_x
        super().__init__(name=name, latex_label=latex_label, minimum=xx[0],
                         maximum=xx[-1])
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (yy[1:] + yy[:-1])
                                               * np.diff(xx))])
        norm = cdf[-1]
        cdf /= cdf[-1]
        # strictly increasing CDF for stable inversion
        cdf = np.maximum.accumulate(cdf + np.arange(len(cdf)) * 1e-15)
        self.xx = xx
        self.yy = yy / norm
        self.cdf = cdf / cdf[-1]

    def _table(self, name, like):
        return torch.as_tensor(getattr(self, name), dtype=like.dtype,
                               device=like.device)

    def transform(self, u):
        return interp(u, self._table("cdf", u), self._table("xx", u))

    def log_prob(self, x):
        dens = interp(x, self._table("xx", x), self._table("yy", x),
                      left=0.0, right=0.0)
        return torch.log(torch.clamp(dens, min=1e-30))


class Constraint(Prior):
    """Range constraint on a derived parameter; not sampled.

    Parameters outside [minimum, maximum] get logL = -inf (reference: bilby
    Constraint + ``evaluate_constraints``, nmma/core/base.py:274-288).
    """

    sampled = False

    def transform(self, u=None):
        raise RuntimeError("Constraint priors are never transformed")

    def log_prob(self, x):
        return torch.where(self._in_range(x), 0.0, -math.inf)


class NMMADummyPrior(Prior):
    """Placeholder read from a .prior file, replaced by
    ``adjust_priors_for_nmma`` (reference nmma/core/base.py:187-231)."""

    sampled = False

    def __init__(self, setup_props, name=None):
        super().__init__(name=name, minimum=0.0, maximum=1.0)
        self.setup_props = setup_props

    def transform(self, u=None):
        raise RuntimeError(
            f"NMMADummyPrior('{self.setup_props}') was never replaced — "
            "call adjust_priors_for_nmma(priors) first")

    def log_prob(self, x):
        return torch.zeros_like(x)


class PriorDict:
    """Ordered prior collection with a batched unit-cube transform."""

    def __init__(self, priors: dict[str, Prior]):
        self.priors = dict(priors)
        for key, p in self.priors.items():
            if p.name is None:
                p.name = key
        self.sampled_names = [k for k, p in self.priors.items()
                              if p.sampled]
        self.constraint_names = [k for k, p in self.priors.items()
                                 if isinstance(p, Constraint)]
        self.fixed = {k: p for k, p in self.priors.items()
                      if (not p.sampled) and not isinstance(p, Constraint)}

    @property
    def ndim(self):
        return len(self.sampled_names)

    def __contains__(self, key):
        return key in self.priors

    def __getitem__(self, key):
        return self.priors[key]

    def keys(self):
        return self.priors.keys()

    def transform(self, u):
        """u [B, ndim] -> {name: [B]}, fixed parameters included."""
        params = {name: self.priors[name].transform(u[:, i])
                  for i, name in enumerate(self.sampled_names)}
        for name, prior in self.fixed.items():
            params[name] = torch.full(u.shape[:1], prior.transform(),
                                      dtype=u.dtype, device=u.device)
        return params

    def constraint_log_prob(self, params):
        """Sum of constraint indicators over the derived parameters present;
        ``[B]``, 0 where every constraint holds and -inf elsewhere."""
        shape = next(iter(params.values())).shape
        like = next(iter(params.values()))
        total = torch.zeros(shape, dtype=like.dtype, device=like.device)
        for name in self.constraint_names:
            if name in params:
                total = total + self.priors[name].log_prob(params[name])
        return total

    def sample_units(self, generator: torch.Generator, n: int):
        """``[n, ndim]`` uniform unit-cube draws on the generator's device."""
        return torch.rand((n, self.ndim), generator=generator,
                          device=generator.device)
