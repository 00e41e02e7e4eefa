"""Prior system: analytic unit-cube transforms on batched tensors.

PyTorch counterpart of ``nmma_tpu/priors/core.py`` (the bilby prior layer
the reference leans on, ``bilby.core.prior`` + ``nmma/em/prior.py``): every
prior is a closed-form inverse-CDF transform ``u in [0,1] -> x`` on a
``[B]`` tensor, so a whole live-point batch ``[B, ndim]`` maps through
``PriorDict.transform`` at once. Conditional priors receive the parameters
already transformed; priors are evaluated in declaration order (parents
first), bilby's convention.
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
    conditional = False  # transform consumes previously transformed params

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
        # -inf where the density is 0, as the JAX package's f32
        # log(max(dens, 1e-300)), whose floor rounds to 0
        return torch.log(torch.clamp(dens, min=0.0))


class UniformComovingVolume(Interped):
    """Luminosity-distance prior uniform in comoving volume
    (``bilby.gw.prior.UniformComovingVolume``): p(d_L) ~ dV_c/dd_L under
    the fiducial cosmology, tabulated on a dense d_L grid and inverted as an
    Interped prior (nmma_tpu priors/core.py:259-283)."""

    def __init__(self, minimum, maximum, name=None, latex_label=None,
                 cosmology=None, **kwargs):
        dl, z, dvc_ddl = _comoving_volume_density(minimum, maximum, cosmology)
        super().__init__(dl, np.maximum(dvc_ddl, 0.0), minimum=minimum,
                         maximum=maximum, name=name, latex_label=latex_label)


class UniformSourceFrame(Interped):
    """d_L prior uniform in comoving volume and source-frame time:
    p(d_L) ~ (dV_c/dd_L) / (1 + z) (``bilby.gw.prior.UniformSourceFrame``)."""

    def __init__(self, minimum, maximum, name=None, latex_label=None,
                 cosmology=None, **kwargs):
        dl, z, dvc_ddl = _comoving_volume_density(minimum, maximum, cosmology)
        super().__init__(dl, np.maximum(dvc_ddl / (1.0 + z), 0.0),
                         minimum=minimum, maximum=maximum, name=name,
                         latex_label=latex_label)


def _comoving_volume_density(minimum, maximum, cosmology=None):
    """(d_L, z, dV_c/dd_L up to a constant) on 2048 nodes, float64: flat
    dV_c/dz ~ D_c^2 / E(z) with D_c = d_L / (1 + z), times dz/dd_L of the
    tabulated curve."""
    from ..cosmology import get_cosmology
    cosmo = cosmology or get_cosmology()
    dl = np.linspace(float(minimum), float(maximum), 2048)
    z = np.interp(dl, cosmo.dl_grid, cosmo.z_grid)
    dc = dl / (1.0 + z)
    dvc_dz = dc * dc * cosmo._inv_efunc(z)
    return dl, z, dvc_dz * np.gradient(z, dl)


class WeightedCategorical(Prior):
    """Discrete prior over ``ncategories`` indices with optional weights
    (the reference's ``WeightedCategorical``, nmma/eos/eos_likelihood.py
    :21-32): the unit-cube coordinate inverts the weight CDF, and the
    transform returns the category's midpoint ``index + 0.5`` as a float."""

    def __init__(self, ncategories, weights=None, name=None,
                 latex_label=None):
        super().__init__(name=name, latex_label=latex_label, minimum=0.0,
                         maximum=float(ncategories))
        self.ncategories = int(ncategories)
        if weights is None:
            w = np.ones(self.ncategories, dtype=np.float64)
        else:
            w = np.asarray(weights, dtype=np.float64)
            if len(w) != self.ncategories:
                raise ValueError(
                    f"{len(w)} weights for {self.ncategories} categories")
        w = np.maximum(w, 0.0)
        self._probs = w / w.sum()
        cdf = np.concatenate([[0.0], np.cumsum(self._probs)])
        cdf[-1] = 1.0
        self._cdf = cdf
        self._log_probs = np.log(np.maximum(self._probs, 1e-300))

    def _table(self, values, like):
        return torch.as_tensor(values, dtype=like.dtype, device=like.device)

    def transform(self, u):
        # category = number of inner CDF edges at or below u
        edges = self._table(self._cdf[1:-1], u)
        idx = (u[..., None] >= edges).sum(dim=-1)
        return idx.to(u.dtype) + 0.5

    def log_prob(self, x):
        idx = torch.clamp(torch.floor(x).long(), 0, self.ncategories - 1)
        in_range = (x >= 0.0) & (x < self.ncategories)
        return torch.where(in_range, self._table(self._log_probs, x)[idx],
                           -math.inf)


class ConditionalGaussianIotaGivenThetaCore(Prior):
    """Half-Gaussian on iota with width ``N_sigma * thetaCore``, truncated
    to [minimum, maximum] (``ConditionalGaussianIotaGivenThetaCore``,
    nmma/em/prior.py:18-77)."""

    conditional = True

    def __init__(self, N_sigma=1.0, minimum=0.0, maximum=np.pi / 2,
                 name=None, latex_label=None, **kwargs):
        super().__init__(name=name, latex_label=latex_label, minimum=minimum,
                         maximum=maximum)
        self.n_sigma = float(N_sigma)

    def transform(self, u, params=None):
        sigma = self.n_sigma * params["thetaCore"]
        sqrt2 = math.sqrt(2.0)
        a = torch.special.erf(self.minimum / (sqrt2 * sigma))
        b = torch.special.erf(self.maximum / (sqrt2 * sigma))
        return sqrt2 * sigma * torch.erfinv(a + u * (b - a))

    def log_prob(self, x):
        raise NotImplementedError("conditional log_prob requires parent")


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
        params = {}
        for i, name in enumerate(self.sampled_names):
            prior = self.priors[name]
            params[name] = prior.transform(u[:, i], params) \
                if prior.conditional else prior.transform(u[:, i])
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


class _SharedMultivariateGaussian:
    """Host-side (float64) Cholesky factor shared by the per-parameter
    components of one multivariate Gaussian block."""

    def __init__(self, names, mean, cov):
        self.names = list(names)
        self.mean = np.asarray(mean, dtype=np.float64)
        cov = np.asarray(cov, dtype=np.float64)
        self.chol = np.linalg.cholesky(cov + 1e-12 * np.eye(len(self.mean)))
        # leading-block inverses, to recover the whitened coordinates of
        # the earlier components
        self._inv_blocks = [None] + [np.linalg.inv(self.chol[:k, :k])
                                     for k in range(1, len(self.mean))]


class MultivariateGaussianComponent(Prior):
    """One coordinate of a correlated Gaussian prior block (bilby's
    ``MultivariateGaussian`` as the reference's HDF5 prior surgery uses it,
    nmma/core/base.py:257-272). The joint map is x = mean + L z with
    z = ndtri(u); component k is conditional on the earlier ones, whose
    whitened coordinates are recovered from their transformed values, so the
    components in order sample the joint distribution."""

    def __init__(self, shared: _SharedMultivariateGaussian, index: int,
                 name=None, latex_label=None):
        sigma = float(np.sqrt(np.sum(shared.chol[index, :index + 1] ** 2)))
        mu = float(shared.mean[index])
        super().__init__(name=name or shared.names[index],
                         latex_label=latex_label,
                         minimum=mu - 10 * sigma, maximum=mu + 10 * sigma)
        self.shared = shared
        self.index = int(index)
        self.conditional = self.index > 0

    def transform(self, u, params=None):
        sh, k = self.shared, self.index

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=u.dtype,
                                   device=u.device)

        z_k = torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))
        x = f32(sh.mean[k]) + f32(sh.chol[k, k]) * z_k
        if k > 0:
            prev = torch.stack([params[sh.names[j]] for j in range(k)],
                               dim=-1)
            z_prev = (prev - f32(sh.mean[:k])) @ f32(sh._inv_blocks[k]).T
            x = x + z_prev @ f32(sh.chol[k, :k])
        return x

    def log_prob(self, x):
        if self.index > 0:
            raise NotImplementedError(
                "conditional log_prob requires the full block")
        mu = float(self.shared.mean[0])
        sig = float(self.shared.chol[0, 0])
        return _normal_logpdf(x, mu, sig)


def multivariate_gaussian_priors(names, mean=None, cov=None, samples=None):
    """Ordered ``{name: prior}`` sampling a joint Gaussian, from
    ``(mean, cov)`` or fitted to ``samples`` [N, D] (as the reference fits
    the HDF5 sample columns)."""
    if samples is not None:
        samples = np.asarray(samples, dtype=np.float64)
        mean = samples.mean(axis=0)
        cov = np.cov(samples, rowvar=False)
    shared = _SharedMultivariateGaussian(names, mean, cov)
    return {name: MultivariateGaussianComponent(shared, i, name=name)
            for i, name in enumerate(shared.names)}
