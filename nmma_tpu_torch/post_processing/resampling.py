"""GW x EM joint resampling over (Mc, q, EOS, alpha, zeta), batch-first.

PyTorch counterpart of ``nmma_tpu/post_processing/resampling.py``
(``gwem-resampling``, ``nmma/post_processing/resampling.py:53-240``):
re-infer the binary and nuisance parameters by combining KDE densities of
the GW posterior with a KDE of the EM-inferred ejecta posterior, through
the EOS-index conversion chain between them, with the port's batched
``NestedSampler``. The conventions are the JAX package's, term for term
(reference resampling.py:96-171):

* the GW chirp-mass KDE is built in the source frame: detector-frame chirp
  masses are divided by (1 + z(d_L)) when the posterior carries a
  ``luminosity_distance`` column;
* the mass-ratio density is a KDE of 1/q evaluated at m1/m2;
* the EM ejecta KDE lives in linear masses, evaluated at (mdyn, mwind);
* GW EOS information enters through the per-EOS sample count of the GW
  posterior's ``EOS`` column, with EOS indices absent from it rejected;
  without an EOS column, a KDE of lambda_tilde stands in;
* the NSBH variant feeds chi_eff = (chi_1 + q chi_2)/(1 + q) to the ejecta
  fits and takes the remnant fit directly as the disk mass.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conversion as C
from .. import resolve_device
from ..constants import geom_msun_km
from ..inference import NestedSampler, NestedSamplerConfig
from ..priors import PriorDict, Uniform
from .kde import GaussianKDE

NEG_INF = -1e30


def _linear_em_samples(em_samples, total_mode):
    """EM KDE training samples in linear ejecta masses."""
    if total_mode:
        if "log10_mej" in em_samples:
            return 10.0 ** np.asarray(em_samples["log10_mej"])
        # the reference's combine_ejecta_mass branch: sum the components
        return (10.0 ** np.asarray(em_samples["log10_mej_dyn"])
                + 10.0 ** np.asarray(em_samples["log10_mej_wind"]))
    return np.column_stack([
        10.0 ** np.asarray(em_samples["log10_mej_dyn"]),
        10.0 ** np.asarray(em_samples["log10_mej_wind"])])


def run_resampler(resampler, nlive, verbose, kwargs):
    """Nested sampling of ``resampler.log_likelihood`` over its priors on
    its device (n_delete = nlive / 8): (result, posterior {name: numpy})."""
    priors = resampler.priors

    @torch.no_grad()
    def unit_logl(u):
        return resampler.log_likelihood(priors.transform(u))

    sampler = NestedSampler(
        unit_logl, priors.ndim,
        NestedSamplerConfig(nlive=nlive, n_delete=max(nlive // 8, 1),
                            **kwargs), device=resampler.device)
    result = sampler.run(verbose=verbose)
    idx = result.posterior_indices()
    with torch.no_grad():
        post = priors.transform(torch.as_tensor(
            result.samples_u[idx], dtype=torch.float32,
            device=resampler.device))
    return result, {k: v.cpu().numpy() for k, v in post.items()}


class GWEMResampler:
    def __init__(self, gw_samples, em_samples, eos_set,
                 total_ejecta_mass=False, with_nsbh=False,
                 priors=None, cosmology=None, device=None):
        """
        gw_samples : dict with chirp_mass (detector frame when a
            luminosity_distance column is present), mass_ratio, and
            either an EOS column or lambda_tilde; ``with_nsbh=True`` also
            chi_1, chi_2.
        em_samples : dict with log10_mej_dyn/log10_mej_wind (or log10_mej
            for ``total_ejecta_mass``)
        eos_set : TabulatedEOSSet (the conversion step)
        priors : optional dict of prior overrides
        device : where the likelihood and the sampler run (default the
            CUDA card)
        """
        self.device = resolve_device(device)
        self.eos_set = eos_set
        self.with_nsbh = bool(with_nsbh)
        self.total_mode = total_ejecta_mass
        self.em_kde = GaussianKDE(_linear_em_samples(em_samples,
                                                     total_ejecta_mass))

        mc = np.asarray(gw_samples["chirp_mass"], dtype=np.float64)
        q = np.asarray(gw_samples["mass_ratio"], dtype=np.float64)
        if "luminosity_distance" in gw_samples:
            from ..cosmology import get_cosmology
            cosmo = cosmology or get_cosmology()
            z = cosmo.redshift_at_dl(torch.as_tensor(
                np.asarray(gw_samples["luminosity_distance"]),
                dtype=torch.float32)).numpy().astype(np.float64)
            mc = mc / (1.0 + z)

        self.mc_kde = GaussianKDE(mc)
        self.invq_kde = GaussianKDE(1.0 / q)

        # GW EOS information: per-EOS sample counts (reference :146) or
        # the lambda_tilde KDE
        self._log_eos_counts = None
        self.lambda_kde = None
        if "EOS" in gw_samples:
            idx = np.clip(np.floor(np.asarray(
                gw_samples["EOS"], dtype=np.float64)).astype(int),
                0, eos_set.n_eos - 1)
            counts = np.bincount(idx, minlength=eos_set.n_eos).astype(
                np.float64)
            with np.errstate(divide="ignore"):
                logc = np.log(counts)
            self._log_eos_counts = torch.as_tensor(
                np.where(counts > 0, logc, NEG_INF), dtype=torch.float32,
                device=self.device)
        elif not self.with_nsbh:
            self.lambda_kde = GaussianKDE(
                np.asarray(gw_samples["lambda_tilde"], dtype=np.float64))

        prior_dict = {
            "chirp_mass": Uniform(minimum=float(mc.min()),
                                  maximum=float(mc.max())),
            "mass_ratio": Uniform(minimum=float(q.min()),
                                  maximum=float(min(q.max(), 1.0))),
            "EOS": Uniform(minimum=0.0, maximum=float(eos_set.n_eos)),
            "alpha": Uniform(minimum=-1e-3, maximum=1e-3),
            "ratio_zeta": Uniform(minimum=0.0, maximum=1.0),
        }
        if self.with_nsbh:
            chi1 = np.asarray(gw_samples["chi_1"], dtype=np.float64)
            chi2 = np.asarray(gw_samples["chi_2"], dtype=np.float64)
            self.chi1_kde = GaussianKDE(chi1)
            self.chi2_kde = GaussianKDE(chi2)
            prior_dict["chi_1"] = Uniform(minimum=float(chi1.min()),
                                          maximum=float(chi1.max()))
            prior_dict["chi_2"] = Uniform(minimum=float(chi2.min()),
                                          maximum=float(chi2.max()))
        if priors:
            prior_dict.update(priors)
        self.priors = PriorDict(prior_dict)

    def log_likelihood(self, params):
        """params {name: [B]} -> [B] log-likelihoods, -1e30 where the
        conversion leaves no ejecta or the density is not finite."""
        p = C.generate_mass_parameters(dict(params))
        # the chirp-mass KDE is source frame, so the sampled masses are
        # source-frame masses
        p["mass_1_source"] = p["mass_1"]
        p["mass_2_source"] = p["mass_2"]
        p = self.eos_set(p)
        m1, m2 = p["mass_1"], p["mass_2"]
        r1, r2 = p["radius_1"], p["radius_2"]
        comp2 = m2 * geom_msun_km / torch.clamp(r2, min=1e-6)
        alpha, zeta = p["alpha"], p["ratio_zeta"]

        if self.with_nsbh:
            # the reference's NSBH resampler (:121-133): chi_eff drives the
            # fits; the remnant fit is the disk mass
            chieff = C.chi_eff(m1, m2, p["chi_1"], p["chi_2"])
            mdyn = C.nsbh_dynamic_mass(m1, m2, comp2, chieff) + alpha
            mdisk = C.nsbh_remnant_disk_mass(m1, m2, comp2, chieff)
            branch_ok = r2 > 0.0       # the secondary a neutron star
        else:
            comp1 = m1 * geom_msun_km / torch.clamp(r1, min=1e-6)
            mdyn = C.bns_dynamic_mass_krfo(m1, m2, comp1, comp2) + alpha
            log10_mdisk = C.bns_log10_disk_mass(
                m1 + m2, m2 / m1, p["TOV_mass"], p["R_16"] / geom_msun_km)
            mdisk = 10.0 ** log10_mdisk
            branch_ok = (r1 > 0.0) & (r2 > 0.0)
        mwind = zeta * mdisk

        logp = self.mc_kde(p["chirp_mass"]) + self.invq_kde(m1 / m2)
        if self._log_eos_counts is not None:
            logp = logp + self._log_eos_counts[self.eos_set.index(p["EOS"])]
        elif self.lambda_kde is not None:
            logp = logp + self.lambda_kde(C.lambda_1_lambda_2_to_lambda_tilde(
                p["lambda_1"], p["lambda_2"], m1, m2))
        if self.with_nsbh:
            logp = logp + self.chi1_kde(p["chi_1"]) + self.chi2_kde(
                p["chi_2"])

        if self.total_mode:
            em_logl = self.em_kde(mdyn + mwind)
        else:
            em_logl = self.em_kde(torch.stack([mdyn, mwind], dim=1))

        logl = logp + em_logl
        ok = branch_ok & (mdyn > 0.0) & (mdisk > 0.0) & torch.isfinite(logl)
        logl = torch.where(ok, logl, NEG_INF)
        return torch.where(torch.isnan(logl), NEG_INF, logl)

    def run(self, nlive=512, verbose=False, **kwargs):
        """Nested sampling of the resampled posterior: (result, posterior
        {name: numpy})."""
        return run_resampler(self, nlive, verbose, kwargs)
