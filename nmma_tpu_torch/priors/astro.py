"""Astrophysics-specific prior construction.

Port of ``nmma_tpu/priors/astro.py`` (the reference's ``nmma/em/prior.py``
and ``adjust_priors_for_nmma``, nmma/core/base.py:198-231): the
linear-decay extinction (Ebv) prior, Hubble priors, the composition step
``create_prior_from_args`` (prior file -> Hubble -> Ebv -> conditional
inclination -> systematics), the HDF5 multivariate-Gaussian block and the
replacement of ``NMMADummyPrior`` placeholders. All of it runs on the host
once; the priors it builds transform ``[B]`` tensors.
"""

from __future__ import annotations

import numpy as np

from .core import (ConditionalGaussianIotaGivenThetaCore, DeltaFunction,
                   Gaussian, Interped, NMMADummyPrior, PriorDict, Uniform,
                   multivariate_gaussian_priors)


def extinction_prior(priors: dict, Ebv_max=0.5724, use_Ebv=True,
                     fixed_Ebv=None):
    """Linear-decay Ebv prior p(Ebv) ~ 1 - Ebv/Ebv_max on [0, Ebv_max]
    (reference prior.py:208-218), added to ``priors`` unless it has an
    Ebv; Ebv_max <= 0 or use_Ebv=False pins Ebv = 0."""
    if "Ebv" in priors:
        return priors
    if fixed_Ebv is not None:
        priors["Ebv"] = DeltaFunction(peak=float(fixed_Ebv), name="Ebv")
    elif Ebv_max > 0.0 and use_Ebv:
        ebv_c = 1.0 / (0.5 * Ebv_max)
        priors["Ebv"] = Interped([0.0, Ebv_max], [ebv_c, 0.0], minimum=0.0,
                                 maximum=Ebv_max, name="Ebv",
                                 latex_label="$E(B-V)$")
    else:
        priors["Ebv"] = DeltaFunction(peak=0.0, name="Ebv")
    return priors


def hubble_prior(kind="uniform", minimum=20.0, maximum=140.0, samples=None):
    """Hubble-constant prior: uniform, the Planck or SH0ES Gaussian, or an
    Interped density from posterior samples (a 100-bin histogram)."""
    if samples is not None:
        hist, edges = np.histogram(np.asarray(samples), bins=100,
                                   density=True)
        centres = 0.5 * (edges[1:] + edges[:-1])
        return Interped(centres, hist, name="Hubble_constant",
                        latex_label="$H_0$")
    if kind == "planck":
        return Gaussian(mu=67.36, sigma=0.54, name="Hubble_constant")
    if kind == "shoes":
        return Gaussian(mu=73.04, sigma=1.04, name="Hubble_constant")
    return Uniform(minimum=minimum, maximum=maximum, name="Hubble_constant",
                   latex_label="$H_0$")


def create_prior_from_args(prior_file, systematics=None, Ebv_max=0.5724,
                           use_Ebv=False,
                           conditional_gaussian_prior_thetaObs=False,
                           conditional_gaussian_prior_N_sigma=1.0,
                           sample_hubble=False, hubble_kind="uniform"):
    """The analysis PriorDict (reference create_prior_from_args,
    nmma/em/prior.py:221-244)."""
    from .parser import load_prior_file
    priors = dict(load_prior_file(prior_file).priors)

    if sample_hubble and "Hubble_constant" not in priors:
        priors["Hubble_constant"] = hubble_prior(hubble_kind)
    if use_Ebv:
        extinction_prior(priors, Ebv_max=Ebv_max, use_Ebv=use_Ebv)
    if conditional_gaussian_prior_thetaObs:
        incl = priors.get("inclination_EM")
        priors["inclination_EM"] = ConditionalGaussianIotaGivenThetaCore(
            N_sigma=conditional_gaussian_prior_N_sigma,
            minimum=getattr(incl, "minimum", 0.0),
            maximum=getattr(incl, "maximum", np.pi / 2),
            name="inclination_EM")
        # the conditional prior comes after its parent
        if "thetaCore" in priors:
            incl = priors.pop("inclination_EM")
            priors["inclination_EM"] = incl
    if systematics is not None:
        priors.update(systematics.create_priors())
    return PriorDict(priors)


def inclination_prior_from_fits(fits_file, dL, ra=None, dec=None,
                                cosiota_node_num=10, n_grid=1000):
    """The skymap-FITS inclination prior needs the FITS reader
    (``io/fits.py``), which is not in the port yet."""
    raise NotImplementedError(
        "inclination_prior_from_fits needs io/fits.py, which nmma_tpu_torch "
        "does not have yet (ROADMAP item 17)")


def h5_to_multivar_prior(h5_file_path, priors=None):
    """Add a multivariate Gaussian fitted to the sample columns of an HDF5
    file, each top-level dataset one parameter's samples (reference
    ``h5_to_multivar_prior``, nmma/core/base.py:257-272)."""
    import h5py

    priors = dict(priors or {})
    with h5py.File(h5_file_path, "r") as f:
        keys = list(f.keys())
        samples = np.column_stack([np.asarray(f[k]) for k in keys])
    priors.update(multivariate_gaussian_priors(keys, samples=samples))
    return priors


def adjust_priors_for_nmma(priors):
    """Replace NMMADummyPrior placeholders: '*h5*' keys become a
    multivariate-Gaussian block from an HDF5 sample file, '*hubble*' keys an
    Interped prior from a two-column Hubble weight table. Returns a
    PriorDict."""
    pd = dict(priors.priors) if isinstance(priors, PriorDict) else \
        dict(priors)
    for key in list(pd):
        prior = pd[key]
        if not isinstance(prior, NMMADummyPrior):
            continue
        setup = prior.setup_props
        pd.pop(key)
        if "h5" in key.lower():
            pd = h5_to_multivar_prior(setup, pd)
        elif "hubble" in key.lower():
            table = np.loadtxt(setup)
            if table.ndim != 2:
                raise ValueError(f"bad Hubble weight table {setup}")
            pd["Hubble_constant"] = Interped(
                table[:, 0], table[:, 1], name="Hubble_constant")
        else:
            raise ValueError(
                f"NMMADummyPrior key {key!r} matches no replacement rule "
                "(expected 'h5' or 'hubble' in the name)")
    return PriorDict(pd)
