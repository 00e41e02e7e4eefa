"""Astrophysics-specific prior construction.

Port of ``nmma_tpu/priors/astro.py`` (the reference's ``nmma/em/prior.py``
and ``adjust_priors_for_nmma``, nmma/core/base.py:198-231): the
linear-decay extinction (Ebv) prior, Hubble priors, the composition step
``create_prior_from_args`` (prior file -> Hubble -> Ebv -> conditional
inclination -> systematics), the sky-map inclination prior, the HDF5
multivariate-Gaussian block and the replacement of ``NMMADummyPrior``
placeholders. All of it runs on the host
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
    """``Interped`` inclination_EM prior from a BAYESTAR-style sky map FITS
    (``inclination_prior_from_fits``, nmma/em/prior.py:80-171; the JAX
    package's nmma_tpu/priors/astro.py:91-148). The multi-order map's
    per-pixel cos-iota-conditional distance layers (the PROBDENSITY,
    DISTMU, DISTSIGMA and DISTNORM ``*_SAMPLES`` columns) are read with
    the numpy FITS reader at the pixel of (ra, dec) in degrees, or of the
    most probable pixel when they are None; then

        p(u) = probdensity(u) distnorm(u) dL^2 N(dL; mu(u), sigma(u))
        p(iota) = p(cos iota) |sin iota|, folded onto [0, pi/2]

    with each layer PCHIP-interpolated over the cos-iota nodes. Host numpy
    once; the prior transforms ``[B]`` tensors."""
    from scipy.interpolate import PchipInterpolator
    from scipy.stats import norm

    from ..io.fits import read_bintable, skymap_pixel_index, uniq2nest

    cols, _ = read_bintable(fits_file)
    if "PROBDENSITY" in cols:                # scalar column (prior.py:86)
        map_idx = int(np.argmax(cols["PROBDENSITY"]))
    else:
        map_idx = int(np.argmax(
            np.atleast_2d(cols["PROBDENSITY_SAMPLES"]).mean(axis=1)))

    if ra is not None and dec is not None and "UNIQ" in cols:
        orders, nests = uniq2nest(cols["UNIQ"])
        order = int(orders[map_idx])
        target = skymap_pixel_index(ra, dec, 2 ** order)
        nest_idxs = np.where(orders == order, nests, 0)
        row = int(np.argmin(np.abs(nest_idxs - target)))
    else:
        row = map_idx

    nodes = np.cos(np.linspace(0.0, np.pi, int(cosiota_node_num)))[::-1]
    layer = {name: PchipInterpolator(
        nodes, np.atleast_2d(cols[f"{name}_SAMPLES"])[row][::-1])
        for name in ("PROBDENSITY", "DISTMU", "DISTSIGMA", "DISTNORM")}

    u = np.linspace(-1.0, 1.0, n_grid)
    prob_u = (layer["PROBDENSITY"](u) * layer["DISTNORM"](u) * dL**2
              * norm(layer["DISTMU"](u), layer["DISTSIGMA"](u)).pdf(dL))
    iota = np.arccos(u)                       # descending pi -> 0
    prob_iota = prob_u * np.abs(np.sin(iota))

    # fold [pi/2, pi] onto [0, pi/2]: the EM side cannot tell iota from
    # pi - iota
    lt = iota < np.pi / 2
    iota_em = iota[lt]
    prob_em = prob_iota[lt] + prob_iota[~lt][::-1]
    order_ix = np.argsort(iota_em)
    return Interped(iota_em[order_ix], prob_em[order_ix], minimum=0.0,
                    maximum=np.pi / 2, name="inclination_EM")


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
