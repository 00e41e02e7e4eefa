"""Marginalised light-curve prediction from GW posterior samples.

PyTorch counterpart of ``nmma_tpu/post_processing/marginalisation.py`` (the
reference's ``marginalised_lightcurve_expectation_from_gw_samples``,
``nmma/post_processing/marginalisation.py:16-70``): push a GW posterior
(chirp mass, mass ratio, distance, inclination, ...) through the
EOS-marginalised conversion chain and a kilonova model, and return
percentile bands of the predicted detector-frame magnitudes. The draws are
made on the host with numpy in the JAX package's order; the conversion
chain and the light-curve model run once on the whole ``[N]`` batch on the
model's device. The GW-sample readers (template ascii, lalinference and
bilby hdf5, bilby json/csv results, coinc xml with a sky map's distance)
are host numpy on the port's ``io/ligolw.py`` and ``io/fits.py``.

Run it as ``python -m nmma_tpu_torch.post_processing.marginalisation
[flags]``: on the CUDA card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conversion as C
from .. import resolve_device


def marginalised_lightcurve_expectation(gw_samples, eos_set, lc_model,
                                        percentiles=(5, 50, 95),
                                        extra_parameters=None,
                                        max_samples=2000, seed=0):
    """Percentile magnitude bands [len(percentiles), F, T].

    gw_samples: dict of posterior arrays (chirp_mass, mass_ratio,
    luminosity_distance, theta_jn, ...). extra_parameters: fixed nuisance
    values merged into every sample (e.g. ratio_zeta, alpha). The EOS is
    marginalised by drawing an index per sample when none is present. The
    samples go through the conversion chain and ``lc_model`` as one
    ``[N]`` batch on the model's device.
    """
    rng = np.random.default_rng(seed)
    n = len(np.asarray(next(iter(gw_samples.values()))))
    weights = gw_samples.get("weight")
    if weights is not None:
        # weighted template inputs: importance-resample with p = weight,
        # with replacement (the reference's idys draw,
        # marginalisation.py:70-71); unweighted inputs keep the
        # lower-variance subsample without replacement
        w = np.asarray(weights, dtype=float)
        take = rng.choice(n, size=min(max_samples, n), p=w / w.sum())
    else:
        take = rng.choice(n, size=min(max_samples, n), replace=False)
    device = lc_model.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    params = {k: f32(np.asarray(v)[take]) for k, v in gw_samples.items()
              if k != "weight"}
    n_used = len(take)
    if "EOS" not in params:
        params["EOS"] = f32(
            rng.choice(eos_set.n_eos, size=n_used,
                       p=np.asarray(eos_set.weights))
            + rng.uniform(0, 1, n_used))
    for key, val in (extra_parameters or {}).items():
        params[key] = f32(np.broadcast_to(np.asarray(val), (n_used,)))

    conversion = C.MultimessengerConversion(
        C.bns_source_frame, eos_set, C.KilonovaEjectaFitting())
    with torch.no_grad():
        _, mags = lc_model(conversion(params))            # [N, F, T]
    mags = mags.cpu().numpy()
    mags = np.where(np.isfinite(mags), mags, np.nan)
    return np.nanpercentile(mags, percentiles, axis=0)


# --------------------------------------------------------------------------
# GW-sample input formats (reference marginalisation.py:35-77): template
# ascii tables, lalinference/bilby hdf5, bilby json/csv posteriors, and
# coinc.xml + skymap FITS, through the port's own readers (io/fits,
# io/ligolw) and h5py for HDF5.

def normalize_gw_quantities(d):
    """Canonicalize a raw sample dict (``get_all_gw_quantities``,
    reference marginalisation.py:178-203): derive chirp mass / eta / q
    from component masses or vice versa, default absent spins and
    angles to zero, prefer aligned spin-z columns, uniform weights."""
    d = {k: np.asarray(v, dtype=np.float64) for k, v in d.items()}
    alias = {"m1": "mass_1", "m2": "mass_2", "mc": "chirp_mass",
             "mchirp": "chirp_mass", "dist": "luminosity_distance",
             "distance": "luminosity_distance", "q": "mass_ratio",
             "inclination": "theta_jn", "a1": "a_1", "a2": "a_2",
             "tilt1": "tilt_1", "tilt2": "tilt_2"}
    for src, dst in alias.items():
        if src in d and dst not in d:
            d[dst] = d.pop(src)
    if "mass_1" in d and "mass_2" in d:
        m1, m2 = d["mass_1"], d["mass_2"]
        d.setdefault("chirp_mass",
                     (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2)
        d.setdefault("mass_ratio", m2 / m1)
    elif "chirp_mass" in d and "mass_ratio" in d:
        q = d["mass_ratio"]
        eta = q / (1.0 + q) ** 2
        mtot = d["chirp_mass"] / eta ** 0.6
        d["mass_1"] = mtot / (1.0 + q)        # q = m2/m1 <= 1
        d["mass_2"] = mtot - d["mass_1"]
    else:
        raise ValueError("need (m1, m2) or (chirp_mass, mass_ratio) "
                         f"columns; got {sorted(d)}")
    n = len(d["mass_1"])
    if "spin1z" in d:
        d["a_1"] = d.pop("spin1z")
    if "spin2z" in d:
        d["a_2"] = d.pop("spin2z")
    for key in ("a_1", "a_2", "theta_jn", "tilt_1", "tilt_2"):
        d.setdefault(key, np.zeros(n))
    d.setdefault("cos_tilt_1", np.cos(d["tilt_1"]))
    d.setdefault("cos_tilt_2", np.cos(d["tilt_2"]))
    d.setdefault("weight", np.full(n, 1.0 / n))
    return d


def skymap_distance_moments(path):
    """Sky-marginal (mean, std) luminosity distance [Mpc] from a
    BAYESTAR/LALInference skymap FITS carrying the conditional distance
    ansatz rho(r) = DISTNORM r^2 N(r; DISTMU, DISTSIGMA) per pixel
    (Singer et al. 2016). Gaussian moments are analytic:
    E[r] = N (mu^3 + 3 mu s^2), E[r^2] = N (mu^4 + 6 mu^2 s^2 + 3 s^4);
    marginalizing over pixels weights by PROB (flat maps) or
    PROBDENSITY * cell area (MOC maps) — no rasterization needed, the
    moments are linear in the pixel weights (the reference rasterizes
    only because ligo.skymap's helper wants a flat map)."""
    from ..io.fits import read_bintable, uniq2nest

    cols, header = read_bintable(path)
    names = {k.upper(): k for k in cols}
    mu = cols[names["DISTMU"]].astype(np.float64)
    sig = cols[names["DISTSIGMA"]].astype(np.float64)
    nrm = cols[names["DISTNORM"]].astype(np.float64)
    if "UNIQ" in names:                     # multi-order (MOC) map
        order, _ = uniq2nest(cols[names["UNIQ"]])
        area = (4.0 * np.pi / 12.0) / (4.0 ** order.astype(np.float64))
        prob = cols[names["PROBDENSITY"]].astype(np.float64) * area
    else:
        prob = cols[names["PROB"]].astype(np.float64)
    good = (np.isfinite(prob) & np.isfinite(mu) & np.isfinite(sig)
            & np.isfinite(nrm) & (prob > 0))
    p = prob[good] / prob[good].sum()
    mu, sig, nrm = mu[good], sig[good], nrm[good]
    e_r = nrm * (mu ** 3 + 3.0 * mu * sig ** 2)
    e_r2 = nrm * (mu ** 4 + 6.0 * mu ** 2 * sig ** 2 + 3.0 * sig ** 4)
    mean = float(np.sum(p * e_r))
    var = float(np.sum(p * e_r2) - mean ** 2)
    return mean, float(np.sqrt(max(var, 0.0)))


def load_gw_samples(template_file=None, hdf5_file=None, coinc_file=None,
                    skymap=None, posterior_file=None, seed=0):
    """GW posterior/trigger samples as a canonical dict of arrays.

    Accepts exactly the reference's three sources (template ascii /
    lalinference hdf5 / coinc.xml + skymap FITS, reference
    marginalisation.py:35-77) plus bilby-result posteriors (json, csv,
    hdf5) via ``posterior_file``.
    """
    rng = np.random.default_rng(seed)
    if template_file is not None:
        raw = np.atleast_2d(np.loadtxt(template_file))
        cols8 = ["SNRdiff", "erf", "weight", "m1", "m2", "a1", "a2",
                 "dist"]
        cols6 = ["SNRdiff", "erf", "weight", "m1", "m2", "dist"]
        names = cols8 if raw.shape[1] == 8 else cols6
        d = {n: raw[:, i] for i, n in enumerate(names)}
        weight = d.pop("weight")
        d.pop("SNRdiff"), d.pop("erf")
        d = normalize_gw_quantities(d)
        d["weight"] = weight / weight.sum()
        return d
    if hdf5_file is not None:
        import h5py

        with h5py.File(hdf5_file, "r") as f:
            if "lalinference" in f:         # lalinference MCMC layout
                group = f["lalinference"]
                run = next(iter(group))
                post = group[run]["posterior_samples"][()]
            elif "posterior" in f:          # bilby hdf5 result
                post = {k: f["posterior"][k][()]
                        for k in f["posterior"]}
            else:
                raise ValueError(
                    f"unrecognized HDF5 layout: {sorted(f)}")
        if hasattr(post, "dtype") and post.dtype.names:
            post = {n: np.asarray(post[n]) for n in post.dtype.names}
        return normalize_gw_quantities(
            {k: v for k, v in post.items()
             if np.asarray(v).dtype.kind in "fiu"})
    if posterior_file is not None:
        path = str(posterior_file)
        if path.endswith(".json"):
            import json as _json

            with open(path) as fh:
                res = _json.load(fh)
            post = res.get("posterior", res)
            post = post.get("content", post)
            return normalize_gw_quantities(
                {k: np.asarray(v) for k, v in post.items()
                 if np.asarray(v).dtype.kind in "fiu"})
        if path.endswith((".hdf5", ".h5", ".hdf")):
            return load_gw_samples(hdf5_file=path)
        raw = np.genfromtxt(path, names=True,
                            delimiter="," if path.endswith(".csv")
                            else None)
        return normalize_gw_quantities(
            {n: np.asarray(raw[n]) for n in raw.dtype.names})
    if coinc_file is not None:
        from ..io.ligolw import read_ligolw_table

        cols = read_ligolw_table(coinc_file, tablename="sngl_inspiral")
        m1 = np.asarray(cols["mass1"], dtype=np.float64)
        m2 = np.asarray(cols["mass2"], dtype=np.float64)
        d = {"m1": m1, "m2": m2}
        for src, dst in (("spin1z", "a1"), ("spin2z", "a2")):
            if src in cols:
                d[dst] = np.asarray(cols[src], dtype=np.float64)
        if skymap is None:
            raise ValueError("coinc_file requires a skymap FITS for the "
                             "distance (reference marginalisation.py:55)")
        mean, std = skymap_distance_moments(skymap)
        d["dist"] = mean + rng.standard_normal(len(m1)) * std
        return normalize_gw_quantities(d)
    raise ValueError(
        "need template_file, hdf5_file, posterior_file, or coinc_file")


def main(args=None, device=None):
    """``lightcurve-marginalisation``: marginalised light-curve bands from
    GW samples, written to ``{outdir}/marginalised_lc.npz`` (with --plot
    also the figure ``marginalised_lc.pdf``, which needs matplotlib);
    returns the npz's path. ``device`` overrides ``--device``.

    Flag names follow the reference's ``lc_marginalisation_parser``
    (post_processing/parser.py:114-135).
    """
    import argparse
    import os

    from ..eos import load_macro_eos_set
    from ..models import DetectorLightCurveModel

    p = argparse.ArgumentParser(
        description="Marginalised light-curve prediction from GW samples")
    p.add_argument("--template-file")
    p.add_argument("--hdf5-file")
    p.add_argument("--coinc-file")
    p.add_argument("--posterior-file",
                   help="bilby result posterior (json/csv/hdf5)")
    p.add_argument("-s", "--skymap")
    p.add_argument("--eos-data", "--eos-dir", dest="eos_data",
                   required=True)
    p.add_argument("-e", "--eos-weights", "--gw170817-eos",
                   dest="eos_weights")
    p.add_argument("--model", default="Me2017")
    p.add_argument("--filters", default="ztfg,ztfr,ztfi")
    p.add_argument("--tmin", type=float, default=0.1)
    p.add_argument("--tmax", type=float, default=14.0)
    p.add_argument("--n-tstep", type=int, default=50)
    p.add_argument("-n", "--Nmarg", type=int, default=100)
    p.add_argument("--generation-seed", type=int, default=42)
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    ns = p.parse_args(args)
    device = resolve_device(device if device is not None else ns.device)

    gw = load_gw_samples(template_file=ns.template_file,
                         hdf5_file=ns.hdf5_file,
                         coinc_file=ns.coinc_file,
                         posterior_file=ns.posterior_file,
                         skymap=ns.skymap, seed=ns.generation_seed)
    weights = None
    if ns.eos_weights:
        weights = np.loadtxt(ns.eos_weights)
        weights = weights / weights.sum()
    eos_set = load_macro_eos_set(ns.eos_data, weights=weights)
    filters = [f.strip() for f in ns.filters.split(",") if f.strip()]
    times = np.geomspace(ns.tmin, ns.tmax, ns.n_tstep)
    model = DetectorLightCurveModel(ns.model, filters, sample_times=times,
                                    device=device)
    bands = marginalised_lightcurve_expectation(
        gw, eos_set, model, max_samples=ns.Nmarg,
        seed=ns.generation_seed)
    os.makedirs(ns.outdir, exist_ok=True)
    out = os.path.join(ns.outdir, "marginalised_lc.npz")
    np.savez(out, bands=bands, times=times,
             filters=np.asarray(filters, dtype=object),
             percentiles=np.asarray([5, 50, 95]))
    print(f"wrote {out}: bands {bands.shape}")
    if ns.plot:
        from ..plotting import plot_marginalised_bands
        plot_marginalised_bands(
            times, bands, filters,
            os.path.join(ns.outdir, "marginalised_lc.pdf"))
    return out


if __name__ == "__main__":
    main()
