"""Secondary command lines: generation, injections, training, the
post-processing combiners, job scripts and the model registry.

Port of every entry point of ``nmma_tpu/cli/tools.py`` (the reference's
console scripts, ``pyproject.toml:106-126``), with the JAX package's flags,
and ``nmma-plot-multi-corner`` (``post_processing/plotting_routines.py``).
Those that run a model or a sampler (lightcurve-generation,
nmma-create-injection, gwem-resampling, create-svdmodel,
svdmodel-benchmark, lightcurve-injection-slurm-setup) run on the CUDA card
and raise without one, unless ``--device cpu`` (or ``device="cpu"``) asks
for the CPU; the others run on the host. The two that draw
(plot-svdmodel-benchmarks, nmma-plot-multi-corner) need matplotlib. Run as

    python -m nmma_tpu_torch.cli.tools <console-script name> [flags]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time
import warnings

import numpy as np

from .. import resolve_device
from ..post_processing import plotting_routines
from .parsing import apply_config, check_for_config

MLP_BACKENDS = ("keras", "tensorflow", "jax", "torch")
GP_BACKENDS = ("sklearn_gp", "api_gp")


def _device_flag(p):
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")


def _device(device, args):
    return resolve_device(device if device is not None else args.device)


def _grid_files(data_path):
    files = sorted(glob.glob(os.path.join(data_path, "*.dat")))
    return files or sorted(glob.glob(data_path))


def create_svdmodel(cli_args=None, device=None, info=None):
    """``create-svdmodel``: train an SVD surrogate from a grid directory and
    write it under --svd-path; returns the written path. ``device``
    overrides ``--device``; a dict ``info`` receives the seconds spent
    reading the grid and, for the MLP, the trained surrogate's
    ``fit_info``."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="create-svdmodel")
    p.add_argument("--model", required=True,
                   help="grid family (Bu2019lm, Bu2019lm_sparse, Ka2017, ...)")
    p.add_argument("--data-path", required=True)
    p.add_argument("--interpolation-type", default="tensorflow")
    p.add_argument("--svd-path", default="svdmodels")
    p.add_argument("--svd-ncoeff", type=int, default=10)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--n-epochs", "--nepochs", dest="n_epochs", type=int,
                   default=4000)
    p.add_argument("--tmin", type=float, default=0.1)
    p.add_argument("--tmax", type=float, default=14.0)
    p.add_argument("--n-tsteps", type=int, default=100)
    p.add_argument("--filters", default=None)
    p.add_argument("--axial-symmetry", action="store_true",
                   help="augment with KNtheta -> -theta / 180-theta "
                        "mirror copies (reference em/training.py:764-779)")
    p.add_argument("--use-UnivariateSpline", dest="use_univariate_spline",
                   action="store_true",
                   help="smoothing-spline grid resampling (reference "
                        "em/training.py:127-131)")
    p.add_argument("--UnivariateSpline-s", dest="univariate_spline_s",
                   type=float, default=2.0)
    p.add_argument("--continue-training", action="store_true",
                   help="resume from an existing saved surrogate "
                        "(reference em/training.py:142-159)")
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from ..training import SVDTrainingConfig, read_bulla_grid, train_svd_model
    from ..training.svd import axial_symmetry
    t0 = time.perf_counter()
    entries, pnames, filters = read_bulla_grid(_grid_files(args.data_path),
                                               model=args.model)
    read_s = time.perf_counter() - t0
    if args.filters:
        filters = args.filters.split(",")
    if args.axial_symmetry:
        entries = axial_symmetry(entries)
    cfg = SVDTrainingConfig(
        n_coeff=args.svd_ncoeff, hidden=args.hidden, n_epochs=args.n_epochs,
        tmin=args.tmin, tmax=args.tmax, n_tsteps=args.n_tsteps,
        univariate_spline=args.use_univariate_spline,
        univariate_spline_s=args.univariate_spline_s)
    os.makedirs(args.svd_path, exist_ok=True)
    itype = args.interpolation_type
    fit_info = {}
    # backend dispatch of the reference's SVDTrainingModel factory
    # (nmma/em/training.py:518-540)
    if itype in GP_BACKENDS:
        from ..training import (save_gp_surrogate, train_svd_compact_gp_model,
                                train_svd_gp_model)
        if itype == "api_gp":
            meta, gp = train_svd_compact_gp_model(entries, pnames, filters,
                                                  cfg, device=device)
        else:
            meta, gp = train_svd_gp_model(entries, pnames, filters, cfg,
                                          device=device)
        out = os.path.join(args.svd_path, f"{args.model}_{itype}.npz")
        save_gp_surrogate(out, meta, gp)
    elif itype in MLP_BACKENDS:
        out = os.path.join(args.svd_path, f"{args.model}.npz")
        init = None
        if args.continue_training:
            if os.path.exists(out):
                from ..models.svd import SVDModelData
                init = SVDModelData.load(out, device=device)
                print(f"continuing training from {out}")
            else:
                warnings.warn("--continue-training set, but no existing "
                              "model found.")
        svd = train_svd_model(entries, pnames, filters, cfg,
                              init_model=init, device=device)
        svd.save(out)
        fit_info = svd.fit_info
    else:
        raise ValueError(
            "interpolation-type must be one of: keras, tensorflow, jax, "
            f"torch, sklearn_gp, api_gp (got {itype!r})")
    if info is not None:
        info.update(read_s=read_s, n_entries=len(entries), **fit_info)
    print(f"saved surrogate to {out}")
    return out


def svdmodel_benchmark(cli_args=None, device=None):
    """``svdmodel-benchmark``: chi^2 percentiles of a surrogate against its
    grid, written to --outdir as json; returns them."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="svdmodel-benchmark")
    p.add_argument("--model", required=True)
    p.add_argument("--data-path", required=True)
    p.add_argument("--svd-path", default="svdmodels")
    p.add_argument("--outdir", default="benchmarks")
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from ..models.svd import SVDModelData
    from ..training import benchmark_svd_model, read_bulla_grid
    entries, pnames, _ = read_bulla_grid(
        sorted(glob.glob(os.path.join(args.data_path, "*.dat"))),
        model=args.model)
    svd = SVDModelData.load(os.path.join(args.svd_path, f"{args.model}.npz"),
                            device=device)
    scores = benchmark_svd_model(svd, entries, pnames)
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, f"{args.model}_benchmark.json")
    with open(out, "w") as fh:
        json.dump(scores, fh, indent=2)
    print(json.dumps(scores, indent=2))
    return scores


def resample_grid(cli_args=None):
    """``resample-grid``: downsample and/or fragment an HDF5 training grid
    (host only); returns the written paths."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="resample-grid")
    p.add_argument("--gridpath", required=True)
    p.add_argument("--base-dirname", default="lcs_grid")
    p.add_argument("--base-filename", default="lcs")
    p.add_argument("--random-seed", type=int, default=21)
    p.add_argument("--downsample", action="store_true")
    p.add_argument("--fragment", action="store_true")
    p.add_argument("--factor", type=int, default=10)
    p.add_argument("--shuffle", action="store_true")
    args = apply_config(p, config, argv)
    if not args.gridpath.endswith((".h5", ".hdf5")):
        raise ValueError("resampling only supports .h5 grid files")

    from ..training.grids import Grid
    with Grid(args.gridpath, base_dirname=args.base_dirname,
              base_filename=args.base_filename,
              random_seed=args.random_seed) as grid:
        out = []
        if args.downsample:
            out.append(grid.downsample(factor=args.factor,
                                       shuffle=args.shuffle))
        if args.fragment:
            out.append(grid.fragment(factor=args.factor,
                                     shuffle=args.shuffle))
    if not out:
        raise ValueError("pass --downsample and/or --fragment")
    for path in out:
        print(path)
    return out


def lightcurve_generation(cli_args=None, device=None):
    """``lightcurve-generation``: light curves of every row of an injection
    file, one json a row under --outdir; returns the written paths. The
    model is a registered source model (reference
    lightcurve_handling:lcs_from_injection_parameters)."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="lightcurve-generation")
    p.add_argument("--model", required=True)
    p.add_argument("--injection", required=True)
    p.add_argument("--filters", default="ztfg,ztfr,ztfi")
    p.add_argument("--label", default="injection")
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--tmin", type=float, default=0.01)
    p.add_argument("--tmax", type=float, default=14.0)
    p.add_argument("--detection-limit", type=float, default=np.inf)
    p.add_argument("--injection-error-budget", type=float, default=0.1)
    p.add_argument("--generation-seed", type=int, default=42)
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from ..injections import create_light_curve_data, read_injection_file
    os.makedirs(args.outdir, exist_ok=True)
    table = read_injection_file(args.injection)
    n = len(next(iter(table.values())))
    filters = args.filters.split(",")
    paths = []
    for i in range(n):
        entry = {k: float(v[i]) for k, v in table.items()}
        data = create_light_curve_data(
            entry, model=args.model, filters=filters, tmin=args.tmin,
            tmax=args.tmax, seed=args.generation_seed + i,
            detection_limit=args.detection_limit,
            injection_error_budget=args.injection_error_budget,
            device=device)
        out = {f: {k: np.asarray(v).tolist() for k, v in sub.items()}
               for f, sub in data.items()}
        path = os.path.join(args.outdir, f"{args.label}_{i}.json")
        with open(path, "w") as fh:
            json.dump(out, fh)
        print(f"wrote {path}")
        paths.append(path)
    return paths


def create_injection(cli_args=None, device=None):
    """``nmma-create-injection``: an injection set drawn from a prior file,
    optionally through the BNS ejecta conversion (quasi-universal radii, or
    the tabulated EOS of --eos-dir) with the finite-ejecta test; returns
    the parameters (reference injection_handling:main)."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="nmma-create-injection")
    p.add_argument("--prior-file", required=True)
    p.add_argument("--injection-file", default=None,
                   help="partial injection json to merge with prior draws")
    p.add_argument("--n-injection", type=int, default=1)
    p.add_argument("--filename", "-f", default="injection.json")
    p.add_argument("--generation-seed", type=int, default=42)
    p.add_argument("--ejecta-conversion", action="store_true")
    p.add_argument("--eos-dir", default=None)
    p.add_argument("--max-redraws", type=int, default=100)
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from .. import conversion as C
    from ..injections import (InjectionCreator, finite_ejecta_test,
                              write_injection_file)
    from ..priors import load_prior_file
    priors = load_prior_file(args.prior_file)

    conversion, tests = None, []
    if args.ejecta_conversion:
        steps = [C.bns_source_frame]
        if args.eos_dir:
            from ..eos import load_macro_eos_set
            steps.append(load_macro_eos_set(args.eos_dir))
        else:
            steps.append(C.radii_from_qur)
        steps.append(C.KilonovaEjectaFitting())
        conversion = C.MultimessengerConversion(*steps)
        tests.append(finite_ejecta_test)

    creator = InjectionCreator(priors, conversion=conversion, tests=tests,
                               max_redraws=args.max_redraws,
                               seed=args.generation_seed, device=device)
    params = creator.generate(args.n_injection)
    write_injection_file(args.filename, params)
    print(f"wrote {args.n_injection} injections to {args.filename}")
    return params


def gwem_resampling(cli_args=None, device=None, sampler_kwargs=None):
    """``gwem-resampling``: joint GW x EM re-inference over (Mc, q, EOS,
    alpha, zeta) by nested sampling on the device; writes the posterior csv
    and returns (result, posterior) (reference
    resampling:main_resampling). ``sampler_kwargs`` (max_iter,
    max_seconds) cap the run."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="gwem-resampling")
    p.add_argument("--GWsamples", required=True)
    p.add_argument("--EMsamples", required=True)
    p.add_argument("--EOS-data", "--eos-data", dest="eos_data", required=True)
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--label", default="gwem_resampling")
    p.add_argument("--nlive", type=int, default=512)
    p.add_argument("--total-ejecta-mass", action="store_true")
    p.add_argument("--withNSBH", dest="with_nsbh", action="store_true",
                   help="NSBH spin variant: sample chi_1/chi_2 with GW "
                        "KDE priors (reference resampling.py:56-71)")
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from ..eos import load_macro_eos_set
    from ..io.results import load_posterior, save_posterior_csv
    from ..post_processing import GWEMResampler
    gw = load_posterior(args.GWsamples)
    em = load_posterior(args.EMsamples)
    if "lambda_tilde" not in gw and not args.with_nsbh:
        from ..conversion import generate_posterior_parameters
        gw = generate_posterior_parameters(gw)
    eos_set = load_macro_eos_set(args.eos_data)
    rs = GWEMResampler(gw, em, eos_set,
                       total_ejecta_mass=args.total_ejecta_mass,
                       with_nsbh=args.with_nsbh, device=device)
    result, post = rs.run(nlive=args.nlive, verbose=True,
                          **(sampler_kwargs or {}))
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, f"{args.label}_posterior_samples.csv")
    save_posterior_csv(out, post)
    print(f"log-evidence {result.logz:.3f}; wrote {out}")
    return result, post


def gwem_hubble_estimate(cli_args=None):
    """``gwem-Hubble-estimate``: combined H0 from per-event distance
    posteriors at known redshifts (host); with GW posteriors the
    reference's per-ordering trend with flat-mass reweighting (reference
    hubble_estimates:main)."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="gwem-Hubble-estimate")
    p.add_argument("--posterior-files", required=True,
                   help="comma-separated EM posterior files (need "
                        "luminosity_distance column)")
    p.add_argument("--gw-posterior-files", default=None,
                   help="comma-separated GW posterior files (need "
                        "luminosity_distance + chirp_mass + mass_ratio); "
                        "enables the reference's full per-ordering trend "
                        "with flat-mass reweighting "
                        "(hubble_estimates.py:76-169)")
    p.add_argument("--redshifts", required=True,
                   help="comma-separated true redshifts, one per file")
    p.add_argument("--N-reordering", type=int, default=10)
    p.add_argument("--N-posterior-samples", type=int, default=3000)
    p.add_argument("--N-prior-samples", type=int, default=2000)
    p.add_argument("--cred-interval", type=float, default=0.95)
    p.add_argument("--p-value-threshold", type=float, default=None)
    p.add_argument("--injected-distances", default=None,
                   help="comma-separated true luminosity distances, one "
                        "per event; required with --p-value-threshold "
                        "(the two-sided GW-consistency cut, reference "
                        "hubble_estimates.py:101-110)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--label", default="hubble")
    args = apply_config(p, config, argv)

    from ..io.results import load_posterior
    from ..post_processing import (combine_hubble_posteriors,
                                   hubble_posterior_from_distance_samples)
    files = args.posterior_files.split(",")
    redshifts = [float(z) for z in args.redshifts.split(",")]
    os.makedirs(args.outdir, exist_ok=True)

    if args.gw_posterior_files:
        from ..post_processing.hubble import (event_h0_kdes,
                                              h0_trend_from_kdes)
        rng = np.random.default_rng(args.seed)
        gw_files = args.gw_posterior_files.split(",")
        if not (len(files) == len(gw_files) == len(redshifts)):
            raise ValueError(
                f"length mismatch: {len(files)} EM files, "
                f"{len(gw_files)} GW files, {len(redshifts)} redshifts")
        inj_d = None
        if args.p_value_threshold:
            if not args.injected_distances:
                raise ValueError(
                    "--p-value-threshold needs --injected-distances "
                    "(the cut compares each GW posterior against the "
                    "true distance)")
            inj_d = [float(d) for d in args.injected_distances.split(",")]
            if len(inj_d) != len(files):
                raise ValueError(
                    f"{len(inj_d)} injected distances for "
                    f"{len(files)} events")
        em_kdes, gw_kdes = [], []
        for i, (em_path, gw_path, z) in enumerate(
                zip(files, gw_files, redshifts)):
            pair = event_h0_kdes(
                load_posterior(em_path)["luminosity_distance"],
                load_posterior(gw_path), z, rng=rng,
                p_value_threshold=args.p_value_threshold,
                injected_distance=inj_d[i] if inj_d else None)
            if pair is not None:
                em_kdes.append(pair[0])
                gw_kdes.append(pair[1])
        h0_prior = rng.uniform(5.0, 120.0, size=args.N_prior_samples)
        trend = h0_trend_from_kdes(
            gw_kdes, em_kdes, h0_prior, np.arange(len(gw_kdes)),
            n_reordering=args.N_reordering,
            n_posterior_samples=args.N_posterior_samples,
            cred_interval=args.cred_interval, rng=rng)
        out = os.path.join(args.outdir,
                           f"GW_EM_H0_trend_{args.label}.dat")
        med, up, low = trend["total"]
        cols = {"GW_med": trend["GW"][0],
                "GW_uperr": trend["GW"][1] - trend["GW"][0],
                "GW_lowerr": trend["GW"][0] - trend["GW"][2],
                "EM_med": trend["EM"][0],
                "EM_uperr": trend["EM"][1] - trend["EM"][0],
                "EM_lowerr": trend["EM"][0] - trend["EM"][2],
                "total_med": med, "total_uperr": up - med,
                "total_lowerr": med - low}
        np.savetxt(out, np.column_stack(list(cols.values())),
                   header=" ".join(cols), comments="")
        print(f"H0 = {med[-1]:.2f} +{(up - med)[-1]:.2f} / "
              f"-{(med - low)[-1]:.2f} km/s/Mpc ({len(gw_kdes)} events); "
              f"wrote {out}")
        return trend

    if len(files) != len(redshifts):
        raise ValueError(f"length mismatch: {len(files)} posterior "
                         f"files, {len(redshifts)} redshifts")
    events = [hubble_posterior_from_distance_samples(
        load_posterior(path)["luminosity_distance"], z)
        for path, z in zip(files, redshifts)]
    grid, pdf, (med, lo, hi) = combine_hubble_posteriors(events)
    np.savez(os.path.join(args.outdir, f"{args.label}_H0.npz"),
             h0_grid=grid, pdf=pdf, median=med, lower68=lo, upper68=hi)
    print(f"H0 = {med:.2f} +{hi - med:.2f} / -{med - lo:.2f} km/s/Mpc")
    return med, lo, hi


def combine_eos(cli_args=None):
    """``combine-EOS``: stacked per-event EOS posteriors -> the R_1.4 trend
    (host; reference ns_characteristics:main)."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="combine-EOS")
    p.add_argument("--posterior-files", required=True)
    p.add_argument("--eos-data", required=True)
    p.add_argument("--no-flat-mass-reweight", action="store_true",
                   help="skip the flat-component-mass reweighting the "
                        "reference applies before counting EOS samples "
                        "(ns_characteristics.py:42)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--label", default="combined_eos")
    args = apply_config(p, config, argv)

    from ..eos import load_macro_eos_set
    from ..io.results import load_posterior
    from ..post_processing import combine_eos_posteriors
    from ..post_processing.ns_characteristics import (eos_index_weights,
                                                      eos_probs_from_posterior)
    eos_set = load_macro_eos_set(args.eos_data)
    rng = np.random.default_rng(args.seed)
    probs = []
    for f in args.posterior_files.split(","):
        post = load_posterior(f)
        if not args.no_flat_mass_reweight and "chirp_mass" in post \
                and "mass_ratio" in post:
            # the reference's counts come from the flat-mass-reweighted
            # posterior
            probs.append(eos_probs_from_posterior(post, eos_set.n_eos,
                                                  rng=rng))
        else:
            probs.append(eos_index_weights(post["EOS"], eos_set.n_eos))
    weights, trend = combine_eos_posteriors(probs, eos_set,
                                            as_probabilities=True)
    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, f"{args.label}.npz"),
             weights=weights, r14_trend=np.asarray(trend))
    med, lo, hi = trend[-1]
    print(f"R_1.4 = {med:.2f} +{hi - med:.2f} / -{med - lo:.2f} km "
          f"({len(probs)} events)")
    return weights, trend


def plot_svdmodel_benchmarks(cli_args=None):
    """``plot-svdmodel-benchmarks``: the chi^2-percentile plot of a
    svdmodel-benchmark json, written as ``{outdir}/<json name>.png``;
    returns its path (reference: nmma.em.training:plot_benchmarks_cli)."""
    from ..plotting_utils import pyplot

    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="plot-svdmodel-benchmarks")
    p.add_argument("--benchmark-file", required=True)
    p.add_argument("--outdir", default="benchmarks")
    args = apply_config(p, config, argv)
    plt = pyplot()

    with open(args.benchmark_file) as fh:
        scores = json.load(fh)
    filters = list(scores)
    fig, ax = plt.subplots(figsize=(1.2 * len(filters) + 2, 4))
    for i, f in enumerate(filters):
        p0, p25, p50, p75, p100 = scores[f]
        ax.plot([i, i], [p0, p100], color="C0", lw=1)
        ax.plot([i, i], [p25, p75], color="C0", lw=5, alpha=0.6)
        ax.plot(i, p50, "o", color="C3")
    ax.set_xticks(range(len(filters)))
    ax.set_xticklabels(filters, rotation=45, ha="right")
    ax.set_yscale("log")
    ax.set_ylabel(r"reduced $\chi^2$ vs training grid")
    fig.tight_layout()
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(
        args.outdir,
        os.path.basename(args.benchmark_file).replace(".json", ".png"))
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def convert_skyportal(cli_args=None):
    """``convert-skyportal-lcs``: a SkyPortal photometry csv as an nmma .dat
    file (host; reference nmma.em.io)."""
    p = argparse.ArgumentParser(prog="convert-skyportal-lcs")
    p.add_argument("--csv-file", "--filename", dest="csv_file", required=True)
    p.add_argument("--outfile", default=None)
    args = p.parse_args(cli_args)
    from ..io.photometry import convert_skyportal_lcs
    out = convert_skyportal_lcs(args.csv_file, args.outfile)
    print(f"wrote {out}")
    return out


def multi_config(cli_args=None):
    """``multi-config-analysis``: every run of a yaml through the port's
    lightcurve-analysis, one subprocess each (reference
    cluster_handling)."""
    p = argparse.ArgumentParser(prog="multi-config-analysis")
    p.add_argument("--config", required=True)
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--max-workers", type=int, default=4)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(cli_args)
    from ..cluster import multi_config_analysis
    out = multi_config_analysis(args.config, parallel=args.parallel,
                                max_workers=args.max_workers,
                                dry_run=args.dry_run)
    print(out)
    return out


def make_lcs(cli_args=None):
    """``nmma-make-lcs``: radiative-transfer spectra -> model light curves
    (host; reference make_lcs, nmma/em/lightcurve_handling.py:239-251)."""
    p = argparse.ArgumentParser(prog="nmma-make-lcs")
    p.add_argument("--modeldir", default="model")
    p.add_argument("--lcdir", default="lcs")
    p.add_argument("--file-type", default=None,
                   help="None (POSSIS ascii) | h5 | kasen | lanl")
    p.add_argument("--filters", default="sdssu,ps1__g,ps1__r,ps1__i,"
                                        "ps1__z,ps1__y,2massj,2massh,2massks")
    p.add_argument("--dMpc", type=float, default=1e-5,
                   help="distance in Mpc; default 10 pc -> absolute mags")
    p.add_argument("--redshift", "--z", dest="redshift", type=float,
                   default=None)
    p.add_argument("--doAB", action="store_true", default=True)
    p.add_argument("--doLbol", action="store_true")
    p.add_argument("--doSmoothing", action="store_true")
    args = p.parse_args(cli_args)
    from ..io.radiative import make_lcs as _make
    written = _make(args.modeldir, args.lcdir,
                    [f for f in args.filters.split(",") if f],
                    file_type=args.file_type, d_mpc=args.dMpc,
                    redshift=args.redshift, bolometric=args.doLbol,
                    smoothing=args.doSmoothing)
    print(f"wrote {len(written)} light-curve file(s) to {args.lcdir}")
    return written


def injection_slurm_setup(cli_args=None, device=None):
    """``lightcurve-injection-slurm-setup``: per-injection analysis
    directories and job scripts from a prior file and a template with
    PRIOR / OUTDIR / INJOUT / INJNUM placeholders (reference
    injection_handling:multi_run_setup, :420-439); returns the scripts."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="lightcurve-injection-slurm-setup")
    p.add_argument("--prior-file", required=True)
    p.add_argument("--analysis-file", required=True,
                   help="job-script template with PRIOR / OUTDIR / "
                        "INJOUT / INJNUM placeholders")
    p.add_argument("--n-injection", type=int, default=1)
    p.add_argument("--generation-seed", type=int, default=42)
    p.add_argument("--outdir", default="outdir")
    _device_flag(p)
    args = apply_config(p, config, argv)
    device = _device(device, args)

    from ..injections import InjectionCreator, write_injection_file
    from ..priors import load_prior_file

    priors = load_prior_file(args.prior_file)
    table = InjectionCreator(priors, seed=args.generation_seed,
                             device=device).generate(args.n_injection)
    with open(args.analysis_file) as fh:
        template = fh.read()
    scripts = []
    for index in range(len(next(iter(table.values())))):
        outdir = os.path.join(args.outdir, str(index))
        os.makedirs(outdir, exist_ok=True)
        shutil.copy(args.prior_file,
                    os.path.join(outdir, "injection.prior"))
        write_injection_file(
            os.path.join(outdir, "injection.json"),
            {k: [v[index]] for k, v in table.items()})
        body = template
        for key, val in zip(
                ("PRIOR", "OUTDIR", "INJOUT", "INJNUM"),
                (os.path.join(outdir, "injection.prior"), outdir,
                 os.path.join(outdir, "lc.csv"), str(index))):
            body = body.replace(key, val)
        path = os.path.join(outdir, "inference.sh")
        with open(path, "w") as fh:
            fh.write(body)
        scripts.append(path)
    print(f"wrote {len(scripts)} per-injection job dirs under "
          f"{args.outdir}")
    return scripts


def create_lightcurve_slurm(cli_args=None):
    """``create-lightcurve-slurm``: an injection file split into batched
    job scripts, INJRANGE substituted per batch (reference
    cluster_handling:lc_creation, :11-24); returns the scripts."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="create-lightcurve-slurm")
    p.add_argument("--injection", "--injection-file", dest="injection",
                   required=True)
    p.add_argument("--analysis-file", required=True,
                   help="job-script template with an INJRANGE placeholder")
    p.add_argument("--n-per-job", type=int, default=100)
    p.add_argument("--outdir", default="outdir")
    args = apply_config(p, config, argv)

    from ..injections import read_injection_file

    os.makedirs(os.path.join(args.outdir, "logs"), exist_ok=True)
    table = read_injection_file(args.injection)
    n_inj = len(next(iter(table.values())))
    n_jobs = int(np.ceil(n_inj / args.n_per_job))
    with open(args.analysis_file) as fh:
        template = fh.read()
    scripts = []
    for ii in range(n_jobs):
        lo = ii * args.n_per_job
        hi = min((ii + 1) * args.n_per_job, n_inj)
        path = os.path.join(args.outdir, f"inference_{ii}.sh")
        with open(path, "w") as fh:
            fh.write(template.replace("INJRANGE", f"{lo},{hi}"))
        scripts.append(path)
    print(f"wrote {n_jobs} batched job scripts under {args.outdir}")
    return scripts


def svdmodel_download(cli_args=None):
    """``svdmodel-download``: resolve a surrogate into the models home, an
    ``.npz`` (the local home or the download hook) or else the
    reference-format files from the registry; returns the path(s)
    (reference nmma.core.gitlab CLI, gitlab.py:271-323)."""
    config, argv = check_for_config(cli_args)
    p = argparse.ArgumentParser(prog="svdmodel-download")
    p.add_argument("--model", required=True)
    p.add_argument("--svd-path", default=None,
                   help="models home (default $NMMA_TPU_MODELS)")
    p.add_argument("--filters", default=None)
    p.add_argument("--registry-url", default=None,
                   help="registry base URL "
                        "(default $NMMA_TPU_REGISTRY_URL, then the "
                        "public nmma-models GitLab)")
    p.add_argument("--refresh-models-list", action="store_true",
                   help="re-fetch models.yaml before resolving")
    args = apply_config(p, config, argv)

    from .. import registry

    filters = args.filters.split(",") if args.filters else None
    if args.refresh_models_list:
        registry.refresh_models_list(args.svd_path,
                                     base_url=args.registry_url)
    try:
        path = registry.get_model(args.model, models_home=args.svd_path,
                                  filters=filters)
        print(path)
        return path
    except FileNotFoundError:
        pass
    paths, _ = registry.download_model(
        args.model, filters=filters, models_home=args.svd_path,
        base_url=args.registry_url)
    for pth in paths:
        print(pth)
    return paths


COMMANDS = {"lightcurve-generation": lightcurve_generation,
            "create-svdmodel": create_svdmodel,
            "svdmodel-benchmark": svdmodel_benchmark,
            "nmma-create-injection": create_injection,
            "gwem-resampling": gwem_resampling,
            "gwem-Hubble-estimate": gwem_hubble_estimate,
            "combine-EOS": combine_eos,
            "convert-skyportal-lcs": convert_skyportal,
            "multi-config-analysis": multi_config,
            "lightcurve-injection-slurm-setup": injection_slurm_setup,
            "create-lightcurve-slurm": create_lightcurve_slurm,
            "svdmodel-download": svdmodel_download,
            "resample-grid": resample_grid,
            "nmma-make-lcs": make_lcs,
            "plot-svdmodel-benchmarks": plot_svdmodel_benchmarks,
            "nmma-plot-multi-corner": plotting_routines.main}


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        sys.exit(f"usage: python -m nmma_tpu_torch.cli.tools "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    COMMANDS[sys.argv[1]](sys.argv[2:])
