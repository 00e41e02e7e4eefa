"""``lightcurve-analysis`` — EM-only parameter estimation from the command
line, on the CUDA card.

Port of ``nmma_tpu/cli/lightcurve_analysis.py`` (the reference's
``nmma.em.analysis:main`` and ``lbol_main``): config-file-first parsing,
data or injection, prior shaping (with the sky map's inclination prior of
``--fits-file`` and the m4opt limit of ``--detection-limit-fits-file``),
model and likelihood assembly (SVD surrogates, and fiesta surrogates
resolved by name under ``--fiesta-surrogates-dir``), nested sampling with
checkpoint and resume or the ensemble MCMC (``--sampler mcmc``), result
files, the best-fit report (``--bestfit``, on by default) and the figures
of ``--plot`` (which need matplotlib); and the bolometric path. Run it as

    python -m nmma_tpu_torch.cli.lightcurve_analysis config.yaml [flags]

It runs on the CUDA card and raises without one, unless ``--device cpu``
(or ``main(..., device="cpu")``) asks for the CPU.
"""

from __future__ import annotations

import os

from .. import resolve_device
from .parsing import (apply_config, base_analysis_parser, check_for_config,
                      sampler_config_from_args, write_complete_config)


def main(cli_args=None, device=None):
    """Run the analysis the arguments describe; returns the EMAnalysis (of
    the last sub-run with --multi/--matrix). ``device`` overrides
    ``--device``."""
    config, argv = check_for_config(cli_args)
    parser = base_analysis_parser("EM transient parameter estimation")
    args = apply_config(parser, config, argv)
    device = resolve_device(device if device is not None else args.device)
    args.device = str(device)

    from .multi import expand_runs
    sub_runs = expand_runs(args)
    if len(sub_runs) > 1:
        out = None
        for run_args in sub_runs:
            print(f"=== sub-run {run_args.label} ===")
            out = _single_run(run_args, device)
        return out
    return _single_run(args, device)


def lbol_main(cli_args=None, device=None):
    """``lightcurve-analysis-lbol``: nested sampling of a bolometric model
    (Arnett by default) on a csv of ``phase,Lbb,Lbb_unc`` columns
    (nmma_tpu/cli/lightcurve_analysis.py:281-324, the reference's
    ``lbol_main`` and ``bolometric_setup``, em/analysis.py:72-108). The
    csv is read with numpy. Writes ``{label}_result.npz``; returns the
    sampler's result."""
    import numpy as np
    import torch

    from ..inference import NestedSampler
    from ..likelihood import BolometricLikelihood
    from ..models import DetectorLightCurveModel
    from ..priors import load_prior_file

    config, argv = check_for_config(cli_args)
    parser = base_analysis_parser("Bolometric light-curve PE")
    args = apply_config(parser, config, argv)
    device = resolve_device(device if device is not None else args.device)

    table = np.genfromtxt(args.light_curve_data, delimiter=",", names=True)
    order = np.argsort(table["phase"])
    times = table["phase"][order] - (args.trigger_time or 0.0)
    model = DetectorLightCurveModel(args.model or "Arnett", [],
                                    device=device)
    likelihood = BolometricLikelihood(model, times, table["Lbb"][order],
                                      table["Lbb_unc"][order])
    priors = load_prior_file(args.prior)

    @torch.no_grad()
    def unit_logl(u):
        return likelihood(priors.transform(u))

    sampler = NestedSampler(unit_logl, priors.ndim,
                            sampler_config_from_args(args), device=device)
    os.makedirs(args.outdir, exist_ok=True)
    result = sampler.run(verbose=args.verbose)
    print(f"log-evidence: {result.logz:.3f} +/- {result.logz_err:.3f}")
    idx = result.posterior_indices()
    with torch.no_grad():
        post = priors.transform(torch.as_tensor(
            result.samples_u[idx], dtype=torch.float32, device=device))
    np.savez(os.path.join(args.outdir, f"{args.label}_result.npz"),
             logz=result.logz, logz_err=result.logz_err,
             **{f"posterior_{k}": v.cpu().numpy() for k, v in post.items()})
    return result


def _reports(args, analysis, result=None, posterior=None):
    """--bestfit's ``{label}_bestfit.json`` and --plot's
    ``{label}_lightcurves.png`` and ``{label}_corner.png`` (the corner
    plot where ``posterior`` is given), for ``result`` (the analysis's
    nested result when None)."""
    if args.bestfit:
        from ..plotting import post_process_bestfit
        post_process_bestfit(analysis, result=result)
    if args.plot:
        from ..plotting import corner_plot, lightcurve_fit_plot
        lightcurve_fit_plot(analysis, result=result)
        if posterior is not None:
            cfg = analysis.config
            corner_plot(posterior, save_path=os.path.join(
                cfg.outdir, f"{cfg.label}_corner.png"))


def _single_run(args, device):
    from ..analysis import EMAnalysis, EMAnalysisConfig
    from ..models.svd import SVDModelData, make_svd_source_model

    if args.sampler not in ("nmma-ns", "mcmc", "neuralnet"):
        raise ValueError(f"unknown sampler {args.sampler!r}")
    model_name = args.model
    fiesta_data = None
    if args.svd_path:
        svd = SVDModelData.load(args.svd_path, device=device)
        model_name = make_svd_source_model(
            model_name, svd, mag_ncoeff=args.svd_mag_ncoeff).name
    else:
        fiesta_data = _fiesta_source(args, device)

    if args.detection_limit_fits_file:
        # read before the injection, whose photometry must see the map's
        # limit as the likelihood does (the JAX package reads it after,
        # fault 3e)
        if args.ra is None or args.dec is None:
            raise ValueError(
                "--detection-limit-fits-file needs --ra and --dec")
        from ..io.fits import detection_limit_from_m4opt_fits
        args.detection_limit = detection_limit_from_m4opt_fits(
            args.detection_limit_fits_file, args.ra, args.dec)
        print(f"detection limit from m4opt map: "
              f"{args.detection_limit:.2f} mag")
    data = None
    trigger_time = args.trigger_time or 0.0
    if args.injection:
        data, _, trigger_time = data_from_injection(args, device)
    if args.injection_model and not args.injection:
        raise ValueError("--injection-model needs --injection")

    n_tsteps = args.n_tsteps
    if args.tstep:
        # reference quick-start --dt convention: a linear step over the
        # model window sets the grid density
        n_tsteps = max(int(round((args.tmax - args.tmin) / args.tstep)) + 1,
                       8)
    cfg = EMAnalysisConfig(
        model=model_name,
        prior_file=args.prior,
        light_curve_data=args.light_curve_data,
        trigger_time=trigger_time,
        data_tmin=args.data_tmin, data_tmax=args.data_tmax,
        filters=args.filters.split(",") if args.filters else None,
        tmin=args.tmin, tmax=args.tmax, n_tsteps=n_tsteps,
        timescale=args.timescale,
        extinction_law=args.extinction_law,
        time_format=args.time_format,
        error_budget=args.em_error_budget,
        systematics_file=args.systematics_file,
        detection_limit=args.detection_limit,
        remove_nondetections=args.remove_nondetections,
        outdir=args.outdir, label=args.label,
        model_kwargs={k: v for k, v in {
            "grb_resolution": args.grb_resolution,
            "jet_type": args.jet_type,
            "n_theta": args.grb_ntheta,
            "n_phi": args.grb_nphi,
            "n_r": args.grb_nr,
            "spread": False if args.grb_no_spread else None,
        }.items() if v is not None},
        sampler=sampler_config_from_args(args),
    )
    if args.fetch_Ebv_from_dustmap:
        raise RuntimeError(
            "--fetch-Ebv-from-dustmap needs the dustmaps SFD data, which "
            "requires network access unavailable in this environment; "
            "pass --Ebv-max or a fixed Ebv in the prior file instead")
    priors = _sky_map_priors(args, _shaped_priors(args))
    if fiesta_data is not None:
        # the reference's FiestaModel raises when the prior reaches beyond
        # the trained support (nmma/em/model.py:434-445): draws there would
        # extrapolate the networks
        from ..priors import load_prior_file
        fiesta_data.check_vs_priors(
            priors if priors is not None else load_prior_file(args.prior))
    analysis = EMAnalysis(cfg, data=data, priors=priors, device=device)
    write_complete_config(args)

    if args.sampler == "neuralnet":
        return _neuralnet_run(args, analysis)
    if args.sampler == "mcmc":
        return _mcmc_run(args, analysis)
    if args.skip_sampling:
        # with a checkpoint, regenerate the result files from it without
        # sampling (reference --skip-sampling, nmma/core/base.py:307-314)
        ckpt = analysis.checkpoint_path()
        if os.path.exists(ckpt):
            sampler = analysis.sampler()
            state, dead = sampler.load_checkpoint(ckpt)
            analysis.result = sampler._finalise(state, *dead)
            analysis.save_result()
            print(f"--skip-sampling: result regenerated from {ckpt} "
                  f"(logz={analysis.result.logz:.3f}).")
            _reports(args, analysis)
            return analysis
        print("--skip-sampling: likelihood assembled; exiting before PE "
              "(no checkpoint found to regenerate from).")
        return analysis
    result = analysis.run(verbose=True)
    print(f"log-evidence: {result.logz:.3f} +/- {result.logz_err:.3f} "
          f"({result.ncall} likelihood calls)")
    _reports(args, analysis, posterior=analysis.posterior_samples()
             if args.plot else None)
    return analysis


def _neuralnet_run(args, analysis):
    """``--sampler neuralnet``: likelihood-free inference (the reference's
    nnanalysis, em/analysis.py:176-307; nmma_tpu/cli/lightcurve_analysis.py
    :191-210). Writes ``{label}_result.npz`` with the JAX package's keys
    (``sampler``, ``posterior_*``); the trained posterior and the stages'
    seconds are kept on the returned analysis."""
    import numpy as np

    from ..mlmodel.inference import nnanalysis
    embedding = None
    if args.lfi_pretrained_embedding:
        if not args.lfi_embedding_weights:
            raise ValueError(
                "--lfi-pretrained-embedding needs --lfi-embedding-weights: "
                "the path of the reference's similarity_embedding_weights"
                ".pth")
        embedding = args.lfi_embedding_weights
    cfg = analysis.config
    timings = {}
    post, posterior = nnanalysis(
        analysis, seed=args.seed, verbose=args.verbose,
        pretrained_embedding=embedding,
        vicreg_pretrain=args.lfi_vicreg_pretrain,
        vicreg_epochs=args.lfi_vicreg_epochs, timings=timings)
    os.makedirs(cfg.outdir, exist_ok=True)
    np.savez(os.path.join(cfg.outdir, f"{cfg.label}_result.npz"),
             sampler="neuralnet",
             **{f"posterior_{k}": np.asarray(v) for k, v in post.items()})
    print(f"neuralnet posterior: {len(next(iter(post.values())))} samples "
          f"written to {cfg.outdir}/{cfg.label}_result.npz")
    analysis.neuralnet_posterior = post
    analysis.lfi_posterior = posterior
    analysis.lfi_timings = timings
    return analysis


def _mcmc_run(args, analysis):
    """``--sampler mcmc``: the ensemble MCMC with --mcmc-walkers, -sweeps and
    -temps (nmma_tpu/cli/lightcurve_analysis.py:211-240). It keeps no
    checkpoint, so --skip-sampling stops after the set-up."""
    import numpy as np

    from ..inference import EnsembleMCMCConfig
    if args.skip_sampling:
        print("--skip-sampling: likelihood assembled; exiting before MCMC "
              "(the ensemble sampler keeps no resume checkpoint to "
              "regenerate from).")
        return analysis
    mcfg = EnsembleMCMCConfig(walkers=args.mcmc_walkers,
                              sweeps=args.mcmc_sweeps,
                              temps=args.mcmc_temps, seed=args.seed)
    post = analysis.run_mcmc(mcmc_config=mcfg, verbose=args.verbose)
    cfg = analysis.config
    print(f"mcmc posterior: {len(next(iter(post.values())))} samples "
          f"written to {cfg.outdir}/{cfg.label}_mcmc_result.npz (max R-hat "
          f"{float(np.nanmax(analysis.mcmc_result.rhat)):.3f})")
    _reports(args, analysis, result=analysis.mcmc_result, posterior=post)
    return analysis


def _shaped_priors(args):
    """The prior file shaped by --Ebv-max/--use-Ebv, the conditional
    inclination prior, --ignore-timeshift and --redshift (reference
    create_prior_from_args, em/prior.py:221-244); None when no flag asks
    for shaping, so the analysis reads the file itself."""
    from ..priors import DeltaFunction, PriorDict, create_prior_from_args

    if not (args.ebv_max > 0.0 or args.use_ebv
            or args.conditional_gaussian_prior_thetaobs
            or args.ignore_timeshift or args.redshift is not None):
        return None
    priors = create_prior_from_args(
        args.prior,
        Ebv_max=args.ebv_max if args.ebv_max > 0 else 0.5724,
        use_Ebv=bool(args.ebv_max > 0 or args.use_ebv),
        conditional_gaussian_prior_thetaObs=bool(
            args.conditional_gaussian_prior_thetaobs),
        conditional_gaussian_prior_N_sigma=float(
            args.conditional_gaussian_prior_n_sigma))
    pd = dict(priors.priors)
    if args.ignore_timeshift:
        pd["timeshift"] = DeltaFunction(peak=0.0, name="timeshift")
    if args.redshift is not None:
        pd["redshift"] = DeltaFunction(peak=float(args.redshift),
                                       name="redshift")
    return PriorDict(pd)


def _fiesta_source(args, device):
    """Resolve an unknown --model under --fiesta-surrogates-dir (or
    $NMMA_FIESTA_SURROGATES) and register it (the reference's
    FiestaKilonovaModel/FiestaGRBModel, nmma/em/model.py:734-888); returns
    the FiestaSurrogateData behind the model, also when an earlier run in
    this process registered it, or None for other models."""
    from ..models import get_source_model
    from ..models.fiesta import (FIESTA_ENV, load_fiesta_surrogate,
                                 make_fiesta_source_model,
                                 registered_fiesta_data)
    fiesta_dir = args.fiesta_surrogates_dir or os.environ.get(FIESTA_ENV)
    try:
        get_source_model(args.model)
        known = True
    except KeyError:
        known = False
    if not known and fiesta_dir:
        try:
            fdata = load_fiesta_surrogate(
                args.model, fiesta_dir,
                filters=args.filters.split(",") if args.filters else None,
                device=device)
        except FileNotFoundError:
            fdata = None
        if fdata is not None:
            make_fiesta_source_model(args.model, fdata)
    return registered_fiesta_data(args.model)


def _sky_map_priors(args, priors):
    """``priors`` with inclination_EM from the sky map of --fits-file at
    --dL (or the prior's fixed luminosity_distance) and --ra/--dec
    (reference prior.py:80-171); unchanged without --fits-file."""
    if not args.fits_file:
        return priors
    from ..priors import PriorDict, load_prior_file
    from ..priors.astro import inclination_prior_from_fits
    pd = dict(priors.priors) if priors is not None else \
        dict(load_prior_file(args.prior).priors)
    dL = args.dL
    if dL is None:
        dL = getattr(pd.get("luminosity_distance"), "peak", None)
        if dL is None:
            raise ValueError("--fits-file needs --dL or a delta-function "
                             "luminosity_distance in the prior file")
    pd["inclination_EM"] = inclination_prior_from_fits(
        args.fits_file, dL=float(dL), ra=args.ra, dec=args.dec,
        cosiota_node_num=args.cosiota_node_num)
    print(f"inclination_EM prior built from {args.fits_file} at "
          f"dL={float(dL):.1f} Mpc")
    return PriorDict(pd)


def data_from_injection(args, device=None):
    """Photometry synthesised from an injection file entry (reference
    ``em/analysis.py:data_from_injection``, :18-31); returns (data, entry,
    trigger time) and writes the data to --injection-outfile when given."""
    from ..injections import create_light_curve_data, read_injection_entry
    entry = read_injection_entry(args.injection, args.injection_num)
    trigger_time = entry.get("trigger_time", 0.0)
    filters = args.filters.split(",") if args.filters else ["ztfg", "ztfr",
                                                            "ztfi"]
    data = create_light_curve_data(
        entry, model=args.injection_model or args.model,
        filters=filters, tmin=args.tmin, tmax=args.tmax,
        seed=args.generation_seed,
        injection_error_budget=args.injection_error_budget,
        detection_limit=args.detection_limit,
        ztf_sampling=args.ztf_sampling,
        ztf_uncertainties=args.ztf_uncertainties,
        ztf_too=args.ztf_too, rubin_too_type=args.rubin_too_type,
        device=device)
    if args.injection_outfile:
        from ..io import write_em_observations
        os.makedirs(os.path.dirname(args.injection_outfile) or ".",
                    exist_ok=True)
        write_em_observations(args.injection_outfile, data)
    return data, entry, trigger_time


if __name__ == "__main__":
    main()
