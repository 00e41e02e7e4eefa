"""``nmma-generation`` / ``nmma-analysis``: the two-stage joint pipeline.

PyTorch counterpart of ``nmma_tpu/cli/joint_main.py`` (the reference's
``nmma/joint/generation.py`` + ``nmma/joint/main.py``). The generation
stage reads the prior and the injection (json or LIGO-LW xml), runs the
conversion chain (cosmology -> source frame -> tabulated EOS or quasi-
universal radii -> ejecta fits), makes the GW data (a zero-noise
injection, or real strain read from files with a median-Welch PSD, a Tukey
window and an FFT), finds the relative-binning fiducial (the injection, or
a maximum-likelihood search), builds the EOS constraints (optionally
folding them into a reweighted, sorted EOS set), loads or synthesises the
EM photometry, writes the data dump and evaluates the joint likelihood
once. The analysis stage rebuilds the likelihood from the dump (GW + EM +
EOS constraints + NS population, with the Hubble, weighted-EOS and
systematics prior surgery) and runs the batched nested sampler; the result
``.npz`` carries the posterior and the conversion chain's derived columns.

Both stages run on the CUDA card and raise without one, unless ``--device
cpu`` (or ``device="cpu"``) asks for the CPU. The dump is the port's own
pickle (plain dicts, numpy arrays and the port's ``InterferometerData``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from .. import resolve_device
from .parsing import apply_config, check_for_config, write_complete_config


def _generation_parser():
    p = argparse.ArgumentParser("nmma-generation")
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--label", default="joint")
    p.add_argument("--prior-file", "--prior", dest="prior_file",
                   required=True)
    p.add_argument("--injection-file", "--injection", dest="injection_file",
                   default=None,
                   help="optional once --strain-files provides real data")
    p.add_argument("--injection-num", type=int, default=0)
    p.add_argument("--trigger-time", type=float, default=1187008882.4)
    p.add_argument("--gw-detectors", "--detectors", dest="detectors",
                   default="H1,L1,V1")
    p.add_argument("--duration", type=float, default=64.0)
    p.add_argument("--minimum-frequency", type=float, default=23.0)
    p.add_argument("--maximum-frequency", type=float, default=1024.0)
    p.add_argument("--waveform", default="TaylorF2",
                   help="TaylorF2 | IMRPhenomD | IMRPhenomD_NRTidalv2")
    # --- real GW data (reference gw/gw_inputs.py via bilby_pipe) ---
    p.add_argument("--strain-files", default=None,
                   help="per-ifo strain files, e.g. 'H1:h1.gwf,L1:l1.txt'")
    p.add_argument("--channels", default=None,
                   help="per-ifo hdf5 dataset/channel names, 'H1:name,...'")
    p.add_argument("--psd-files", default=None,
                   help="per-ifo two-column (f, PSD) files, 'H1:psd.dat,...'")
    p.add_argument("--post-trigger-duration", type=float, default=2.0)
    p.add_argument("--psd-duration", type=float, default=None)
    p.add_argument("--tukey-roll-off", type=float, default=0.4)
    p.add_argument("--fiducial-rounds", type=int, default=4)
    p.add_argument("--fiducial-batch", type=int, default=256)
    # --- GW likelihood options ---
    p.add_argument("--no-relative-binning", action="store_true",
                   help="use the dense Whittle likelihood")
    p.add_argument("--binning-epsilon", type=float, default=0.1)
    p.add_argument("--phase-marginalization", action="store_true")
    p.add_argument("--distance-marginalization", action="store_true")
    p.add_argument("--time-marginalization", action="store_true",
                   help="dense likelihood only (implies "
                        "--no-relative-binning)")
    # --- EM ---
    p.add_argument("--em-model", "--kilonova-model", dest="em_model",
                   default=None)
    p.add_argument("--svd-path", default=None)
    p.add_argument("--filters", default="ztfg,ztfr")
    p.add_argument("--light-curve-data", default=None,
                   help="observed photometry file (instead of synthesizing "
                        "from the injection)")
    p.add_argument("--em-trigger-time", type=float, default=None,
                   help="EM trigger MJD; default derives from --trigger-time")
    p.add_argument("--systematics-file", default=None)
    p.add_argument("--em-tmin", dest="tmin", type=float, default=0.1)
    p.add_argument("--em-tmax", dest="tmax", type=float, default=14.0)
    p.add_argument("--generation-seed", type=int, default=42)
    p.add_argument("--em-error-budget", type=float, default=1.0)
    # --- EOS ---
    p.add_argument("--eos-data", "--eos-dir", dest="eos_data", default=None)
    p.add_argument("--eos-weights", default=None,
                   help="per-EOS prior weight file (one weight per line)")
    p.add_argument("--lower-mtov", default=None, metavar="MASS,ERR",
                   help="heavy-pulsar MTOV constraint, e.g. '2.01,0.04'")
    p.add_argument("--upper-mtov", default=None, metavar="MASS,ERR")
    p.add_argument("--mass-radius-files", default=None,
                   help="comma list of (R,M[,w]) posterior sample files "
                        "(NICER-style mass-radius constraints)")
    p.add_argument("--eos-constraint-json", default=None,
                   help="constraint spec json: {name: {type: ..., ...}}")
    p.add_argument("--eos-reweight", action="store_true",
                   help="pre-weight the tabulated EOS set under the "
                        "constraints (reference tabulate_weighted_eos)")
    # --- population / cosmology ---
    p.add_argument("--population-model", default=None,
                   help="NS mass population: flat | peak")
    p.add_argument("--population-beta", type=float, default=0.0)
    p.add_argument("--hubble-prior", default=None,
                   help="uniform | planck | sh0es — adds a sampled "
                        "Hubble_constant (reference Hubble prior surgery)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    return p


def _per_ifo(spec):
    """'H1:a,L1:b' -> {'H1': 'a', 'L1': 'b'}."""
    if not spec:
        return {}
    out = {}
    for item in spec.split(","):
        name, _, value = item.partition(":")
        if not value:
            raise ValueError(f"expected IFO:value, got {item!r}")
        out[name.strip()] = value.strip()
    return out


def _parse_constraints(args):
    """Constraint specs from the flags and the json (reference
    compose_eos_constraints, nmma/eos/eos_likelihood.py:133-191)."""
    specs = []
    if args.lower_mtov:
        m, e = (float(x) for x in args.lower_mtov.split(","))
        specs.append({"type": "lower_mtov", "mass": m, "error": e})
    if args.upper_mtov:
        m, e = (float(x) for x in args.upper_mtov.split(","))
        specs.append({"type": "upper_mtov", "mass": m, "error": e})
    if args.mass_radius_files:
        for path in args.mass_radius_files.split(","):
            specs.append({"type": "mass_radius", "file": path})
    if args.eos_constraint_json:
        with open(args.eos_constraint_json) as f:
            payload = json.load(f)
        for name, spec in payload.items():
            spec = dict(spec)
            spec.setdefault("name", name)
            specs.append(spec)
    return specs


def _build_constraint(specs):
    """The specs' ``JointEoSConstraint``, or None without specs."""
    from ..eos.likelihood import (JointEoSConstraint, LowerMTOVConstraint,
                                  MassRadiusConstraint, UpperMTOVConstraint)
    terms = []
    for spec in specs:
        kind = spec["type"].lower().replace("-", "_")
        if kind in ("lower_mtov", "maximum_mass_lower", "lower_mtov_mass"):
            terms.append(LowerMTOVConstraint(spec["mass"], spec["error"],
                                             name=spec.get("name")))
        elif kind in ("upper_mtov", "maximum_mass_upper"):
            terms.append(UpperMTOVConstraint(spec["mass"], spec["error"],
                                             name=spec.get("name")))
        elif kind in ("mass_radius", "mr"):
            terms.append(MassRadiusConstraint(file_path=spec["file"],
                                              name=spec.get("name")))
        else:
            raise ValueError(f"unknown EOS constraint type {spec['type']!r}")
    return JointEoSConstraint(*terms) if terms else None


def _register_svd_model(args, device):
    """Register ``--svd-path``'s surrogate as ``--em-model`` on
    ``device``."""
    from ..models import SVDModelData, make_svd_source_model
    make_svd_source_model(args["em_model"],
                          SVDModelData.load(args["svd_path"], device=device))


def _scalars(parameters):
    """The numeric scalar entries of a parameter dict, as floats."""
    return {k: float(v) for k, v in parameters.items()
            if not isinstance(v, str) and np.ndim(v) == 0}


def _batch_of_one(point, device):
    return {k: torch.tensor([v], dtype=torch.float32, device=device)
            for k, v in point.items()}


def nmma_generation(cli_args=None, device=None):
    """The generation stage; returns the path of the data dump. ``device``
    overrides ``--device``."""
    config, argv = check_for_config(cli_args)
    args = apply_config(_generation_parser(), config, argv)
    device = resolve_device(device if device is not None else args.device)
    args.device = str(device)

    from ..gw import get_waveform
    from ..injections import create_light_curve_data, read_injection_entry
    from ..priors import load_prior_file

    os.makedirs(args.outdir, exist_ok=True)
    write_complete_config(args)

    # per-phase wall-clock seconds: printed and written to
    # <label>_generation_meta.json
    timings = {}
    t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        now = time.perf_counter()
        timings[name] = round(now - t0, 2)
        t0 = now

    priors = load_prior_file(args.prior_file)
    waveform = get_waveform(args.waveform)
    phase("prior_waveform")

    strain_files = _per_ifo(args.strain_files)
    if not args.injection_file and not strain_files:
        raise ValueError("need --injection-file (simulation) or "
                         "--strain-files (real data)")

    injection = None
    inj_scalar = None
    if args.injection_file:
        injection = dict(read_injection_entry(args.injection_file,
                                              args.injection_num))
        if "EOS" not in injection:
            # LIGO-LW xml injections carry no tidal information;
            # zero-tidal is the standard default for sim_inspiral ingestion
            injection.setdefault("lambda_1", 0.0)
            injection.setdefault("lambda_2", 0.0)

    conversion = _build_conversion(vars(args), injection)
    phase("conversion_build")
    if injection is not None:
        with torch.no_grad():
            inj_conv = conversion(_batch_of_one(_scalars(injection), device))
        inj_scalar = {k: float(v[0]) for k, v in inj_conv.items()
                      if v.numel() == 1}
    phase("setup_priors_conversion")

    # ---- GW data: real strain from disk, or a zero-noise injection ----
    if strain_files:
        from ..gw.strain import interferometer_from_files
        channels = _per_ifo(args.channels)
        psd_files = _per_ifo(args.psd_files)
        ifos = [interferometer_from_files(
            name, path, args.trigger_time, channel=channels.get(name),
            psd_file=psd_files.get(name), duration=args.duration,
            post_trigger=args.post_trigger_duration,
            f_min=args.minimum_frequency, f_max=args.maximum_frequency,
            psd_duration=args.psd_duration, roll_off=args.tukey_roll_off)
            for name, path in strain_files.items()]
    else:
        from ..gw import InterferometerData
        ifos = [InterferometerData.zero_noise_injection(
            name, inj_scalar, duration=args.duration,
            f_min=args.minimum_frequency, f_max=args.maximum_frequency,
            waveform=waveform, trigger_time=args.trigger_time,
            device=device)
            for name in args.detectors.split(",")]
    phase("gw_data")

    # ---- relative-binning fiducial: the injection, or an ML search ----
    fiducial = inj_scalar
    if fiducial is None:
        from ..gw.fiducial import find_fiducial
        print("no injection: searching for a maximum-likelihood fiducial…")
        fiducial, fid_logl = find_fiducial(
            ifos, priors, waveform, args.trigger_time,
            n_rounds=args.fiducial_rounds, batch=args.fiducial_batch,
            seed=args.generation_seed, transform=conversion, device=device)
        print(f"fiducial logL (time+phase marginalized): {fid_logl:.2f}")
    phase("fiducial")

    # ---- EOS constraints, optionally folded into a reweighted EOS set ----
    constraint_specs = _parse_constraints(args)
    eos_payload = args.eos_data
    eos_weights_file = args.eos_weights
    if args.eos_reweight:
        if not args.eos_data:
            raise ValueError("--eos-reweight needs --eos-data")
        from ..eos import load_macro_eos_set, tabulate_weighted_eos
        constraint = _build_constraint(constraint_specs)
        if constraint is None:
            raise ValueError("--eos-reweight needs at least one constraint")
        prev = np.loadtxt(eos_weights_file) if eos_weights_file else None
        w_path, sorted_dir, n_kept, _ = tabulate_weighted_eos(
            load_macro_eos_set(args.eos_data), constraint, args.outdir,
            previous_weights=prev, device=device)
        print(f"EOS reweighting: {n_kept} EOS kept -> {sorted_dir}")
        eos_payload, eos_weights_file = sorted_dir, w_path
        constraint_specs = []   # folded into the weights
    phase("eos")

    # ---- EM data: observed photometry or injection synthesis ----
    em_data = None
    filters = args.filters.split(",")
    if args.light_curve_data:
        from ..io import (cut_data_to_time_range, gps_to_mjd,
                          load_em_observations, shift_to_trigger_time)
        em_trigger = args.em_trigger_time
        if em_trigger is None:
            em_trigger = gps_to_mjd(args.trigger_time)
        raw = cut_data_to_time_range(load_em_observations(
            args.light_curve_data), em_trigger, tmin=0.0, tmax=args.tmax)
        em_data = shift_to_trigger_time(raw, em_trigger)
        if args.filters:
            em_data = {f: em_data[f] for f in filters if f in em_data}
    elif args.em_model and inj_scalar is not None:
        if args.svd_path:
            _register_svd_model(vars(args), device)
        em_data = create_light_curve_data(
            inj_scalar, model=args.em_model, filters=filters,
            tmin=max(args.tmin, 0.3), tmax=min(args.tmax, 12.0),
            n_tsteps=20, seed=args.generation_seed, device=device)
    phase("em_data")

    dump = {
        "args": vars(args),
        "injection": injection,
        "fiducial": fiducial,
        "ifos": ifos,
        "em_data": em_data,
        "eos_data": eos_payload,
        "eos_weights": eos_weights_file,
        "eos_constraints": constraint_specs,
        "prior_file": args.prior_file,
        "trigger_time": args.trigger_time,
    }
    path = os.path.join(args.outdir, f"{args.label}_data_dump.pickle")
    with open(path, "wb") as f:
        pickle.dump(dump, f)

    # test-build the likelihood with one evaluation (reference
    # generation.py:209-213)
    likelihood, priors = build_joint_likelihood(dump, device=device)
    test_point = _fill_from_priors(
        inj_scalar if inj_scalar is not None else fiducial, priors, device)
    with torch.no_grad():
        logl = float(likelihood.log_likelihood(
            _batch_of_one(test_point, device))[0])
    phase("test_build_eval")
    timings["total"] = round(sum(timings.values()), 2)
    with open(os.path.join(args.outdir,
                           f"{args.label}_generation_meta.json"), "w") as f:
        json.dump({"timings_s": timings, "device": str(device),
                   "test_logl": logl}, f, indent=2)
    print(f"data dump written to {path}; test logL = {logl:.2f}; "
          f"phases [s]: {timings}")
    return path


def _fill_from_priors(point, priors, device):
    """``point`` completed with the prior median of every sampled or fixed
    parameter it lacks."""
    point = dict(point)
    with torch.no_grad():
        u = torch.full((1, priors.ndim), 0.5, device=device)
        for k, v in priors.transform(u).items():
            point.setdefault(k, float(v[0]))
    return point


def _build_conversion(args, injection):
    """The conversion chain: cosmology -> source frame, then for an EOS or
    EM run (EOS data, an EM model or light curve, or an injection with
    ``EOS``/``ratio_zeta``) the tabulated EOS set (or quasi-universal radii
    without EOS data) and the ejecta fits."""
    from .. import conversion as C
    gw_only = (args.get("em_model") is None
               and args.get("light_curve_data") is None
               and (injection is None
                    or ("EOS" not in injection
                        and "ratio_zeta" not in injection)))
    chain = [C.cosmology_to_distance, C.bns_source_frame]
    if args.get("eos_data"):
        from ..eos import load_macro_eos_set
        weights = None
        if args.get("eos_weights"):
            weights = np.loadtxt(args["eos_weights"])
        chain.append(load_macro_eos_set(args["eos_data"], weights=weights))
    elif not gw_only:
        chain.append(C.radii_from_qur)
    if not gw_only:
        # ejecta fitting needs EOS radii and disk-wind fractions; a pure-GW
        # injection (e.g. from a sim_inspiral xml) skips it
        chain.append(C.KilonovaEjectaFitting())
    return C.MultimessengerConversion(*chain)


class _EOSConstraintTerm:
    """constraint(params, curves) as a likelihood of the parameters: the
    sampled EOS's radius rows come from the tabulated set."""

    def __init__(self, constraint, eos_set):
        self.constraint = constraint
        self.eos_set = eos_set

    def __call__(self, parameters):
        curves = None
        if self.eos_set is not None and "EOS_index" in parameters:
            curves = {"masses": self.eos_set.mass_grid,
                      "radii": self.eos_set.rows(parameters["EOS_index"])}
        return self.constraint(parameters, curves)


def _with_priors(priors, extra):
    from ..priors import PriorDict
    return PriorDict({**priors.priors, **extra})


def build_joint_likelihood(dump, device=None):
    """(MultiMessengerLikelihood, PriorDict) from a data dump.

    GW: relative binning by default (its set-up raises rather than falling
    back), else the dense likelihood with the requested phase, distance
    and time marginalisations. Then, as the dump asks: the EM term (yaml
    systematics priors join the prior), the EOS-constraint term and the NS
    population term; a sampled Hubble_constant (``--hubble-prior``) and a
    weighted categorical EOS prior for a weighted EOS set.
    """
    from ..eos import TabulatedEOSSet
    from ..gw import (GWTransientLikelihood, RelativeBinningGWLikelihood,
                      get_waveform)
    from ..joint import MultiMessengerLikelihood
    from ..priors import (WeightedCategorical, adjust_priors_for_nmma,
                          hubble_prior, load_prior_file)

    device = resolve_device(device)
    args = dump["args"]
    priors = adjust_priors_for_nmma(load_prior_file(dump["prior_file"]))
    waveform = get_waveform(args.get("waveform", "TaylorF2"))
    if args.get("hubble_prior"):
        priors = _with_priors(priors, {
            "Hubble_constant": hubble_prior(args["hubble_prior"])})
    conversion = _build_conversion(
        dict(args, eos_data=dump.get("eos_data"),
             eos_weights=dump.get("eos_weights")), dump.get("injection"))
    eos_set = next((step for step in conversion._conversions
                    if isinstance(step, TabulatedEOSSet)), None)
    # a weighted EOS set replaces a plain 'EOS' prior with the weighted
    # categorical (reference setup_tabulated_eos_priors,
    # nmma/eos/eos_likelihood.py:21-32)
    if eos_set is not None and dump.get("eos_weights") and "EOS" in priors:
        priors = _with_priors(priors, {"EOS": WeightedCategorical(
            eos_set.n_eos, weights=eos_set.weights, name="EOS")})

    if not (args.get("no_relative_binning")
            or args.get("time_marginalization")):
        gw_lk = RelativeBinningGWLikelihood(
            dump["ifos"], dump["fiducial"], waveform=waveform,
            trigger_time=dump["trigger_time"],
            eps=args.get("binning_epsilon", 0.1),
            phase_marginalization=bool(args.get("phase_marginalization")),
            device=device)
    else:
        # the distance-marginalisation grid covers (and weights by) the
        # sampler's luminosity_distance prior
        dist_kwargs = {}
        lum = priors.priors.get("luminosity_distance")
        if (args.get("distance_marginalization") and lum is not None
                and np.isfinite(lum.minimum)):
            dist_kwargs["distance_bounds"] = (lum.minimum, lum.maximum)
            dist_kwargs["distance_prior"] = lambda d: float(torch.exp(
                lum.log_prob(torch.tensor(d, dtype=torch.float32))))
        gw_lk = GWTransientLikelihood(
            dump["ifos"], waveform=waveform,
            trigger_time=dump["trigger_time"],
            phase_marginalization=bool(args.get("phase_marginalization")),
            distance_marginalization=bool(
                args.get("distance_marginalization")),
            time_marginalization=bool(args.get("time_marginalization")),
            device=device, **dist_kwargs)
    likelihoods = [gw_lk]
    sanity = ()

    if dump.get("em_data"):
        from ..likelihood import (EMLikelihood, PhotometryData,
                                  SystematicsModel)
        from ..models import DetectorLightCurveModel
        filters = sorted(dump["em_data"].keys())
        if args.get("svd_path"):
            _register_svd_model(args, device)
        model = DetectorLightCurveModel(
            args["em_model"], filters,
            sample_times=np.geomspace(args["tmin"], args["tmax"], 100),
            device=device)
        photo, _ = PhotometryData.from_dict(dump["em_data"], filters,
                                            device=device)
        systematics = SystematicsModel(filters, args.get("systematics_file"),
                                       args.get("em_error_budget"))
        # yaml-requested systematics parameters join the sampled priors
        sys_priors = systematics.create_priors()
        if sys_priors:
            priors = _with_priors(priors, sys_priors)
        systematics.finalize(list(priors.keys()))
        likelihoods.append(EMLikelihood(model, photo, filters, systematics))
        sanity = ("log10_mej_dyn",)

    # the EOS constraint messenger (reference joint_likelihood.py:131-141)
    constraint = _build_constraint(dump.get("eos_constraints") or [])
    if constraint is not None:
        likelihoods.append(_EOSConstraintTerm(constraint, eos_set))

    # the NS mass population term (reference joint_likelihood.py:156-158)
    if args.get("population_model"):
        from ..population import NeutronStarPopulation
        likelihoods.append(NeutronStarPopulation(
            args["population_model"], beta=args.get("population_beta", 0.0)))
    return MultiMessengerLikelihood(conversion, likelihoods,
                                    sanity_keys=sanity), priors


def unit_cube_logl(likelihood, priors):
    """The batched ``u [B, ndim] -> logL [B]`` the sampler drives."""

    @torch.no_grad()
    def logl(u):
        return likelihood(priors.transform(u))

    return logl


def _analysis_parser():
    p = argparse.ArgumentParser("nmma-analysis")
    p.add_argument("--data-dump", required=True)
    p.add_argument("--outdir", default="outdir")
    p.add_argument("--label", default="joint")
    p.add_argument("--nlive", type=int, default=1024)
    p.add_argument("--n-delete", type=int, default=None)
    p.add_argument("--walks", type=int, default=24)
    p.add_argument("--dlogz", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-iter", type=int, default=100000)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    return p


def nmma_analysis(cli_args=None, device=None):
    """The analysis stage: nested sampling on the dump's likelihood; writes
    ``{label}_result.npz`` and returns the sampler's result. ``device``
    overrides ``--device``."""
    config, argv = check_for_config(cli_args)
    args = apply_config(_analysis_parser(), config, argv)
    device = resolve_device(device if device is not None else args.device)

    from ..inference import NestedSampler, NestedSamplerConfig

    with open(args.data_dump, "rb") as f:
        dump = pickle.load(f)
    likelihood, priors = build_joint_likelihood(dump, device=device)
    cfg = NestedSamplerConfig(
        nlive=args.nlive, n_delete=args.n_delete or max(args.nlive // 8, 1),
        walks=args.walks, dlogz=args.dlogz, seed=args.seed,
        max_iter=args.max_iter)
    sampler = NestedSampler(unit_cube_logl(likelihood, priors), priors.ndim,
                            cfg, device=device)
    os.makedirs(args.outdir, exist_ok=True)
    ckpt = os.path.join(args.outdir, f"{args.label}_checkpoint_resume.npz")
    result = sampler.run(verbose=True, checkpoint_path=ckpt, resume=True)

    # posterior conversion (reference posterior_conversion): every derived
    # 1-D column of the conversion chain (source-frame masses, ...)
    idx = result.posterior_indices()
    with torch.no_grad():
        post = priors.transform(torch.as_tensor(
            result.samples_u[idx], dtype=torch.float32, device=device))
        converted = likelihood.conversion(post)
    n_post = len(idx)
    derived = {k: v.cpu().numpy() for k, v in converted.items()
               if k not in post and v.ndim == 1 and v.shape[0] == n_post}
    np.savez(os.path.join(args.outdir, f"{args.label}_result.npz"),
             logz=result.logz, logz_err=result.logz_err, ncall=result.ncall,
             posterior_log_likelihood=result.logl[idx],
             **{f"posterior_{k}": v.cpu().numpy() for k, v in post.items()},
             **{f"posterior_{k}": v for k, v in derived.items()})
    print(f"log-evidence: {result.logz:.3f} +/- {result.logz_err:.3f} "
          f"({len(derived)} derived posterior columns)")
    return result


if __name__ == "__main__":
    raise SystemExit("invoke via nmma-generation / nmma-analysis")
