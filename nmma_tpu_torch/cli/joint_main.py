"""``nmma-generation`` / ``nmma-analysis``: the two-stage pipeline, GW only.

PyTorch counterpart of the GW-only branch of ``nmma_tpu/cli/joint_main.py``
(the reference's ``nmma/joint/generation.py`` + ``nmma/joint/main.py``).
The generation stage reads the prior and the injection (json or LIGO-LW
xml), runs the conversion chain (cosmology -> source frame), makes the GW
data (a zero-noise injection, or real strain read from files with a
median-Welch PSD, a Tukey window and an FFT), finds the relative-binning
fiducial (the injection, or a maximum-likelihood search), writes the data
dump and evaluates the likelihood once. The analysis stage rebuilds the
likelihood from the dump and runs the batched nested sampler; the result
``.npz`` carries the posterior and the conversion chain's derived columns.

Both stages run on the CUDA card and raise without one, unless ``--device
cpu`` (or ``device="cpu"``) asks for the CPU. The dump is the port's own
pickle (plain dicts, numpy arrays and the port's ``InterferometerData``).
The EOS, EM, population and Hubble parts of the joint pipeline are ROADMAP
item 16; their flags raise.
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
    # --- EM (ROADMAP item 16) ---
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
    # --- EOS (ROADMAP item 16) ---
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
    # --- population / cosmology (ROADMAP item 16) ---
    p.add_argument("--population-model", default=None,
                   help="NS mass population: flat | peak")
    p.add_argument("--population-beta", type=float, default=0.0)
    p.add_argument("--hubble-prior", default=None,
                   help="uniform | planck | sh0es — adds a sampled "
                        "Hubble_constant (reference Hubble prior surgery)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    return p


# the flags of the joint path's EOS, EM, population and Hubble parts
_JOINT_FLAGS = {
    "eos_data": "--eos-data", "eos_weights": "--eos-weights",
    "eos_reweight": "--eos-reweight", "lower_mtov": "--lower-mtov",
    "upper_mtov": "--upper-mtov", "mass_radius_files": "--mass-radius-files",
    "eos_constraint_json": "--eos-constraint-json", "em_model": "--em-model",
    "light_curve_data": "--light-curve-data",
    "population_model": "--population-model",
    "hubble_prior": "--hubble-prior",
}


def _refuse_joint_flags(args):
    for dest, flag in _JOINT_FLAGS.items():
        if args.get(dest):
            raise NotImplementedError(
                f"{flag} belongs to the joint path with EOS and EM, which "
                "nmma_tpu_torch does not have yet (ROADMAP item 16)")


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
    _refuse_joint_flags(vars(args))
    device = resolve_device(device if device is not None else args.device)
    args.device = str(device)

    from ..gw import get_waveform
    from ..injections import read_injection_entry
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

    dump = {
        "args": vars(args),
        "injection": injection,
        "fiducial": fiducial,
        "ifos": ifos,
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
    """The GW-only conversion chain: cosmology -> source frame. An EOS or
    EM run (EOS data, an EM model or light curve, or an injection with
    ``EOS``/``ratio_zeta``) is the joint path of ROADMAP item 16."""
    from .. import conversion as C
    gw_only = (args.get("em_model") is None
               and args.get("light_curve_data") is None
               and not args.get("eos_data")
               and (injection is None
                    or ("EOS" not in injection
                        and "ratio_zeta" not in injection)))
    if not gw_only:
        raise NotImplementedError(
            "EOS and ejecta conversions belong to the joint path with EOS "
            "and EM, which nmma_tpu_torch does not have yet (ROADMAP item 16)")
    return C.MultimessengerConversion(C.cosmology_to_distance,
                                      C.bns_source_frame)


def build_joint_likelihood(dump, device=None):
    """(MultiMessengerLikelihood, PriorDict) from a data dump: relative
    binning by default, else the dense likelihood with the requested
    phase, distance and time marginalisations."""
    from ..gw import (GWTransientLikelihood, RelativeBinningGWLikelihood,
                      get_waveform)
    from ..joint import MultiMessengerLikelihood
    from ..priors import adjust_priors_for_nmma, load_prior_file

    device = resolve_device(device)
    args = dump["args"]
    _refuse_joint_flags(args)
    priors = adjust_priors_for_nmma(load_prior_file(dump["prior_file"]))
    waveform = get_waveform(args.get("waveform", "TaylorF2"))
    conversion = _build_conversion(args, dump.get("injection"))

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
    return MultiMessengerLikelihood(conversion, [gw_lk]), priors


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
