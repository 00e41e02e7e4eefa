"""Config/flag layer: config-file-first argv convention + shared parsers.

Port of ``nmma_tpu/cli/parsing.py`` (the reference's
``nmma/core/parsing.py``): the first positional argument may be a
yaml/ini/toml/cfg config file whose keys are flag names
(``check_for_config``, reference :72-103); explicit CLI flags override the
file. The flags are the JAX package's, so its configs run unchanged; the
port adds ``--device``. yaml and tomllib are imported only to read such a
file.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def check_for_config(cli_args=None):
    """Split (config_dict, remaining_argv) following reference :72-103."""
    cli_args = list(sys.argv[1:] if cli_args is None else cli_args)
    if not cli_args or cli_args[0].startswith("-"):
        return {}, cli_args
    candidate = cli_args[0]
    if not os.path.isfile(candidate):
        return {}, cli_args
    ext = os.path.splitext(candidate)[1].lower()
    config = {}
    if ext in (".yaml", ".yml"):
        import yaml
        with open(candidate) as f:
            config = yaml.safe_load(f) or {}
    elif ext in (".toml",):
        import tomllib
        with open(candidate, "rb") as f:
            config = tomllib.load(f)
    elif ext in (".ini", ".cfg", ".config"):
        import configparser
        cp = configparser.ConfigParser()
        cp.read(candidate)
        for section in cp.sections():
            config.update(dict(cp[section]))
        if cp.defaults():
            config.update(dict(cp.defaults()))
    else:
        return {}, cli_args
    return config, cli_args[1:]


def apply_config(parser: argparse.ArgumentParser, config: dict, argv):
    """Parse argv with config-file values as defaults (flags win).

    ini/cfg values arrive as strings: coerce them through each action's
    declared type (booleans for store_true/false flags — a string
    'False' would otherwise be truthy, silently flipping flags on
    complete-config round trips)."""
    if config:
        normalized = {k.replace("-", "_"): v for k, v in config.items()}
        defaults = {}
        for action in parser._actions:
            if action.dest not in normalized:
                continue
            value = normalized[action.dest]
            if isinstance(value, str):
                if isinstance(action, (argparse._StoreTrueAction,
                                       argparse._StoreFalseAction)) or \
                        isinstance(action.default, bool):
                    value = value.strip().lower() in ("true", "1", "yes",
                                                      "on")
                elif action.type is not None:
                    try:
                        value = action.type(value)
                    except (TypeError, ValueError):
                        pass
            defaults[action.dest] = value
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def base_analysis_parser(description=""):
    """Shared sampling/output flags (reference :105-129 names)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--model", type=str, help="EM model name")
    p.add_argument("--interpolation-type", type=str, default="tensorflow")
    p.add_argument("--svd-path", type=str, default=None,
                   help="Path to the SVD surrogate .npz")
    p.add_argument("--svd-mag-ncoeff", type=int, default=10)
    p.add_argument("--fiesta-surrogates-dir", type=str, default=None,
                   help="fiesta surrogate root (default "
                        "$NMMA_FIESTA_SURROGATES); --model names not in "
                        "the builtin registry resolve here (reference "
                        "FiestaKilonovaModel/FiestaGRBModel)")
    p.add_argument("--outdir", type=str, default="outdir")
    p.add_argument("--label", type=str, default="injection")
    p.add_argument("--prior", type=str, help="bilby-style .prior file")
    p.add_argument("--trigger-time", type=float, default=None)
    p.add_argument("--data-tmin", type=float, default=0.0)
    p.add_argument("--data-tmax", type=float, default=np.inf)
    p.add_argument("--light-curve-data", type=str, default=None)
    p.add_argument("--filters", type=str, default=None,
                   help="comma-separated filter list")
    p.add_argument("--em-tmin", "--tmin", dest="tmin", type=float,
                   default=0.01)
    p.add_argument("--em-tmax", "--tmax", dest="tmax", type=float,
                   default=14.0)
    p.add_argument("--em-nsteps", "--n-tsteps", dest="n_tsteps", type=int,
                   default=150)
    p.add_argument("--em-tstep", "--dt", dest="tstep", type=float,
                   default=None,
                   help="linear model-grid time step [days] (reference "
                        "quick-start --dt; overrides --em-nsteps)")
    p.add_argument("--kilonova-error", "--em-error-budget",
                   "--error-budget", dest="em_error_budget", type=float,
                   default=None)
    p.add_argument("--Ebv-max", dest="ebv_max", type=float, default=0.0,
                   help="linear-decay Ebv extinction prior upper bound "
                        "(0 disables; reference em_parsing.py:447)")
    p.add_argument("--injection-outfile", type=str, default=None,
                   help="write the synthesized injection photometry here")
    p.add_argument("--ztf-sampling", action="store_true",
                   help="KDE-drawn ZTF survey epochs (reference "
                        "adjust_data_for_ztf)")
    p.add_argument("--ztf-uncertainties", action="store_true",
                   help="skew-normal ZTF photometric uncertainties")
    p.add_argument("--ztf-ToO", dest="ztf_too", choices=["180", "300"],
                   default=None,
                   help="add ZTF target-of-opportunity exposures (s)")
    p.add_argument("--rubin-ToO-type", dest="rubin_too_type", default=None,
                   help="platinum | gold[_z] | silver[_z]")
    p.add_argument("--em-timescale", dest="timescale", default="log",
                   choices=["log", "linear"],
                   help="model time-grid spacing (reference "
                        "em_parsing.py:49)")
    p.add_argument("--em-extinction-law", dest="extinction_law",
                   default="P92_SMC_host",
                   choices=["P92_SMC_host", "G23_MW"])
    p.add_argument("--time-format", "--data-time-unit", dest="time_format",
                   default="mjd", help="photometry time column format "
                                       "(mjd | gps | jd | isot)")
    p.add_argument("--injection-model", type=str, default=None,
                   help="synthesize data with this model instead of "
                        "--model (reference em_parsing.py)")
    p.add_argument("--injection-error-budget",
                   "--photometric-error-budget",
                   dest="injection_error_budget", type=float, default=0.1)
    p.add_argument("--use-Ebv", dest="use_ebv", action="store_true",
                   help="sample Ebv even when --Ebv-max keeps its default")
    p.add_argument("--fetch-Ebv-from-dustmap", action="store_true",
                   help="GATED: dustmaps needs network data unavailable "
                        "in this environment")
    p.add_argument("--conditional-gaussian-prior-thetaObs",
                   dest="conditional_gaussian_prior_thetaobs",
                   action="store_true",
                   help="half-Gaussian iota | thetaCore conditional prior "
                        "(reference prior.py:18-77)")
    p.add_argument("--conditional-gaussian-prior-N-sigma",
                   dest="conditional_gaussian_prior_n_sigma", type=float,
                   default=1.0)
    p.add_argument("--ignore-timeshift", action="store_true",
                   help="pin timeshift = 0 regardless of the prior file")
    p.add_argument("--redshift", "--z", dest="redshift", type=float,
                   default=None, help="fix the source redshift")
    p.add_argument("--local-only", "--local-model-only", dest="local_only",
                   action="store_true",
                   help="never invoke the surrogate-download registry")
    p.add_argument("--em-transient-class", type=str, default=None)
    p.add_argument("--systematics-file", type=str, default=None)
    p.add_argument("--fits-file", type=str, default=None,
                   help="GW skymap FITS to build the inclination_EM prior "
                        "from (reference em/prior.py:80-171)")
    p.add_argument("--lfi-pretrained-embedding", action="store_true",
                   help="--sampler neuralnet conditions on the "
                        "reference's shipped similarity embedding "
                        "(ztf bands; mlmodel/pretrained.py)")
    p.add_argument("--lfi-vicreg-pretrain", action="store_true",
                   help="--sampler neuralnet runs the VICReg "
                        "self-supervised embedding stage on the "
                        "simulated set before flow training (reference "
                        "mlmodel/embedding.py two-stage pipeline)")
    p.add_argument("--lfi-vicreg-epochs", type=int, default=60)
    p.add_argument("--lfi-embedding-weights", type=str, default=None,
                   help="the reference's similarity_embedding_weights.pth "
                        "for --lfi-pretrained-embedding (it is not in the "
                        "repository)")
    p.add_argument("--detection-limit-fits-file", type=str, default=None,
                   help="m4opt LIMMAG HEALPix FITS: the detection limit "
                        "is read at --ra/--dec (reference "
                        "em/utils.py:199-210)")
    p.add_argument("--cosiota-node-num", type=int, default=10)
    p.add_argument("--ra", type=float, default=None,
                   help="sky position RA [deg] for the skymap pixel lookup")
    p.add_argument("--dec", type=float, default=None)
    p.add_argument("--dL", type=float, default=None,
                   help="fixed luminosity distance [Mpc] for the skymap "
                        "inclination prior (default: prior-file peak)")
    p.add_argument("--grb-resolution", type=float, default=12.0,
                   help="upper bound on thetaWing/thetaCore for the "
                        "afterglow kernel (reference em_parsing.py:430)")
    p.add_argument("--jet-type", type=int, default=0, choices=[-1, 0, 4],
                   help="afterglow jet structure: 0 Gaussian, -1 tophat, "
                        "4 power-law (reference em_parsing.py:424)")
    p.add_argument("--grb-ntheta", type=int, default=None,
                   help="afterglow ring count (default 32; doubling moves "
                        "mags < 0.01 on the GW170817 config)")
    p.add_argument("--grb-nphi", type=int, default=None)
    p.add_argument("--grb-nr", type=int, default=None,
                   help="afterglow radial grid (default 256)")
    p.add_argument("--grb-no-spread", action="store_true",
                   help="disable lateral spreading (afterglowpy default "
                        "is ON)")
    p.add_argument("--detection-limit", type=float, default=np.inf)
    p.add_argument("--remove-nondetections", action="store_true")
    p.add_argument("--injection", type=str, default=None,
                   help="injection json file")
    p.add_argument("--injection-num", type=int, default=0)
    p.add_argument("--generation-seed", type=int, default=42)
    # sampler flags (reference defaults: nlive=2048, dlogz=0.1)
    p.add_argument("--sampler", type=str, default="nmma-ns",
                   help="nmma-ns (vectorized nested sampling) or mcmc "
                        "(ensemble MCMC) or neuralnet (likelihood-free "
                        "inference)")
    p.add_argument("--mcmc-walkers", type=int, default=256)
    p.add_argument("--mcmc-sweeps", type=int, default=1500)
    p.add_argument("--mcmc-temps", type=int, default=1,
                   help="parallel-tempering ladder size for "
                        "--sampler mcmc (1 = plain ensemble)")
    p.add_argument("--nlive", type=int, default=2048)
    p.add_argument("--dlogz", type=float, default=0.1)
    p.add_argument("--n-delete", type=int, default=None,
                   help="live points replaced per NS iteration")
    p.add_argument("--walks", type=int, default=24)
    p.add_argument("--seed", "--sampling-seed", dest="seed", type=int,
                   default=42)
    p.add_argument("--check-point-delta-t", type=float, default=1800.0)
    p.add_argument("--skip-sampling", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--verbose", action="store_true")
    # on by default, as in the JAX package: the {label}_bestfit.json report
    p.add_argument("--bestfit", action="store_true", default=True)

    def yaml_dict(value):
        import yaml
        if isinstance(value, dict):
            return value
        return yaml.safe_load(value)

    p.add_argument("--multi", type=yaml_dict, default=None,
                   help="yaml dict mapping a flag to values (or named runs "
                        "to override dicts); expands into sub-runs")
    p.add_argument("--matrix", type=yaml_dict, default=None,
                   help="yaml dict of flag -> value list; cartesian product")
    return p


def sampler_config_from_args(args):
    from ..inference import NestedSamplerConfig
    n_delete = args.n_delete or max(args.nlive // 8, 1)
    return NestedSamplerConfig(
        nlive=args.nlive, n_delete=n_delete, walks=args.walks,
        dlogz=args.dlogz, seed=args.seed,
        check_point_delta_t=args.check_point_delta_t)


def write_complete_config(args, outdir=None, label=None):
    """Write back the fully-resolved configuration as an ini file.

    Counterpart of ``write_complete_config_file``
    (nmma/joint/generation.py:76-114): every flag with its resolved value
    (defaults + config file + CLI overrides), so a run is reproducible
    from its output directory alone.
    """
    import os
    outdir = outdir or getattr(args, "outdir", "outdir")
    label = label or getattr(args, "label", "run")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{label}_config_complete.ini")
    with open(path, "w") as fh:
        fh.write("[config]\n")
        for key in sorted(vars(args)):
            value = getattr(args, key)
            if value is None:
                continue
            fh.write(f"{key.replace('_', '-')} = {value}\n")
    return path
