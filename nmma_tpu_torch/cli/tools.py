"""Surrogate-training command lines: ``create-svdmodel``,
``svdmodel-benchmark`` and ``resample-grid``.

Port of those entry points of ``nmma_tpu/cli/tools.py`` (the reference's
``nmma.em.training:create_svdmodel`` / ``benchmark`` and
``lightcurve_handling:resample_lightcurve_grid``), with the JAX package's
flags. Training and the benchmark run on the CUDA card and raise without
one, unless ``--device cpu`` (or ``device="cpu"``) asks for the CPU. Run as

    python -m nmma_tpu_torch.cli.tools create-svdmodel --model ... [flags]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import warnings

from .. import resolve_device
from .parsing import apply_config, check_for_config

MLP_BACKENDS = ("keras", "tensorflow", "jax", "torch")
GP_BACKENDS = ("sklearn_gp", "api_gp")


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
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    args = apply_config(p, config, argv)
    device = resolve_device(device if device is not None else args.device)

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
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    args = apply_config(p, config, argv)
    device = resolve_device(device if device is not None else args.device)

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


COMMANDS = {"create-svdmodel": create_svdmodel,
            "svdmodel-benchmark": svdmodel_benchmark,
            "resample-grid": resample_grid}


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        sys.exit(f"usage: python -m nmma_tpu_torch.cli.tools "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    COMMANDS[sys.argv[1]](sys.argv[2:])
