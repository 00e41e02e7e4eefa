"""The nested sampler split over every card of one host, one NCCL rank a
card (``nmma_tpu_torch.parallel``), against the same run in one process.

Run it from the repository root with one process per card:

    torchrun --standalone --nproc-per-node=N scripts/torch_mesh_cards.py \
        [--iterations 10]

Each rank builds chip_smoke.py's phase-4 analysis on its card (the
production Bu2019lm surrogate through K1, photometry made from it at the
injection, the headline prior) and runs the capped sampler (nlive 1,024,
n_delete 128) through ``NestedSampler(..., mesh=make_mesh())``. It fails
unless
* every rank's samples, logL, logZ, iterations and calls are equal bit for
  bit, and K1 launches 1 + iterations x walks on each rank, at nlive / N
  and n_delete / N rows;
* rank 0's run of the same sampler in one process, without the mesh, reads
  a logZ within 3 max(hypot(errors), 0.1) (whether the two are equal bit
  for bit is printed);
* ``shard_logl`` on 8,192 seeded rows agrees with one process's
  ``batched_logl``: sentinels identical, |dlogL| <= 1e-2 + 1e-4 |logL|
  (K1's 1e-4 mag carried to logL).
It measures the wall s of each run (after a 2-iteration sharded run that
takes the first launches of every kernel), an ``all_reduce``'s us at
B = 128, a sharded walk step's wall ms and idle share against one card's
``batched_logl`` at the walk's B = 128 (on rank 0), and ``shard_logl``
against one card's ``batched_logl`` at B = 8,192 and 65,536. Rank 0 prints
the card's name and power limit, a line per check, and last one JSON
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# shard_logl against one card's batched_logl at these batches
SCALING_BATCHES = (8192, 65536)
SCALING_CALLS = 10


def wall_ms(torch, fn, calls=SCALING_CALLS, warmup=2):
    """Host ms of one ``fn()`` over ``calls`` synchronized calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=10)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import chip_smoke as S
    from nmma_tpu_torch import _kernels
    from nmma_tpu_torch.analysis import EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.parallel import mesh as M

    M.initialize_distributed()
    if not dist.is_initialized():
        raise SystemExit("run under torchrun: no process group")
    mesh = M.make_mesh()
    rank, n = mesh.rank, mesh.size
    lead = rank == 0

    def say(phase, **fields):
        if lead:
            S.say(phase, **fields)

    if lead:
        name = torch.cuda.get_device_name(mesh.device)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        t0 = time.time()
        _kernels.build()
        say("build", seconds=f"{time.time() - t0:.3f}")
    dist.barrier()
    S.DEVICE = mesh.device      # the smoke's helpers make tensors there
    svd = SVDModelData.load(S.ARTIFACT, device=mesh.device)
    make_svd_source_model(S.MODEL, svd)
    with tempfile.TemporaryDirectory(prefix="torch_mesh_cards_") as root:
        data_path = os.path.join(root, "injection.dat")
        prior_path = os.path.join(root, "bu2019lm.prior")
        with open(prior_path, "w") as f:
            f.write(S.PRIOR_TEXT)
        S.synthetic_photometry(np, torch, S.MODEL, list(svd.filters),
                               data_path, S.INJECTION,
                               sample_times=(0.01, 14.0, 150),
                               epochs=(0.5, 12.0))
        cfg = EMAnalysisConfig(
            model=S.MODEL, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=S.TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
            filters=list(svd.filters),
            sampler=NestedSamplerConfig(nlive=1024, n_delete=128,
                                        max_iter=args.iterations))
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        cfg, analysis, u = S.mesh_analysis(torch, root, mesh.device)

    # a short sharded run first, so that neither timed run pays for the
    # first launches of its kernels; then the sharded run on every rank,
    # and the one-process run on rank 0
    S.mesh_run(torch, analysis, dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, max_iter=2)), mesh)
    result, launches, collectives, seconds, rows = S.mesh_run(
        torch, analysis, cfg, mesh)
    mine = dict(samples_u=result.samples_u, logl=result.logl,
                logz=result.logz, niter=result.niter, ncall=result.ncall,
                launches=launches, collectives=collectives, rows=rows,
                seconds=seconds)
    ranks = [None] * n
    dist.all_gather_object(ranks, mine)
    if lead:
        plain, plain_k1, _, plain_s, plain_rows = S.mesh_run(
            torch, analysis, cfg, None, device=mesh.device)
    dist.barrier()
    expected = 1 + result.niter * cfg.sampler.walks
    share = [cfg.sampler.n_delete // n, cfg.sampler.nlive // n]
    for r, got in enumerate(ranks):
        for field in ("samples_u", "logl", "logz", "niter", "ncall"):
            if not np.array_equal(got[field], mine[field]):
                raise RuntimeError(f"rank {r}'s {field} differs from rank "
                                   f"{rank}'s")
        if (got["launches"], got["collectives"], got["rows"]) \
                != (expected, expected, share):
            raise RuntimeError(
                f"rank {r}: K1 launches {got['launches']} at rows "
                f"{got['rows']} and {got['collectives']} collectives, "
                f"expected {expected} at rows {share}")

    # shard_logl at B = 8,192 against one process's batched_logl
    sharded = M.shard_logl(analysis.batched_logl, mesh)
    logl = sharded(u).cpu().numpy()
    report = {}
    if lead:
        dz = abs(result.logz - plain.logz)
        dz_gate = 3.0 * max(math.hypot(result.logz_err, plain.logz_err),
                            0.1)
        if not dz < dz_gate:
            raise RuntimeError(f"logZ {result.logz} on {n} ranks against "
                               f"{plain.logz} in one process: |dlogZ| {dz} "
                               f">= {dz_gate}")
        one = analysis.batched_logl(u).cpu().numpy()
        usable = one > -1e29
        if not np.array_equal(usable, logl > -1e29):
            raise RuntimeError("shard_logl's sentinels differ from one "
                               "process's")
        dlogl = np.abs(logl - one)[usable]
        if np.any(dlogl > S.LOGL_ATOL + S.LOGL_RTOL * np.abs(one[usable])):
            raise RuntimeError(f"shard_logl off one process's batched_logl "
                               f"by {float(dlogl.max())}")
        bitwise = all(np.array_equal(mine[f], np.asarray(getattr(plain, f)))
                      for f in ("samples_u", "logl", "logz"))
        report.update(
            ranks=n, iterations=result.niter, logz=result.logz,
            logz_one_process=plain.logz, dlogz=dz, dlogz_gate=dz_gate,
            bitwise_ranks=True, bitwise_vs_one_process=bitwise,
            k1_launches_per_rank=expected, k1_rows=share,
            k1_launches_one_process=plain_k1,
            k1_rows_one_process=plain_rows,
            seconds_run=[r["seconds"] for r in ranks],
            seconds_one_process=plain_s,
            logl_bitwise=bool(np.array_equal(logl, one)),
            max_abs_dlogl=float(dlogl.max()) if dlogl.size else 0.0)
        say("mesh_cards", **{k: report[k] for k in (
            "ranks", "iterations", "logz", "logz_one_process",
            "bitwise_vs_one_process", "logl_bitwise", "seconds_one_process")},
            seconds_run=",".join(f"{s:.3f}" for s in report["seconds_run"]))
    dist.barrier()

    # the collective, a walk step, and the likelihood's scaling
    report["collective_us_b128"] = S.mesh_collective_us(torch, mesh, 128)
    walk = S.mesh_walk(torch, sharded, u[:128], profile=lead)
    report.update(walk_wall_ms=walk[0], walk_busy_ms=walk[1],
                  walk_idle_share=walk[2])
    if lead:
        walk = S.mesh_walk(torch, analysis.batched_logl, u[:128])
        report.update(one_card_walk_wall_ms=walk[0],
                      one_card_walk_busy_ms=walk[1],
                      one_card_walk_idle_share=walk[2])
    dist.barrier()
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(1)
    for b in SCALING_BATCHES:
        ub = analysis.priors.sample_units(gen, b)
        report[f"shard_logl_ms_b{b}"] = wall_ms(torch, lambda: sharded(ub))
        if lead:
            report[f"one_card_ms_b{b}"] = wall_ms(
                torch, lambda: analysis.batched_logl(ub))
        dist.barrier()
    if lead:
        report["device"] = {"kind": name, "count": n}
        say("mesh_cards_timing", **{k: (f"{v:.4f}" if isinstance(v, float)
                                        else v) for k, v in report.items()
                                    if k.startswith(("collective", "walk",
                                                     "shard", "one_card"))})
        say("mesh_cards_seconds", sharded=report["seconds_run"][0],
            one_process=report["seconds_one_process"])
        print(json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
