#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``nmma_tpu_torch/csrc`` and drives the
EM parameter-estimation main path of ``nmma_tpu_torch`` with its source
models: the Bu2019lm SVD surrogate at production width (P=4, H=2048, C=10,
F=9, Q=150) through K1, the analytic Me2017 kilonova (299 shells, T=150,
9 filters x 9 bandpass nodes) through K2, the TrPi2018 GRB afterglow at the
JAX package's full resolution (48 rings x 16 phi nodes, 256 radii, stage 2
on 128, 64 observer times, 5 filters) through K3, and Me2017 + TrPi2018
through K2 and K3:

  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    nvcc build of every kernel, all started together, in seconds,
              and ptxas's registers, stack and spills of each kernel;
  3. k1       K1 against its plain PyTorch version on the card at the main
              path's shapes (B = 1, 128, 8199; max abs error <= 1e-4 mag),
              then its device time at the samplers' B = 128 (torch.profiler
              over 20 launches) and kernel and plain timings at B = 8192
              (CUDA events, median of 25 rounds of 10 launches), each with
              its bound;
  4. logl     synthetic photometry from the surrogate -> .dat file ->
              load_em_observations -> EMAnalysis.batched_logl at B = 8192
              (one K1 launch, no K2 launch): finite share, evals/s over 5
              rounds of >= 0.4 s of back-to-back calls (with the spread of
              the rounds), and max |dlogL| against the same batch with the
              plain K1 on the card; a torch.profiler pass at B = 8192 and
              128 gives device-busy time and idle share;
  5. sampler  EMAnalysis.run: nested sampling with nlive=1024, n_delete=128,
              capped at 40 iterations and 90 s; logZ, likelihood calls and
              the run's K1 launches, which must be 1 + iterations x walks,
              with no K2 launch; result files.
  6. k2       K2 against its plain version on the card at B = 1, 128, 8199
              under the near-tie rule (ops/me2017_kernel.py
              compare_dynamics): max relative errors, near-ties, mismatches;
              r_photo must equal the plain version's bit for bit and ltot
              lie within 1e-4 relative where ltot_ref > 1e-4; then its
              device time at B = 128 and kernel and plain timings at
              B = 8192 as for K1; then [k2_ties]: K2 against its plain
              version at B = 1024 on shells tied exactly in pairs
              (ops/me2017_kernel.py tied_operands), the pair in two lanes
              and in two slots of one lane: r_photo bit for bit, at least
              100 ties where the pair's vm differ, ltot within 1e-4, one
              launch per call;
  7. me2017_logl
              the same as phase 4 with the Me2017 model (one K2 launch, no
              K1 launch), its peak device memory, and |dlogL| against the
              plain K2 off the live points where the plain version sees a
              near-tie;
  8. me2017_sampler
              the same as phase 5 with the Me2017 model: K2 launches
              1 + iterations x walks, no K1 launch.
  9. k3       K3 against its plain version on the card on stage-1 operands
              of config-3 prior draws at B = 1, 64, 257 (max relative error
              where |ref| > 1e-6 max|ref|, <= 1e-4); then the kernel's time
              at B = 8192 (median of 5 rounds of 2 launches), its time on
              the same rows with every query moved above the cap (the map,
              cummax and phi sum alone), the plain version's (one call) and
              the bound; then [k3_edges]: K3 against its plain version on
              hand-made rows (ops/grb_kernel.py edge_operands: cummax
              plateaus, queries on a node, on a plateau value, at both ends
              and outside the rows) at R = 100, 128, 256, T = 37, Ph = 5
              and 16: within the same 1e-4, zeros in the same places, one
              launch per call;
 10. grb_logl the same as phase 7 with TrPi2018 on config-3 photometry (one
              K3 launch, no K1 or K2 launch), with |dlogL| against the plain
              K3 at B = 1024 and the profile at B = 8192 and 64 with K3's
              device time;
 11. grb_sampler
              nested sampling with config 3's nlive=512, n_delete=64,
              walks=16, capped at 40 iterations and 90 s: K3 launches
              1 + iterations x walks, no K1 or K2 launch, finite logZ;
 12. combined_logl
              Me2017 + TrPi2018 (make_combined_source_model) on synthetic
              photometry, one batched_logl at B = 1024: one K2 and one K3
              launch, |dlogL| against the plain K2 and K3 off near-tie live
              points.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(HERE, "artifacts", "Bu2019lm_production_svd.npz")
MODEL = "Bu2019lm_production"
# the headline prior of the repo's benchmark (bench.py:59-66)
PRIOR_TEXT = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)
KNphi = Uniform(minimum=15., maximum=75.)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
             "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0}
TRIGGER_MJD = 60000.0
DEVICE = "cuda"
BATCH = 8192
K1_TOL = 1e-4                # mag, as tests/test_pallas_svd.py:55
LOGL_RTOL, LOGL_ATOL = 1e-4, 1e-2
# the Me2017 path: the in-repo prior of tests/test_inference.py:61-66 with
# the distance and timeshift free, and its injection (:46-47)
ME_PRIOR_TEXT = """\
log10_mej = Uniform(minimum=-3., maximum=-0.5)
log10_vej = Uniform(minimum=-2., maximum=-0.5)
beta = Uniform(minimum=1., maximum=5.)
log10_kappa_r = Uniform(minimum=-1., maximum=2.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
ME_INJECTION = {"log10_mej": -1.3, "log10_vej": -1.1, "beta": 3.0,
                "log10_kappa_r": 0.8, "luminosity_distance": 40.0,
                "timeshift": 0.0}
# f32 operations per (live point, shell, step) in the K2 loop body
# (csrc/me2017_dynamics.cu), and per (live point, step) outside it
K2_OPS_SHELL_STEP = 31
K2_OPS_STEP = 2
# K2's ltot against its plain version, relative, where ltot_ref > 1e-4: the
# kernel's one reciprocal per shell-step and FMAs read ~5e-7 in the CPU
# emulation (tests/test_torch_me2017.py); 20x inside compare_dynamics' 2e-3
K2_LTOT_TOL = 1e-4
# the samplers' walk batch (n_delete=128), where K1 and K2 run 961 times
SAMPLER_BATCH = 128
# the TrPi2018 path: BASELINE config 3, scripts/bench_grb_pe.py:17-50
GRB_FILTERS = ["ztfg", "ztfr", "ztfi", "X-ray-1keV", "radio-6GHz"]
GRB_PRIOR_TEXT = """\
log10_E0 = Uniform(minimum=49., maximum=54.)
thetaCore = Uniform(minimum=0.01, maximum=0.3)
thetaWing = 0.4
inclination_EM = Uniform(minimum=0., maximum=0.5)
log10_n0 = Uniform(minimum=-4., maximum=1.)
p = Uniform(minimum=2.01, maximum=2.9)
log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)
log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)
xi_N = 1.0
luminosity_distance = 350.0
timeshift = Uniform(minimum=-0.1, maximum=0.1)
"""
GRB_INJECTION = {"log10_E0": 51.5, "thetaCore": 0.1, "thetaWing": 0.4,
                 "inclination_EM": 0.05, "log10_n0": -1.5, "p": 2.4,
                 "log10_epsilon_e": -1.2, "log10_epsilon_B": -3.0,
                 "xi_N": 1.0, "luminosity_distance": 350.0, "timeshift": 0.0}
# relative, where |ref| > 1e-6 max|ref|: K3 reads <= 2.6e-5 against its plain
# version on the card, a bf16 hat (the JAX default's) 3e-4 to 7e-4 against
# the plain version on the CPU (tests/test_torch_grb.py)
K3_TOL = 1e-4
# Me2017 + TrPi2018: the model and prior of BASELINE config 4
# (scripts/bench_grb_pe.py:63-97) on synthetic photometry
COMBINED_PRIOR_TEXT = """\
log10_mej = Uniform(minimum=-3., maximum=-1.)
log10_vej = Uniform(minimum=-2., maximum=-0.5)
beta = Uniform(minimum=1., maximum=5.)
log10_kappa_r = Uniform(minimum=-1., maximum=2.)
log10_E0 = Uniform(minimum=47., maximum=53.)
thetaCore = Uniform(minimum=0.01, maximum=0.3)
thetaWing = 0.3
inclination_EM = Uniform(minimum=0., maximum=0.4)
log10_n0 = Uniform(minimum=-5., maximum=1.)
p = Uniform(minimum=2.01, maximum=2.9)
log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)
log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)
xi_N = 1.0
luminosity_distance = 350.0
timeshift = 0.0
"""
COMBINED_INJECTION = {"log10_mej": -1.3, "log10_vej": -1.1, "beta": 3.0,
                      "log10_kappa_r": 0.8, "log10_E0": 51.0,
                      "thetaCore": 0.1, "thetaWing": 0.3,
                      "inclination_EM": 0.05, "log10_n0": -1.5, "p": 2.4,
                      "log10_epsilon_e": -1.2, "log10_epsilon_B": -3.0,
                      "xi_N": 1.0, "luminosity_distance": 350.0,
                      "timeshift": 0.0}
# f32 operations that K3's function needs, an FMA counted as two and a sin,
# exp or log as one, from the steps of csrc/grb_eats.cu: per (live point,
# ring, phi, r) the arrival-time map, its log, the cummax and the cap at 60;
# per (live point, ring, phi, t) query the in-range test. A query out of
# range carries no flux and needs nothing more; one in range needs a search
# of the monotone log-time row (a compare and a select per step), the two
# hat nodes that can be nonzero (coefficients, hat and six sums each) and
# the Doppler/synchrotron epilogue, with its per-filter part and the phi sum
K3_OPS_MAP = 11
K3_OPS_RANGE = 2
K3_OPS_SEARCH_STEP = 2
K3_OPS_NODE = 24
K3_OPS_PAIR = 52
K3_OPS_PAIR_F = 9
# peaks of one H100 SXM at 700 W (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def ptxas_summary(report):
    """registers, stack frame and spill bytes of each kernel entry in
    nvcc's -Xptxas -v output, '/'-joined where a library has several."""
    regs = re.findall(r"Used (\d+) registers", report)
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", report)
    return {"registers": "/".join(regs),
            "stack_bytes": "/".join(f[0] for f in frames),
            "spill_store_bytes": "/".join(f[1] for f in frames),
            "spill_load_bytes": "/".join(f[2] for f in frames)}


def relative_error(torch, got, want):
    """Max |got - want| / |want| where |want| > 1e-6 max|want|."""
    scale = float(want.abs().max())
    return float(((got - want).abs() / torch.clamp(
        want.abs(), min=1e-6 * scale)).max())


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(torch, fn, rounds=25, launches=10, warmup=3):
    """Device time of one ``fn()``: CUDA events around ``launches``
    back-to-back calls, median over ``rounds`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def throughput(torch, fn, rounds=5, round_s=0.4, warmup=3):
    """Host-clock rate of back-to-back ``fn()`` calls after warm-up: each
    round calls ``fn`` until ``round_s`` has passed, then synchronizes.
    Returns (ms per call over all rounds, calls, [ms per call of each
    round])."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls, seconds, per_round = 0, 0.0, []
    for _ in range(rounds):
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < round_s:
            fn()
            n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls, seconds = calls + n, seconds + dt
        per_round.append(1e3 * dt / n)
    return 1e3 * seconds / calls, calls, per_round


def device_profile(torch, fn, kernel=None):
    """(device-busy ms, kernel launches, top kernels, device ms of the
    kernels whose name contains ``kernel``, their launches) of one ``fn()``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    named = [e for e in dev if kernel and kernel in e.key]
    return busy_ms, sum(e.count for e in dev), ";".join(
        f"{e.key[:40]}:{e.self_device_time_total / 1e3:.4f}" for e in top), \
        sum(e.self_device_time_total for e in named) / 1e3, \
        sum(e.count for e in named)


def kernel_device_ms(torch, fn, kernel, calls=20, warmup=3):
    """Device ms of one launch of the kernels whose name contains
    ``kernel``, from torch.profiler over ``calls`` calls of ``fn`` after
    warm-up: at the samplers' small batches the host launches slower than
    the card runs the kernel, so CUDA events would time the host's gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    named_ms, count = device_profile(
        torch, lambda: [fn() for _ in range(calls)], kernel)[3:]
    # the tracer may drop a record: average over the launches it saw
    if not 0 < count <= calls:
        raise RuntimeError(f"the profiler saw {count} launches of {kernel} "
                           f"in {calls} calls")
    return named_ms / count


def synthetic_photometry(np, torch, model, filters, path, injection,
                         sample_times, epochs):
    """Injection light curve of one of the port's models on the grid
    ``geomspace(*sample_times)``: 10 epochs per filter drawn in ``epochs``
    (days) with seeded noise and a few upper limits, written as a .dat
    file in MJD."""
    from nmma_tpu_torch.io import write_em_observations
    from nmma_tpu_torch.models import DetectorLightCurveModel

    detector = DetectorLightCurveModel(
        model, filters, sample_times=np.geomspace(*sample_times),
        device=DEVICE)
    params = {k: torch.tensor([v], device=DEVICE)
              for k, v in injection.items()}
    t_obs, mags = detector(params)
    t_obs = t_obs[0].cpu().numpy().astype(np.float64)
    mags = mags[0].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(2017)
    data = {}
    for i, f in enumerate(filters):
        t = np.sort(rng.uniform(epochs[0], epochs[1], 10))
        m = np.interp(t, t_obs, mags[i]) + rng.normal(0.0, 0.1, t.size)
        err = np.full(t.size, 0.1)
        if i % 3 == 0:      # last epoch of every third filter: upper limit
            m[-1] -= 1.0
            err[-1] = np.inf
        if not np.all(np.isfinite(m)):
            raise RuntimeError(f"injection light curve not finite in {f}")
        data[f] = {"time": t + TRIGGER_MJD, "mag": m, "mag_error": err}
    write_em_observations(path, data, fmt="dat")
    return data


def injection_units(priors, injection):
    """The injection as a [1, ndim] point of the unit cube (Uniform
    priors)."""
    import torch

    return torch.tensor([[
        (injection[n] - priors[n].minimum)
        / (priors[n].maximum - priors[n].minimum)
        for n in priors.sampled_names]], device=DEVICE)


def me2017_path(np, torch, gen, sample_times):
    """Phases 6-8: K2 against its plain version, then the Me2017 main path
    through EMAnalysis.batched_logl and the sampler. Returns K2's entry of
    the kernel line."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.ops import me2017_kernel as k2
    from nmma_tpu_torch.ops import svd_kernel

    # 6. K2 against its plain version at the main path's shapes
    def draw(b):   # the parameter ranges of tests/test_pallas_kernel.py
        u = torch.rand((4, b), generator=gen, device=DEVICE)
        return (-3.0 + 2.5 * u[0], -2.0 + 1.5 * u[1], 1.0 + 4.0 * u[2],
                10.0 ** (-1.0 + 3.0 * u[3]))

    worst = {"ltot_max_rel": 0.0, "r_max_rel_non_tie": 0.0}
    max_err = 0.0
    for b in (1, 128, BATCH + 7):
        ops = k2.me2017_operands(*draw(b), sample_times)
        ltot, r_photo = k2.me2017_dynamics_from_operands(*ops)
        want = k2.me2017_dynamics_plain(*ops, with_ties=True)
        torch.cuda.synchronize()
        stats = k2.compare_dynamics(ltot, r_photo, *want)
        if ltot.shape != want[0].shape or not stats["ok"]:
            raise RuntimeError(f"K2 disagrees at B={b}: {stats}")
        # the kernel rounds tau as the plain version does: same shell
        if not torch.equal(r_photo, want[1]):
            raise RuntimeError(f"K2's r_photo differs from the plain "
                               f"version's at B={b} in "
                               f"{int((r_photo != want[1]).sum())} points")
        if stats["ltot_max_rel"] > K2_LTOT_TOL:
            raise RuntimeError(f"K2's ltot is {stats['ltot_max_rel']} off "
                               f"the plain version's at B={b} (tolerance "
                               f"{K2_LTOT_TOL})")
        for key in worst:
            worst[key] = max(worst[key], stats[key])
        max_err = max(max_err, float((ltot - want[0]).abs().max()))
        say("k2", batch=b, **{k: v for k, v in stats.items() if k != "ok"},
            r_exact_share=f"{float((r_photo == want[1]).float().mean()):.6f}")
    n_t = sample_times.shape[0]

    def bound(ops, n_b):
        n_ops = (n_t - 1) * n_b * (K2_OPS_SHELL_STEP * k2.N_SHELLS
                                   + K2_OPS_STEP)
        n_bytes = 4.0 * sum(t.numel() for t in ops) + 4.0 * 2 * n_b * n_t
        return n_ops, n_bytes, 1e3 * max(n_ops / PEAK_F32_FLOPS,
                                         n_bytes / PEAK_BYTES), \
            "operations" if n_ops / PEAK_F32_FLOPS >= n_bytes / PEAK_BYTES \
            else "bytes"

    ops = k2.me2017_operands(*draw(SAMPLER_BATCH), sample_times)
    k2_ms_small = kernel_device_ms(
        torch, lambda: k2.me2017_dynamics_from_operands(*ops),
        "me2017_dynamics_kernel")
    say("k2", batch=SAMPLER_BATCH, kernel_ms=f"{k2_ms_small:.4f}",
        timed_by="profiler", bound_ms=f"{bound(ops, SAMPLER_BATCH)[2]:.4f}")
    ops = k2.me2017_operands(*draw(BATCH), sample_times)
    k2_ms = time_ms(torch, lambda: k2.me2017_dynamics_from_operands(*ops))
    k2_plain_ms = time_ms(torch, lambda: k2.me2017_dynamics_plain(*ops))
    n_ops, n_bytes, k2_bound_ms, k2_bound_by = bound(ops, BATCH)
    say("k2", batch=BATCH, kernel_ms=f"{k2_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", bound_ms=f"{k2_bound_ms:.4f}",
        bound_by=k2_bound_by, bound_share=f"{k2_bound_ms / k2_ms:.4f}",
        gops=f"{n_ops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}")

    # K2 on exact ties: shell s + stride takes tau of shell s, in two lanes
    # (stride 1) or two slots of one lane (stride 32); the first shell of a
    # pair must win, as in the plain version
    n_ties = 1024
    for stride in (1, 32):
        shells, per_sample, per_step = k2.me2017_operands(
            *draw(n_ties), sample_times)
        shells = k2.tied_operands(shells, stride)
        before = k2.LAUNCHES
        ltot, r_photo = k2.me2017_dynamics_from_operands(
            shells, per_sample, per_step)
        launched = k2.LAUNCHES - before
        ltot_ref, r_ref, gap, r_cand = k2.me2017_dynamics_plain(
            shells, per_sample, per_step, with_ties=True)
        torch.cuda.synchronize()
        tied = gap == 0
        decisive = tied & (r_cand[..., 0] != r_cand[..., 1])
        sel = ltot_ref > 1e-4
        ltot_rel = float(((ltot - ltot_ref).abs() / ltot_ref)[sel].max())
        mismatches = int((r_photo != r_ref).sum())
        say("k2_ties", stride=stride, batch=n_ties,
            exact_ties=int(tied.sum()), decisive_ties=int(decisive.sum()),
            r_mismatches=mismatches, ltot_max_rel=f"{ltot_rel:.3e}",
            launches=launched)
        if launched != 1 or mismatches or int(decisive.sum()) < 100 \
                or not ltot_rel <= K2_LTOT_TOL \
                or not bool(torch.isfinite(ltot).all()):
            raise RuntimeError(f"K2 fails on tied shells (stride {stride}): "
                               f"{launched} launches, {mismatches} r_photo "
                               f"mismatches, {int(decisive.sum())} decisive "
                               f"ties, ltot {ltot_rel} off")

    # 7. the Me2017 main path: photometry file -> batched_logl at B=8192
    filters = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
               "2massj", "2massh", "2massks"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_me2017_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "me2017.prior")
        with open(prior_path, "w") as f:
            f.write(ME_PRIOR_TEXT)
        synthetic_photometry(np, torch, "Me2017", filters, data_path,
                             ME_INJECTION, sample_times=(0.01, 14.0, 150),
                             epochs=(0.5, 12.0))
        cfg = EMAnalysisConfig(
            model="Me2017", prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
            filters=filters, outdir=os.path.join(tmp, "outdir"),
            label="chip_smoke_me2017",
            sampler=NestedSamplerConfig(nlive=1024, n_delete=128,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        svd_kernel.LAUNCHES = k2.LAUNCHES = 0
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches = k2.LAUNCHES
        if logl_launches != 1 or svd_kernel.LAUNCHES != 0:
            raise RuntimeError(f"Me2017 batched_logl launched K2 "
                               f"{logl_launches} times and K1 "
                               f"{svd_kernel.LAUNCHES} times, not once and "
                               "never")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u))
        for b, ms in ((BATCH, logl_ms), (128, throughput(
                torch, lambda: analysis.batched_logl(u[:128]))[0])):
            busy, n_launch, top, _, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]))
            say("me2017_profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, top=top)

        # the same batch with the plain K2 on the card, off the live points
        # where the plain version sees a near-tie
        kernel_fn = k2.me2017_dynamics_from_operands
        k2.me2017_dynamics_from_operands = k2.me2017_dynamics_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            k2.me2017_dynamics_from_operands = kernel_fn
        p = analysis.priors.transform(u)
        gap = k2.me2017_dynamics_plain(*k2.me2017_operands(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], analysis.model.sample_times),
            with_ties=True)[2]
        keep = ~(gap < k2.NEAR_TIE).any(dim=1)
        if not torch.equal(usable[keep], (logl_plain > -1e29)[keep]):
            raise RuntimeError("sentinel positions differ from the plain K2")
        kept = usable & keep
        dlogl = (logl - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K2 by {float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, ME_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("me2017_logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k2_launches=logl_launches, k1_launches=svd_kernel.LAUNCHES,
            calls=logl_calls, wall_ms=f"{logl_ms:.4f}",
            evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
            tie_samples_dropped=int((~keep).sum()),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 8. the nested sampler on the Me2017 path
        t0 = time.time()
        svd_kernel.LAUNCHES = k2.LAUNCHES = 0
        result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = k2.LAUNCHES
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"Me2017 logZ not finite: {result.logz}")
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or launches <= 0 \
                or svd_kernel.LAUNCHES != 0:
            raise RuntimeError(f"the Me2017 sampler launched K2 {launches} "
                               f"times (expected {expected}) and K1 "
                               f"{svd_kernel.LAUNCHES} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("me2017_sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k2_launches=launches, k1_launches=svd_kernel.LAUNCHES)

    return {
        "name": "me2017_dynamics", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/me2017_dynamics.cu",
        "replaces": "nmma_tpu/ops/pallas_me2017.py:35",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_err, **worst,
        "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
        "ms_sampler_batch": k2_ms_small,
        "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
    }


def k3_queries_in_range(torch, ops, rows=256):
    """K3's (live point, ring, phi, t) queries whose log_q lies in
    [log_t[0], log_t[-1]], the ones that carry flux, counted on the card
    in chunks of `rows` live points."""
    from nmma_tpu_torch.constants import c_cgs
    from nmma_tpu_torch.ops.grb_kernel import one_minus_mu

    t_delay, tracks, r_grid, scal, log_q, cphi = ops[:6]
    count = 0
    for s in range(0, t_delay.shape[0], rows):
        sc = scal[s:s + rows, :, None, None, None]           # [b, 8, 1, 1, 1]
        th_r = torch.exp(tracks[s:s + rows, 4])[:, :, None, :]
        t_obs = (1.0 + sc[:, 0]) * (
            t_delay[s:s + rows, :, None, :]
            + one_minus_mu(sc[:, 4], sc[:, 2], th_r, cphi[:, None])
            * r_grid[s:s + rows, None, None, :] / c_cgs)     # [b, Th, Ph, R]
        log_t = torch.log(torch.clamp(t_obs, min=1e-10))
        lo = torch.clamp(log_t[..., :1], max=60.0)
        hi = torch.clamp(log_t.amax(-1, keepdim=True), max=60.0)
        count += int(((log_q >= lo) & (log_q <= hi)).sum())
    return count


def grb_path(np, torch, gen):
    """Phases 9-11: K3 against its plain version, then the TrPi2018 main
    path (BASELINE config 3) through EMAnalysis.batched_logl and the
    sampler. Returns K3's entry of the kernel line."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.models import grb
    from nmma_tpu_torch.ops import grb_kernel as k3
    from nmma_tpu_torch.ops import me2017_kernel, svd_kernel

    def reset():
        svd_kernel.LAUNCHES = me2017_kernel.LAUNCHES = k3.LAUNCHES = 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grb_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "trpi2018.prior")
        with open(prior_path, "w") as f:
            f.write(GRB_PRIOR_TEXT)
        synthetic_photometry(np, torch, "TrPi2018", GRB_FILTERS, data_path,
                             GRB_INJECTION, sample_times=(0.05, 40.0, 64),
                             epochs=(0.1, 30.0))
        cfg = EMAnalysisConfig(
            model="TrPi2018", prior_file=prior_path,
            light_curve_data=data_path, trigger_time=TRIGGER_MJD, tmin=0.05,
            tmax=40.0, n_tsteps=64, error_budget=0.5, filters=GRB_FILTERS,
            outdir=os.path.join(tmp, "outdir"), label="chip_smoke_grb",
            sampler=NestedSamplerConfig(nlive=512, n_delete=64, walks=16,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        t_grid = grb.trpi2018_time_grid(analysis.model.sample_times)

        def operands(b):
            """K3's operands for b config-3 prior draws at full width."""
            p = analysis.model.prepare_parameters(analysis.priors.transform(
                analysis.priors.sample_units(gen, b)))
            p.setdefault("d_L", 3.086e19)
            nu_obs = analysis.model.nu_0s[None].expand(b, -1)
            return grb.grb_stage1(t_grid, nu_obs, p)[0]

        # 9. K3 against its plain version at the main path's shapes
        max_rel = max_abs = 0.0
        for b in (1, 64, 257):
            ops = operands(b)
            got = k3.eats_flux(*ops)
            want = k3.eats_flux_plain(*ops)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            rel = relative_error(torch, got, want)
            if got.shape != want.shape or not math.isfinite(rel) \
                    or rel > K3_TOL or not torch.isfinite(got).all():
                raise RuntimeError(f"K3 disagrees at B={b}: max relative "
                                   f"error {rel} (tolerance {K3_TOL})")
            max_rel = max(max_rel, rel)
            max_abs = max(max_abs, float((got - want).abs().max()))
            say("k3", batch=b, shape="x".join(map(str, got.shape)),
                max_rel_err=f"{rel:.3e}", max_abs_err=f"{max_abs:.3e}",
                ref_max=f"{scale:.4e}")
        # a shape the kernel is not built for is refused before a launch
        launched = k3.LAUNCHES
        wide = [o.repeat_interleave(3, dim=-1).contiguous() if i < 3 else o
                for i, o in enumerate(ops)]
        refused = False
        try:
            k3.eats_flux(*wide)
        except ValueError:
            refused = True
        if not refused or k3.LAUNCHES != launched:
            raise RuntimeError(f"K3 took R={wide[0].shape[-1]}, beyond the "
                               "shapes it is built for")
        ops = operands(BATCH)
        k3_ms = time_ms(torch, lambda: k3.eats_flux(*ops), rounds=5,
                        launches=2, warmup=1)
        k3_plain_ms = time_ms(torch, lambda: k3.eats_flux_plain(*ops),
                              rounds=1, launches=1, warmup=1)
        # the same rows with every query above the cap of 60: each query
        # skips the search, the hat nodes and the epilogue, so this is the
        # time of the map, its cummax and the phi sum
        above = ops[:4] + (ops[4] + 100.0,) + ops[5:]
        k3_map_ms = time_ms(torch, lambda: k3.eats_flux(*above), rounds=5,
                            launches=2, warmup=1)
        del above
        n_b, n_th, n_r = ops[0].shape
        n_t, n_phi, n_f = ops[4].shape[0], ops[5].shape[0], ops[7].shape[1]
        queries = n_b * n_th * n_phi * n_t
        in_range = k3_queries_in_range(torch, ops)
        map_ops = n_b * n_th * n_phi * n_r * K3_OPS_MAP
        n_ops = (map_ops + queries * K3_OPS_RANGE
                 + in_range * (K3_OPS_SEARCH_STEP * math.ceil(math.log2(n_r))
                               + 2 * K3_OPS_NODE + K3_OPS_PAIR
                               + K3_OPS_PAIR_F * n_f))
        n_bytes = 4.0 * (sum(t.numel() for t in ops)
                         + n_b * n_th * n_f * n_t)
        k3_bound_ms = 1e3 * max(n_ops / PEAK_F32_FLOPS,
                                n_bytes / PEAK_BYTES)
        k3_bound_by = "operations" if n_ops / PEAK_F32_FLOPS >= \
            n_bytes / PEAK_BYTES else "bytes"
        say("k3", batch=BATCH, kernel_ms=f"{k3_ms:.4f}",
            no_query_in_range_ms=f"{k3_map_ms:.4f}",
            plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound_ms:.4f}",
            bound_by=k3_bound_by, gops=f"{n_ops / 1e9:.3f}",
            mbytes=f"{n_bytes / 1e6:.3f}",
            queries_in_range=f"{in_range}/{queries}",
            share_of_bound=f"{k3_bound_ms / k3_ms:.4f}",
            shape=f"B{n_b}xTh{n_th}xPh{n_phi}xT{n_t}xR{n_r}xF{n_f}")
        del ops

        # K3 on hand-made rows: cummax plateaus, a query on a node, on a
        # plateau value, at log_t[0] and log_t[-1], and outside the rows
        for n_r in (100, 128, 256):
            for n_phi in (5, 16):
                ops = k3.edge_operands(8, 8, n_r, 37, n_phi, len(GRB_FILTERS),
                                       seed=n_r + n_phi, device=DEVICE)
                launched = k3.LAUNCHES
                got = k3.eats_flux(*ops)
                want = k3.eats_flux_plain(*ops)
                torch.cuda.synchronize()
                rel = relative_error(torch, got, want)
                zeros = want == 0
                if k3.LAUNCHES != launched + 1 or not math.isfinite(rel) \
                        or rel > K3_TOL or not torch.isfinite(got).all() \
                        or not torch.equal(got == 0, zeros):
                    raise RuntimeError(
                        f"K3 disagrees on hand-made rows at R={n_r}, "
                        f"Ph={n_phi}: max relative error {rel} (tolerance "
                        f"{K3_TOL}), zeros {int((got == 0).sum())} against "
                        f"{int(zeros.sum())}, {k3.LAUNCHES - launched} "
                        "launches")
                say("k3_edges", R=n_r, Ph=n_phi, T=37,
                    shape="x".join(map(str, got.shape)),
                    max_rel_err=f"{rel:.3e}",
                    zeros=f"{int(zeros.sum())}/{zeros.numel()}")

        # 10. the TrPi2018 main path: photometry file -> batched_logl
        u = analysis.priors.sample_units(gen, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        reset()
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches = k3.LAUNCHES
        if logl_launches != 1 or svd_kernel.LAUNCHES != 0 \
                or me2017_kernel.LAUNCHES != 0:
            raise RuntimeError(
                f"TrPi2018 batched_logl launched K3 {logl_launches} times, "
                f"K1 {svd_kernel.LAUNCHES} and K2 {me2017_kernel.LAUNCHES} "
                "times, not once, never and never")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u), warmup=1)
        walk = cfg.sampler.n_delete
        for b, ms in ((BATCH, logl_ms), (walk, throughput(
                torch, lambda: analysis.batched_logl(u[:walk]))[0])):
            busy, n_launch, top, k3_dev, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]),
                kernel="grb_eats")
            say("grb_profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, k3_device_ms=f"{k3_dev:.4f}",
                top=top)

        # the same batch with the plain K3 on the card
        n_cmp = 1024
        kernel_fn = k3.eats_flux
        k3.eats_flux = k3.eats_flux_plain
        try:
            logl_plain = analysis.batched_logl(u[:n_cmp])
        finally:
            k3.eats_flux = kernel_fn
        if not torch.equal(usable[:n_cmp], logl_plain > -1e29):
            raise RuntimeError("sentinel positions differ from the plain K3")
        kept = usable[:n_cmp]
        dlogl = (logl[:n_cmp] - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K3 by {float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, GRB_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("grb_logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k3_launches=logl_launches, k1_launches=svd_kernel.LAUNCHES,
            k2_launches=me2017_kernel.LAUNCHES, calls=logl_calls,
            wall_ms=f"{logl_ms:.4f}",
            evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
            compared=n_cmp,
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 11. the nested sampler with config 3's settings
        t0 = time.time()
        reset()
        result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = k3.LAUNCHES
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"TrPi2018 logZ not finite: {result.logz}")
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or launches <= 0 \
                or svd_kernel.LAUNCHES != 0 or me2017_kernel.LAUNCHES != 0:
            raise RuntimeError(
                f"the TrPi2018 sampler launched K3 {launches} times "
                f"(expected {expected}), K1 {svd_kernel.LAUNCHES} and K2 "
                f"{me2017_kernel.LAUNCHES} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("grb_sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k3_launches=launches, k1_launches=svd_kernel.LAUNCHES,
            k2_launches=me2017_kernel.LAUNCHES)

    return {
        "name": "grb_eats_flux", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/grb_eats.cu",
        "replaces": "nmma_tpu/ops/pallas_grb.py:47",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": k3_ms, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms, "bound_by": k3_bound_by, "library_ms": None,
    }


def combined_logl(np, torch, gen):
    """Phase 12: Me2017 + TrPi2018 through make_combined_source_model, one
    batched_logl at B = 1024 through K2 and K3, against the plain K2 and K3
    off the live points where the plain K2 sees a near-tie."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import (get_source_model,
                                       make_combined_source_model)
    from nmma_tpu_torch.ops import grb_kernel as k3
    from nmma_tpu_torch.ops import me2017_kernel as k2
    from nmma_tpu_torch.ops import svd_kernel

    model = "Me2017_TrPi2018_smoke"
    make_combined_source_model(model, [get_source_model("Me2017"),
                                       get_source_model("TrPi2018")])
    filters = ["ztfg", "ztfr", "ztfi", "2massks", "X-ray-1keV",
               "radio-6GHz"]
    n_b = 1024
    with tempfile.TemporaryDirectory(prefix="chip_smoke_combined_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "combined.prior")
        with open(prior_path, "w") as f:
            f.write(COMBINED_PRIOR_TEXT)
        synthetic_photometry(np, torch, model, filters, data_path,
                             COMBINED_INJECTION,
                             sample_times=(0.02, 40.0, 100),
                             epochs=(0.5, 12.0))
        cfg = EMAnalysisConfig(
            model=model, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, tmin=0.02, tmax=40.0, n_tsteps=100,
            error_budget=1.0, filters=filters)
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, n_b)
        svd_kernel.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        launches = (svd_kernel.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES)
        if launches != (0, 1, 1):
            raise RuntimeError(f"the combined batched_logl launched (K1, K2, "
                               f"K3) {launches} times, not (0, 1, 1)")
        if logl.shape != (n_b,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")

        kernels = (k2.me2017_dynamics_from_operands, k3.eats_flux)
        k2.me2017_dynamics_from_operands = k2.me2017_dynamics_plain
        k3.eats_flux = k3.eats_flux_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            k2.me2017_dynamics_from_operands, k3.eats_flux = kernels
        p = analysis.priors.transform(u)
        gap = k2.me2017_dynamics_plain(*k2.me2017_operands(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], analysis.model.sample_times),
            with_ties=True)[2]
        keep = ~(gap < k2.NEAR_TIE).any(dim=1)
        if not torch.equal(usable[keep], (logl_plain > -1e29)[keep]):
            raise RuntimeError("sentinel positions differ from the plain "
                               "K2 and K3")
        kept = usable & keep
        dlogl = (logl - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"combined logL off the plain kernels by "
                               f"{float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, COMBINED_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("combined_logl", batch=n_b, finite_share=f"{finite_share:.4f}",
            k1_launches=launches[0], k2_launches=launches[1],
            k3_launches=launches[2],
            tie_samples_dropped=int((~keep).sum()),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            max_rel_dlogl_vs_plain=f"{float((dlogl / logl_plain[kept].abs().clamp(min=1.0)).max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, HERE)
    import nmma_tpu_torch
    if not os.path.abspath(nmma_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError("nmma_tpu_torch must come from this checkout, not "
                           f"{nmma_tpu_torch.__file__}")
    from nmma_tpu_torch import _kernels
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.ops import me2017_kernel, svd_kernel

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.time()
    libs = _kernels.build()
    say("build", seconds=f"{time.time() - t0:.3f}",
        libraries=",".join(os.path.basename(p) for p in libs.values()))
    for lib in libs:
        say("ptxas", library=lib, **(ptxas_summary(_kernels.REPORTS[lib])
                                     if lib in _kernels.REPORTS
                                     else {"report": "not built in this run"}))

    # 3. K1 against its plain version at the main path's shapes
    svd = SVDModelData.load(ARTIFACT, device=DEVICE)
    sample_times = torch.tensor(np.geomspace(0.01, 14.0, 150),
                                dtype=torch.float32, device=DEVICE)
    va_q, off_q, _ = svd.operator_rankc(sample_times)
    weights = (svd.w1, svd.b1, svd.w2, svd.b2, va_q, off_q)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    max_err = 0.0
    for b in (1, 128, BATCH + 7):
        x = torch.rand((b, svd.w1.shape[1]), generator=gen, device=DEVICE)
        got = svd_kernel.svd_surrogate_mags(x, *weights)
        want = svd_kernel.svd_surrogate_mags_plain(x, *weights)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != want.shape or not math.isfinite(err) \
                or err > K1_TOL:
            raise RuntimeError(f"K1 disagrees at B={b}: max abs err {err} "
                               f"(tolerance {K1_TOL} mag)")
        max_err = max(max_err, err)
        say("k1", batch=b, max_abs_err=f"{err:.3e}")
    n_f, p, h = svd.w1.shape
    c, q = svd.w2.shape[2], va_q.shape[2]

    def k1_bound(n_b):
        flops = 2.0 * n_b * n_f * (p * h + h * c + c * q)
        n_bytes = 4.0 * (n_b * p + n_f * (p * h + h + h * c + c + c * q + q)
                         + n_b * n_f * q)
        return flops, n_bytes, 1e3 * max(flops / PEAK_F32_FLOPS,
                                         n_bytes / PEAK_BYTES), \
            "operations" if flops / PEAK_F32_FLOPS >= n_bytes / PEAK_BYTES \
            else "bytes"

    x = torch.rand((SAMPLER_BATCH, p), generator=gen, device=DEVICE)
    k1_ms_small = kernel_device_ms(
        torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights),
        "svd_mlp_mags_kernel")
    say("k1", batch=SAMPLER_BATCH, kernel_ms=f"{k1_ms_small:.4f}",
        timed_by="profiler", bound_ms=f"{k1_bound(SAMPLER_BATCH)[2]:.4f}")
    x = torch.rand((BATCH, p), generator=gen, device=DEVICE)
    k1_ms = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights))
    plain_ms = time_ms(
        torch, lambda: svd_kernel.svd_surrogate_mags_plain(x, *weights))
    flops, n_bytes, bound_ms, bound_by = k1_bound(BATCH)
    say("k1", batch=BATCH, kernel_ms=f"{k1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bound_share=f"{bound_ms / k1_ms:.4f}",
        gflop=f"{flops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}")

    # 4. main path: photometry file -> EMAnalysis.batched_logl at B=8192
    make_svd_source_model(MODEL, svd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "bu2019lm.prior")
        with open(prior_path, "w") as f:
            f.write(PRIOR_TEXT)
        synthetic_photometry(np, torch, MODEL, list(svd.filters), data_path,
                             INJECTION, sample_times=(0.01, 14.0, 150),
                             epochs=(0.5, 12.0))

        cfg = EMAnalysisConfig(
            model=MODEL, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
            filters=list(svd.filters), outdir=os.path.join(tmp, "outdir"),
            label="chip_smoke",
            sampler=NestedSamplerConfig(nlive=1024, n_delete=128,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, BATCH)
        svd_kernel.LAUNCHES = me2017_kernel.LAUNCHES = 0
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches = svd_kernel.LAUNCHES
        if logl_launches != 1 or me2017_kernel.LAUNCHES != 0:
            raise RuntimeError(f"batched_logl launched K1 {logl_launches} "
                               f"times and K2 {me2017_kernel.LAUNCHES} times, "
                               "not once and never")
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u))
        evals_per_s = BATCH / (logl_ms / 1e3)
        # where the time goes: device-busy share of the unprofiled wall
        # time, at this batch and at the sampler's walk batch
        for b, ms in ((BATCH, logl_ms), (128, throughput(
                torch, lambda: analysis.batched_logl(u[:128]))[0])):
            busy, n_launch, top, _, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]))
            say("profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, top=top)

        # the same batch with the plain K1 on the card
        kernel_fn = svd_kernel.svd_surrogate_mags
        svd_kernel.svd_surrogate_mags = svd_kernel.svd_surrogate_mags_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            svd_kernel.svd_surrogate_mags = kernel_fn
        if not torch.equal(usable, logl_plain > -1e29):
            raise RuntimeError("sentinel positions differ from the plain K1")
        dlogl = (logl - logl_plain)[usable].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[usable].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K1 by {float(dlogl.max())}")
        # the injection must fit better than a typical prior draw
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k1_launches=logl_launches, calls=logl_calls,
            wall_ms=f"{logl_ms:.4f}", evals_per_s=f"{evals_per_s:.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 5. nested sampler through EMAnalysis.run
        t0 = time.time()
        svd_kernel.LAUNCHES = me2017_kernel.LAUNCHES = 0
        result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = svd_kernel.LAUNCHES
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"logZ not finite: {result.logz}")
        # one batch for the initial live set, one per walk step
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or launches <= 0:
            raise RuntimeError(f"the sampler launched K1 {launches} times, "
                               f"expected {expected}")
        if me2017_kernel.LAUNCHES != 0:
            raise RuntimeError(f"the Bu2019lm sampler launched K2 "
                               f"{me2017_kernel.LAUNCHES} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k1_launches=launches)

    k2_entry = me2017_path(np, torch, gen, sample_times)
    k3_entry = grb_path(np, torch, gen)
    combined_logl(np, torch, gen)
    kernels = [{
        "name": "svd_mlp_mags", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/svd_mlp.cu",
        "replaces": "nmma_tpu/ops/pallas_svd.py:37",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_err,
        "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": plain_ms,
        "ms_sampler_batch": k1_ms_small, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, k2_entry, k3_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
