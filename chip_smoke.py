#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``nmma_tpu_torch/csrc`` and drives the
EM parameter-estimation main path of ``nmma_tpu_torch`` with its two source
models: the Bu2019lm SVD surrogate at production width (P=4, H=2048, C=10,
F=9, Q=150) through K1, and the analytic Me2017 kilonova (299 shells, T=150,
9 filters x 9 bandpass nodes) through K2:

  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    nvcc build of every kernel, all started together, in seconds;
  3. k1       K1 against its plain PyTorch version on the card at the main
              path's shapes (B = 1, 128, 8199; max abs error <= 1e-4 mag),
              then kernel and plain timings at B = 8192 (CUDA events, median
              of 25 rounds of 10 launches);
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
              then kernel and plain timings at B = 8192 as for K1;
  7. me2017_logl
              the same as phase 4 with the Me2017 model (one K2 launch, no
              K1 launch), its peak device memory, and |dlogL| against the
              plain K2 off the live points where the plain version sees a
              near-tie;
  8. me2017_sampler
              the same as phase 5 with the Me2017 model: K2 launches
              1 + iterations x walks, no K1 launch.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
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
# peaks of one H100 SXM at 700 W (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def device_profile(torch, fn):
    """(device-busy ms, kernel launches, top kernels) of one ``fn()`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    return busy_ms, sum(e.count for e in dev), ";".join(
        f"{e.key[:40]}:{e.self_device_time_total / 1e3:.4f}" for e in top)


def synthetic_photometry(np, torch, model, filters, path, injection):
    """Injection light curve of one of the port's models, ~10 epochs per
    filter in 0.5-12 d with seeded noise and a few upper limits, written as
    a .dat file in MJD."""
    from nmma_tpu_torch.io import write_em_observations
    from nmma_tpu_torch.models import DetectorLightCurveModel

    detector = DetectorLightCurveModel(
        model, filters, sample_times=np.geomspace(0.01, 14.0, 150),
        device=DEVICE)
    params = {k: torch.tensor([v], device=DEVICE)
              for k, v in injection.items()}
    t_obs, mags = detector(params)
    t_obs = t_obs[0].cpu().numpy().astype(np.float64)
    mags = mags[0].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(2017)
    data = {}
    for i, f in enumerate(filters):
        t = np.sort(rng.uniform(0.5, 12.0, 10))
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
        for key in worst:
            worst[key] = max(worst[key], stats[key])
        max_err = max(max_err, float((ltot - want[0]).abs().max()))
        say("k2", batch=b, **{k: v for k, v in stats.items() if k != "ok"},
            r_exact_share=f"{float((r_photo == want[1]).float().mean()):.6f}")
    n_t = sample_times.shape[0]
    ops = k2.me2017_operands(*draw(BATCH), sample_times)
    k2_ms = time_ms(torch, lambda: k2.me2017_dynamics_from_operands(*ops))
    k2_plain_ms = time_ms(torch, lambda: k2.me2017_dynamics_plain(*ops))
    n_ops = (n_t - 1) * BATCH * (K2_OPS_SHELL_STEP * k2.N_SHELLS
                                 + K2_OPS_STEP)
    n_bytes = 4.0 * sum(t.numel() for t in ops) + 4.0 * 2 * BATCH * n_t
    k2_bound_ms = 1e3 * max(n_ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
    k2_bound_by = "operations" if n_ops / PEAK_F32_FLOPS >= \
        n_bytes / PEAK_BYTES else "bytes"
    say("k2", batch=BATCH, kernel_ms=f"{k2_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", bound_ms=f"{k2_bound_ms:.4f}",
        bound_by=k2_bound_by, gops=f"{n_ops / 1e9:.3f}",
        mbytes=f"{n_bytes / 1e6:.3f}")

    # 7. the Me2017 main path: photometry file -> batched_logl at B=8192
    filters = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
               "2massj", "2massh", "2massks"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_me2017_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "me2017.prior")
        with open(prior_path, "w") as f:
            f.write(ME_PRIOR_TEXT)
        synthetic_photometry(np, torch, "Me2017", filters, data_path,
                             ME_INJECTION)
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
            busy, n_launch, top = device_profile(
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
        priors = analysis.priors
        inj_u = torch.tensor([[
            (ME_INJECTION[n] - priors[n].minimum)
            / (priors[n].maximum - priors[n].minimum)
            for n in priors.sampled_names]], device=DEVICE)
        logl_inj = float(analysis.batched_logl(inj_u)[0])
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
        "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
    }


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
    x = torch.rand((BATCH, svd.w1.shape[1]), generator=gen, device=DEVICE)
    k1_ms = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights))
    plain_ms = time_ms(
        torch, lambda: svd_kernel.svd_surrogate_mags_plain(x, *weights))
    n_f, p, h = svd.w1.shape
    c, q = svd.w2.shape[2], va_q.shape[2]
    flops = 2.0 * BATCH * n_f * (p * h + h * c + c * q)
    n_bytes = 4.0 * (BATCH * p + n_f * (p * h + h + h * c + c + c * q + q)
                     + BATCH * n_f * q)
    bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= \
        n_bytes / PEAK_BYTES else "bytes"
    say("k1", batch=BATCH, kernel_ms=f"{k1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, gflop=f"{flops / 1e9:.3f}",
        mbytes=f"{n_bytes / 1e6:.3f}")

    # 4. main path: photometry file -> EMAnalysis.batched_logl at B=8192
    make_svd_source_model(MODEL, svd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "bu2019lm.prior")
        with open(prior_path, "w") as f:
            f.write(PRIOR_TEXT)
        synthetic_photometry(np, torch, MODEL, list(svd.filters), data_path,
                             INJECTION)

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
            busy, n_launch, top = device_profile(
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
        priors = analysis.priors
        inj_u = torch.tensor([[
            (INJECTION[n] - priors[n].minimum)
            / (priors[n].maximum - priors[n].minimum)
            for n in priors.sampled_names]], device=DEVICE)
        logl_inj = float(analysis.batched_logl(inj_u)[0])
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
    kernels = [{
        "name": "svd_mlp_mags", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/svd_mlp.cu",
        "replaces": "nmma_tpu/ops/pallas_svd.py:37",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_err,
        "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, k2_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
