"""The posterior check of BASELINE config 3 (TrPi2018 on an injection) for
the PyTorch port: run the port's nested sampler to convergence at the JAX
package's production settings and hold its posterior against the JAX
package's, JS < 0.01 per parameter (BASELINE.md:33).

The configuration is that of scripts/parity_cross_sampler.py:82-126 (the
truth, five filters, an injection at seed 10 with a 0.2 mag error budget,
the prior text, a 0.05-40 d model grid of 64 steps, error budget 0.5,
nlive=2048, n_delete=256, walks=32, dlogz=0.3, chunk_size=5), built with
the port's modules only. The references are the JAX package's posteriors
in artifacts/: diag_config3_ns2048.npz (the nested sampler at the same
settings; logZ -59.4958 +- 0.0843, outdir_grb/diag_ns2048_result_meta.json)
and diag_config3_mcmc_long.npz (a converged tempered MCMC). Those runs
used the JAX default's bf16 hat, ~0.003 mag from the f32 hat that K3
computes; against the 0.5 mag error budget that moves no marginal.

Run it on the CUDA card from the repository root:

    python scripts/torch_parity_config3.py [--out PATH]

It prints one JSON line and writes the port's equal-weight posterior
(float32, compressed) to PATH, by default
tests/data/config3_port_posterior.npz, which
tests/test_torch_parity_config3.py holds against both reference files on
the CPU. chip_smoke.py's [posterior_config3] phase runs the same
functions.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSTERIOR_FILE = os.path.join(REPO, "tests", "data",
                              "config3_port_posterior.npz")
REFERENCES = {
    "ns2048": os.path.join(REPO, "artifacts", "diag_config3_ns2048.npz"),
    "mcmc_long": os.path.join(REPO, "artifacts",
                              "diag_config3_mcmc_long.npz"),
}
# the JAX package's ns2048 run (outdir_grb/diag_ns2048_result_meta.json)
REFERENCE_LOGZ = (-59.49583296903499, 0.08425893925181797)
JS_GATE = 0.01
LOGZ_SIGMAS = 5.0

TRUTH = dict(log10_E0=51.5, thetaCore=0.1, thetaWing=0.4,
             inclination_EM=0.05, log10_n0=-1.5, p=2.4,
             log10_epsilon_e=-1.2, log10_epsilon_B=-3.0, xi_N=1.0,
             luminosity_distance=350.0, timeshift=0.0)
FILTERS = ["ztfg", "ztfr", "ztfi", "X-ray-1keV", "radio-6GHz"]
PRIOR_TEXT = (
    "log10_E0 = Uniform(minimum=49., maximum=54.)\n"
    "thetaCore = Uniform(minimum=0.01, maximum=0.3)\n"
    "thetaWing = 0.4\n"
    "inclination_EM = Uniform(minimum=0., maximum=0.5)\n"
    "log10_n0 = Uniform(minimum=-4., maximum=1.)\n"
    "p = Uniform(minimum=2.01, maximum=2.9)\n"
    "log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)\n"
    "log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)\n"
    "xi_N = 1.0\n"
    "luminosity_distance = 350.0\n"
    "timeshift = Uniform(minimum=-0.1, maximum=0.1)\n")


def config3_data(device=None):
    """Config 3's injection photometry (parity_cross_sampler.py:94-96)."""
    from nmma_tpu_torch.injections import create_light_curve_data
    return create_light_curve_data(
        TRUTH, "TrPi2018", FILTERS, tmin=0.1, tmax=30.0, n_tsteps=24,
        seed=10, injection_error_budget=0.2, device=device)


def config3_analysis(outdir, device=None):
    """The config-3 EMAnalysis at the production sampler settings."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.priors import parse_prior_dict
    cfg = EMAnalysisConfig(
        model="TrPi2018", trigger_time=0.0, tmin=0.05, tmax=40.0,
        n_tsteps=64, error_budget=0.5, outdir=outdir,
        label="parity_trpi2018",
        sampler=NestedSamplerConfig(nlive=2048, n_delete=256, walks=32,
                                    dlogz=0.3, chunk_size=5))
    return EMAnalysis(cfg, data=config3_data(device),
                      priors=parse_prior_dict(PRIOR_TEXT), device=device)


def reference_posteriors():
    return {name: dict(np.load(path)) for name, path in REFERENCES.items()}


def compare(posterior, logz=None, logz_err=None):
    """JS per sampled parameter of ``posterior`` against both reference
    posteriors, and logZ against the ns2048 run's. Returns a dict with the
    per-reference JS, their maximum, and ``ok`` (every JS below 0.01 and
    |dlogZ| within 5 combined standard errors, when logZ is given)."""
    from nmma_tpu_torch.post_processing import posterior_js_divergences
    names = [k for k in posterior if k != "log_likelihood"
             and np.std(posterior[k]) > 0]
    out = {"parameters": names, "n_samples": int(len(posterior[names[0]]))}
    worst = 0.0
    for ref_name, ref in reference_posteriors().items():
        js = posterior_js_divergences(posterior, ref, names)
        out[f"js_{ref_name}"] = {k: float(v) for k, v in js.items()}
        worst = max(worst, max(js.values()))
    out["js_max"] = worst
    ok = worst < JS_GATE
    if logz is not None:
        ref_logz, ref_err = REFERENCE_LOGZ
        out["dlogz"] = float(logz - ref_logz)
        out["dlogz_limit"] = float(LOGZ_SIGMAS * np.hypot(logz_err, ref_err))
        ok = ok and abs(out["dlogz"]) <= out["dlogz_limit"]
    out["ok"] = bool(ok)
    return out


def run(analysis, verbose=False):
    """Nested sampling to convergence; returns (result, posterior of the
    sampled parameters as float32, seconds)."""
    import torch
    t0 = time.time()
    result = analysis.run(verbose=verbose, checkpoint=False)
    if analysis.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    post = analysis.posterior_samples(result)
    names = analysis.priors.sampled_names
    return result, {k: np.asarray(post[k], np.float32) for k in names}, \
        seconds


def save_posterior(path, posterior, result, seconds, device_name):
    np.savez_compressed(
        path, logz=result.logz, logz_err=result.logz_err,
        ncall=result.ncall, niter=result.niter, seconds=seconds,
        device=device_name, **posterior)


def main(argv=None):
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=POSTERIOR_FILE,
                        help="where to write the posterior (.npz)")
    out = parser.parse_args(argv).out
    if not torch.cuda.is_available():
        print("torch_parity_config3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from nmma_tpu_torch import tracing
    with tempfile.TemporaryDirectory(prefix="parity_config3_") as tmp:
        analysis = config3_analysis(tmp)
        tracing.reset(tracing.K3_LAUNCHES)
        result, post, seconds = run(analysis, verbose=True)
        launches = tracing.counter(tracing.K3_LAUNCHES)
    name = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_posterior(out, post, result, seconds, name)
    summary = compare(post, result.logz, result.logz_err)
    summary.update(device=name, logz=result.logz, logz_err=result.logz_err,
                   iterations=result.niter, calls=result.ncall,
                   k3_launches=launches, seconds=seconds,
                   written=out)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
