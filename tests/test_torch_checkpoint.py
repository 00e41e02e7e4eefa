"""Checkpoint and resume of the port's nested sampler on the CPU.

A run that sends itself SIGUSR1 during its first chunk writes a checkpoint
after that chunk and stops; a second sampler resumes from the checkpoint
and runs to convergence. The resumed run must equal a run that was never
interrupted bit for bit: logZ, every dead point (unit-cube position, logL,
weight, volume), the call and iteration counts and the posterior draws. The
checkpoint carries the torch.Generator's state beside the sampler's, which
is what makes the resumed draws those of the uninterrupted run.
"""

import os
import signal
import threading

import numpy as np
import torch

from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
from nmma_tpu_torch.inference import NestedSampler, NestedSamplerConfig
from nmma_tpu_torch.priors import parse_prior_dict

torch.set_num_threads(1)

NDIM = 3
CONFIG = NestedSamplerConfig(nlive=128, n_delete=16, walks=6, dlogz=0.1,
                             chunk_size=4, seed=11)


def gauss_logl(u, sigma=0.05):
    x = (u - 0.4) / sigma
    return -0.5 * (x * x).sum(dim=1)


def interrupting_logl(after_calls):
    """gauss_logl that sends SIGUSR1 to this process on call
    ``after_calls``."""
    calls = {"n": 0}

    def logl(u):
        calls["n"] += 1
        if calls["n"] == after_calls:
            os.kill(os.getpid(), signal.SIGUSR1)
        return gauss_logl(u)
    return logl


def assert_same_result(got, want):
    assert got.logz == want.logz
    assert got.logz_err == want.logz_err
    assert (got.ncall, got.niter) == (want.ncall, want.niter)
    for name in ("samples_u", "logl", "logw", "log_x"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(got.posterior_indices(),
                                  want.posterior_indices())


def test_interrupted_run_resumes_bit_for_bit(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    ckpt = str(tmp_path / "run_checkpoint_resume.npz")
    before = signal.getsignal(signal.SIGUSR1)

    # SIGUSR1 in the first chunk: the run stops after it, checkpointed
    partial = NestedSampler(interrupting_logl(3), NDIM, CONFIG,
                            device="cpu").run(
        verbose=False, checkpoint_path=ckpt, resume=False)
    assert signal.getsignal(signal.SIGUSR1) is before
    assert os.path.exists(ckpt)
    assert partial.niter == CONFIG.chunk_size

    resumed = NestedSampler(gauss_logl, NDIM, CONFIG, device="cpu").run(
        verbose=False, checkpoint_path=ckpt, resume=True)
    whole = NestedSampler(gauss_logl, NDIM, CONFIG, device="cpu").run(
        verbose=False)
    assert whole.niter > 5 * CONFIG.chunk_size
    assert_same_result(resumed, whole)
    # the analytic evidence of the Gaussian: ln((2 pi sigma^2)^(3/2))
    assert abs(whole.logz - 1.5 * np.log(2 * np.pi * 0.05**2)) \
        < 5 * whole.logz_err + 0.1


def test_checkpoint_roundtrip_and_finalise(tmp_path):
    """save_checkpoint/load_checkpoint keep every field of the state and
    the dead points exactly, and _finalise of the loaded checkpoint gives
    the result of the run that wrote it (what --skip-sampling reads)."""
    ckpt = str(tmp_path / "ck.npz")
    cfg = NestedSamplerConfig(**{**CONFIG.__dict__, "max_iter": 12,
                                 "check_point_delta_t": 0.0})
    sampler = NestedSampler(gauss_logl, NDIM, cfg, device="cpu")
    result = sampler.run(verbose=False, checkpoint_path=ckpt)
    state, dead = sampler.load_checkpoint(ckpt)
    assert state.it == 12 and state.n_call == result.ncall
    assert state.rng_state.dtype == torch.uint8
    again = sampler._finalise(state, *dead)
    assert_same_result(again, result)
    assert sampler.load_checkpoint(str(tmp_path / "absent.npz")) is None


def test_analysis_run_writes_and_resumes_its_checkpoint(tmp_path):
    """EMAnalysis.run writes {label}_checkpoint_resume.npz, and a second
    run resumes from it: with max_iter reached it samples no further and
    its result equals the first run's."""
    t = np.linspace(0.5, 8.0, 6)
    data = {"ztfg": {"time": t, "mag": 19.0 + 0.1 * t,
                     "mag_error": np.full(6, 0.1)}}
    priors = parse_prior_dict(
        "log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
        "log10_vej = -1.0\nbeta = 3.0\nlog10_kappa_r = 0.5\n"
        "luminosity_distance = 40.0\ntimeshift = 0.0\n"
        "em_syserr = Uniform(minimum=0.0, maximum=1.0)\n")
    cfg = EMAnalysisConfig(
        model="Me2017", outdir=str(tmp_path), label="ck",
        tmin=0.05, tmax=10.0, n_tsteps=40,
        sampler=NestedSamplerConfig(nlive=32, n_delete=8, walks=2,
                                    max_iter=6, chunk_size=3, seed=5,
                                    check_point_delta_t=0.0))
    first = EMAnalysis(cfg, data=data, priors=priors, device="cpu").run(
        verbose=False)
    assert (tmp_path / "ck_checkpoint_resume.npz").exists()
    second = EMAnalysis(cfg, data=data, priors=priors, device="cpu").run(
        verbose=False)
    assert_same_result(second, first)
