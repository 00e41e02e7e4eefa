"""Nested sampler of the PyTorch port against the JAX package.

The two packages draw different random numbers, so a run cannot match bit
for bit. The deterministic parts are held exactly on the same inputs: the
volume decrements, and ``_finalise``'s weights, volumes and evidence from
the same dead points and final live set. The rest is held statistically:
on the analytic Gaussian of tests/test_evidence_calibration.py:36 the
port's logZ lies within 3 sigma (its own reported error) of the truth.
"""

import math

import numpy as np
import pytest
import torch

import nmma_tpu.inference.nested as j_nested
import nmma_tpu_torch.inference.nested as t_nested

torch.set_num_threads(1)


@pytest.mark.parametrize("nlive,n_delete", [(1024, 128), (128, 16), (50, 7)])
def test_volume_decrements_exact(nlive, n_delete):
    np.testing.assert_array_equal(
        t_nested._volume_decrements(nlive, n_delete),
        j_nested._volume_decrements(nlive, n_delete))


@pytest.mark.parametrize("logzvar", [0.04, 0.0])
def test_finalise_exact(logzvar):
    """Same dead chunks and final state (f32, as both samplers keep it):
    identical samples, logL, weights, volumes, evidence and error, the
    latter on both branches (accumulated variance, sqrt(H/nlive))."""
    nlive, ndim, k, chunks = 64, 3, 8, 5
    rng = np.random.default_rng(11)
    dead_u = [rng.uniform(size=(k, ndim)).astype(np.float32)
              for _ in range(chunks)]
    dead_logl = [np.sort(rng.normal(-50.0, 5.0, k)).astype(np.float32)
                 for _ in range(chunks)]
    dead_logw = [(l - 3.0).astype(np.float32) for l in dead_logl]
    dead_logx = [-np.cumsum(np.full(k, 1.0 / nlive)).astype(np.float32)
                 for _ in range(chunks)]
    u_live = rng.uniform(size=(nlive, ndim)).astype(np.float32)
    logl_live = rng.normal(-40.0, 3.0, nlive).astype(np.float32)
    scalars = dict(log_x=-0.7, logz=-43.2, logzvar=logzvar, h_info=2.5)

    j_cfg = j_nested.NestedSamplerConfig(nlive=nlive, n_delete=k)
    j_state = j_nested.NSState(
        u_live=u_live, logl_live=logl_live,
        **{n: np.float32(v) for n, v in scalars.items()},
        scale=np.float32(1.0), n_accept=np.float32(0.0),
        n_propose=np.float32(0.0), n_call=np.int32(999),
        it=np.int32(chunks), key=None)
    want = j_nested.NestedSampler(lambda u: u[:, 0], ndim, j_cfg)._finalise(
        j_state, list(dead_u), list(dead_logl), list(dead_logw),
        list(dead_logx))

    t_cfg = t_nested.NestedSamplerConfig(nlive=nlive, n_delete=k)
    t_state = t_nested.NSState(
        u_live=torch.from_numpy(u_live), logl_live=torch.from_numpy(logl_live),
        **{n: torch.tensor(v, dtype=torch.float32)
           for n, v in scalars.items()},
        scale=torch.tensor(1.0), n_accept=torch.tensor(0.0), n_propose=0,
        n_call=999, it=chunks)
    got = t_nested.NestedSampler(lambda u: u[:, 0], ndim, t_cfg,
                                 device="cpu")._finalise(
        t_state, dead_u, dead_logl, dead_logw, dead_logx)

    for field in ("samples_u", "logl", "logw", "log_x"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for field in ("logz", "logz_err", "h_info", "ncall", "niter"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.posterior_indices(),
                                  want.posterior_indices())


def test_gaussian_evidence_within_3_sigma():
    """logZ of a 3-d Gaussian of width 0.1 on [-10, 10]^3 (analytic
    -3 ln 20), at the calibration test's small nlive."""
    ndim, sigma = 3, 0.1

    def logl_fn(u):
        x = 20.0 * u - 10.0
        return (-0.5 * torch.sum((x / sigma) ** 2, dim=-1)
                - 0.5 * ndim * math.log(2 * math.pi * sigma ** 2))

    cfg = t_nested.NestedSamplerConfig(nlive=128, n_delete=16, walks=16,
                                       dlogz=0.1, chunk_size=10, seed=0)
    res = t_nested.NestedSampler(logl_fn, ndim, cfg,
                                 device="cpu").run(verbose=False)
    analytic = -ndim * math.log(20.0)
    assert res.logz_err > 0.0
    assert abs(res.logz - analytic) < 3.0 * res.logz_err, \
        (res.logz, res.logz_err, analytic)
    assert res.niter < cfg.max_iter     # stopped on dlogz, not the cap
    # posterior mean near the mode at u = 0.5
    idx = res.posterior_indices()
    np.testing.assert_allclose(res.samples_u[idx].mean(axis=0), 0.5,
                               atol=0.01)
