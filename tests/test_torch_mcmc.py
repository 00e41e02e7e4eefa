"""The port's ensemble MCMC (``nmma_tpu_torch/inference/mcmc.py``) against
the JAX package's.

The cases of tests/test_mcmc.py run on the port's sampler with the same
targets, settings and bounds: Gaussian moments and R-hat, the tempering
ladder on a bimodal target, stepping-stone ln Z against the analytic value
and against the port's nested sampler, the validation errors (with the JAX
package's messages). The two packages draw different random numbers, so
their chains are compared by these statistics, not step by step.

The deterministic pieces get the same numpy inputs in both packages and
agree within 1e-12: ``_rhat`` on a chain, ``_betas`` (the f32 ladder) and
``_stepping_stone`` on tempered logL chains. Port only: the chain is equal
bit for bit whatever ``chunk_sweeps`` is (one generator drawn in a fixed
order per sweep). ``EMAnalysis.run_mcmc`` and the CLI's ``--sampler mcmc``
are in tests/test_torch_cli.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmma_tpu.inference import mcmc as j_mcmc
from nmma_tpu_torch.inference import (EnsembleMCMC, EnsembleMCMCConfig,
                                      NestedSampler, NestedSamplerConfig)
from nmma_tpu_torch.inference import mcmc as t_mcmc

torch.set_num_threads(1)

# correlated 2-D Gaussian inside the unit cube (tests/test_mcmc.py:17-19)
_MU = np.array([0.58, 0.44])
_COV = np.array([[0.004, 0.0025], [0.0025, 0.0036]])
_PREC = torch.tensor(np.linalg.inv(_COV), dtype=torch.float32)


def _logl(u):
    d = u - torch.tensor(_MU, dtype=torch.float32)
    return -0.5 * torch.einsum("...i,ij,...j->...", d, _PREC, d)


def _mcmc(logl, ndim, **cfg):
    return EnsembleMCMC(logl, ndim, EnsembleMCMCConfig(**cfg), device="cpu")


def _ns(seed):
    return NestedSampler(_logl, 2, NestedSamplerConfig(
        nlive=256, n_delete=32, walks=12, dlogz=0.1, chunk_size=10,
        seed=seed), device="cpu").run(verbose=False)


def test_gaussian_moments_and_rhat():
    res = _mcmc(_logl, 2, walkers=128, sweeps=1200, burn_frac=0.4, thin=2,
                seed=0).run()
    assert 0.1 < res.acceptance < 0.9, res.acceptance
    assert np.nanmax(res.rhat) < 1.05, res.rhat
    np.testing.assert_allclose(res.samples_u.mean(axis=0), _MU, atol=0.01)
    np.testing.assert_allclose(np.cov(res.samples_u.T), _COV, rtol=0.25,
                               atol=4e-4)
    assert res.n_call == (1200 * 128 + 128)
    assert res.samples_u.dtype == np.float32


def test_cross_sampler_agreement():
    """The port's nested sampler and MCMC agree in mean and std."""
    m = _mcmc(_logl, 2, walkers=128, sweeps=1000, burn_frac=0.4,
              seed=1).run()
    r = _ns(1)
    ns_samp = r.samples_u[r.posterior_indices()]
    for k in range(2):
        assert abs(ns_samp[:, k].mean() - m.samples_u[:, k].mean()) < 0.012
        assert abs(ns_samp[:, k].std() - m.samples_u[:, k].std()) < 0.012


@pytest.mark.parametrize("ndim,cfg", [
    (2, dict(walkers=31)), (20, dict(walkers=32)),
    (2, dict(evidence=True, temps=1))])
def test_validation_errors_as_jax(ndim, cfg):
    """The same configurations are refused with the JAX package's
    messages."""
    with pytest.raises(ValueError) as j_err:
        j_mcmc.EnsembleMCMC(lambda u: u[..., 0], ndim,
                            j_mcmc.EnsembleMCMCConfig(**cfg))
    with pytest.raises(ValueError) as t_err:
        _mcmc(_logl, ndim, **cfg)
    assert str(t_err.value) == str(j_err.value)


def test_parallel_tempering_multimodal():
    """The tempering ladder recovers both modes of a bimodal target with
    the right weights."""
    mu1, mu2, s = 0.25, 0.75, 0.02

    def logl(u):
        d1 = -0.5 * ((u - mu1) ** 2).sum(-1) / s**2
        d2 = -0.5 * ((u - mu2) ** 2).sum(-1) / s**2
        return torch.logaddexp(d1, d2)

    res = _mcmc(logl, 2, walkers=128, sweeps=1500, burn_frac=0.4, temps=4,
                t_max=32.0, seed=3).run()
    frac_hi = (res.samples_u[:, 0] > 0.5).mean()
    assert 0.35 < frac_hi < 0.65, frac_hi
    assert np.nanmax(res.rhat) < 1.2, res.rhat
    assert res.n_call == (1500 * 128 + 128) * 4


def test_stepping_stone_evidence():
    """Stepping-stone ln Z matches the analytic value and the nested
    sampler's."""
    lnz_true = np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(_COV))
    res = _mcmc(_logl, 2, walkers=128, sweeps=1500, burn_frac=0.4, temps=8,
                t_max=512.0, evidence=True, seed=5).run()
    assert np.isfinite(res.logz) and np.isfinite(res.logz_err)
    assert abs(res.logz - lnz_true) < max(3 * res.logz_err, 0.1), (
        res.logz, lnz_true, res.logz_err)
    r = _ns(2)
    assert abs(res.logz - r.logz) < 3 * max(res.logz_err + r.logz_err,
                                            0.05), (res.logz, r.logz)


def test_chunk_sweeps_do_not_change_the_chain():
    """chunk_sweeps sets only how often kept sweeps reach the host: the
    chain, its logL and its acceptance are equal bit for bit, with a chunk
    that does not divide the sweeps and with a ladder (swaps drawn)."""
    for temps in (1, 3):
        runs = [_mcmc(_logl, 2, walkers=32, sweeps=50, chunk_sweeps=c,
                      temps=temps, seed=3).run() for c in (7, 500)]
        assert np.array_equal(runs[0].chain_u, runs[1].chain_u)
        assert np.array_equal(runs[0].logl, runs[1].logl)
        assert runs[0].acceptance == runs[1].acceptance


def test_proposals_outside_the_cube_are_rejected():
    """A target that rises toward the cube's edge: the walkers stay
    strictly inside [1e-6, 1 - 1e-6] (rejected, not clipped onto the
    boundary)."""
    res = _mcmc(lambda u: 50.0 * u.sum(-1), 2, walkers=32, sweeps=200,
                seed=4).run()
    assert (res.samples_u > 1e-6).all() and (res.samples_u < 1 - 1e-6).all()
    assert not np.any(res.samples_u == np.float32(1 - 1e-6))


def test_rhat_matches_jax():
    chain = np.random.default_rng(6).normal(size=(60, 32, 3)) \
        + np.linspace(0, 0.3, 60)[:, None, None]
    np.testing.assert_allclose(t_mcmc._rhat(chain), j_mcmc._rhat(chain),
                               rtol=0, atol=1e-12)
    assert np.isnan(t_mcmc._rhat(chain[:3])).all()
    assert np.isnan(j_mcmc._rhat(chain[:3])).all()


@pytest.mark.parametrize("temps,t_max,evidence", [
    (1, 64.0, False), (4, 32.0, False), (6, 64.0, False), (8, 512.0, True)])
def test_betas_match_jax(temps, t_max, evidence):
    cfg = dict(walkers=32, temps=temps, t_max=t_max, evidence=evidence)
    got = _mcmc(_logl, 2, **cfg)._betas.numpy()
    want = np.asarray(j_mcmc.EnsembleMCMC(
        lambda u: u[..., 0], 2, j_mcmc.EnsembleMCMCConfig(**cfg))._betas)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_stepping_stone_matches_jax():
    rng = np.random.default_rng(7)
    betas = np.asarray(j_mcmc.EnsembleMCMC(
        lambda u: u[..., 0], 2, j_mcmc.EnsembleMCMCConfig(
            temps=5, t_max=100.0, evidence=True))._betas)
    ls_all = (-np.abs(rng.normal(5.0, 3.0, (40, 6, 24)))
              * (1.0 + np.arange(6))[None, :, None]).astype(np.float32)
    got = t_mcmc.EnsembleMCMC._stepping_stone(ls_all, betas)
    want = j_mcmc.EnsembleMCMC._stepping_stone(ls_all, jnp.asarray(betas))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
