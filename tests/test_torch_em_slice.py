"""The whole EM slice of the PyTorch port against the JAX package.

The same photometry file, prior file and seeded unit-cube batch (B=64) go
through ``nmma_tpu.analysis.EMAnalysis.batched_logl`` and
``nmma_tpu_torch.analysis.EMAnalysis(..., device="cpu").batched_logl``, with
the production Bu2019lm surrogate. Some epochs sit at 0.25 d, so draws with
a late timeshift leave them outside the model's range and hit the -1e30
sentinel.

Tolerances: sentinel positions identical; finite logL within rtol 1e-4 and
atol 1e-2. Each magnitude carries the K1 tolerance of 1e-4 mag (f32 sums
over H=2048 in another order), and a chi^2 term moves by about
|m - est| / sigma^2 per unit of magnitude error, so a logL summed over ~90
epochs with residuals of a few magnitudes can move by ~1e-3 absolute or
~1e-5 relative; the bounds leave a factor of ten.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.analysis as j_analysis
import nmma_tpu.models as j_models
import nmma_tpu.models.svd as j_svd
import nmma_tpu_torch.analysis as t_analysis
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.svd as t_svd
from nmma_tpu_torch.inference import NestedSamplerConfig
from nmma_tpu_torch.io import load_bestfit, load_posterior

torch.set_num_threads(1)

ART = "artifacts/Bu2019lm_production_svd.npz"
MODEL = "Bu2019lm_production_parity"
TRIGGER = 58000.0
# the headline prior of the repo's benchmark (bench.py:59-66)
PRIOR = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)
KNphi = Uniform(minimum=15., maximum=75.)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
             "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0}
SENTINEL = -1e29
RTOL, ATOL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def surrogates():
    jax_svd = j_svd.SVDModelData.load(ART)
    j_svd.make_svd_source_model(MODEL, jax_svd)
    port_svd = t_svd.SVDModelData.load(ART, device="cpu")
    t_svd.make_svd_source_model(MODEL, port_svd)
    return jax_svd, port_svd


@pytest.fixture(scope="module")
def files(surrogates, tmp_path_factory):
    """Photometry of the JAX surrogate at the injection: 10 epochs per
    filter (the first at 0.25 d), 0.1 mag noise, an upper limit in every
    third filter; written as an observation file in MJD with a prior file."""
    filters = list(surrogates[0].filters)
    det = j_models.DetectorLightCurveModel(
        MODEL, filters, sample_times=np.geomspace(0.01, 14.0, 150))
    t_obs, mags = det({k: jnp.asarray(v) for k, v in INJECTION.items()})
    t_obs, mags = np.asarray(t_obs), np.asarray(mags)
    rng = np.random.default_rng(170817)
    lines = []
    for i, f in enumerate(filters):
        t = np.concatenate([[0.25], np.sort(rng.uniform(0.5, 12.0, 9))])
        m = np.interp(t, t_obs, mags[i]) + rng.normal(0.0, 0.1, t.size)
        err = np.full(t.size, 0.1)
        if i % 3 == 0:
            m[-1] -= 1.0
            err[-1] = np.inf
        lines += [f"{float(TRIGGER + ti)!r} {f} {float(mi)!r} {ei}\n"
                  for ti, mi, ei in zip(t, m, err)]
    root = tmp_path_factory.mktemp("em_slice")
    (root / "obs.dat").write_text("".join(lines))
    (root / "bu.prior").write_text(PRIOR)
    return str(root / "obs.dat"), str(root / "bu.prior"), filters


def _config(module, files, **extra):
    data, prior, filters = files
    return module.EMAnalysisConfig(
        model=MODEL, prior_file=prior, light_curve_data=data,
        trigger_time=TRIGGER, data_tmax=12.5, filters=filters, **extra)


def test_detector_model_matches(surrogates, files):
    """Observable times and apparent magnitudes of the detector-frame
    model for 64 prior draws: inf rows/points identical, magnitudes within
    the K1 tolerance (1e-4 mag) plus f32 round-off of ~40 mag values."""
    filters = files[2]
    t_det = t_models.DetectorLightCurveModel(
        MODEL, filters, sample_times=np.geomspace(0.01, 14.0, 150),
        device="cpu")
    j_det = j_models.DetectorLightCurveModel(
        MODEL, filters, sample_times=np.geomspace(0.01, 14.0, 150))
    rng = np.random.default_rng(3)
    names = list(INJECTION)
    lo = np.array([-3.0, -2.0, 15.0, 0.0, 1.0, -0.2])
    hi = np.array([-1.0, -0.5, 75.0, 90.0, 200.0, 0.2])
    theta = rng.uniform(lo, hi, (64, 6)).astype(np.float32)
    t_times, t_mags = t_det({n: torch.from_numpy(theta[:, i])
                             for i, n in enumerate(names)})
    j_times, j_mags = jax.vmap(lambda th: j_det(
        {n: th[i] for i, n in enumerate(names)}))(jnp.asarray(theta))
    np.testing.assert_allclose(t_times.numpy(), np.asarray(j_times),
                               rtol=1e-6, atol=1e-6)
    got, want = t_mags.numpy(), np.asarray(j_mags)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


def test_batched_logl_matches(surrogates, files):
    j_ana = j_analysis.EMAnalysis(_config(j_analysis, files))
    t_ana = t_analysis.EMAnalysis(_config(t_analysis, files), device="cpu")
    assert t_ana.filters == j_ana.filters
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    u = np.random.default_rng(64).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(jax.jit(j_ana.batched_logl)(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (64,)
    dead = want <= SENTINEL
    np.testing.assert_array_equal(got <= SENTINEL, dead)
    # the data place both kinds of draw in the batch
    assert 0 < dead.sum() < 64
    np.testing.assert_array_equal(got[dead], want[dead])
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=RTOL, atol=ATOL)


def test_run_writes_results(surrogates, files, tmp_path):
    """A short nested-sampling run through EMAnalysis.run: finite evidence,
    and result files that load back through io.results."""
    cfg = _config(t_analysis, files, outdir=str(tmp_path), label="slice",
                  sampler=NestedSamplerConfig(nlive=64, n_delete=8, walks=4,
                                              max_iter=6, chunk_size=3))
    ana = t_analysis.EMAnalysis(cfg, device="cpu")
    result = ana.run(verbose=False)
    assert np.isfinite(result.logz) and result.niter == 6
    assert result.ncall == 64 + 6 * 8 * 4
    post = load_posterior(tmp_path / "slice_posterior_samples.csv")
    assert set(ana.priors.sampled_names) <= set(post)
    assert len(post["log_likelihood"]) == len(
        result.posterior_indices())
    best = load_bestfit(tmp_path / "slice_bestfit_params.json")
    assert best["log_likelihood"] == pytest.approx(float(result.logl.max()))
    npz = load_posterior(tmp_path / "slice_result.npz")
    assert float(npz["logz"]) == pytest.approx(result.logz)


# -- Me2017: the analytic kilonova through K2's plain version ---------------
#
# The port's Me2017 agrees with the JAX model to ~3e-6 relative in ltot and
# r_photo off near-ties (tests/test_torch_me2017.py). Through
# T_eff ~ (ltot / r^2)^(1/4) and the Planck factor (x = h nu / k T <~ 30 on
# the grid) that moves a magnitude by <~ 1.086 (2 + 30 * 2) 3e-6 ~ 2e-4 mag at
# worst, and f32 round-off of ln F_nu ~ -50 adds ~5e-6 mag: magnitudes are
# compared within atol 1e-3 mag, and logL within the K1 bounds above (rtol
# 1e-4, atol 1e-2: ~90 chi^2 terms with residuals of a few magnitudes).
# Where the JAX side's two best photosphere shells tie within 1e-5 in
# |tau - 1|, the two packages may pick different shells (a whole shell, ~1%
# in radius): those live points are dropped, and counted.

ME_PRIOR = """\
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
ME_FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
              "2massj", "2massh", "2massks"]
ME_MAG_ATOL = 1e-3


def _me_tie_samples(params):
    """Live points where the JAX side has a near-tie at any time."""
    from test_torch_me2017 import jax_near_ties

    gap, _ = jax_near_ties(
        np.asarray(params["log10_mej"]), np.asarray(params["log10_vej"]),
        np.asarray(params["beta"]),
        10.0 ** np.asarray(params["log10_kappa_r"], dtype=np.float32),
        np.geomspace(0.01, 14.0, 150))
    return (gap < 1e-5).any(axis=1)


@pytest.fixture(scope="module")
def me_files(tmp_path_factory):
    """Photometry of the JAX Me2017 model at the injection of
    tests/test_inference.py:46-47 in the surrogate's 9 filters: 8 epochs per
    filter (the first at 0.1 d), 0.1 mag noise, an upper limit in every
    third filter; an observation file in MJD with the prior file."""
    det = j_models.DetectorLightCurveModel(
        "Me2017", ME_FILTERS, sample_times=np.geomspace(0.01, 14.0, 150))
    t_obs, mags = det({k: jnp.asarray(v) for k, v in ME_INJECTION.items()})
    t_obs, mags = np.asarray(t_obs), np.asarray(mags)
    rng = np.random.default_rng(2017)
    lines = []
    for i, f in enumerate(ME_FILTERS):
        t = np.concatenate([[0.1], np.sort(rng.uniform(0.5, 12.0, 7))])
        m = np.interp(t, t_obs, mags[i]) + rng.normal(0.0, 0.1, t.size)
        assert np.all(np.isfinite(m))
        err = np.full(t.size, 0.1)
        if i % 3 == 0:
            m[-1] -= 1.0
            err[-1] = np.inf
        lines += [f"{float(TRIGGER + ti)!r} {f} {float(mi)!r} {ei}\n"
                  for ti, mi, ei in zip(t, m, err)]
    root = tmp_path_factory.mktemp("me2017_slice")
    (root / "obs.dat").write_text("".join(lines))
    (root / "me2017.prior").write_text(ME_PRIOR)
    return str(root / "obs.dat"), str(root / "me2017.prior"), ME_FILTERS


def test_me2017_detector_model_matches():
    """Observable times and banded apparent magnitudes of the Me2017
    detector-frame model for 64 prior draws: inf positions identical,
    magnitudes within ME_MAG_ATOL off near-tie live points."""
    names = list(ME_INJECTION)
    lo = np.array([-3.0, -2.0, 1.0, -1.0, 1.0, -0.2])
    hi = np.array([-0.5, -0.5, 5.0, 2.0, 200.0, 0.2])
    theta = np.random.default_rng(11).uniform(lo, hi, (64, 6)).astype(
        np.float32)
    t_det = t_models.DetectorLightCurveModel(
        "Me2017", ME_FILTERS, sample_times=np.geomspace(0.01, 14.0, 150),
        device="cpu")
    assert t_det.source.banded
    j_det = j_models.DetectorLightCurveModel(
        "Me2017", ME_FILTERS, sample_times=np.geomspace(0.01, 14.0, 150))
    t_times, t_mags = t_det({n: torch.from_numpy(theta[:, i])
                             for i, n in enumerate(names)})
    j_times, j_mags = jax.vmap(lambda th: j_det(
        {n: th[i] for i, n in enumerate(names)}))(jnp.asarray(theta))
    np.testing.assert_allclose(t_times.numpy(), np.asarray(j_times),
                               rtol=1e-6, atol=1e-6)
    got, want = t_mags.numpy(), np.asarray(j_mags)
    assert got.shape == want.shape == (64, 9, 150)
    keep = ~_me_tie_samples({n: theta[:, i] for i, n in enumerate(names)})
    print("Me2017 detector: dropped", int((~keep).sum()), "of 64 live points"
          " with a near-tie")
    assert keep.sum() >= 60
    got, want = got[keep], want[keep]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    assert fin.mean() > 0.9
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ME_MAG_ATOL)


def test_me2017_batched_logl_matches(me_files):
    """EMAnalysis("Me2017").batched_logl at B=64 from the same files:
    sentinel positions identical, finite logL within rtol 1e-4 / atol 1e-2,
    off near-tie live points."""
    def config(module):
        data, prior, filters = me_files
        return module.EMAnalysisConfig(
            model="Me2017", prior_file=prior, light_curve_data=data,
            trigger_time=TRIGGER, data_tmax=12.5, filters=filters)

    j_ana = j_analysis.EMAnalysis(config(j_analysis))
    t_ana = t_analysis.EMAnalysis(config(t_analysis), device="cpu")
    assert t_ana.filters == j_ana.filters
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    u = np.random.default_rng(6417).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(jax.jit(j_ana.batched_logl)(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (64,)
    keep = ~_me_tie_samples(j_ana.priors.transform(jnp.asarray(u)))
    print("Me2017 logL: dropped", int((~keep).sum()), "of 64 live points"
          " with a near-tie")
    assert keep.sum() >= 60
    got, want = got[keep], want[keep]
    dead = want <= SENTINEL
    np.testing.assert_array_equal(got <= SENTINEL, dead)
    # draws with a timeshift past the epoch at 0.1 d hit the sentinel
    assert 0 < dead.sum() < keep.sum()
    np.testing.assert_array_equal(got[dead], want[dead])
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=RTOL, atol=ATOL)
