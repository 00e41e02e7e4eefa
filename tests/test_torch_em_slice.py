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
