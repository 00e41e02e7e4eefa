"""The port's survey cadences (``nmma_tpu_torch/strategies.py``) and the
cadence branches of ``injections.create_light_curve_data`` against the JAX
package's, and faults 3i and 3j.

Both packages draw cadences from numpy and scipy generators in the same
order on the host, so with the same seed and the same dense curves the
epochs, limits and errors are equal exactly. Through
``create_light_curve_data`` the curves come from each package's surrogate
(the K1 tolerance, 1e-4 mag, on the CPU), so magnitudes agree within 1e-4
and the detection flags and drawn errors agree exactly except at an epoch
within 1e-4 mag of its limit or of an edge of the uncertainty intervals.

3i: the injected times are the model's f32 offsets plus the trigger time
summed in float64. 3j: a query on the first or last node of the model grid
reads the model's value there, as ``np.interp`` does.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.injections as j_inj
import nmma_tpu.models.svd as j_svd
import nmma_tpu.strategies as j_strat
import nmma_tpu_torch.injections as t_inj
import nmma_tpu_torch.models.svd as t_svd
import nmma_tpu_torch.strategies as t_strat

torch.set_num_threads(1)

ART = "artifacts/Bu2019lm_production_svd.npz"
MODEL = "Bu2019lm_strategies"
INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
             "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0}
MAG_TOL = 1e-4
EDGE_TOL = 1e-4


@pytest.fixture(scope="module")
def surrogates():
    j_svd.make_svd_source_model(MODEL, j_svd.SVDModelData.load(ART))
    svd = t_svd.SVDModelData.load(ART, device="cpu")
    t_svd.make_svd_source_model(MODEL, svd)
    return list(svd.filters)


def dense_curves(seed=3, t_last=14.0, filters=("ztfg", "ztfr", "ztfi",
                                                 "ps1::z")):
    """Smooth seeded light curves on a geomspace grid, 18-23 mag."""
    rng = np.random.default_rng(seed)
    t = np.geomspace(0.01, t_last, 150) + 60000.0
    out = {}
    for f in filters:
        a, b = rng.uniform(18.0, 19.0), rng.uniform(0.2, 0.5)
        mag = a + b * (t - 60000.0)
        out[f] = {"time": t, "mag": mag,
                  "mag_error": np.full(t.size, 0.1)}
    return out


def test_npz_is_a_byte_copy():
    assert filecmp.cmp(t_strat.ZTF_NPZ, "nmma_tpu/data/ztf_observing.npz",
                       shallow=False)


@pytest.mark.parametrize("tier", ["ztf", "platinum", "gold", "gold_z",
                                  "silver", "silver_z"])
def test_strategies_match_jax(tier):
    if tier == "ztf":
        want = j_strat.ztf_strategy(np.random.default_rng(5))
        got = t_strat.ztf_strategy(np.random.default_rng(5))
    else:
        want, got = j_strat.rubin_strategy(tier), t_strat.rubin_strategy(tier)
    assert got == want
    curves = dense_curves()
    for trigger in (0.0, 60000.0):
        w = j_strat.apply_strategy(curves, want, trigger_time=trigger)
        g = t_strat.apply_strategy(curves, got, trigger_time=trigger)
        assert list(g) == list(w)
        for f in w:
            np.testing.assert_array_equal(g[f]["time"], w[f]["time"])
            np.testing.assert_array_equal(g[f]["mag"], w[f]["mag"])


def test_unknown_rubin_tier_raises():
    for module in (j_strat, t_strat):
        with pytest.raises(ValueError, match="platinum"):
            module.rubin_strategy("bronze")


def test_validate_lightcurve_matches_jax(tmp_path):
    from nmma_tpu_torch.io import write_em_observations
    data = dense_curves()
    data["ztfi"]["mag_error"][3:] = np.inf     # three detections only
    path = str(tmp_path / "lc.dat")
    write_em_observations(path, data)
    cases = [dict(), dict(min_obs=4), dict(min_obs=3, cutoff_time=0.5),
             dict(filters="ztfg,ztfr"), dict(filters=["ztfg", "sdssu"])]
    for kwargs in cases:
        for source in (data, path):
            want = j_strat.validate_lightcurve(source, **kwargs)
            assert t_strat.validate_lightcurve(source, **kwargs) == want, \
                kwargs
    assert not t_strat.validate_lightcurve(data, min_obs=4)
    assert t_strat.validate_lightcurve(data, filters="ztfg,ztfr")


@pytest.mark.parametrize("uncertainties,too", [
    (False, None), (True, None), (True, "180"), (True, "300"),
    (False, "300")])
def test_ztf_observing_model_matches_jax(uncertainties, too):
    curves = dense_curves(seed=7, filters=("ztfg", "ztfr", "ztfi"))
    for f in curves:
        curves[f]["mag"] = curves[f]["mag"] + 1.5     # straddle the limits
    j_model, t_model = j_strat.ZTFObservingModel(), t_strat.ZTFObservingModel()
    for seed in (0, 1, 2):
        want = j_model.apply(curves, list(curves), np.random.default_rng(seed),
                             14.0, trigger_time=60000.0,
                             uncertainties=uncertainties, too=too)
        limits = {}
        got = t_model.apply(curves, list(curves), np.random.default_rng(seed),
                            14.0, trigger_time=60000.0,
                            uncertainties=uncertainties, too=too,
                            limits=limits)
        assert sorted(got) == sorted(want)
        for f in want:
            for key in ("time", "mag", "mag_error"):
                np.testing.assert_array_equal(got[f][key], want[f][key])
        if uncertainties:
            flags = np.concatenate([np.isinf(got[f]["mag_error"])
                                    for f in got])
            assert flags.any() and not flags.all()
            for f in got:
                lim = got[f]["mag"][np.isinf(got[f]["mag_error"])]
                np.testing.assert_array_equal(
                    lim, limits[f][np.isinf(got[f]["mag_error"])])


def near_edge(model, sides, limits):
    """Epochs detected (on either side) within EDGE_TOL of their limit or
    of an edge of the uncertainty intervals: there the detection flag or
    the drawn error may differ."""
    edges = model.interval_edges()
    close = np.zeros(len(sides[0]["mag"]), dtype=bool)
    for side in sides:
        mag = np.where(np.isfinite(side["mag_error"]), side["mag"], np.inf)
        close |= (np.abs(mag[:, None] - edges[None, :]).min(axis=1)
                  <= EDGE_TOL) | (np.abs(mag - limits) <= EDGE_TOL)
    return close


CADENCES = {
    "ztf_sampling": dict(ztf_sampling=True),
    "ztf_uncertainties": dict(ztf_sampling=True, ztf_uncertainties=True),
    "ztf_too_180": dict(ztf_uncertainties=True, ztf_too="180"),
    "ztf_too_300": dict(ztf_sampling=True, ztf_uncertainties=True,
                        ztf_too="300"),
    "rubin_platinum": dict(rubin_too_type="platinum"),
    "rubin_gold_z": dict(rubin_too_type="gold_z", detection_limit=21.5),
    "rubin_and_ztf": dict(rubin_too_type="platinum", ztf_sampling=True),
}


@pytest.mark.parametrize("case", list(CADENCES))
def test_cadences_match_jax(surrogates, case):
    """create_light_curve_data with each cadence flag through both packages
    at trigger 0: the same epochs and filters, magnitudes within 1e-4 mag,
    detection flags and errors equal away from the edges."""
    kwargs = CADENCES[case]
    want = j_inj.create_light_curve_data(
        INJECTION, MODEL, surrogates, trigger_time=0.0, seed=11,
        keep_infinite_data=True, **kwargs)
    limits = {}
    got = t_inj.create_light_curve_data(
        INJECTION, MODEL, surrogates, trigger_time=0.0, seed=11,
        keep_infinite_data=True, device="cpu", ztf_limits=limits, **kwargs)
    assert sorted(got) == sorted(want) and got
    model = t_strat.ZTFObservingModel()
    n_epochs = n_near = 0
    for f in want:
        np.testing.assert_array_equal(got[f]["time"], want[f]["time"])
        g_mag, w_mag = got[f]["mag"], want[f]["mag"]
        np.testing.assert_array_equal(np.isfinite(g_mag), np.isfinite(w_mag))
        fin = np.isfinite(w_mag)
        np.testing.assert_allclose(g_mag[fin], w_mag[fin], rtol=0,
                                   atol=MAG_TOL)
        g_err, w_err = got[f]["mag_error"], want[f]["mag_error"]
        far = ~near_edge(model, (got[f], want[f]), limits[f]) \
            if kwargs.get("ztf_uncertainties") else \
            np.ones(len(w_mag), dtype=bool)
        n_near += int((~far).sum())
        np.testing.assert_array_equal(np.isinf(g_err)[far],
                                      np.isinf(w_err)[far])
        np.testing.assert_array_equal(g_err[far], w_err[far])
        n_epochs += len(w_mag)
    assert n_epochs >= 3 and n_near <= n_epochs // 10
    if "rubin_too_type" in kwargs and not kwargs.get("ztf_sampling"):
        # the surrogate has no ps1::g/r/i: those tiers' filters are skipped
        assert set(got) <= {"ps1::z", "ps1::y"}


def test_ztf_falls_back_to_the_parametric_cadence(surrogates, monkeypatch,
                                                  tmp_path):
    """Without the npz the ZTF flags take the parametric cadence, as the
    JAX package's do."""
    def missing(*args, **kwargs):
        raise FileNotFoundError("no npz")
    monkeypatch.setattr(j_strat, "ZTFObservingModel", missing)
    monkeypatch.setattr(t_strat, "ZTF_NPZ", str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError):
        t_strat.ZTFObservingModel()
    want = j_inj.create_light_curve_data(INJECTION, MODEL, surrogates,
                                         trigger_time=0.0, ztf_sampling=True,
                                         ztf_uncertainties=True)
    got = t_inj.create_light_curve_data(INJECTION, MODEL, surrogates,
                                        trigger_time=0.0, ztf_sampling=True,
                                        ztf_uncertainties=True, device="cpu")
    assert sorted(got) == sorted(want) == ["ztfg", "ztfi", "ztfr"]
    for f in want:
        assert len(want[f]["time"]) == 10
        np.testing.assert_array_equal(got[f]["time"], want[f]["time"])
        np.testing.assert_allclose(got[f]["mag"], want[f]["mag"], rtol=0,
                                   atol=MAG_TOL)


def test_injected_times_are_float64_sums(surrogates):
    """3i: at MJD 60000 the written times equal the model's f32 offsets
    summed with the trigger in float64, bit for bit; the last epoch sits on
    the model grid's last node, not 2^-9 d beyond it."""
    from nmma_tpu_torch.models import DetectorLightCurveModel
    model = DetectorLightCurveModel(
        MODEL, surrogates, sample_times=np.geomspace(0.25, 12.0, 150),
        device="cpu")
    params = {k: torch.tensor([v]) for k, v in INJECTION.items()}
    offsets = model(params)[0][0].numpy()
    data = t_inj.create_light_curve_data(INJECTION, model, surrogates,
                                         trigger_time=60000.0, device="cpu")
    want = offsets[offsets >= 0.0].astype(np.float64) + 60000.0
    for f in surrogates:
        assert data[f]["time"].dtype == np.float64
        np.testing.assert_array_equal(data[f]["time"], want)
    assert data["ztfg"]["time"][-1] - 60000.0 == np.float64(offsets[-1])


def test_end_nodes_read_the_grid_values(surrogates):
    """3j: with the data on the model grid (the injection's own distance
    and timeshift), queries on the first and last node read the model's
    magnitudes there, as np.interp does; every other query equals the JAX
    package's estimate within 1e-4 mag; logL at seeded points away from
    the injection equals the JAX package's, and at the injection it is
    finite and above every seeded point's."""
    import nmma_tpu.analysis as j_analysis
    import nmma_tpu_torch.analysis as t_analysis
    from nmma_tpu.priors import parse_prior_dict as j_parse
    from nmma_tpu_torch.priors import parse_prior_dict as t_parse

    filters = ["ztfg", "ztfr", "2massks"]
    data = t_inj.create_light_curve_data(
        INJECTION, MODEL, filters, tmin=0.25, tmax=12.0, trigger_time=0.0,
        seed=2, device="cpu")
    prior = "\n".join([
        "log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)",
        "log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)",
        "KNphi = Uniform(minimum=15., maximum=75.)",
        "KNtheta = Uniform(minimum=0., maximum=90.)",
        "luminosity_distance = Uniform(minimum=30., maximum=60.)",
        "timeshift = Uniform(minimum=-0.01, maximum=0.0)"])
    kw = dict(model=MODEL, trigger_time=0.0, filters=filters, tmin=0.25,
              tmax=12.0)
    t_ana = t_analysis.EMAnalysis(t_analysis.EMAnalysisConfig(**kw),
                                  data=data, priors=t_parse(prior),
                                  device="cpu")
    j_ana = j_analysis.EMAnalysis(j_analysis.EMAnalysisConfig(**kw),
                                  data=data, priors=j_parse(prior))

    params = {k: torch.tensor([v]) for k, v in INJECTION.items()}
    x, mags = t_ana.model(params)
    est = t_ana.likelihood.expected_mags(x, mags)[0].numpy()   # [F, N]
    j_x, j_mags = j_ana.model({k: jnp.asarray(v)
                               for k, v in INJECTION.items()})
    j_est = np.asarray(j_ana.likelihood.expected_mags(j_x, j_mags))
    xg, yg = x[0].numpy(), mags[0].numpy()
    rows = [t_ana.model.filters.index(f) for f in t_ana.filters]
    times = t_ana.likelihood.data.times.numpy()
    valid = t_ana.likelihood.data.valid.numpy()
    ends = (times == xg[0]) | (times == xg[-1])
    assert (ends & valid).sum() == 2 * len(filters)
    for i, r in enumerate(rows):
        on = ends[i] & valid[i]
        np.testing.assert_array_equal(
            est[i][on], np.interp(times[i][on], xg, yg[r]).astype(np.float32))
        assert np.all(j_est[i][on] == 0.0)       # the JAX package's fault
        rest = valid[i] & ~ends[i]
        np.testing.assert_allclose(est[i][rest], j_est[i][rest], rtol=0,
                                   atol=MAG_TOL)

    u = np.random.default_rng(9).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 32
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-2)
    at_injection = float(t_ana.likelihood.log_likelihood(params)[0])
    assert np.isfinite(at_injection) and at_injection > -1e29
    assert at_injection > got.max()
