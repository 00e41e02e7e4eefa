"""The port's best-fit reports, light-curve bands and figures
(``nmma_tpu_torch.plotting``, ``plotting_utils`` and
``post_processing/plotting_routines``) against the JAX package's, on the
CPU.

* ``sig_lims``, ``nan_level`` and ``shared_limits`` are numpy in both
  packages: equal exactly (the strings, and the levels bit for bit).
* ``compute_chisquare_dict`` on Bu2019lm and Me2017, the same data (the
  photometry files of tests/test_torch_em_slice.py) and the same best-fit
  parameters handed to both packages: every filter's chi^2/dof, raw and
  with systematics, within 1e-3 + 1e-3 chi^2/dof (a magnitude within the
  model's parity tolerance moves a term by ~2 |resid| dm / sigma^2).
* ``lightcurve_bands`` (one batched model call: the best fit and up to 60
  posterior draws) against the JAX package's ``jax.vmap(lk.model)`` of the
  same draws and ``jax.jit(lk.model)`` of the best fit, with each model's
  parity tolerance: Bu2019lm 1e-4 mag (K1, tests/test_torch_svd.py),
  Me2017 1e-3 mag off draws with a photosphere near-tie
  (tests/test_torch_me2017.py), TrPi2018 1e-3 mag of the fused JAX model
  below mag 45 (tests/test_torch_grb.py's FAINT_MAG); inf in the same
  places; the 5th and 95th percentiles within the same tolerance.
* Each drawing function, and ``plot-svdmodel-benchmarks`` and
  ``nmma-plot-multi-corner``, writes a non-empty PNG here, where matplotlib
  imports; without matplotlib a drawing function raises an ImportError
  naming it, while the compute half runs.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.analysis as j_analysis
import nmma_tpu.plotting as j_plotting
import nmma_tpu.plotting_utils as j_utils
import nmma_tpu.post_processing.plotting_routines as j_routines
import nmma_tpu_torch.analysis as t_analysis
import nmma_tpu_torch.plotting as t_plotting
import nmma_tpu_torch.plotting_utils as t_utils
import nmma_tpu_torch.post_processing.plotting_routines as t_routines
from nmma_tpu_torch.cli import tools as t_tools
import nmma_tpu_torch.models as t_models
from test_torch_em_slice import (INJECTION, ME_FILTERS, ME_INJECTION,
                                 ME_MAG_ATOL, ME_PRIOR, MODEL, TRIGGER,
                                 _me_tie_samples, files,  # noqa: F401
                                 surrogates)  # noqa: F401

torch.set_num_threads(1)

K1_MAG_ATOL = 1e-4
GRB_MAG_ATOL = 1e-3
FAINT_MAG = 45.0


class Draws:
    """A result of equal-weight unit-cube draws, as the samplers' results
    present them to the plotting functions."""

    def __init__(self, samples_u, logl):
        self.samples_u, self.logl = samples_u, logl
        self.logz = self.logz_err = float("nan")

    def posterior_indices(self, rng=None):
        return np.arange(len(self.logl))


def seeded_draws(ndim, n=80, seed=0):
    rng = np.random.default_rng(seed)
    return Draws(rng.uniform(size=(n, ndim)).astype(np.float32),
                 rng.normal(size=n))


# -- the numpy helpers --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_sig_lims_and_nan_level_equal_jax(seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4, 4)
    values = rng.normal(rng.uniform(-100, 100), scale, 500)
    assert t_utils.sig_lims(values) == j_utils.sig_lims(values)
    assert t_utils.sig_lims(values, sig_unc=1) == \
        j_utils.sig_lims(values, sig_unc=1)
    assert t_utils.sig_lims(np.full(5, 3.0)) == j_utils.sig_lims(
        np.full(5, 3.0))
    values[rng.choice(500, 20 * seed, replace=False)] = np.nan
    weights = rng.uniform(size=500)
    for level in (0.5, 0.9, 0.99):
        for w in (None, weights):
            got = t_utils.nan_level(values, level, weights=w)
            want = j_utils.nan_level(values, level, weights=w)
            np.testing.assert_array_equal(got, want)
    assert t_utils.latex_label("R_14") == j_utils.latex_label("R_14")
    assert t_utils.LATEX_LABELS == j_utils.LATEX_LABELS


def test_shared_limits_equal_jax():
    rng = np.random.default_rng(7)
    posts = [{"a": rng.normal(0, 1, 300), "b": rng.uniform(2, 5, 300)},
             {"a": rng.normal(1, 2, 500)}]
    got = t_routines.shared_limits(posts, ["a", "b"])
    want = j_routines.shared_limits(posts, ["a", "b"])
    assert got == want


# -- the best-fit report --------------------------------------------------------

def _chi2_agree(got, want):
    assert sorted(got) == sorted(want) and got
    for filt, row in want.items():
        assert got[filt]["n_points"] == row["n_points"]
        for key in ("chi2_per_dof", "chi2_per_dof_with_systematics"):
            assert abs(got[filt][key] - row[key]) <= 1e-3 + 1e-3 * row[key], \
                (filt, key, got[filt][key], row[key])


def _config(module, data, prior, filters, model, **extra):
    return module.EMAnalysisConfig(
        model=model, prior_file=prior, light_curve_data=data,
        trigger_time=58000.0, data_tmax=12.5, filters=filters, **extra)


@pytest.fixture(scope="module")
def bu_analyses(surrogates, files):  # noqa: F811
    data, prior, filters = files
    return (j_analysis.EMAnalysis(_config(j_analysis, data, prior, filters,
                                          MODEL)),
            t_analysis.EMAnalysis(_config(t_analysis, data, prior, filters,
                                          MODEL), device="cpu"))


@pytest.fixture(scope="module")
def me_files(tmp_path_factory):
    """tests/test_torch_em_slice.py's Me2017 photometry (its seed, epochs,
    noise and upper limits), made by the port's model on the CPU rather
    than the JAX package's eager one, which takes ~15 s; both packages then
    read the same file."""
    det = t_models.DetectorLightCurveModel(
        "Me2017", ME_FILTERS, sample_times=np.geomspace(0.01, 14.0, 150),
        device="cpu")
    t_obs, mags = det({k: torch.tensor([v], dtype=torch.float32)
                       for k, v in ME_INJECTION.items()})
    t_obs, mags = t_obs[0].numpy(), mags[0].numpy()
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
    root = tmp_path_factory.mktemp("me2017_plotting")
    (root / "obs.dat").write_text("".join(lines))
    (root / "me2017.prior").write_text(ME_PRIOR)
    return str(root / "obs.dat"), str(root / "me2017.prior"), ME_FILTERS


@pytest.fixture(scope="module")
def me_analyses(me_files):
    data, prior, filters = me_files
    return (j_analysis.EMAnalysis(_config(j_analysis, data, prior, filters,
                                          "Me2017")),
            t_analysis.EMAnalysis(_config(t_analysis, data, prior, filters,
                                          "Me2017"), device="cpu"))


@pytest.mark.parametrize("model", ["Bu2019lm", "Me2017"])
def test_chisquare_dict_matches_jax(request, model):
    if model == "Bu2019lm":
        j_ana, t_ana = request.getfixturevalue("bu_analyses")
        point = dict(INJECTION, KNphi=50.0, luminosity_distance=43.0)
    else:
        j_ana, t_ana = request.getfixturevalue("me_analyses")
        point = dict(ME_INJECTION, log10_mej=-1.25, timeshift=0.02)
    want = j_plotting.compute_chisquare_dict(j_ana, point)
    got = t_plotting.compute_chisquare_dict(t_ana, point)
    _chi2_agree(got, want)
    assert any(row["chi2_per_dof"] > 0.1 for row in got.values())


def test_post_process_bestfit_keys_match_jax(bu_analyses, tmp_path):
    """The report of a result without an evidence (an MCMC's NaN logZ):
    the JAX package's keys, None for the evidence, strict JSON."""
    j_ana, t_ana = bu_analyses
    result = seeded_draws(t_ana.priors.ndim, seed=1)
    t_ana.config.outdir, t_ana.config.label = str(tmp_path), "port"
    got = t_plotting.post_process_bestfit(t_ana, result=result)
    want = j_plotting.post_process_bestfit(j_ana, result=result, save=False)
    on_file = json.loads((tmp_path / "port_bestfit.json").read_text())
    assert sorted(on_file) == sorted(got) == sorted(want)
    assert on_file["log_evidence"] is None and want["log_evidence"] is None
    assert on_file["Best fit index"] == want["Best fit index"]
    assert sorted(on_file["posterior_parameters"]) == \
        sorted(want["posterior_parameters"])
    _chi2_agree(got["chi2_per_dof"], want["chi2_per_dof"])


# -- the light-curve bands --------------------------------------------------

def _jax_bands(j_ana, result, take):
    """The JAX model's magnitudes of the draws ``take`` and of the best fit
    (the largest logL), in one vmapped call as the port makes them, and
    the parameters of that call (the best fit first)."""
    best = int(np.argmax(result.logl))
    params = j_ana.priors.transform(
        jnp.asarray(result.samples_u[np.concatenate([[best], take])]))
    _, mags = jax.jit(jax.vmap(j_ana.likelihood.model))(params)
    mags = np.asarray(mags)
    return mags[1:], mags[0], params


def _bands_agree(got, draws, best, keep, tol, faint=np.inf):
    draws, got_draws = draws[keep], got["draws"][keep]
    for g, w in ((got_draws, draws), (got["best"], best)):
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        sel = np.isfinite(w) & (w < faint)
        assert sel.mean() > 0.5
        np.testing.assert_allclose(g[sel], w[sel], rtol=0, atol=tol)
    if keep.all():
        masked = np.where(np.isfinite(draws), draws, np.nan)
        for name, q in (("lo", 5), ("hi", 95)):
            want = np.nanpercentile(masked, q, axis=0)
            sel = np.isfinite(want) & (want < faint)
            np.testing.assert_array_equal(np.isnan(got[name]),
                                          np.isnan(want))
            np.testing.assert_allclose(got[name][sel], want[sel], rtol=0,
                                       atol=tol)


def test_lightcurve_bands_bu2019lm_match_jax(bu_analyses):
    j_ana, t_ana = bu_analyses
    result = seeded_draws(t_ana.priors.ndim, seed=2)
    take = t_plotting.band_draws(result)
    assert len(take) == 60
    got = t_plotting.lightcurve_bands(t_ana, result)
    assert got["draws"].shape == (60, len(t_ana.filters), 150)
    draws, best, _ = _jax_bands(j_ana, result, take)
    _bands_agree(got, draws, best, np.ones(60, bool), K1_MAG_ATOL)


def test_lightcurve_bands_me2017_match_jax(me_analyses):
    j_ana, t_ana = me_analyses
    result = seeded_draws(t_ana.priors.ndim, n=40, seed=3)
    take = t_plotting.band_draws(result)
    assert len(take) == 40
    got = t_plotting.lightcurve_bands(t_ana, result)
    draws, best, params = _jax_bands(j_ana, result, take)
    ties = _me_tie_samples(params)
    assert not ties[0]
    keep = ~ties[1:]
    assert keep.sum() >= 36
    _bands_agree(got, draws, best, keep, ME_MAG_ATOL)


def test_lightcurve_bands_trpi2018_match_jax(monkeypatch, tmp_path):
    """TrPi2018 at the reduced resolution of tests/test_torch_grb.py
    (n_theta 8, n_phi 4, n_r 128) on photometry the port's model makes at
    config 3's injection, against the fused JAX model."""
    from nmma_tpu_torch.injections import create_light_curve_data
    from nmma_tpu_torch.io import write_em_observations
    from nmma_tpu_torch.models import DetectorLightCurveModel
    from test_torch_grb import (GRB_FILTERS, GRB_INJECTION, GRB_PRIOR,
                                SMALL)

    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    epochs = DetectorLightCurveModel(
        "TrPi2018", GRB_FILTERS, sample_times=np.geomspace(0.1, 30.0, 6),
        model_kwargs=SMALL, device="cpu")
    data = create_light_curve_data(
        {**GRB_INJECTION, "trigger_time": 59000.0}, epochs, GRB_FILTERS)
    write_em_observations(tmp_path / "grb.dat", data)
    (tmp_path / "grb.prior").write_text(GRB_PRIOR)

    def config(module):
        return module.EMAnalysisConfig(
            model="TrPi2018", prior_file=str(tmp_path / "grb.prior"),
            light_curve_data=str(tmp_path / "grb.dat"),
            trigger_time=59000.0, tmin=0.05, tmax=40.0, n_tsteps=64,
            filters=GRB_FILTERS, model_kwargs=SMALL)

    j_ana = j_analysis.EMAnalysis(config(j_analysis))
    t_ana = t_analysis.EMAnalysis(config(t_analysis), device="cpu")
    result = seeded_draws(t_ana.priors.ndim, n=16, seed=4)
    got = t_plotting.lightcurve_bands(t_ana, result)
    draws, best, _ = _jax_bands(j_ana, result, t_plotting.band_draws(result))
    _bands_agree(got, draws, best, np.ones(16, bool), GRB_MAG_ATOL,
                 faint=FAINT_MAG)


# -- the figures ------------------------------------------------------------

def _png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000, path


def test_drawing_functions_write_pngs(bu_analyses, tmp_path):
    _, t_ana = bu_analyses
    result = seeded_draws(t_ana.priors.ndim, seed=5)
    _png(t_plotting.lightcurve_fit_plot(
        t_ana, result, n_band_samples=8,
        save_path=str(tmp_path / "lc.png")))
    rng = np.random.default_rng(8)
    post = {"a": rng.normal(0, 1, 400), "b": rng.normal(2, 0.5, 400),
            "log_likelihood": rng.normal(size=400)}
    _png(t_plotting.corner_plot(post, truths={"a": 0.0, "b": 2.0},
                                save_path=str(tmp_path / "corner.png")))
    eos_set = types.SimpleNamespace(
        mass_grid=np.linspace(1.0, 2.2, 25),
        radii=np.clip(rng.normal(12.0, 0.6, (30, 25)), 0, None)
        * (np.linspace(1.0, 2.2, 25) < rng.uniform(1.8, 2.3, (30, 1))))
    constraint = types.SimpleNamespace(name="J0740", measured_mass=2.08)
    _png(t_plotting.eos_mr_band_plot(
        eos_set, weights=rng.uniform(size=30), constraints=[constraint],
        save_path=str(tmp_path / "mr.png")))
    times = np.geomspace(0.1, 14.0, 30)
    bands = 20.0 + np.sort(rng.normal(size=(3, 2, 30)), axis=0)
    _png(t_plotting.plot_marginalised_bands(times, bands, ["ztfg", "ztfr"],
                                            str(tmp_path / "bands.png")))
    second = {"a": rng.normal(0.5, 1, 300), "b": rng.normal(2, 0.7, 300)}
    t_routines.plot_histograms_only([post, second], keys=["a", "b"],
                                    truths={"a": 0.0},
                                    save_path=str(tmp_path / "hist.png"))
    t_routines.plot_multi_corner([post], keys=["a", "b"],
                                 save_path=str(tmp_path / "one.png"))
    t_routines.plot_r14_trend([12.1, 12.0, 11.9], [11.5, 11.6, 11.6],
                              [12.7, 12.4, 12.2], true_value=11.9,
                              save_path=str(tmp_path / "r14.png"))
    for name in ("hist", "one", "r14"):
        _png(tmp_path / f"{name}.png")
    fig, _ = t_utils.fig_setup()
    fig2, axes = t_utils.setup_multi_axes(5)
    assert len(axes) == 5
    assert t_utils.fading_cmap("C0").N == 256


def test_plotting_entry_points_write_pngs(tmp_path):
    scores = {"ztfg": [0.1, 0.5, 1.0, 2.0, 9.0],
              "ztfr": [0.2, 0.6, 1.1, 2.5, 7.0]}
    (tmp_path / "bu_benchmark.json").write_text(json.dumps(scores))
    _png(t_tools.COMMANDS["plot-svdmodel-benchmarks"](
        ["--benchmark-file", str(tmp_path / "bu_benchmark.json"),
         "--outdir", str(tmp_path / "bench")]))
    rng = np.random.default_rng(9)
    np.savez(tmp_path / "run_a.npz", posterior_a=rng.normal(0, 1, 300),
             posterior_b=rng.normal(1, 1, 300), logz=1.0)
    header = "a,b"
    np.savetxt(tmp_path / "run_b.csv", rng.normal(0.3, 1, (300, 2)),
               delimiter=",", header=header, comments="")
    # a csv read with numpy as pandas reads it (whose fast float parser may
    # round a last digit the other way)
    got = t_routines.load_posterior_file(str(tmp_path / "run_b.csv"))
    want = j_routines.load_posterior_file(str(tmp_path / "run_b.csv"))
    assert list(got) == list(want) == ["a", "b"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-15, atol=0)
    results = [str(tmp_path / "run_a.npz"), str(tmp_path / "run_b.csv")]
    for extra, name in (([], "multi.png"), (["--histograms-only"],
                                             "hist.png")):
        out = t_tools.COMMANDS["nmma-plot-multi-corner"](
            [*results, "--labels", "a,b", "--outfile",
             str(tmp_path / name), *extra])
        _png(out)


def test_drawing_without_matplotlib_raises(bu_analyses, monkeypatch,
                                           tmp_path):
    """No hidden fallback: without matplotlib the drawing functions raise
    an ImportError naming it; the compute half still runs."""
    _, t_ana = bu_analyses
    result = seeded_draws(t_ana.priors.ndim, seed=6)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bands = t_plotting.lightcurve_bands(t_ana, result, n_band_samples=4)
    assert bands["draws"].shape[0] == 4
    for draw in (lambda: t_plotting.lightcurve_fit_plot(
                     t_ana, result, n_band_samples=4,
                     save_path=str(tmp_path / "lc.png")),
                 lambda: t_plotting.corner_plot(
                     {"a": np.arange(5.0)}, save_path=str(tmp_path / "c.png")),
                 lambda: t_routines.plot_r14_trend([1.0], [0.5], [1.5])):
        with pytest.raises(ImportError, match="matplotlib"):
            draw()
    assert not (tmp_path / "lc.png").exists()
