"""The port's ``lightcurve-analysis`` CLI against the JAX package's.

One yaml config drives both ``main``s: the production Bu2019lm surrogate
(``--svd-path``), photometry synthesised from an injection json, a yaml
systematics file with time nodes on one filter group, the linear-decay Ebv
prior of ``--Ebv-max`` and G23-MW extinction. With ``--skip-sampling``
each assembles its analysis and stops; then

* the injection photometry each writes (``--injection-outfile``) agrees
  within 1e-4 mag (the K1 tolerance; both draw the noise from
  ``np.random.default_rng(seed)`` in the same order), at the same times:
  the port sums the model's offsets and the trigger time in float64, and
  the JAX package, which sums them in f32 (ROADMAP fault 3i), is handed
  its offsets summed in float64;
* ``batched_logl`` at 64 seeded unit points agrees within rtol 1e-4 and
  atol 1e-2 with identical -1e30 sentinels (the bounds of
  tests/test_torch_em_slice.py);
* the port's complete-config file has every key of the JAX package's.

A tiny full run of the port's CLI (nlive 64, dlogz 1) writes every result
file and its checkpoint, and ``--skip-sampling`` regenerates its logZ from
the checkpoint bit for bit. ``--sampler mcmc`` writes the JAX package's
result keys in both packages, and ``EMAnalysis.run_mcmc`` agrees with a
nested run on the posterior medians. ``--sampler neuralnet`` runs in the
port and writes the JAX package's result keys. ``--ztf-sampling`` and
``--rubin-ToO-type platinum`` give both packages the same epochs and logL.
--bestfit (on by default) and --plot write the JAX package's report keys
and the figures; the
sky-map options (--fits-file, --detection-limit-fits-file) and
--fiesta-surrogates-dir give the JAX package's priors, detection limit and
logL.
"""

import configparser
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import nmma_tpu.cli.lightcurve_analysis as j_cli
import nmma_tpu_torch.cli.lightcurve_analysis as t_cli
from nmma_tpu_torch import injections as t_injections

torch.set_num_threads(1)

ART = "artifacts/Bu2019lm_production_svd.npz"
FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y", "2massj",
           "2massh", "2massks"]
PRIOR = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)
KNphi = Uniform(minimum=15., maximum=75.)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
             "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0,
             "Ebv": 0.1, "trigger_time": 60000.0}
SYSTEMATICS = {
    "optical": {"filters": ["ztfg", "ztfr", "ztfi"], "time_nodes": 3,
                "time_range": "linear 0.5 12.0",
                "prior": "Uniform(minimum=0.0, maximum=1.0)"},
    "rest": {"prior": "Uniform(minimum=0.0, maximum=1.0)"},
}
RTOL, ATOL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    (root / "bu.prior").write_text(PRIOR)
    (root / "sys.yaml").write_text(yaml.safe_dump(SYSTEMATICS))
    t_injections.write_injection_file(
        root / "inj.json", {k: [v] for k, v in INJECTION.items()})
    # keys are the flags' destinations (extinction-law for
    # --em-extinction-law), as apply_config maps them in both packages
    cfg = {"model": "Bu2019lm_cli", "svd-path": ART,
           "prior": str(root / "bu.prior"),
           "injection": str(root / "inj.json"),
           "filters": ",".join(FILTERS), "tmin": 0.25, "tmax": 12.0,
           "ebv-max": 0.5, "extinction-law": "G23_MW",
           "systematics-file": str(root / "sys.yaml"),
           "nlive": 64, "n-delete": 32, "walks": 3, "dlogz": 1.0,
           "check-point-delta-t": 0, "label": "cli"}
    path = root / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return root, str(path)


def _skip_sampling_run(main, config, outdir, **kwargs):
    return main([config, "--skip-sampling", "--outdir", str(outdir),
                 "--injection-outfile", str(outdir / "inj_data.json")],
                **kwargs)


def f64_injection_times(original):
    """The JAX package's create_light_curve_data with its offsets summed
    with the trigger time in float64 (fault 3i: it sums them in f32), so
    both CLIs analyse the same data."""
    def create(injection_parameters, *args, trigger_time=None, **kwargs):
        if trigger_time is None:
            trigger_time = injection_parameters.get("trigger_time", 0.0)
        data = original(injection_parameters, *args, trigger_time=0.0,
                        **kwargs)
        for sub in data.values():
            sub["time"] = np.asarray(sub["time"], np.float64) + trigger_time
        return data
    return create


@pytest.fixture()
def jax_f64_times(monkeypatch):
    """The JAX package's injections with float64 times for this test."""
    import nmma_tpu.injections as j_injections
    monkeypatch.setattr(j_injections, "create_light_curve_data",
                        f64_injection_times(
                            j_injections.create_light_curve_data))


def test_cli_matches_jax(config, jax_f64_times):
    root, path = config
    j_ana = _skip_sampling_run(j_cli.main, path, root / "jax")
    t_ana = _skip_sampling_run(t_cli.main, path, root / "port",
                               device="cpu")
    assert t_ana.model.extinction_law == "G23_MW"
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    assert "Ebv" in t_ana.priors.sampled_names
    assert "em_syserr_optical_2" in t_ana.priors.sampled_names

    want = json.loads((root / "jax" / "inj_data.json").read_text())
    got = json.loads((root / "port" / "inj_data.json").read_text())
    assert sorted(got) == sorted(want) == sorted(FILTERS)
    for f in FILTERS:
        # the JAX package's offsets summed with the trigger in float64
        np.testing.assert_allclose(got[f]["time"], want[f]["time"],
                                   rtol=1e-9)
        np.testing.assert_allclose(got[f]["mag"], want[f]["mag"], rtol=0,
                                   atol=1e-4)
        assert len(got[f]["mag"]) > 100

    u = np.random.default_rng(64).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 12    # a late timeshift leaves the first epochs unmodelled
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)

    def ini_keys(outdir):
        cp = configparser.ConfigParser()
        cp.read(outdir / "cli_config_complete.ini")
        return set(cp["config"])
    assert ini_keys(root / "jax") <= ini_keys(root / "port")


def test_cli_full_run_and_skip_sampling(config):
    root, path = config
    outdir = root / "full"
    ana = t_cli.main([path, "--outdir", str(outdir)], device="cpu")
    assert np.isfinite(ana.result.logz)
    for suffix in ("_result.npz", "_result_meta.json",
                   "_posterior_samples.csv", "_bestfit_params.json",
                   "_checkpoint_resume.npz", "_config_complete.ini"):
        assert (outdir / f"cli{suffix}").exists(), suffix
    (outdir / "cli_result.npz").unlink()
    again = t_cli.main([path, "--outdir", str(outdir), "--skip-sampling"],
                       device="cpu")
    assert again.result.logz == ana.result.logz
    assert again.result.ncall == ana.result.ncall
    assert float(np.load(outdir / "cli_result.npz")["logz"]) == \
        ana.result.logz


def test_logl_at_the_injection_is_finite(config):
    """Faults 3i and 3j: the configuration's injection spans the whole model
    grid, so its first and last epochs sit on the grid's end nodes; with
    the times summed in float64 and one-sided end hats, the logL at the
    injection (the systematics at their priors' midpoints) is finite and
    above the logL of 64 seeded prior points."""
    root, path = config
    ana = t_cli.main([path, "--skip-sampling", "--outdir",
                      str(root / "at_injection")], device="cpu")
    names = ana.priors.sampled_names
    u = [[(INJECTION[n] - ana.priors[n].minimum)
          / (ana.priors[n].maximum - ana.priors[n].minimum)
          if n in INJECTION else 0.5 for n in names]]
    at_injection = float(ana.batched_logl(torch.tensor(u))[0])
    seeded = ana.batched_logl(torch.from_numpy(np.random.default_rng(
        66).uniform(size=(64, len(names))).astype(np.float32)))
    assert at_injection > -1e29
    assert at_injection > float(seeded.max())


def test_bestfit_and_plot_match_jax(config, jax_f64_times):
    """--bestfit (on by default in both packages) on a tiny full run, with
    --plot on the port's: each package writes {label}_bestfit.json with the
    same keys, the same filters and points in its chi^2 table, and None for
    no evidence nowhere; the port's chi^2/dof at its own best fit equals the JAX
    package's compute at that point within 1e-3 + 1e-3 chi^2/dof; the port
    draws {label}_lightcurves.png and {label}_corner.png."""
    import nmma_tpu.plotting as j_plotting

    root, path = config
    flags = ["--nlive", "32", "--n-delete", "16", "--dlogz", "5"]
    t_ana = t_cli.main([path, "--outdir", str(root / "plot_port"), "--plot",
                        *flags], device="cpu")
    # the JAX figures are not compared: its run only writes the report
    j_ana = j_cli.main([path, "--outdir", str(root / "plot_jax"), *flags])
    got = json.loads((root / "plot_port" / "cli_bestfit.json").read_text())
    want = json.loads((root / "plot_jax" / "cli_bestfit.json").read_text())
    assert sorted(got) == sorted(want)
    assert sorted(got["posterior_parameters"]) == \
        sorted(want["posterior_parameters"])
    assert sorted(got["chi2_per_dof"]) == sorted(want["chi2_per_dof"])
    assert got["log_evidence"] == t_ana.result.logz
    assert got["log_likelihood"] == pytest.approx(
        float(t_ana.result.logl.max()))
    jax_chi2 = j_plotting.compute_chisquare_dict(
        j_ana, got["posterior_parameters"])
    for filt, row in got["chi2_per_dof"].items():
        assert row["n_points"] == jax_chi2[filt]["n_points"]
        for key in ("chi2_per_dof", "chi2_per_dof_with_systematics"):
            assert abs(row[key] - jax_chi2[filt][key]) <= \
                1e-3 + 1e-3 * abs(jax_chi2[filt][key])
    for suffix in ("_lightcurves.png", "_corner.png"):
        assert (root / "plot_port" / f"cli{suffix}").stat().st_size > 0


CADENCE_FLAGS = {
    "ztf": ["--ztf-sampling"],
    "rubin": ["--rubin-ToO-type", "platinum"],
}


@pytest.mark.parametrize("case", list(CADENCE_FLAGS))
def test_cadence_options_match_jax(config, case):
    """--ztf-sampling (the ZTF observing model's epochs) and
    --rubin-ToO-type platinum (its epochs in ps1::z and ps1::y, the
    surrogate's only Rubin filters) through both CLIs on an injection at
    trigger 0 with --skip-sampling: the same filters and epochs, magnitudes
    within 1e-4 mag, the same non-detections, and logL at 64 seeded unit
    points within rtol 1e-4 / atol 1e-2 with identical sentinels."""
    root, path = config
    t_injections.write_injection_file(
        root / f"{case}_inj.json",
        {k: [v] for k, v in {**INJECTION, "trigger_time": 0.0}.items()})
    flags = [*CADENCE_FLAGS[case], "--injection",
             str(root / f"{case}_inj.json")]
    runs = {}
    for name, main, kwargs in (("jax", j_cli.main, {}),
                               ("port", t_cli.main, {"device": "cpu"})):
        outdir = root / f"{case}_{name}"
        runs[name] = main([path, "--skip-sampling", "--outdir", str(outdir),
                           "--injection-outfile",
                           str(outdir / "inj_data.json"), *flags], **kwargs)
    want = json.loads((root / f"{case}_jax" / "inj_data.json").read_text())
    got = json.loads((root / f"{case}_port" / "inj_data.json").read_text())
    assert sorted(got) == sorted(want)
    assert set(got) == ({"ztfg", "ztfr", "ztfi"} if case == "ztf"
                        else {"ps1::z", "ps1::y"})
    for f in want:
        np.testing.assert_array_equal(got[f]["time"], want[f]["time"])
        np.testing.assert_allclose(got[f]["mag"], want[f]["mag"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(got[f]["mag_error"],
                                      want[f]["mag_error"])
    t_ana, j_ana = runs["port"], runs["jax"]
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    u = np.random.default_rng(65).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 8
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


NN_PRIOR = """\
log10_mej_dyn = Uniform(minimum=-2.8, maximum=-1.8)
log10_mej_wind = Uniform(minimum=-1.8, maximum=-1.0)
luminosity_distance = 40.0
timeshift = 0.0
"""
NN_INJECTION = {"log10_mej_dyn": -2.3, "log10_mej_wind": -1.3,
                "luminosity_distance": 40.0, "timeshift": 0.0,
                "trigger_time": 60000.0}


def test_neuralnet_sampler_runs_on_the_cpu(tmp_path):
    """--sampler neuralnet in the port (3,000 simulations, 400 epochs,
    20,000 draws: the JAX package's defaults) on the sparse surrogate: the
    result file has the JAX package's keys and the posterior median of
    log10_mej_wind lies near its injection."""
    (tmp_path / "nn.prior").write_text(NN_PRIOR)
    t_injections.write_injection_file(
        tmp_path / "inj.json", {k: [v] for k, v in NN_INJECTION.items()})
    flags = ["--model", "Bu2019lm_nn",
             "--svd-path", "artifacts/Bu2019lm_sparse_svd.npz",
             "--prior", str(tmp_path / "nn.prior"),
             "--injection", str(tmp_path / "inj.json"),
             "--filters", "ztfg,ztfr,ztfi", "--tmin", "0.5", "--tmax", "10",
             "--injection-error-budget", "0.05", "--em-error-budget", "0.1",
             "--n-tsteps", "24",
             "--label", "nn", "--outdir", str(tmp_path / "out")]
    ana = t_cli.main(flags + ["--sampler", "neuralnet"], device="cpu")
    j_ana = j_cli.main(flags + ["--skip-sampling"])
    result = np.load(tmp_path / "out" / "nn_result.npz")
    want = {"sampler"} | {f"posterior_{k}"
                          for k in j_ana.priors.sampled_names}
    assert set(result.files) == want
    assert str(result["sampler"]) == "neuralnet"
    post = result["posterior_log10_mej_wind"]
    assert post.shape == (20000,) and np.isfinite(post).all()
    assert abs(np.median(post) - NN_INJECTION["log10_mej_wind"]) < 0.15
    assert set(ana.lfi_timings) == {"simulate_s", "train_s", "sample_s"}


def test_k1_shape_check():
    """K1's shape check (ops/svd_kernel.py:kernel_route), which the wrapper
    runs before any launch: P from 1 to 16 with any C; the specialised
    instantiations for (4, 10) and (2, 10); P = 17 refused."""
    from nmma_tpu_torch.ops import svd_kernel
    assert svd_kernel.kernel_route(4, 10) == "specialised"
    assert svd_kernel.kernel_route(2, 10) == "specialised"
    for p in range(1, 17):
        for c in (1, 6, 8, 10, 40, 1000):
            want = "specialised" if (p, c) in ((4, 10), (2, 10)) \
                else "general"
            assert svd_kernel.kernel_route(p, c) == want
    for p, c in ((17, 10), (0, 10), (4, 0)):
        with pytest.raises(ValueError):
            svd_kernel.kernel_route(p, c)


def sky_map_flags(root, case):
    """The flags of the sky-map and fiesta options on the [cli] config,
    with the files they read written under ``root``."""
    from nmma_tpu_torch.io.fits import write_bintable
    from test_torch_fits import skymap_columns

    if case == "fits":
        write_bintable(str(root / "skymap.fits"), skymap_columns(),
                       extra_header={"MOC": True})
        return ["--fits-file", str(root / "skymap.fits"), "--dL", "40",
                "--ra", "197.45", "--dec", "-23.38"]
    if case == "limit_fits":
        limmag = np.random.default_rng(8).uniform(19.0, 21.0, 12 * 16**2)
        write_bintable(str(root / "limits.fits"), {"LIMMAG": limmag},
                       extra_header={"NSIDE": 16, "ORDERING": "NESTED"})
        return ["--detection-limit-fits-file", str(root / "limits.fits"),
                "--ra", "120.0", "--dec", "-30.0"]
    # with --svd-path the surrogate is the SVD one in both packages
    (root / "surrogates").mkdir(exist_ok=True)
    return ["--fiesta-surrogates-dir", str(root / "surrogates")]


@pytest.mark.parametrize("case", ["fits", "limit_fits", "fiesta_dir"])
def test_sky_map_and_fiesta_options_match_jax(config, case, jax_f64_times):
    """--fits-file (the sky map's inclination prior at --dL, --ra, --dec),
    --detection-limit-fits-file (the m4opt limit at --ra, --dec) and
    --fiesta-surrogates-dir beside --svd-path, in both packages with
    --skip-sampling: the same priors, detection limit and logL at 64
    seeded unit points (rtol 1e-4, atol 1e-2, identical sentinels). The
    JAX package is handed the map's limit as --detection-limit too."""
    root, path = config
    flags = sky_map_flags(root, case)
    t_ana = t_cli.main([path, "--skip-sampling", "--outdir",
                        str(root / f"{case}_port"), *flags], device="cpu")
    j_flags = flags
    if case == "limit_fits":
        # the JAX package reads the map after making the injection (fault
        # 3e); given the map's limit as --detection-limit, its injection
        # sees the limit as the port's does
        j_flags = [*flags, "--detection-limit",
                   repr(t_ana.config.detection_limit)]
    j_ana = j_cli.main([path, "--skip-sampling", "--outdir",
                        str(root / f"{case}_jax"), *j_flags])
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    assert t_ana.config.detection_limit == j_ana.config.detection_limit
    if case == "fits":
        got = t_ana.priors["inclination_EM"]
        want = j_ana.priors.priors["inclination_EM"]
        np.testing.assert_allclose(got.xx, np.asarray(want.xx), rtol=1e-6)
        np.testing.assert_allclose(got.yy, np.asarray(want.yy), rtol=1e-6)
    if case == "limit_fits":
        assert 19.0 <= t_ana.config.detection_limit <= 21.0
    u = np.random.default_rng(65).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 12
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def test_detection_limit_map_reaches_the_injection(config):
    """Fault 3e: the m4opt map's limit (20.94 mag everywhere) is read
    before the injection is made, so the injected photometry and the
    likelihood both see it: the logL at the injection equals the
    --detection-limit 20.94 run's and is negative (the JAX package, which
    reads the map after the injection, gives it a large positive logL)."""
    from nmma_tpu_torch.io.fits import write_bintable

    root, path = config
    write_bintable(str(root / "limit_2094.fits"),
                   {"LIMMAG": np.full(12 * 16**2, 20.94)},
                   extra_header={"NSIDE": 16, "ORDERING": "NESTED"})
    at_injection = {}
    for case, flags in (
            ("map", ["--detection-limit-fits-file",
                     str(root / "limit_2094.fits"), "--ra", "120.0",
                     "--dec", "-30.0"]),
            ("flag", ["--detection-limit", "20.94"])):
        ana = t_cli.main([path, "--skip-sampling", "--outdir",
                          str(root / f"limit_{case}"), *flags],
                         device="cpu")
        assert ana.config.detection_limit == pytest.approx(20.94)
        names = ana.priors.sampled_names
        u = [[(INJECTION[n] - ana.priors[n].minimum)
              / (ana.priors[n].maximum - ana.priors[n].minimum)
              if n in INJECTION else 0.5 for n in names]]
        at_injection[case] = float(ana.batched_logl(torch.tensor(u))[0])
    assert -1e29 < at_injection["flag"] < 0.0
    assert at_injection["map"] == pytest.approx(at_injection["flag"],
                                                rel=1e-6)


def test_unported_entry_points_name_their_items(config, tmp_path):
    root, path = config
    # a model name neither registered nor found as a fiesta surrogate is
    # unknown in both packages
    for main, kwargs in ((j_cli.main, {}), (t_cli.main, {"device": "cpu"})):
        with pytest.raises(KeyError, match="Fiesta_kn_model"):
            main([path, "--svd-path", "", "--model", "Fiesta_kn_model",
                  "--outdir", str(tmp_path), "--skip-sampling"], **kwargs)
    with pytest.raises(RuntimeError, match="dustmaps"):
        t_cli.main([path, "--outdir", str(tmp_path),
                    "--fetch-Ebv-from-dustmap", "--skip-sampling"],
                   device="cpu")


def test_cli_device_flag_and_default(config):
    """``--device cpu`` is main(..., device='cpu'); the complete config
    records the device."""
    root, path = config
    outdir = root / "flag"
    ana = t_cli.main([path, "--device", "cpu", "--outdir", str(outdir),
                      "--skip-sampling"])
    assert ana.device == torch.device("cpu")
    assert "device = cpu" in (outdir / "cli_config_complete.ini").read_text()


def test_svd_mag_ncoeff_matches():
    """``--svd-mag-ncoeff 6``: the port zeroes the dropped coefficients so
    K1 keeps C=10, the JAX package slices them away; the detector-frame
    magnitudes agree within 1e-4 mag at 16 seeded draws."""
    import jax

    import nmma_tpu.models as j_models
    import nmma_tpu.models.svd as j_svd
    import nmma_tpu_torch.models as t_models
    import nmma_tpu_torch.models.svd as t_svd

    j_svd.make_svd_source_model("Bu2019lm_c6", j_svd.SVDModelData.load(ART),
                                mag_ncoeff=6)
    port = t_svd.SVDModelData.load(ART, device="cpu")
    t_svd.make_svd_source_model("Bu2019lm_c6", port, mag_ncoeff=6)
    assert port.w2.abs().sum() > 0     # the loaded surrogate is untouched
    grid = np.geomspace(0.25, 12.0, 80)
    j_det = j_models.DetectorLightCurveModel("Bu2019lm_c6", FILTERS,
                                             sample_times=grid)
    t_det = t_models.DetectorLightCurveModel("Bu2019lm_c6", FILTERS,
                                             sample_times=grid,
                                             device="cpu")
    rng = np.random.default_rng(6)
    lo = np.array([-3.0, -2.0, 15.0, 0.0, 1.0])
    hi = np.array([-1.0, -0.5, 75.0, 90.0, 200.0])
    theta = rng.uniform(lo, hi, (16, 5)).astype(np.float32)
    names = ["log10_mej_dyn", "log10_mej_wind", "KNphi", "KNtheta",
             "luminosity_distance"]
    want = np.asarray(jax.vmap(lambda th: j_det(
        {n: th[i] for i, n in enumerate(names)})[1])(jnp.asarray(theta)))
    got = t_det({n: torch.from_numpy(theta[:, i])
                 for i, n in enumerate(names)})[1].numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


def test_photometry_io_helpers_match(tmp_path):
    """Trigger-time conversions, the model-table reader and the SkyPortal
    converter give the JAX package's values and files."""
    import nmma_tpu.io.photometry as j_io
    import nmma_tpu_torch.io.photometry as t_io

    for gps in (1187008882.43, 1e9, 1.4e9):
        assert t_io.gps_to_mjd(gps) == j_io.gps_to_mjd(gps)
        mjd = j_io.gps_to_mjd(gps)
        assert t_io.mjd_to_gps(mjd) == j_io.mjd_to_gps(mjd)
    for kwargs in ({"parameters": {"geocent_time": 1187008882.43}},
                   {"trigger_time": "2017-08-17T12:41:04.4"},
                   {"trigger_time": 1187008882.43, "time_format": "gps"},
                   {"trigger_time": 57982.5, "out_format": "gps"}, {}):
        assert t_io.read_trigger_time(**kwargs) == \
            j_io.read_trigger_time(**kwargs)
    table = tmp_path / "model.dat"
    table.write_text("time ztfg ztfr ztfg_error\n0.5 20.1 20.4 0.05\n"
                     "1.0 20.6 20.8 0.07\n")
    got = t_io.load_em_observations(str(table), format="model")
    want = j_io.load_em_observations(str(table), format="model")
    assert sorted(got) == sorted(want) == ["ztfg", "ztfr"]
    for f in want:
        for k in ("time", "mag", "mag_error"):
            np.testing.assert_array_equal(got[f][k], want[f][k])
    csv = tmp_path / "skyportal.csv"
    csv.write_text("mjd,filter,mag,magerr,limiting_mag\n"
                   "60000.5,ztfg,19.5,0.1,21.0\n60001.5,ztfr,,,20.5\n")
    out_t = t_io.convert_skyportal_lcs(str(csv), str(tmp_path / "t.dat"))
    out_j = j_io.convert_skyportal_lcs(str(csv), str(tmp_path / "j.dat"))
    assert open(out_t).read() == open(out_j).read()


def test_cli_mcmc_writes_the_jax_keys(config):
    """--sampler mcmc at a tiny size in both packages: the same result-file
    keys and csv columns, and the port's n_call; --skip-sampling stops
    before any sweep (nmma_tpu/cli/lightcurve_analysis.py:211-240)."""
    root, path = config
    flags = ["--sampler", "mcmc", "--mcmc-walkers", "32", "--mcmc-sweeps",
             "6"]
    j_cli.main([path, "--outdir", str(root / "mcmc_jax"), *flags])
    ana = t_cli.main([path, "--outdir", str(root / "mcmc_port"), *flags],
                     device="cpu")
    res = ana.mcmc_result
    assert res.n_call == 6 * 32 + 32
    assert np.isfinite(res.acceptance) and res.samples_u.shape[1] == 11
    want = np.load(root / "mcmc_jax" / "cli_mcmc_result.npz")
    got = np.load(root / "mcmc_port" / "cli_mcmc_result.npz")
    assert sorted(got.files) == sorted(want.files)
    assert int(got["ncall"]) == int(want["ncall"])
    assert got["posterior_log10_mej_dyn"].shape == \
        want["posterior_log10_mej_dyn"].shape

    def columns(outdir):
        with open(outdir / "cli_mcmc_posterior_samples.csv") as f:
            return set(f.readline().strip().split(","))
    assert columns(root / "mcmc_port") == columns(root / "mcmc_jax")
    skipped = t_cli.main([path, "--outdir", str(root / "mcmc_skip"), *flags,
                          "--skip-sampling"], device="cpu")
    assert not hasattr(skipped, "mcmc_result")
    assert not (root / "mcmc_skip" / "cli_mcmc_result.npz").exists()


def test_run_mcmc_matches_the_nested_posterior(config):
    """EMAnalysis.run_mcmc on the CLI's photometry with the two ejecta
    masses free and the rest fixed (no systematics): R-hat, a finite logL
    for every kept draw, and the posterior medians and widths against a
    nested run on the same likelihood (the two samplers share nothing but
    the likelihood). The rest is fixed at 80 Mpc and timeshift -0.05 d,
    where the logL is finite on the whole mass square; at the injection's
    40 Mpc and 0 d this configuration's logL is the -1e30 sentinel in both
    packages. The full configuration has ~70% of its prior volume at the
    sentinel, which holds some untempered walkers on that plateau in both
    packages (max R-hat ~5 after 2,000 sweeps); chip_smoke.py's [mcmc]
    runs it with a tempering ladder."""
    from nmma_tpu_torch.inference import EnsembleMCMCConfig
    root, path = config
    fixed = {k: v for k, v in INJECTION.items()
             if k not in ("log10_mej_dyn", "log10_mej_wind", "trigger_time")}
    fixed.update(luminosity_distance=80.0, timeshift=-0.05)
    (root / "two.prior").write_text(
        PRIOR.splitlines()[0] + "\n" + PRIOR.splitlines()[1] + "\n"
        + "".join(f"{k} = {v}\n" for k, v in fixed.items()))
    cfg = yaml.safe_load(open(path))
    cfg.update({"prior": str(root / "two.prior"), "ebv-max": 0.0,
                "nlive": 256, "dlogz": 0.1})
    del cfg["systematics-file"]
    two = root / "two.yaml"
    two.write_text(yaml.safe_dump(cfg))
    ana = _skip_sampling_run(t_cli.main, str(two), root / "run_mcmc",
                             device="cpu")
    assert ana.priors.sampled_names == ["log10_mej_dyn", "log10_mej_wind"]
    post = ana.run_mcmc(EnsembleMCMCConfig(walkers=32, sweeps=1500, seed=3),
                        verbose=False)
    assert (root / "run_mcmc" / "cli_mcmc_posterior_samples.csv").exists()
    assert np.nanmax(ana.mcmc_result.rhat) < 1.1, ana.mcmc_result.rhat
    assert (ana.mcmc_result.logl > -1e29).all()
    ref = t_cli.main([str(two), "--outdir", str(root / "run_mcmc_ns")],
                     device="cpu").posterior_samples()
    for key in ("log10_mej_dyn", "log10_mej_wind"):
        scale = np.std(ref[key])
        print(key, np.median(post[key]), np.median(ref[key]),
              np.std(post[key]), scale)
        assert abs(np.median(post[key]) - np.median(ref[key])) < 0.3 * scale
        assert abs(np.std(post[key]) / scale - 1.0) < 0.2


def test_lbol_main_needs_its_csv_columns(tmp_path):
    """lbol_main, ported, reads phase, Lbb and Lbb_unc by name (numpy's
    genfromtxt): a csv without them is refused."""
    csv = tmp_path / "bad.csv"
    csv.write_text("time,L\n1.0,1e42\n2.0,2e42\n")
    prior = tmp_path / "a.prior"
    prior.write_text("tau_m = Uniform(minimum=5., maximum=30.)\n"
                     "log10_mni = Uniform(minimum=-2., maximum=0.)\n")
    with pytest.raises(ValueError, match="phase"):
        t_cli.lbol_main(["--prior", str(prior), "--light-curve-data",
                         str(csv), "--outdir", str(tmp_path)], device="cpu")
