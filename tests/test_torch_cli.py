"""The port's ``lightcurve-analysis`` CLI against the JAX package's.

One yaml config drives both ``main``s: the production Bu2019lm surrogate
(``--svd-path``), photometry synthesised from an injection json, a yaml
systematics file with time nodes on one filter group, the linear-decay Ebv
prior of ``--Ebv-max`` and G23-MW extinction. With ``--skip-sampling``
each assembles its analysis and stops; then

* the injection photometry each writes (``--injection-outfile``) agrees
  within 1e-4 mag (the K1 tolerance; both draw the noise from
  ``np.random.default_rng(seed)`` in the same order), at the same times;
* ``batched_logl`` at 64 seeded unit points agrees within rtol 1e-4 and
  atol 1e-2 with identical -1e30 sentinels (the bounds of
  tests/test_torch_em_slice.py);
* the port's complete-config file has every key of the JAX package's.

A tiny full run of the port's CLI (nlive 64, dlogz 1) writes every result
file and its checkpoint, and ``--skip-sampling`` regenerates its logZ from
the checkpoint bit for bit. ``--sampler mcmc`` writes the JAX package's
result keys in both packages, and ``EMAnalysis.run_mcmc`` agrees with a
nested run on the posterior medians. Each option whose module the port
does not have yet raises NotImplementedError naming its ROADMAP item.
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
from nmma_tpu_torch.priors import astro as t_astro

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


def test_cli_matches_jax(config):
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


UNPORTED = {
    "neuralnet": (["--sampler", "neuralnet"], 18),
    "fits": (["--fits-file", "skymap.fits"], 17),
    "limit_fits": (["--detection-limit-fits-file", "limits.fits"], 17),
    "bestfit": (["--bestfit"], 19),
    "plot": (["--plot"], 19),
    "fiesta_dir": (["--fiesta-surrogates-dir", "surrogates"], 14),
    "ztf": (["--ztf-sampling"], 19),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_options_name_their_item(config, case):
    root, path = config
    flags, item = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        t_cli.main([path, "--outdir", str(root / case), "--skip-sampling",
                    *flags], device="cpu")


def test_unported_entry_points_name_their_items(config, tmp_path):
    root, path = config
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        t_cli.main([path, "--svd-path", "", "--model", "Fiesta_kn_model",
                    "--skip-sampling"], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        t_astro.inclination_prior_from_fits("skymap.fits", dL=40.0)
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
