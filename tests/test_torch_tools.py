"""The port's secondary command lines (``nmma_tpu_torch/cli/tools.py``) and
``cluster.py`` against the JAX package's, on the same files.

Each entry point runs through both packages on files written under
``tmp_path``. Where the packages draw from different generators
(``jax.random`` against ``torch.Generator`` in ``InjectionCreator``, the
nested samplers), the comparison is on fixed inputs: the port's draws go
through the JAX package's conversion chain, and a sampler's output is
compared by its written columns and by both likelihoods at seeded points.
Host-only tools (the H0 and EOS combiners, the SkyPortal converter,
nmma-make-lcs, the job scripts) must give the JAX package's files.
Tolerances: magnitudes 1e-4 mag (K1 on the CPU); times 1e-6 relative
(f32 model grids); conversions 1e-5; resampler logL rtol 1e-4 / atol 1e-3.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import nmma_tpu.cli.tools as j_tools
import nmma_tpu.models.svd as j_svd
import nmma_tpu_torch.cli.tools as t_tools
import nmma_tpu_torch.models.svd as t_svd
from nmma_tpu_torch.injections import read_injection_file, write_injection_file
from test_torch_eos import write_macro_set

torch.set_num_threads(1)

ART = "artifacts/Bu2019lm_production_svd.npz"
MODEL = "Bu2019lm_tools"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BNS_PRIOR = (
    "chirp_mass = Uniform(minimum=1.18, maximum=1.21)\n"
    "mass_ratio = Uniform(minimum=0.6, maximum=1.0)\n"
    "luminosity_distance = Uniform(minimum=10., maximum=100.)\n"
    "ratio_zeta = Uniform(minimum=0., maximum=0.5)\n"
    "alpha = 5e-5\ntheta_jn = 0.4\n")
EOS_LINE = "EOS = Uniform(minimum=0., maximum=10.)\n"
QUR_LINES = ("lambda_1 = Uniform(minimum=200., maximum=800.)\n"
             "lambda_2 = Uniform(minimum=300., maximum=1200.)\n"
             "TOV_mass = Uniform(minimum=2.0, maximum=2.4)\n")


@pytest.fixture(scope="module")
def surrogate():
    j_svd.make_svd_source_model(MODEL, j_svd.SVDModelData.load(ART))
    t_svd.make_svd_source_model(MODEL, t_svd.SVDModelData.load(
        ART, device="cpu"))
    return MODEL


@pytest.fixture(scope="module")
def eos_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_eos")
    write_macro_set(root)
    return str(root)


def test_every_jax_entry_point_has_a_counterpart():
    names = {n for n in dir(j_tools) if callable(getattr(j_tools, n))
             and getattr(getattr(j_tools, n), "__module__", "")
             == j_tools.__name__}
    missing = names - set(dir(t_tools))
    assert not missing
    assert len(t_tools.COMMANDS) == 16
    assert t_tools.COMMANDS["plot-svdmodel-benchmarks"] is \
        t_tools.plot_svdmodel_benchmarks


def test_lightcurve_generation_matches_jax(surrogate, tmp_path):
    rows = {"log10_mej_dyn": [-2.0, -2.5, -1.6], "log10_mej_wind":
            [-1.2, -1.0, -1.5], "KNphi": [45.0, 30.0, 60.0],
            "KNtheta": [30.0, 10.0, 70.0],
            "luminosity_distance": [40.0, 80.0, 150.0],
            "timeshift": [0.0, 0.05, -0.1]}
    write_injection_file(tmp_path / "inj.json", rows)
    flags = ["--model", surrogate, "--injection", str(tmp_path / "inj.json"),
             "--filters", "ztfg,ztfr,2massks", "--tmin", "0.5", "--tmax",
             "11", "--detection-limit", "22.5"]
    j_tools.lightcurve_generation(flags + ["--outdir", str(tmp_path / "j")])
    paths = t_tools.lightcurve_generation(
        flags + ["--outdir", str(tmp_path / "t")], device="cpu")
    assert [os.path.basename(p) for p in paths] == \
        [f"injection_{i}.json" for i in range(3)]
    n_limits = 0
    for path in paths:
        got = json.loads(open(path).read())
        want = json.loads(open(tmp_path / "j" / os.path.basename(path))
                          .read())
        assert sorted(got) == sorted(want) == ["2massks", "ztfg", "ztfr"]
        for f in want:
            np.testing.assert_allclose(got[f]["time"], want[f]["time"],
                                       rtol=1e-6)
            np.testing.assert_allclose(got[f]["mag"], want[f]["mag"],
                                       rtol=0, atol=1e-4)
            assert got[f]["mag_error"] == want[f]["mag_error"]
            n_limits += sum(e == float("inf") for e in got[f]["mag_error"])
    assert n_limits > 0


def jax_chain(eos_dir):
    from nmma_tpu import conversion as C
    if eos_dir:
        from nmma_tpu.eos import load_macro_eos_set
        middle = load_macro_eos_set(eos_dir)
    else:
        middle = C.radii_from_qur
    return C.MultimessengerConversion(C.bns_source_frame, middle,
                                      C.KilonovaEjectaFitting())


@pytest.mark.parametrize("case", ["plain", "qur", "eos"])
def test_create_injection_matches_jax(tmp_path, eos_dir, case):
    """nmma-create-injection: the port's draws through the JAX package's
    conversion give the port's derived columns; without a tabulated EOS
    both packages write the same columns."""
    prior = BNS_PRIOR + (EOS_LINE if case == "eos" else QUR_LINES)
    (tmp_path / "bns.prior").write_text(prior)
    flags = ["--prior-file", str(tmp_path / "bns.prior"), "--n-injection",
             "24", "--generation-seed", "5"]
    if case != "plain":
        flags.append("--ejecta-conversion")
    if case == "eos":
        flags += ["--eos-dir", eos_dir]
    got = t_tools.create_injection(flags + ["-f", str(tmp_path / "t.json")],
                                   device="cpu")
    table = read_injection_file(tmp_path / "t.json")
    assert set(table) == set(got) | {"simulation_id"}
    assert len(table["chirp_mass"]) == 24
    assert np.all((table["chirp_mass"] >= 1.18)
                  & (table["chirp_mass"] <= 1.21))
    if case != "eos":
        # JAX's creator calls its one-sample chain on a batch with a
        # tabulated EOS (ROADMAP 3d): only the other cases run in both
        j_tools.create_injection(flags + ["-f", str(tmp_path / "j.json")])
        assert set(read_injection_file(tmp_path / "j.json")) == set(table)
    if case == "plain":
        return
    assert np.all(np.isfinite(table["log10_mej_dyn"]))
    from nmma_tpu_torch.priors import load_prior_file
    sampled = list(load_prior_file(str(tmp_path / "bns.prior")).keys())
    want = jax.vmap(jax_chain(eos_dir if case == "eos" else None))(
        {k: jnp.asarray(table[k], dtype=jnp.float32) for k in sampled})
    for k in ("mass_1_source", "mass_2_source", "radius_1", "radius_2",
              "log10_mej_dyn", "log10_mej_wind"):
        np.testing.assert_allclose(table[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def write_posteriors(root, n=1500, seed=9):
    from nmma_tpu_torch.io.results import save_posterior_csv
    rng = np.random.default_rng(seed)
    gw = {"chirp_mass": rng.normal(1.1977, 0.001, n),
          "mass_ratio": rng.uniform(0.7, 1.0, n),
          "luminosity_distance": rng.normal(40.0, 4.0, n),
          "EOS": rng.uniform(0.0, 10.0, n)}
    em = {"log10_mej_dyn": rng.normal(-2.2, 0.2, n),
          "log10_mej_wind": rng.normal(-1.6, 0.2, n),
          "luminosity_distance": rng.normal(42.0, 5.0, n)}
    save_posterior_csv(str(root / "gw.csv"), gw)
    save_posterior_csv(str(root / "em.csv"), em)
    return str(root / "gw.csv"), str(root / "em.csv")


def test_gwem_resampling_matches_jax(tmp_path, eos_dir, monkeypatch):
    """gwem-resampling capped at 20 iterations in both packages: the same
    columns, inside the priors; both packages' resamplers, built from the
    files as the tools build them, agree on logL at 64 seeded points."""
    from nmma_tpu import eos as j_eos
    from nmma_tpu.io.results import load_posterior as j_load
    from nmma_tpu.post_processing import GWEMResampler as JGWEM
    from nmma_tpu_torch import eos as t_eos
    from nmma_tpu_torch.io.results import load_posterior as t_load
    from nmma_tpu_torch.post_processing import GWEMResampler
    from test_torch_post_processing import assert_logl_match, unit_points

    gw, em = write_posteriors(tmp_path)
    flags = ["--GWsamples", gw, "--EMsamples", em, "--EOS-data", eos_dir,
             "--nlive", "64"]
    run = JGWEM.run
    monkeypatch.setattr(JGWEM, "run", lambda self, **kw: run(
        self, max_iter=20, **kw))
    j_tools.gwem_resampling(flags + ["--outdir", str(tmp_path / "j")])
    result, post = t_tools.gwem_resampling(
        flags + ["--outdir", str(tmp_path / "t")], device="cpu",
        sampler_kwargs={"max_iter": 20})
    assert result.niter == 20 and np.isfinite(result.logz)
    path = "gwem_resampling_posterior_samples.csv"
    with open(tmp_path / "t" / path) as f, open(tmp_path / "j" / path) as g:
        assert f.readline() == g.readline()
    t_rs = GWEMResampler(t_load(gw), t_load(em),
                         t_eos.load_macro_eos_set(eos_dir), device="cpu")
    j_rs = JGWEM(j_load(gw), j_load(em), j_eos.load_macro_eos_set(eos_dir))
    for k, prior in t_rs.priors.priors.items():
        assert prior.minimum <= post[k].min() <= post[k].max() \
            <= prior.maximum, k
    assert_logl_match(t_rs, j_rs, unit_points(t_rs.priors.ndim))


def test_hubble_estimate_matches_jax(tmp_path):
    gw, em = write_posteriors(tmp_path)
    em2 = str(tmp_path / "em2.csv")
    from nmma_tpu_torch.io.results import save_posterior_csv
    save_posterior_csv(em2, {"luminosity_distance": np.random.default_rng(
        2).normal(80.0, 8.0, 1500)})
    base = ["--posterior-files", f"{em},{em2}", "--redshifts",
            "0.0098,0.019", "--N-reordering", "2",
            "--N-posterior-samples", "300", "--N-prior-samples", "200"]
    for name, tools in (("j", j_tools), ("t", t_tools)):
        tools.gwem_hubble_estimate(base + ["--outdir", str(tmp_path / name)])
        tools.gwem_hubble_estimate(base + [
            "--gw-posterior-files", f"{gw},{gw}", "--outdir",
            str(tmp_path / name), "--label", "trend"])
    got = np.load(tmp_path / "t" / "hubble_H0.npz")
    want = np.load(tmp_path / "j" / "hubble_H0.npz")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    trend = "GW_EM_H0_trend_trend.dat"
    assert open(tmp_path / "t" / trend).readline() == \
        open(tmp_path / "j" / trend).readline()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / trend, skiprows=1),
                               np.loadtxt(tmp_path / "j" / trend, skiprows=1),
                               rtol=1e-6)


def test_combine_eos_matches_jax(tmp_path, eos_dir):
    gw, _ = write_posteriors(tmp_path)
    from nmma_tpu_torch.io.results import save_posterior_csv
    only = str(tmp_path / "eos_only.csv")
    save_posterior_csv(only, {"EOS": np.random.default_rng(3).uniform(
        0.0, 10.0, 800)})
    for extra in ([], ["--no-flat-mass-reweight"]):
        for name, tools in (("j", j_tools), ("t", t_tools)):
            tools.combine_eos(["--posterior-files", f"{gw},{only}",
                               "--eos-data", eos_dir, "--outdir",
                               str(tmp_path / name), *extra])
        got = np.load(tmp_path / "t" / "combined_eos.npz")
        want = np.load(tmp_path / "j" / "combined_eos.npz")
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)


def test_convert_skyportal_matches_jax(tmp_path):
    csv = tmp_path / "sp.csv"
    csv.write_text(
        "mjd,filter,mag,magerr,limiting_mag\n"
        "60000.5,ztfg,19.5,0.05,21.0\n"
        "60001.5,ztfr,,,20.8\n"
        "60002.25,ztfi,20.1,0.12,21.2\n")
    outs = {name: tools.convert_skyportal(
        ["--csv-file", str(csv), "--outfile", str(tmp_path / f"{name}.dat")])
        for name, tools in (("j", j_tools), ("t", t_tools))}
    assert open(outs["t"]).read() == open(outs["j"]).read()


def test_make_lcs_matches_jax(tmp_path):
    from test_torch_radiative import write_possis_ascii
    modeldir = tmp_path / "model"
    modeldir.mkdir()
    write_possis_ascii(str(modeldir / "nph1e6_mej0.05.txt"))
    flags = ["--modeldir", str(modeldir), "--filters", "ztfg,ztfr,2massj",
             "--dMpc", "40"]
    j_tools.make_lcs(flags + ["--lcdir", str(tmp_path / "j")])
    written = t_tools.make_lcs(flags + ["--lcdir", str(tmp_path / "t")])
    assert written
    for path in written:
        want = tmp_path / "j" / os.path.basename(path)
        assert open(path).readline() == open(want).readline()
        g, w = np.loadtxt(path, skiprows=1), np.loadtxt(want, skiprows=1)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)],
                                   rtol=1e-6)


def test_job_scripts_match_jax(tmp_path):
    """The slurm tools write the JAX package's files (the injection values
    aside: different generators); the analysis sbatch script differs only
    in the GPU directive and the command."""
    from nmma_tpu import cluster as j_cluster
    from nmma_tpu_torch import cluster as t_cluster
    (tmp_path / "bns.prior").write_text(BNS_PRIOR)
    (tmp_path / "job.sh").write_text(
        "#!/bin/bash\nlightcurve-analysis --prior PRIOR --outdir OUTDIR "
        "--injection-outfile INJOUT --injection-num INJNUM\n")
    (tmp_path / "lc.sh").write_text("lightcurve-generation --range "
                                    "INJRANGE\n")
    rows = {"luminosity_distance": list(np.linspace(10, 100, 7))}
    write_injection_file(tmp_path / "inj.json", rows)
    scripts = {}
    for name, tools, kw in (("j", j_tools, {}), ("t", t_tools,
                                                  {"device": "cpu"})):
        out = str(tmp_path / name)
        setup = tools.injection_slurm_setup(
            ["--prior-file", str(tmp_path / "bns.prior"), "--analysis-file",
             str(tmp_path / "job.sh"), "--n-injection", "3", "--outdir",
             out], **kw)
        batches = tools.create_lightcurve_slurm(
            ["--injection", str(tmp_path / "inj.json"), "--analysis-file",
             str(tmp_path / "lc.sh"), "--n-per-job", "3", "--outdir",
             out + "_lc"])
        scripts[name] = [open(p).read().replace(out, "OUT")
                         for p in setup + batches]
        for i in range(3):
            assert open(os.path.join(out, str(i), "injection.prior")).read() \
                == BNS_PRIOR
        keys = set(read_injection_file(os.path.join(out, "0",
                                                    "injection.json")))
        scripts[name].append(sorted(keys))
    assert scripts["t"] == scripts["j"]
    assert len(scripts["t"]) == 3 + 3 + 1
    assert "--range 6,7" in scripts["t"][5]

    want = open(j_cluster.slurm_analysis_script(
        "--model $MODEL --data $DATA", outdir=str(tmp_path / "sj"),
        tpu_type="v5litepod-8", n_array=4, extra_lines=["module load x"],
    )).read().splitlines()
    got = open(t_cluster.slurm_analysis_script(
        "--model $MODEL --data $DATA", outdir=str(tmp_path / "sj"),
        n_array=4, extra_lines=["module load x"])).read().splitlines()
    assert len(got) == len(want)
    diff = [(g, w) for g, w in zip(got, want) if g != w]
    assert diff == [
        ("#SBATCH --gres=gpu:1", "#SBATCH --gres=tpu:v5litepod-8"),
        ("python -m nmma_tpu_torch.cli.lightcurve_analysis --model $MODEL "
         "--data $DATA", "lightcurve-analysis --model $MODEL --data $DATA")]


def test_multi_config_runs_the_port(tmp_path):
    """multi-config-analysis: --dry-run gives the JAX package's argv lists;
    a real run starts the port's CLI in a subprocess (device: cpu in the
    yaml), rc 0, and writes its result."""
    from nmma_tpu_torch.injections import write_injection_file as write
    (tmp_path / "bu.prior").write_text(
        "log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)\n"
        "log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)\n"
        "KNphi = 45.0\nKNtheta = 30.0\nluminosity_distance = 40.0\n"
        "timeshift = 0.0\n")
    write(tmp_path / "inj.json", {"log10_mej_dyn": [-2.0],
                                  "log10_mej_wind": [-1.2], "KNphi": [45.0],
                                  "KNtheta": [30.0],
                                  "luminosity_distance": [40.0],
                                  "timeshift": [0.0]})
    run = {"model": "Bu2019lm_multi", "svd_path": os.path.join(REPO, ART),
           "prior": str(tmp_path / "bu.prior"),
           "injection": str(tmp_path / "inj.json"),
           "filters": "ztfg,ztfr", "tmin": 0.5, "tmax": 11.0,
           "n_tsteps": 40, "nlive": 32, "dlogz": 20.0, "walks": 2,
           "outdir": str(tmp_path / "out"), "device": "cpu",
           "check_point_delta_t": 1e6, "local_only": True}
    (tmp_path / "runs.yaml").write_text(yaml.safe_dump({"first": run}))
    dry = ["--config", str(tmp_path / "runs.yaml"), "--dry-run"]
    assert t_tools.multi_config(dry) == j_tools.multi_config(dry)
    out = t_tools.multi_config(["--config", str(tmp_path / "runs.yaml")])
    assert out == [("first", 0)]
    assert (tmp_path / "out" / "first_result.npz").exists()


def test_commands_run_as_a_module(tmp_path):
    """python -m nmma_tpu_torch.cli.tools <console-script name>."""
    rows = {"luminosity_distance": list(np.linspace(10, 100, 5))}
    write_injection_file(tmp_path / "inj.json", rows)
    (tmp_path / "lc.sh").write_text("run INJRANGE\n")
    proc = subprocess.run(
        [sys.executable, "-m", "nmma_tpu_torch.cli.tools",
         "create-lightcurve-slurm", "--injection", str(tmp_path / "inj.json"),
         "--analysis-file", str(tmp_path / "lc.sh"), "--n-per-job", "2",
         "--outdir", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert open(tmp_path / "out" / "inference_2.sh").read() == "run 4,5\n"
