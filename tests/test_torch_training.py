"""The port's surrogate training (``nmma_tpu_torch.training.svd``, ``grids``
and ``cli/tools.py``) against the JAX package's, on the CPU.

The grid is made here: 24 points of the sparse Bu2019lm surrogate
(``artifacts/Bu2019lm_sparse_svd.npz``, 9 filters) evaluated through the
JAX package's model, written as bulla ``.dat`` files to a temporary
directory. Tolerances:

* filename parsing of every grid family: equal;
* the interpolated grid: rtol 1e-6 (the JAX package interpolates in f32;
  XLA may contract one multiply-add, an ulp);
* normalisation and SVD on the same input: equal;
* 20 epochs continued from the JAX package's initial weights: atol 1e-5 on
  the weights (measured 7e-7; the same adam in another f32 order);
* a surrogate saved by either package loads in the other with magnitudes
  within 1e-4 mag (the K1 tolerance);
* the benchmark's chi^2 percentiles: rtol 1e-4.
"""

import glob
import json

import jax
import numpy as np
import pytest
import torch

import nmma_tpu.training.svd as j_svd
import nmma_tpu_torch.training.svd as t_svd
from nmma_tpu.models.svd import SVDModelData as JaxSVD
from nmma_tpu.models.svd import svd_surrogate_mags
from nmma_tpu_torch.cli import tools as t_tools
from nmma_tpu_torch.models.svd import SVDModelData

torch.set_num_threads(1)

SPARSE = "artifacts/Bu2019lm_sparse_svd.npz"
N_GRID = 24
GRID_T = np.linspace(0.1, 14.0, 40)
CFG = dict(n_coeff=6, hidden=32, tmin=0.2, tmax=12.0, n_tsteps=30)


def jax_grid(n, seed=0):
    """(params {name: [n]}, mags [n, F, T]) of the sparse surrogate at n
    seeded points inside its bounds, through the JAX package's model."""
    svd = JaxSVD.load(SPARSE)
    theta = np.random.default_rng(seed).uniform(
        svd.param_mins, svd.param_maxs, (n, len(svd.parameter_names)))
    params = {k: theta[:, i] for i, k in enumerate(svd.parameter_names)}
    mags = jax.vmap(lambda p: svd_surrogate_mags(svd, p, GRID_T))(params)
    return svd, params, np.asarray(mags)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    svd, params, mags = jax_grid(N_GRID)
    t_svd.write_bulla_grid(str(root), "Bu2019lm_sparse", params, GRID_T,
                           mags, list(svd.filters))
    files = sorted(glob.glob(str(root / "*.dat")))
    return root, files


@pytest.fixture(scope="module")
def entries(grid):
    _, files = grid
    return (j_svd.read_bulla_grid(files, model="Bu2019lm_sparse"),
            t_svd.read_bulla_grid(files, model="Bu2019lm_sparse"))


GRID_NAMES = {
    "Bu2019lm": "nph1.0e+06_mejdyn0.005_mejwind0.050_phi30_theta25.84.dat",
    "Bu2019lm_sparse": "nph1.0e+06_mejdyn0.020_mejwind0.110_phi45_"
                       "theta0.00.dat",
    "Bu2019nsbh": "nph1.0e+06_mejdyn0.010_mejwind0.090_theta36.87.dat",
    "Bu2022Ye": "nph1.0e+06_mejdyn0.001_vdyn0.12_Yedyn0.15_mejwind0.01_"
                "vwind0.05_theta60.00.dat",
    "Ka2017": "m0.0100_v0.10_X1.0e-4.dat",
    "AnBa2022_linear": "mtot1.5_vej0.10_mni0.05_mrp0.02_xmix0.3.dat",
    "AnBa2022_log": "mtot1.5_vej0.10_mni0.05_mrp0.02_xmix0.3.dat",
    "AnBa2022_sparse": "mtot1.5_vej0.10_mni0.05_mrp0.02_xmix0.3.dat",
    "Bu2023Ye": "mejdyn0.001_vdyn0.15_Yedyn0.2_mejwind-0.05_vwind0.1_"
                "Yewind0.3_theta10.dat",
    "CV": "cv_example_3.dat",
    "LANL2022": "Run_TP_dyn_all_lanth_wind2_all_md0.1_vd0.3_mw0.001_vw0.05_"
                "mags_2020-01-01_theta30.dat",
    "LANLTP1": "Run_TP_md1_vd3_mw1_vw5_angle45.dat",
    "LANLTP2": "Run_TP_md01_vd05_mw001_vw015_mags.dat",
    "LANLTS1": "Run_TS_md0.05_vd0.15_mw0.01_vw0.3_theta0.dat",
    "LANLTS2": "Run_TS_md5_vd2_mw1_vw5_mags.dat",
}


@pytest.mark.parametrize("family", sorted(j_svd.GRID_PARSERS))
def test_grid_parser_matches_jax(family):
    j_parse, j_names = j_svd.GRID_PARSERS[family]
    t_parse, t_names = t_svd.GRID_PARSERS[family]
    assert t_names == j_names
    name = "/some/dir/" + GRID_NAMES[family]
    assert t_parse(name) == j_parse(name)


def test_read_bulla_grid_matches_jax(entries):
    (ej, pj, fj), (et, pt, ft) = entries
    assert pt == pj and ft == fj and len(et) == len(ej) == N_GRID
    for a, b in zip(ej, et):
        assert a["params"] == b["params"]
        np.testing.assert_array_equal(a["t"], b["t"])
        for f in fj:
            np.testing.assert_array_equal(a["mags"][f], b["mags"][f])
    # axial symmetry needs KNtheta, which the sparse family lacks
    with pytest.raises(ValueError):
        t_svd.axial_symmetry(et)


@pytest.mark.parametrize("spline", [False, True])
def test_interpolated_grid_matches_jax(entries, spline):
    (ej, _, fj), (et, _, _) = entries
    tt = np.linspace(0.05, 15.0, 37)    # extrapolates at both ends
    want = j_svd._interp_grid(ej, fj, tt, spline=spline)
    got = t_svd._interp_grid(et, fj, tt, spline=spline)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_interp_handles_gaps_like_jax():
    x = np.array([3.0, 0.5, 1.0, 2.0, 7.0, 5.0])
    y = np.array([-14.0, np.nan, -15.5, -15.0, np.inf, -13.2])
    xq = np.linspace(-1.0, 9.0, 23)
    want = np.asarray(j_svd.masked_interp_linear(xq, x, y, fill_value=np.nan))
    got = t_svd.masked_interp_linear(xq, x, y, fill_value=np.nan)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    one = t_svd.masked_interp_linear(xq, x[:2], y[:2], fill_value=np.nan)
    assert np.isnan(one).all()


def test_normalisation_and_svd_match_jax(entries):
    (ej, pj, fj), _ = entries
    tt = np.linspace(0.2, 12.0, 30)
    data = j_svd._interp_grid(ej, fj, tt)
    data[3, 1, :4] = np.nan           # an entry without coverage there
    params = np.asarray([[e["params"][p] for p in pj] for e in ej])
    want = j_svd._normalize_and_decompose(data, params, 6)
    got = t_svd._normalize_and_decompose(data, params, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    const = np.column_stack([params[:, 0], np.zeros(len(params))])
    np.testing.assert_array_equal(
        t_svd.normalize_params(const, const.min(0), const.max(0)),
        j_svd.normalize_params(const, const.min(0), const.max(0)))


@pytest.fixture(scope="module")
def jax_initial(entries, tmp_path_factory):
    """The JAX package's untrained surrogate (n_epochs=0), saved."""
    (ej, pj, fj), _ = entries
    init = j_svd.train_svd_model(
        ej, pj, fj[:3], j_svd.SVDTrainingConfig(n_epochs=0, **CFG),
        verbose=False)
    path = tmp_path_factory.mktemp("init") / "init.npz"
    init.save(path)
    return init, str(path)


def test_continued_training_matches_jax(entries, jax_initial):
    (ej, pj, fj), (et, pt, ft) = entries
    init, path = jax_initial
    want = j_svd.train_svd_model(
        ej, pj, fj[:3], j_svd.SVDTrainingConfig(n_epochs=20, **CFG),
        verbose=False, init_model=init)
    got = t_svd.train_svd_model(
        et, pt, ft[:3], t_svd.SVDTrainingConfig(n_epochs=20, **CFG),
        verbose=False, init_model=SVDModelData.load(path, device="cpu"),
        device="cpu")
    for k in ("w1", "b1", "w2", "b2"):
        moved = np.abs(getattr(want, k) - getattr(init, k)).max()
        assert moved > 1e-3, k          # the 20 epochs did train
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(want, k), rtol=0, atol=1e-5)
    for k in ("tt", "va", "mins", "maxs", "param_mins", "param_maxs"):
        np.testing.assert_array_equal(got.host[k], getattr(want, k))
    assert got.fit_info["n_holdout"] == 2 and got.fit_info["epochs"] == 20


def _mags(svd_port, svd_jax, theta):
    t = np.asarray(svd_jax.tt)
    want = np.stack([np.asarray(svd_surrogate_mags(
        svd_jax, dict(zip(svd_jax.parameter_names, row)), t))
        for row in theta])
    params = {k: torch.tensor(theta[:, i], dtype=torch.float32)
              for i, k in enumerate(svd_port.parameter_names)}
    got = svd_port(params, torch.tensor(t, dtype=torch.float32)).numpy()
    return got, want


def test_surrogates_load_across_packages(entries, jax_initial, tmp_path):
    (_, _, _), (et, pt, ft) = entries
    init, path = jax_initial
    theta = np.random.default_rng(3).uniform(init.param_mins,
                                             init.param_maxs, (6, 2))
    # the JAX package's surrogate in the port
    got, want = _mags(SVDModelData.load(path, device="cpu"), init, theta)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a surrogate the port trained, in the JAX package
    trained = t_svd.train_svd_model(
        et, pt, ft[:3], t_svd.SVDTrainingConfig(n_epochs=60, **CFG),
        verbose=False, device="cpu")
    trained.save(tmp_path / "port.npz")
    got, want = _mags(trained, JaxSVD.load(tmp_path / "port.npz"), theta)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_benchmark_matches_jax(entries, jax_initial):
    (ej, pj, _), (et, pt, _) = entries
    init, path = jax_initial
    want = j_svd.benchmark_svd_model(init, ej, pj)
    got = t_svd.benchmark_svd_model(SVDModelData.load(path, device="cpu"),
                                    et, pt)
    assert sorted(got) == sorted(want)
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4)


def test_fresh_training_fits_the_grid(entries):
    _, (et, pt, ft) = entries
    svd = t_svd.train_svd_model(
        et, pt, ft[:3], t_svd.SVDTrainingConfig(n_epochs=1000, **CFG),
        verbose=False, device="cpu")
    info = svd.fit_info
    assert info["n_train"] + info["n_holdout"] == N_GRID
    # the JAX package reaches 0.40 at 300 epochs on this grid, from 1.07
    assert info["train_mse"] < 0.05 and info["holdout_mse"] < 0.05, info
    assert tuple(svd.w1.shape) == (3, 2, 32) and svd.n_coeff == 6


def test_create_svdmodel_cli(grid, tmp_path):
    root, _ = grid
    args = ["--model", "Bu2019lm_sparse", "--data-path", str(root),
            "--svd-path", str(tmp_path / "svd"), "--svd-ncoeff", "6",
            "--hidden", "32", "--n-epochs", "40", "--n-tsteps", "30",
            "--filters", "ztfg,ztfr"]
    info = {}
    out = t_tools.create_svdmodel(args, device="cpu", info=info)
    first = SVDModelData.load(out, device="cpu")
    assert first.filters == ("ztfg", "ztfr") and info["epochs"] == 40
    # continued training starts from the saved weights
    t_tools.create_svdmodel(args + ["--continue-training"], device="cpu")
    again = SVDModelData.load(out, device="cpu")
    assert not torch.equal(again.w1, first.w1)
    np.testing.assert_array_equal(again.host["va"], first.host["va"])

    scores = t_tools.svdmodel_benchmark(
        ["--model", "Bu2019lm_sparse", "--data-path", str(root),
         "--svd-path", str(tmp_path / "svd"),
         "--outdir", str(tmp_path / "bench")], device="cpu")
    assert sorted(scores) == ["ztfg", "ztfr"]
    on_disk = json.loads(
        (tmp_path / "bench" / "Bu2019lm_sparse_benchmark.json").read_text())
    assert on_disk == scores and all(len(v) == 5 for v in scores.values())

    gp_out = t_tools.create_svdmodel(
        ["--model", "Bu2019lm_sparse", "--data-path", str(root),
         "--svd-path", str(tmp_path / "svd"), "--svd-ncoeff", "4",
         "--interpolation-type", "api_gp", "--filters", "ztfg"],
        device="cpu")
    assert gp_out.endswith("Bu2019lm_sparse_api_gp.npz")
    with pytest.raises(ValueError, match="interpolation-type"):
        t_tools.create_svdmodel(args + ["--interpolation-type", "nope"],
                                device="cpu")


def test_resample_grid_cli(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "grid.h5"
    with h5py.File(path, "w") as f:
        for i in range(10):
            g = f.create_group(f"lc{i:02d}")
            g["time"] = np.linspace(0.1, 5.0, 8)
            g["ZTF_g"] = np.full(8, 20.0 + i)
    base = tmp_path / "out"
    (down,) = t_tools.resample_grid(
        ["--gridpath", str(path), "--downsample", "--factor", "3",
         "--base-dirname", str(base)])
    (frags,) = t_tools.resample_grid(
        ["--gridpath", str(path), "--fragment", "--factor", "2",
         "--base-dirname", str(base)])
    from nmma_tpu_torch.training.grids import read_hdf5_grid
    got = read_hdf5_grid(down)
    assert sorted(got) == ["lc00", "lc03", "lc06", "lc09"]
    assert sorted(got["lc03"]) == ["t", "ztfg"]
    assert got["lc03"]["ztfg"][0] == 23.0
    assert len(frags) == 2
    assert sum(len(read_hdf5_grid(p)) for p in frags) == 10
    with pytest.raises(ValueError, match=".h5"):
        t_tools.resample_grid(["--gridpath", str(tmp_path / "x.dat"),
                               "--downsample"])
