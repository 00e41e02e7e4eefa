"""The port's radiative-transfer readers and converters
(``nmma_tpu_torch/io/radiative.py``) and POSSIS spectral models against the
JAX package's, on files written here, on the CPU.

* the POSSIS ASCII and HDF5, Kasen HDF5 and LANL readers, band synthesis
  and the bolometric integral are the same host numpy in both packages:
  equal;
* ``make_lcs`` writes the same files with the same names; their columns
  agree within 1e-9 relative, except where a distance is turned into a
  redshift (``d_mpc`` > 10 pc), which both read off their cosmology's f32
  table: 1e-6 relative there;
* a POSSIS spectrum through ``spectral_model_from_file`` (ASCII and HDF5),
  then both packages' ``DetectorLightCurveModel`` at B = 16 seeded live
  points: magnitudes within 1e-4 mag with inf in the same places (the
  spectral-model gate of tests/test_torch_em_models.py); and through both
  packages' ``lightcurve-analysis --model`` with --skip-sampling: logL at
  64 seeded unit points within rtol 1e-4 / atol 1e-2, identical
  sentinels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.io.radiative as j_rad
import nmma_tpu.models as j_models
import nmma_tpu.models.spectral as j_spec
import nmma_tpu_torch.io.radiative as t_rad
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.spectral as t_spec

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)

B = 16
MAG_ATOL = 1e-4
FILTERS = ["ztfg", "ztfr", "ztfi", "2massj"]


def possis_arrays(seed=0, n_obs=4, n_wave=120, n_time=24):
    """A kilonova-like POSSIS spectral series at 10 pc: a cooling
    blackbody-ish shape with a seeded ripple, per viewing angle."""
    rng = np.random.default_rng(seed)
    wave = np.geomspace(1500.0, 25000.0, n_wave)
    time = np.linspace(0.5, 12.0, n_time)
    temp = 6000.0 * (time / 0.5) ** -0.4
    x = 1.4388e8 / (wave[None, :] * temp[:, None])
    shape = 1.0 / (wave[None, :] ** 5 * np.expm1(np.minimum(x, 700.0)))
    flam = np.stack([
        1e-3 * (1.0 - 0.15 * i) * shape
        * (1.0 + 0.05 * rng.standard_normal((n_time, n_wave)))
        for i in range(n_obs)])                      # [Nobs, T, W]
    return time, wave, np.abs(flam)


def write_possis_ascii(path, seed=0, **kw):
    time, wave, flam = possis_arrays(seed, **kw)
    n_obs, n_time, n_wave = flam.shape
    dt = time[1] - time[0]
    ti = time[0] - 0.5 * dt
    with open(path, "w") as fh:
        fh.write(f"{n_obs}\n{n_wave}\n{n_time} {ti} {ti + n_time * dt}\n")
        np.savetxt(fh, np.vstack([np.column_stack([wave, flam[i].T])
                                  for i in range(n_obs)]))


def write_possis_h5(path, seed=1, **kw):
    time, wave, flam = possis_arrays(seed, **kw)
    stokes = np.zeros(flam.shape + (4,))
    stokes[..., 0] = flam
    stokes[..., 1] = 0.01 * flam
    with h5py.File(path, "w") as f:
        g = f.create_group("observables")
        g["stokes"] = stokes
        g["time"] = time * 86400.0
        g["wave"] = wave
        g["lbol"] = np.trapezoid(flam[0], wave, axis=1)


def write_kasen_h5(path, seed=2):
    rng = np.random.default_rng(seed)
    nu = np.geomspace(1e13, 3e15, 96)[::-1]
    time = np.linspace(0.2, 15.0, 30) * 86400.0
    lnu = 1e25 * (1 + 0.1 * rng.standard_normal((30, 96))) ** 2
    lnu[5, 40] = 0.0                                 # a data hole
    with h5py.File(path, "w") as f:
        f["nu"], f["time"], f["Lnu"] = nu, time, lnu


def write_lanl(path, seed=3, n_time=6, n_wave=48, n_angles=4):
    rng = np.random.default_rng(seed)
    wave_lo = np.geomspace(1e-5, 2.5e-4, n_wave)
    with open(path, "w") as fh:
        for it in range(n_time):
            fh.write(f"time (days) = {0.5 + it}\n")
            for iw in range(n_wave):
                specs = " ".join(
                    f"{1e-3 * rng.uniform(0.5, 1.5):.6e}"
                    for _ in range(n_angles))
                fh.write(f"{wave_lo[iw]:.6e} {1.05 * wave_lo[iw]:.6e} "
                         f"{specs}\n")


def assert_same(got, want, rtol=0.0):
    """Nested tuples/dicts of arrays equal (or within ``rtol``)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, rtol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=0.0)


def test_band_mags_and_bolometric_match():
    time, wave, flam = possis_arrays(4)
    filters = FILTERS + ["radio-3GHz", "uvot::uvw1"]
    assert_same(t_rad.band_mags_from_spectra(wave, flam[0], filters),
                j_rad.band_mags_from_spectra(wave, flam[0], filters))
    assert_same(t_rad.bolometric_lc_dict(time, wave, flam[1]),
                j_rad.bolometric_lc_dict(time, wave, flam[1]))
    assert_same(t_rad.spectra_to_lc_dict(time, wave, flam[2], filters),
                j_rad.spectra_to_lc_dict(time, wave, flam[2], filters))


@pytest.mark.parametrize("kind", ["possis_ascii", "possis_h5", "kasen",
                                  "lanl"])
def test_readers_match(tmp_path, kind):
    path = str(tmp_path / f"{kind}.dat")
    writer, reader = {
        "possis_ascii": (write_possis_ascii, "read_possis_ascii"),
        "possis_h5": (write_possis_h5, "read_possis_h5"),
        "kasen": (write_kasen_h5, "read_kasen_h5"),
        "lanl": (write_lanl, "read_lanl_spectra"),
    }[kind]
    writer(path)
    kwargs = {"angles": range(4)} if kind == "lanl" else {}
    got = getattr(t_rad, reader)(path, **kwargs)
    want = getattr(j_rad, reader)(path, **kwargs)
    assert_same(got, want)
    assert_same(t_rad.lanl_thetas(4), j_rad.lanl_thetas(4))


@pytest.mark.parametrize("case", [
    ("possis", None, {}), ("possis", None, {"d_mpc": 40.0}),
    ("possis", None, {"redshift": 0.05, "smoothing": True}),
    ("possis", "h5", {}), ("possis", "h5", {"bolometric": True}),
    ("kasen", "kasen", {}), ("lanl", "lanl", {"d_mpc": 100.0}),
], ids=["ascii", "ascii_40mpc", "ascii_z_smooth", "h5", "h5_lbol", "kasen",
        "lanl_100mpc"])
def test_make_lcs_matches(tmp_path, case):
    source, file_type, kwargs = case
    modeldir = tmp_path / "model"
    modeldir.mkdir()
    if source == "possis" and file_type is None:
        write_possis_ascii(str(modeldir / "nph1e6_mej0.05.txt"))
    elif source == "possis":
        write_possis_h5(str(modeldir / "nph1e6_mej0.05.h5"))
    elif source == "kasen":
        write_kasen_h5(str(modeldir / "knova_d1_n10_m0.040_vk0.10.h5"))
    else:
        write_lanl(str(modeldir / "Run_TP_md0.01_vd0.3_spec.dat"))
    rtol = 1e-6 if ("d_mpc" in kwargs or "redshift" in kwargs) else 1e-9
    written = {}
    for name, mod in (("jax", j_rad), ("port", t_rad)):
        lcdir = str(tmp_path / name)
        written[name] = mod.make_lcs(str(modeldir), lcdir, FILTERS,
                                     file_type=file_type, verbose=False,
                                     **kwargs)
    names = [os.path.basename(p) for p in written["port"]]
    assert names == [os.path.basename(p) for p in written["jax"]]
    assert names
    for got, want in zip(written["port"], written["jax"]):
        with open(got) as fg, open(want) as fw:
            assert fg.readline() == fw.readline()          # the header
        g, w = np.loadtxt(got, skiprows=1), np.loadtxt(want, skiprows=1)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol)


@pytest.mark.parametrize("fmt", ["ascii", "h5"])
def test_possis_spectral_model_matches(tmp_path, fmt):
    path = str(tmp_path / ("possis.txt" if fmt == "ascii" else "possis.h5"))
    (write_possis_ascii if fmt == "ascii" else write_possis_h5)(path)
    name = f"possis_{fmt}_port_test"
    t_model = t_spec.spectral_model_from_file(name, path)
    j_spec.spectral_model_from_file(name, path)
    assert t_model.banded
    rng = np.random.default_rng(9)
    params = {"supernova_mag_boost": rng.uniform(-1, 1, B),
              "luminosity_distance": rng.uniform(10, 200, B),
              "timeshift": rng.uniform(-0.5, 0.5, B)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    times = np.linspace(0.3, 13.0, 40)
    t_det = t_models.DetectorLightCurveModel(name, FILTERS,
                                             sample_times=times,
                                             device="cpu")
    j_det = j_models.DetectorLightCurveModel(name, FILTERS,
                                             sample_times=times)
    _, got = t_det({k: torch.from_numpy(v) for k, v in params.items()})
    _, want = jax.jit(jax.vmap(j_det))(
        {k: jnp.asarray(v) for k, v in params.items()})
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=MAG_ATOL)


def test_possis_model_through_the_cli(tmp_path):
    """A POSSIS HDF5 spectrum registered in both packages, then
    ``lightcurve-analysis --model`` on photometry it makes at an injection,
    with --skip-sampling: logL at 64 seeded unit points within rtol 1e-4
    and atol 1e-2, identical sentinels (tests/test_torch_cli.py's gate)."""
    import nmma_tpu.cli.lightcurve_analysis as j_cli
    import nmma_tpu_torch.cli.lightcurve_analysis as t_cli

    path = str(tmp_path / "possis.h5")
    write_possis_h5(path)
    name = "possis_cli_port_test"
    t_spec.spectral_model_from_file(name, path)
    j_spec.spectral_model_from_file(name, path)
    det = j_models.DetectorLightCurveModel(name, FILTERS,
                                           sample_times=np.linspace(
                                               0.5, 12.0, 60))
    t_obs, mags = det({"supernova_mag_boost": jnp.asarray(0.0),
                       "luminosity_distance": jnp.asarray(40.0),
                       "timeshift": jnp.asarray(0.0)})
    epochs = np.linspace(1.0, 11.0, 10)
    rows = [f"{60000 + t:.4f} {f} {m:.4f} 0.10"
            for i, f in enumerate(FILTERS)
            for t, m in zip(epochs, np.interp(epochs, np.asarray(t_obs),
                                              np.asarray(mags[i])))]
    (tmp_path / "lc.dat").write_text("\n".join(rows) + "\n")
    (tmp_path / "p.prior").write_text(
        "supernova_mag_boost = Uniform(minimum=-1., maximum=1.)\n"
        "luminosity_distance = Uniform(minimum=10., maximum=200.)\n"
        "timeshift = Uniform(minimum=-0.5, maximum=0.5)\n")
    args = ["--model", name, "--prior", str(tmp_path / "p.prior"),
            "--light-curve-data", str(tmp_path / "lc.dat"),
            "--trigger-time", "60000", "--tmin", "0.5", "--tmax", "12.0",
            "--outdir", str(tmp_path), "--label", "possis",
            "--skip-sampling"]
    j_ana = j_cli.main(args)
    t_ana = t_cli.main(args, device="cpu")
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    u = np.random.default_rng(64).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 32
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-2)
