"""The port's post-processing (``nmma_tpu_torch/post_processing/`` and
``eos/baryonic.py``) against the JAX package's, on the CPU.

Tolerances, with their reasons:

* host numpy in both packages (``hubble``, ``ns_characteristics``, the
  baryonic tables, the GW-sample readers): equal, or within 1e-6 relative
  where a redshift or distance is read off the cosmology's f32 table;
* ``GaussianKDE.log_prob`` against ``jax.vmap`` of the JAX ``logpdf``:
  1e-5 relative and 1e-4 absolute (an f32 logsumexp over ~1,000 centres;
  both set the kernel up in float64 on the host);
* the resamplers' logL at 64 seeded unit points (each package's prior
  transform of the same points, no sampler run): the sentinels in the same
  places, and within 1e-4 relative and 1e-3 absolute elsewhere (the KDE's
  f32 terms added to the f32 ejecta fits);
* the marginalised bands on the same 200 drawn samples, and
  ``lightcurve-marginalisation`` end to end: within 1e-4 mag (the
  models' gate; a percentile moves no further than the values under it).

EOS tables are made here with the port's TOV solver
(tests/test_torch_eos.py), and the sparse Bu2019lm surrogate
(``artifacts/Bu2019lm_sparse_svd.npz``, P = 2) is the light-curve model.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.eos as j_eos
import nmma_tpu.eos.baryonic as j_bary
import nmma_tpu.models as j_models
import nmma_tpu.models.svd as j_svd
import nmma_tpu.post_processing.hubble as j_hub
import nmma_tpu.post_processing.marginalisation as j_marg
import nmma_tpu.post_processing.ns_characteristics as j_ns
import nmma_tpu_torch.eos as t_eos
import nmma_tpu_torch.eos.baryonic as t_bary
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.post_processing.hubble as t_hub
import nmma_tpu_torch.post_processing.marginalisation as t_marg
import nmma_tpu_torch.post_processing.ns_characteristics as t_ns
from nmma_tpu.io.fits import write_bintable
from nmma_tpu.post_processing.kde import GaussianKDE as JKDE
from nmma_tpu.post_processing.maximum_mass import \
    MaximumMassResampler as JMaxMass
from nmma_tpu.post_processing.resampling import GWEMResampler as JGWEM
from nmma_tpu_torch.post_processing import (GaussianKDE, GWEMResampler,
                                            MaximumMassResampler)
from test_torch_eos import crust_table, write_macro_set

torch.set_num_threads(1)

KDE_RTOL, KDE_ATOL = 1e-5, 1e-4
LOGL_RTOL, LOGL_ATOL = 1e-4, 1e-3
MAG_ATOL = 1e-4
SPARSE = "artifacts/Bu2019lm_sparse_svd.npz"
MODEL = "Bu2019lm_sparse_post_processing"
FILTERS = ["ztfg", "ztfr", "ztfi"]


@pytest.fixture(scope="module")
def eos_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eos")
    write_macro_set(root)
    return str(root)


@pytest.fixture(scope="module")
def models():
    """The sparse surrogate registered in both packages."""
    j_models.register_source_model(j_svd.make_svd_source_model(
        MODEL, j_svd.SVDModelData.load(SPARSE)))
    t_models.make_svd_source_model(
        MODEL, t_models.SVDModelData.load(SPARSE, device="cpu"))
    return MODEL


def write_baryonic_set(root, slopes=(50.0, 70.0, 90.0)):
    """Macro (R, M, Lambda, P_c) on the stable branch and micro (n, eps, p,
    cs2) files ``{i}.dat`` of NEP tables on the numpy crust; returns the
    two directories."""
    macro, micro = os.path.join(root, "macro"), os.path.join(root, "micro")
    os.makedirs(macro)
    os.makedirs(micro)
    tables = [t_eos.eos_from_nep(32.0, s, crust_table()) for s in slopes]
    families = t_eos.construct_families(
        [t_eos.nep_eos_table(32.0, s, crust_table()) for s in slopes],
        device="cpu")
    for i, (table, (r, m, lam, pc)) in enumerate(zip(tables, families)):
        n, p, eps = table[:, 0], table[:, 1], table[:, 2]
        stable = slice(0, int(np.argmax(m.numpy())) + 1)
        np.savetxt(os.path.join(macro, f"{i}.dat"), np.column_stack(
            [a.numpy()[stable] for a in (r, m, lam, pc)]))
        np.savetxt(os.path.join(micro, f"{i}.dat"),
                   np.column_stack([n, eps, p, np.gradient(p, eps)]))
    return macro, micro


@pytest.mark.parametrize("case", ["1d", "2d_weighted", "5d"])
def test_gaussian_kde_matches(case):
    rng = np.random.default_rng(3)
    dim = {"1d": 1, "2d_weighted": 2, "5d": 5}[case]
    samples = rng.normal(size=(1000, dim)) * np.arange(1, dim + 1) + 3.0
    weights = rng.uniform(0.2, 1.0, 1000) if "weighted" in case else None
    x = (rng.normal(size=(257, dim)) * 1.5 * np.arange(1, dim + 1)
         + 3.0).astype(np.float32)
    if dim == 1:
        samples, x = samples[:, 0], x[:, 0]
    got = GaussianKDE(samples, weights).log_prob(torch.from_numpy(x))
    jk = JKDE(samples, weights)
    want = np.asarray(jax.vmap(jk.logpdf)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=KDE_RTOL,
                               atol=KDE_ATOL)


def test_hubble_matches():
    rng = np.random.default_rng(4)
    dist = 40.0 * (1 + 0.1 * rng.standard_normal(3000))
    got = t_hub.hubble_posterior_from_distance_samples(dist, 0.0098)
    want = j_hub.hubble_posterior_from_distance_samples(dist, 0.0098)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    events = [70.0 * (1 + 0.1 * rng.standard_normal(2000)),
              66.0 * (1 + 0.15 * rng.standard_normal(2000))]
    g, w = (mod.combine_hubble_posteriors(events) for mod in (t_hub, j_hub))
    for a, b in zip(g[:2], w[:2]):
        np.testing.assert_array_equal(a, b)
    assert g[2] == w[2]
    assert t_hub.hdi(events[0], 0.9) == j_hub.hdi(events[0], 0.9)
    gw = {"chirp_mass": rng.normal(1.1977, 0.001, 2000),
          "mass_ratio": rng.uniform(0.7, 1.0, 2000),
          "luminosity_distance": 40.0 * (1 + 0.2 * rng.standard_normal(2000))}
    kdes = {}
    for name, mod in (("port", t_hub), ("jax", j_hub)):
        kdes[name] = [mod.event_h0_kdes(dist, gw, 0.0098, rng=seed)
                      for seed in (1, 2)]
    grid = np.linspace(40.0, 100.0, 61)
    for (g_em, g_gw), (w_em, w_gw) in zip(kdes["port"], kdes["jax"]):
        np.testing.assert_array_equal(g_em.logpdf_batch(grid),
                                      w_em.logpdf_batch(grid))
        np.testing.assert_array_equal(g_gw.logpdf_batch(grid),
                                      w_gw.logpdf_batch(grid))
    trend = {name: mod.h0_trend_from_kdes(
        [k[1] for k in kdes[name]], [k[0] for k in kdes[name]],
        np.linspace(40.0, 100.0, 200), range(2), n_reordering=2,
        n_posterior_samples=300, rng=5)
        for name, mod in (("port", t_hub), ("jax", j_hub))}
    for key in ("GW", "EM", "total"):
        for a, b in zip(trend["port"][key], trend["jax"][key]):
            np.testing.assert_array_equal(a, b)


def test_ns_characteristics_match(eos_dir):
    t_set = t_eos.load_macro_eos_set(eos_dir)
    j_set = j_eos.load_macro_eos_set(eos_dir)
    np.testing.assert_array_equal(np.asarray(t_set.r14),
                                  np.asarray(j_set.r14))
    rng = np.random.default_rng(6)
    events = [rng.normal(mu, 1.5, 3000).clip(0, 9.99) for mu in (3.0, 6.0)]
    got = t_ns.combine_eos_posteriors(events, t_set)
    want = j_ns.combine_eos_posteriors(events, j_set)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    post = {"chirp_mass": rng.normal(1.1977, 0.001, 3000),
            "mass_ratio": rng.uniform(0.7, 1.0, 3000), "EOS": events[0]}
    probs = [mod.eos_probs_from_posterior(post, 10, rng=7)
             for mod in (t_ns, j_ns)]
    np.testing.assert_array_equal(*probs)
    trends = [mod.estimate_observable_trend(
        np.asarray(t_set.r14), [probs[0], np.full(10, 0.1)],
        np.full(10, 0.1), n_reordering=3, n_posterior_samples=500, rng=8)
        for mod in (t_ns, j_ns)]
    for a, b in zip(*trends):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_baryonic_tables_match(tmp_path):
    macro, micro = write_baryonic_set(str(tmp_path))
    files = [sorted(os.listdir(d)) for d in (macro, micro)]
    macro_files = [os.path.join(macro, f) for f in files[0]]
    micro_files = [os.path.join(micro, f) for f in files[1]]
    grid = np.linspace(1.0, 2.4, 8)
    got = t_bary.stacked_baryonic_tables(macro_files, micro_files, grid)
    want = j_bary.stacked_baryonic_tables(macro_files, micro_files, grid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the baryonic mass exceeds the gravitational one below M_TOV
    ok = np.isfinite(got[0])
    assert ok.sum() >= 12 and (got[0][ok] > np.broadcast_to(
        grid, got[0].shape)[ok]).all()
    assert t_bary.baryonic_kepler_mass(2.2, 12.0, 1.2, 0.01) == \
        j_bary.baryonic_kepler_mass(2.2, 12.0, 1.2, 0.01)


def unit_points(ndim, seed=64, n=64):
    return np.random.default_rng(seed).uniform(
        size=(n, ndim)).astype(np.float32)


def assert_logl_match(t_rs, j_rs, u):
    t_p = t_rs.priors.transform(torch.from_numpy(u))
    j_p = j_rs.priors.transform(jnp.asarray(u))
    got = t_rs.log_likelihood(t_p).numpy()
    want = np.asarray(jax.vmap(j_rs.log_likelihood)(j_p))
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= len(u) // 4
    np.testing.assert_allclose(got[ok], want[ok], rtol=LOGL_RTOL,
                               atol=LOGL_ATOL)


@pytest.mark.parametrize("case", ["eos_column", "lambda_tilde", "nsbh",
                                  "total_ejecta"])
def test_gwem_resampler_logl_matches(eos_dir, case):
    rng = np.random.default_rng(9)
    n = 1500
    if case == "nsbh":
        gw = {"chirp_mass": rng.normal(1.9, 0.01, n),
              "mass_ratio": rng.uniform(0.35, 0.5, n),
              "chi_1": rng.normal(0.3, 0.05, n),
              "chi_2": rng.normal(0.0, 0.02, n)}
    else:
        gw = {"chirp_mass": rng.normal(1.1977, 0.001, n),
              "mass_ratio": rng.uniform(0.7, 1.0, n),
              "luminosity_distance": rng.normal(40.0, 4.0, n)}
        if case == "lambda_tilde":
            gw["lambda_tilde"] = rng.normal(400.0, 100.0, n).clip(10)
        else:
            gw["EOS"] = rng.uniform(0.0, 10.0, n)
    em = {"log10_mej_dyn": rng.normal(-2.2, 0.2, n),
          "log10_mej_wind": rng.normal(-1.6, 0.2, n)}
    kwargs = dict(with_nsbh=case == "nsbh",
                  total_ejecta_mass=case == "total_ejecta")
    t_rs = GWEMResampler(gw, em, t_eos.load_macro_eos_set(eos_dir),
                         device="cpu", **kwargs)
    j_rs = JGWEM(gw, em, j_eos.load_macro_eos_set(eos_dir), **kwargs)
    assert list(t_rs.priors.keys()) == list(j_rs.priors.keys())
    assert_logl_match(t_rs, j_rs, unit_points(t_rs.priors.ndim))


@pytest.fixture(scope="module")
def baryonic_dirs(tmp_path_factory):
    return write_baryonic_set(str(tmp_path_factory.mktemp("baryonic")))


@pytest.mark.parametrize("use_m_max", [False, True])
def test_maximum_mass_resampler_logl_matches(baryonic_dirs, use_m_max):
    rng = np.random.default_rng(10)
    n = 1500
    q = rng.uniform(0.75, 1.0, n)
    post = {"chirp_mass": rng.normal(1.19, 0.005, n),
            "eta_star": np.log(0.25 - q / (1 + q) ** 2 + 1e-6),
            "EOS": rng.uniform(0.0, 3.0, n),
            "log10_mdisk": rng.normal(-1.3, 0.2, n),
            "log10_mej_dyn": rng.normal(-2.3, 0.2, n)}
    grid = np.linspace(0.9, 2.5, 12)
    t_rs = MaximumMassResampler(post, *baryonic_dirs, use_m_max=use_m_max,
                                mass_grid=grid, device="cpu")
    j_rs = JMaxMass(post, *baryonic_dirs, use_m_max=use_m_max,
                    mass_grid=grid)
    np.testing.assert_array_equal(t_rs.mb_tables.numpy(),
                                  np.asarray(j_rs.mb_tables))
    assert list(t_rs.priors.keys()) == list(j_rs.priors.keys())
    assert_logl_match(t_rs, j_rs, unit_points(t_rs.priors.ndim))


def gw_posterior(seed=11, n=2000):
    rng = np.random.default_rng(seed)
    return {"chirp_mass": rng.normal(1.1977, 0.002, n),
            "mass_ratio": rng.uniform(0.7, 1.0, n),
            "luminosity_distance": rng.normal(40.0, 5.0, n),
            "theta_jn": rng.uniform(0.1, 0.6, n),
            "ratio_zeta": rng.uniform(0.1, 0.3, n),
            "alpha": rng.uniform(0.0, 1e-3, n)}


def test_marginalised_bands_match(models, eos_dir):
    gw = j_marg.normalize_gw_quantities(gw_posterior())
    t_gw = t_marg.normalize_gw_quantities(gw_posterior())
    for k in gw:
        np.testing.assert_array_equal(t_gw[k], gw[k])
    times = np.geomspace(0.2, 14.0, 40)
    t_model = t_models.DetectorLightCurveModel(models, FILTERS,
                                               sample_times=times,
                                               device="cpu")
    j_model = j_models.DetectorLightCurveModel(models, FILTERS,
                                               sample_times=times)
    extra = {"KNphi": 30.0}
    got = t_marg.marginalised_lightcurve_expectation(
        t_gw, t_eos.load_macro_eos_set(eos_dir), t_model, max_samples=200,
        extra_parameters=extra, seed=3)
    want = j_marg.marginalised_lightcurve_expectation(
        gw, j_eos.load_macro_eos_set(eos_dir), j_model, max_samples=200,
        extra_parameters=extra, seed=3)
    assert got.shape == want.shape == (3, len(FILTERS), len(times))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=MAG_ATOL)
    assert (np.diff(got[:, ok.all(0)], axis=0) >= 0).all()


def write_coinc(path, m1, m2):
    cols = "\n".join(f'      <Column Name="sngl_inspiral:{c}" Type="real_4"/>'
                     for c in ("mass1", "mass2", "spin1z", "spin2z"))
    body = ",\n      ".join(f"{a},{b},0.01,-0.02" for a, b in zip(m1, m2))
    with open(path, "w") as fh:
        fh.write(f"""<?xml version='1.0' encoding='utf-8'?>
<LIGO_LW>
  <Table Name="sngl_inspiral:table">
{cols}
      <Stream Name="sngl_inspiral:table" Type="Local" Delimiter=",">
      {body}
      </Stream>
  </Table>
</LIGO_LW>
""")


@pytest.mark.parametrize("source", ["template8", "template6", "hdf5_bilby",
                                    "hdf5_lalinference", "json", "csv",
                                    "coinc_moc", "coinc_flat"])
def test_load_gw_samples_matches(tmp_path, source):
    import h5py

    post = gw_posterior(12, 300)
    rng = np.random.default_rng(13)
    kwargs = {"seed": 5}
    if source.startswith("template"):
        path = tmp_path / "template.dat"
        m1 = rng.uniform(1.3, 1.6, 300)
        cols = [rng.normal(size=300), rng.normal(size=300),
                rng.uniform(0.1, 1.0, 300), m1, m1 * 0.9]
        cols += ([rng.uniform(0, 0.1, 300)] * 2 if source == "template8"
                 else [])
        np.savetxt(path, np.column_stack(cols + [rng.uniform(30, 50, 300)]))
        kwargs["template_file"] = str(path)
    elif source == "hdf5_bilby":
        path = tmp_path / "result.h5"
        with h5py.File(path, "w") as f:
            for k, v in post.items():
                f[f"posterior/{k}"] = v
        kwargs["hdf5_file"] = str(path)
    elif source == "hdf5_lalinference":
        path = tmp_path / "lalinference.hdf5"
        table = np.zeros(300, dtype=[(k, "f8") for k in post])
        for k, v in post.items():
            table[k] = v
        with h5py.File(path, "w") as f:
            f["lalinference/lalinference_mcmc/posterior_samples"] = table
        kwargs["hdf5_file"] = str(path)
    elif source == "json":
        path = tmp_path / "result.json"
        path.write_text(json.dumps({"posterior": {"content": {
            k: v.tolist() for k, v in post.items()}}}))
        kwargs["posterior_file"] = str(path)
    elif source == "csv":
        path = tmp_path / "posterior.csv"
        np.savetxt(path, np.column_stack(list(post.values())),
                   delimiter=",", header=",".join(post), comments="")
        kwargs["posterior_file"] = str(path)
    else:
        coinc = tmp_path / "coinc.xml"
        write_coinc(coinc, rng.uniform(1.3, 1.6, 4), rng.uniform(1.1, 1.3, 4))
        n = 48
        mu = rng.uniform(35.0, 45.0, n)
        sig = rng.uniform(5.0, 9.0, n)
        sky = {"DISTMU": mu, "DISTSIGMA": sig,
               "DISTNORM": 1.0 / (mu**2 + sig**2)}
        if source == "coinc_moc":
            sky = {"UNIQ": np.arange(4, 4 + n, dtype=np.int64) + 12,
                   "PROBDENSITY": rng.uniform(0.1, 1.0, n), **sky}
        else:
            sky["PROB"] = rng.dirichlet(np.ones(n))
        write_bintable(str(tmp_path / "sky.fits"), sky)
        kwargs.update(coinc_file=str(coinc), skymap=str(tmp_path / "sky.fits"))
        assert t_marg.skymap_distance_moments(kwargs["skymap"]) == \
            j_marg.skymap_distance_moments(kwargs["skymap"])
    got = t_marg.load_gw_samples(**kwargs)
    want = j_marg.load_gw_samples(**kwargs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lightcurve_marginalisation_cli_matches(tmp_path, models, eos_dir):
    post = gw_posterior(14)
    post["KNphi"] = np.full(len(post["chirp_mass"]), 30.0)
    csv = tmp_path / "posterior.csv"
    np.savetxt(csv, np.column_stack(list(post.values())), delimiter=",",
               header=",".join(post), comments="")
    args = ["--posterior-file", str(csv), "--eos-data", eos_dir,
            "--model", models, "--filters", ",".join(FILTERS),
            "--tmin", "0.2", "--tmax", "14", "--n-tstep", "30",
            "-n", "200"]
    got = np.load(t_marg.main(args + ["--outdir", str(tmp_path / "port"),
                                      "--device", "cpu"]),
                  allow_pickle=True)
    want = np.load(j_marg.main(args + ["--outdir", str(tmp_path / "jax")]),
                   allow_pickle=True)
    assert list(got["filters"]) == list(want["filters"]) == FILTERS
    np.testing.assert_array_equal(got["times"], want["times"])
    np.testing.assert_array_equal(got["percentiles"], want["percentiles"])
    g, w = got["bands"], want["bands"]
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = np.isfinite(w)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=MAG_ATOL)
    # --plot draws the bands (matplotlib imports here)
    t_marg.main(args + ["--plot", "--outdir", str(tmp_path / "plot"),
                        "--device", "cpu"])
    assert (tmp_path / "plot" / "marginalised_lc.pdf").stat().st_size > 0


def test_resamplers_run_on_the_port_sampler(eos_dir, baryonic_dirs):
    """A short nested run of each resampler on the CPU: finite logZ and a
    posterior over its priors' names, inside their supports."""
    rng = np.random.default_rng(15)
    n = 1500
    gw = {"chirp_mass": rng.normal(1.1977, 0.001, n),
          "mass_ratio": rng.uniform(0.7, 1.0, n),
          "EOS": rng.uniform(0.0, 10.0, n)}
    em = {"log10_mej_dyn": rng.normal(-2.2, 0.2, n),
          "log10_mej_wind": rng.normal(-1.6, 0.2, n)}
    q = rng.uniform(0.75, 1.0, n)
    mm = {"chirp_mass": rng.normal(1.19, 0.005, n),
          "eta_star": np.log(0.25 - q / (1 + q) ** 2 + 1e-6),
          "EOS": rng.uniform(0.0, 3.0, n),
          "log10_mdisk": rng.normal(-1.3, 0.2, n),
          "log10_mej_dyn": rng.normal(-2.3, 0.2, n)}
    for rs in (GWEMResampler(gw, em, t_eos.load_macro_eos_set(eos_dir),
                             device="cpu"),
               MaximumMassResampler(mm, *baryonic_dirs,
                                    mass_grid=np.linspace(0.9, 2.5, 12),
                                    device="cpu")):
        result, post = rs.run(nlive=64, max_iter=20)
        assert np.isfinite(result.logz) and result.niter == 20
        assert sorted(post) == sorted(rs.priors.keys())
        for k, prior in rs.priors.priors.items():
            assert prior.minimum <= post[k].min() <= post[k].max() \
                <= prior.maximum, k
