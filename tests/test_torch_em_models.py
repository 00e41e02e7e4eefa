"""The supernova, shock-cooling, spectral and bolometric paths of the port
against the JAX package (nmma_tpu/models/shock_cooling.py, supernova.py,
spectral.py, likelihood/bolometric.py, em_detectors.py and lbol_main).

The same seeded numpy parameters at B=16 go through both packages'
``DetectorLightCurveModel`` (``jax.vmap`` on the JAX side). Tolerances, with
their reasons:
- magnitudes: 1e-4 mag (the port's f32 gate for models, as
  tests/test_torch_kilonova_models.py); inf positions identical. A cold
  photosphere's Wien tail gives magnitudes far beyond any observation
  (Piro2021 reaches ~1e6 mag): there the magnitude is proportional to 1/T,
  so a few f32 ulps of T become the same relative error in the magnitude,
  and points fainter than mag 100 are held to 1e-5 relative instead;
- bolometric luminosities (L / 1e40 erg/s): 1e-5 relative, a few f32 ulps
  through the 64-node quadrature;
- logL: 1e-5 relative, identical sentinels;
- lbol_main: the two samplers draw different random numbers, so their logZ
  agree within 3 of their combined errors, and their posterior medians
  within 0.1 of the prior width.
Spectral templates go through both packages' loaders from
tests/data/synthetic_sn_template.dat.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.em_detectors as j_det
import nmma_tpu.models as j_models
import nmma_tpu.models.spectral as j_spec
import nmma_tpu_torch.em_detectors as t_det
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.spectral as t_spec
from nmma_tpu.cli.lightcurve_analysis import lbol_main as j_lbol_main
from nmma_tpu.likelihood.bolometric import \
    BolometricLikelihood as JBolometric
from nmma_tpu_torch.cli.lightcurve_analysis import lbol_main as t_lbol_main
from nmma_tpu_torch.likelihood import BolometricLikelihood as TBolometric

torch.set_num_threads(1)

TEMPLATE = os.path.join(os.path.dirname(__file__), "data",
                        "synthetic_sn_template.dat")
B = 16
MAG_ATOL = 1e-4
FAINT, FAINT_RTOL = 100.0, 1e-5
LBOL_RTOL = 1e-5
FILTERS = ["ztfg", "ztfr", "ztfi", "2massks"]


def draws(seed, **ranges):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, B).astype(np.float32)
            for k, (lo, hi) in ranges.items()}


def both(name, params, filters, times):
    """(port, JAX) detector outputs of one model on the same parameters."""
    t_det_model = t_models.DetectorLightCurveModel(
        name, filters, sample_times=times, device="cpu")
    j_det_model = j_models.DetectorLightCurveModel(name, filters,
                                                   sample_times=times)
    t_t, t_out = t_det_model({k: torch.from_numpy(v)
                              for k, v in params.items()})
    j_t, j_out = jax.jit(jax.vmap(j_det_model))(
        {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(t_t.numpy(), np.asarray(j_t), rtol=1e-6,
                               atol=1e-6)
    return t_out.numpy(), np.asarray(j_out)


def assert_mags_match(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    bright = fin & (want < FAINT)
    faint = fin & ~bright
    print(f"max |dmag| {np.abs(got[bright] - want[bright]).max():.3e}; "
          f"{int(faint.sum())} points fainter than {FAINT}")
    np.testing.assert_allclose(got[bright], want[bright], rtol=0,
                               atol=MAG_ATOL)
    np.testing.assert_allclose(got[faint], want[faint], rtol=FAINT_RTOL,
                               atol=0)


def test_piro2021_mags_match():
    params = draws(1, log10_Menv=(-2.0, -0.5), log10_Renv=(12.0, 14.0),
                   log10_Ee=(49.0, 51.0), luminosity_distance=(10.0, 200.0))
    got, want = both("Piro2021", params, FILTERS,
                     np.geomspace(1.0 / 24.0, 3.5, 100))
    assert got.shape == (B, 4, 100)
    assert_mags_match(got, want)


def test_piro2021_bolometric_matches():
    from nmma_tpu.models.shock_cooling import piro2021_bolometric as j_fn
    from nmma_tpu_torch.models.shock_cooling import \
        piro2021_bolometric as t_fn
    params = draws(2, log10_Menv=(-2.0, -0.5), log10_Renv=(12.0, 14.0),
                   log10_Ee=(49.0, 51.0))
    t = np.geomspace(1.0 / 24.0, 3.5, 100).astype(np.float32)
    got = t_fn({k: torch.from_numpy(v) for k, v in params.items()},
               torch.from_numpy(t))
    want = jax.vmap(lambda p: j_fn(p, jnp.asarray(t)))(
        {k: jnp.asarray(v) for k, v in params.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LBOL_RTOL)


@pytest.mark.parametrize("name,extra", [
    ("Arnett", {}), ("Arnett_modified", {"t_0": (5.0, 50.0)})])
def test_arnett_lbol_matches(name, extra):
    """Arnett and Arnett_modified through the detector: L / 1e40 with the
    (1+z)^2 correction, on their default grid."""
    params = draws(3, tau_m=(5.0, 30.0), log10_mni=(-2.0, 0.0),
                   luminosity_distance=(10.0, 200.0), timeshift=(-1.0, 1.0),
                   **extra)
    got, want = both(name, params, [], np.linspace(0.005, 20.0, 40))
    assert got.shape == (B, 40)
    assert np.isfinite(want).all() and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=LBOL_RTOL)


def test_sr2023_mags_match():
    params = draws(4, alpha_AG=(0.5, 1.5), luminosity_distance=(10.0, 200.0))
    for i, f in enumerate(FILTERS):
        params.update(draws(10 + i, **{f"a_AG_{f}": (1.0, 100.0),
                                       f"f_nu_{f}": (1.0, 10.0),
                                       f"host_mag_{f}": (20.0, 24.0)}))
    got, want = both("Sr2023", params, FILTERS, np.geomspace(0.1, 20.0, 50))
    assert_mags_match(got, want)


@pytest.fixture(scope="module")
def template():
    """The fixture template through both loaders, registered in both
    packages (anchored) and as a SALT2 surface (M1 a phase-antisymmetric
    perturbation, CL a smooth colour law, as tests/test_spectral_roundtrip
    .py builds them)."""
    t_tpl = t_spec.load_sncosmo_ascii_template(TEMPLATE)
    j_tpl = j_spec.load_sncosmo_ascii_template(TEMPLATE)
    for a, b in zip(t_tpl, j_tpl):
        np.testing.assert_array_equal(a, b)
    phase, wave, flam = t_tpl
    t_spec.make_spectral_source_model("sn_template_port_test", *t_tpl)
    j_spec.make_spectral_source_model("sn_template_port_test", *j_tpl)
    pk = phase[np.argmax(flam.sum(axis=1))]
    m1 = flam * 0.3 * np.tanh((phase[:, None] - pk) / 10.0)
    cl = 0.4 * np.log(wave / 5500.0)
    # M0 scaled so x0 ~ 1e-5 gives observable magnitudes
    for mod in (t_spec, j_spec):
        mod.make_salt2_source_model("salt2_port_test", phase, wave,
                                    flam * 1e13, m1 * 1e13, cl)
    return phase, wave, flam


def test_spectral_mags_match(template):
    """Band magnitudes of the anchored template with the K-correction of
    each live point's redshift (distances up to 500 Mpc) and the boost."""
    params = draws(5, supernova_mag_boost=(-1.0, 1.0),
                   luminosity_distance=(10.0, 500.0))
    got, want = both("sn_template_port_test", params,
                     ["sdssu", "ztfg", "ztfr", "ztfi"],
                     np.linspace(1.0, 60.0, 40))
    assert_mags_match(got, want)


def test_spectral_peak_anchoring(template):
    """The rest-frame peak in the anchor band is M_REF, before any boost:
    the same offset in both packages."""
    phase, wave, flam = template
    nu = torch.tensor([[2.99792458e10 / (4380.0 * 1e-8)]])
    mags = t_models.get_source_model("sn_template_port_test").mags_fn(
        {}, torch.tensor(phase[phase > 0], dtype=torch.float32), nu)
    assert abs(float(mags.min()) - t_spec.M_REF) < 1e-3
    assert t_spec.M_REF == j_spec.M_REF


def test_salt2_mags_match(template):
    """SALT2 x0/x1/c: apparent amplitude, so no distance modulus in either
    package."""
    params = draws(6, x1=(-1.0, 1.0), c=(-0.2, 0.3),
                   luminosity_distance=(10.0, 500.0))
    params["x0"] = (10.0 ** np.random.default_rng(7).uniform(
        -6.0, -4.0, B)).astype(np.float32)
    got, want = both("salt2_port_test", params, ["ztfg", "ztfr", "ztfi"],
                     np.linspace(1.0, 60.0, 40))
    assert_mags_match(got, want)
    far = dict(params, luminosity_distance=params["luminosity_distance"] * 4)
    got_far, _ = both("salt2_port_test", far, ["ztfg", "ztfr", "ztfi"],
                      np.linspace(1.0, 60.0, 40))
    z_shift = np.abs(got_far - got)[np.isfinite(got)].max()
    assert z_shift < 1.0    # only the redshift moves, not 5 log10(4)


def test_spectral_model_from_file_refuses_what_needs_io(tmp_path):
    model = t_spec.spectral_model_from_file("sn_from_file", TEMPLATE)
    assert model.banded and model.parameter_names == ("supernova_mag_boost",)
    ragged = tmp_path / "ragged.dat"
    ragged.write_text("0.5 1000 1.0\n0.5 2000 2.0\n1.5 1000 1.0\n")
    with pytest.raises(ValueError, match="not rectangular"):
        t_spec.spectral_model_from_file("ragged", str(ragged))


def lbol_data(seed=11):
    """Arnett photometry from the JAX model at (tau_m 15, log10_mni -0.5):
    12 epochs in 1-19 d, 5% noise, the last epoch an upper limit."""
    det = j_models.DetectorLightCurveModel("Arnett", [])
    t, lbol = det({"tau_m": jnp.asarray(15.0),
                   "log10_mni": jnp.asarray(-0.5)})
    rng = np.random.default_rng(seed)
    phase = np.linspace(1.0, 19.0, 12)
    true = np.interp(phase, np.asarray(t), np.asarray(lbol)) * 1e40
    err = 0.05 * true
    obs = true + rng.normal(0.0, err)
    err[-1] = np.inf
    return phase, obs, err


@pytest.mark.parametrize("model", ["Arnett", "Arnett_modified"])
def test_bolometric_likelihood_matches(model):
    """Detections and an upper limit, with live points whose timeshift
    moves the model grid."""
    phase, obs, err = lbol_data()
    params = draws(12, tau_m=(5.0, 30.0), log10_mni=(-2.0, 0.0),
                   timeshift=(-1.0, 1.0), t_0=(5.0, 50.0))
    t_like = TBolometric(t_models.DetectorLightCurveModel(
        model, [], device="cpu"), phase, obs, err)
    j_like = JBolometric(j_models.DetectorLightCurveModel(model, []),
                         phase, obs, err)
    got = t_like({k: torch.from_numpy(v) for k, v in params.items()}).numpy()
    want = np.asarray(jax.vmap(j_like)(
        {k: jnp.asarray(v) for k, v in params.items()}))
    assert (want > -1e29).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("filters,detectors,too", [
    ("ztfg,ztfr", None, None), (None, "ztf,lsst", None),
    (None, "rubin", None), (None, "rubin", "gold"), (None, "ztf", "silver")])
def test_em_detectors_match(filters, detectors, too):
    got = t_det.set_filters(filters, detectors, too)
    assert got == j_det.set_filters(filters, detectors, too)
    for limit in (None, 22.5, {"ztfg": 21.0}):
        assert t_det.create_detection_limit(got, limit, detectors, too) == \
            j_det.create_detection_limit(got, limit, detectors, too)
    with pytest.raises(ValueError, match="unknown EM detectors"):
        t_det.set_filters(None, "ztf,wise")


def test_lbol_main_matches(tmp_path):
    """lbol_main of both packages on one csv (read with numpy in the port,
    pandas in the JAX package): finite logZ within 3 combined errors,
    posterior medians within 0.1 of the prior width, the result file with
    the JAX package's keys."""
    phase, obs, err = lbol_data()
    csv = tmp_path / "lbol.csv"
    np.savetxt(csv, np.column_stack([phase, obs, err]), delimiter=",",
               header="phase,Lbb,Lbb_unc", comments="")
    prior = tmp_path / "arnett.prior"
    prior.write_text("tau_m = Uniform(minimum=5., maximum=30.)\n"
                     "log10_mni = Uniform(minimum=-2., maximum=0.)\n")
    results, posts = [], []
    for name, fn, kw in (("jax", j_lbol_main, {}),
                         ("port", t_lbol_main, {"device": "cpu"})):
        out = tmp_path / name
        results.append(fn(["--model", "Arnett", "--prior", str(prior),
                           "--light-curve-data", str(csv), "--nlive", "128",
                           "--dlogz", "0.5", "--outdir", str(out),
                           "--label", "lbol"], **kw))
        posts.append(np.load(out / "lbol_result.npz"))
    (j_res, t_res), (j_post, t_post) = results, posts
    assert np.isfinite(t_res.logz)
    assert abs(t_res.logz - j_res.logz) < 3 * (t_res.logz_err
                                               + j_res.logz_err)
    assert sorted(t_post.files) == sorted(j_post.files)
    for key, width in (("posterior_tau_m", 25.0),
                       ("posterior_log10_mni", 2.0)):
        assert abs(np.median(t_post[key]) - np.median(j_post[key])) \
            < 0.1 * width
