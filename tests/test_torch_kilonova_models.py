"""The port's HoNa2020, blackbody_fixedT, PL_BB_fixedT and
synchrotron_powerlaw models and its G23-MW extinction against the JAX
package.

The same seeded parameter draws (numpy, B=16) go through the JAX package's
``DetectorLightCurveModel`` under ``jax.vmap`` on the CPU and through the
port's batch-first ``DetectorLightCurveModel(..., device="cpu")``. The
detector frame is compared (redshift, distance modulus, extinction and, for
HoNa2020 and blackbody_fixedT, the bandpass quadrature), so each model's
magnitudes reach the likelihood as compared here.

Tolerances: inf in the same places; finite magnitudes within 1e-4 mag. Both
packages evaluate the same f32 formulas in the same order; what differs is
the libraries' transcendental functions (erfc, pow, arctan) and the order of
HoNa2020's sum over 99 shells, each a few ulps. HoNa2020's RK4 carries them
through 299 steps; the test prints its largest deviation. G23-MW flux
factors: relative 1e-5 (a polynomial of degree 7 in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.models as j_models
import nmma_tpu.ops.extinction as j_ext
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.ops.extinction as t_ext

torch.set_num_threads(1)

B = 16
MAG_TOL = 1e-4
FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "2massks"]
# (low, high) of each parameter's seeded uniform draw
CASES = {
    "HoNa2020": dict(
        log10_mej=(-2.5, -1.0), vej_min=(0.03, 0.08), vej_max=(0.2, 0.4),
        vej_frac=(0.2, 0.8), log10_kappa_low_vej=(-0.5, 0.5),
        log10_kappa_high_vej=(0.3, 1.0), luminosity_distance=(10.0, 200.0),
        timeshift=(-0.1, 0.1), Ebv=(0.0, 0.3)),
    "blackbody_fixedT": dict(
        log10_bb_luminosity=(40.0, 42.0), temperature=(3000.0, 10000.0),
        luminosity_distance=(10.0, 200.0), timeshift=(-0.1, 0.1),
        Ebv=(0.0, 0.3)),
    "PL_BB_fixedT": dict(
        log10_bb_luminosity=(40.0, 42.0), temperature=(3000.0, 10000.0),
        beta=(0.5, 2.0), powerlaw_mag=(18.0, 24.0),
        luminosity_distance=(10.0, 200.0), timeshift=(-0.1, 0.1),
        Ebv=(0.0, 0.3)),
    "synchrotron_powerlaw": dict(
        alpha_time=(0.5, 1.5), beta_freq=(0.5, 1.0), F_ref=(0.01, 1.0),
        luminosity_distance=(10.0, 200.0), timeshift=(-0.1, 0.1),
        Ebv=(0.0, 0.3)),
}


def draws(ranges, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, B).astype(np.float32)
            for k, (lo, hi) in ranges.items()}


def both_detectors(name, filters, law, grid):
    j_det = j_models.DetectorLightCurveModel(
        name, filters, sample_times=grid, extinction_law=law)
    t_det = t_models.DetectorLightCurveModel(
        name, filters, sample_times=grid, extinction_law=law, device="cpu")
    return j_det, t_det


def run_both(j_det, t_det, params):
    j_times, j_mags = jax.vmap(j_det)(
        {k: jnp.asarray(v) for k, v in params.items()})
    t_times, t_mags = t_det({k: torch.from_numpy(v)
                             for k, v in params.items()})
    return (np.asarray(j_times), np.asarray(j_mags), t_times.numpy(),
            t_mags.numpy())


@pytest.mark.parametrize("law", ["P92_SMC_host", "G23_MW"])
@pytest.mark.parametrize("name", list(CASES))
def test_model_magnitudes_match(name, law):
    """Detector-frame magnitudes of the four models at B=16 under both
    extinction laws: inf in the same places, 1e-4 mag elsewhere."""
    grid = np.geomspace(0.1, 14.0, 60) if name == "HoNa2020" \
        else np.geomspace(0.05, 14.0, 40)
    j_det, t_det = both_detectors(name, FILTERS, law, grid)
    params = draws(CASES[name], seed=len(name))
    j_times, j_mags, t_times, t_mags = run_both(j_det, t_det, params)
    np.testing.assert_allclose(t_times, j_times, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.isinf(t_mags), np.isinf(j_mags))
    fin = np.isfinite(j_mags)
    assert fin.mean() > 0.5, f"{name}: only {fin.mean():.2f} finite"
    dev = float(np.abs(t_mags[fin] - j_mags[fin]).max())
    print(f"{name} {law}: max |dmag| {dev:.3e} over {int(fin.sum())} values")
    assert dev <= MAG_TOL


def test_pl_bb_anchors_on_g_band():
    """PL_BB_fixedT with a 'g' filter that is not the first: the power law
    is anchored at that filter's frequency in both packages."""
    filters = ["ztfr", "g", "ztfi"]
    grid = np.geomspace(0.05, 14.0, 40)
    j_det, t_det = both_detectors("PL_BB_fixedT", filters, "P92_SMC_host",
                                  grid)
    params = draws(CASES["PL_BB_fixedT"], seed=3)
    _, j_mags, _, t_mags = run_both(j_det, t_det, params)
    np.testing.assert_array_equal(np.isinf(t_mags), np.isinf(j_mags))
    fin = np.isfinite(j_mags)
    np.testing.assert_allclose(t_mags[fin], j_mags[fin], rtol=0,
                               atol=MAG_TOL)


def test_hona2020_at_reference_point():
    """HoNa2020 at the JAX package's oracle point
    (tests/test_kilonova_models.py:149-155) on the reference grid
    geomspace(0.05, 14, 80), single-frequency photometry through the source
    model itself: 1e-4 mag."""
    grid = np.geomspace(0.05, 14.0, 80)
    point = dict(log10_mej=-1.5, vej_min=0.05, vej_max=0.3, vej_frac=0.5,
                 log10_kappa_low_vej=0.0, log10_kappa_high_vej=0.7)
    nu = np.array([4.8e14, 6.3e14], dtype=np.float32)
    want = np.asarray(j_models.get_source_model("HoNa2020").mags_fn(
        {k: jnp.float32(v) for k, v in point.items()},
        jnp.asarray(grid, dtype=jnp.float32), jnp.asarray(nu)))
    got = t_models.get_source_model("HoNa2020").mags_fn(
        {k: torch.tensor([v]) for k, v in point.items()},
        torch.tensor(grid, dtype=torch.float32),
        torch.from_numpy(nu)[None])[0].numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.9
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=MAG_TOL)


def test_g23_mw_factors_match():
    """G23-MW flux factors and band magnitudes on frequencies across the
    law's IR, optical and UV branches and outside its range: relative 1e-5
    for the factors, 1e-5 mag for the band average."""
    rng = np.random.default_rng(23)
    nu = np.geomspace(5e13, 3e15, 64).astype(np.float32)  # x from 0.17 to 10
    ebv = rng.uniform(0.0, 1.0, B).astype(np.float32)
    want = np.asarray(j_ext.extinction_factor_mw(
        jnp.asarray(nu)[None, :], jnp.asarray(ebv)[:, None]))
    got = t_ext.extinction_factor_mw(
        torch.from_numpy(nu)[None, :], torch.from_numpy(ebv)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    nodes = nu.reshape(8, 8)
    weights = rng.uniform(0.1, 1.0, (8, 8)).astype(np.float32)
    weights /= weights.sum(axis=1, keepdims=True)
    want = np.asarray(jax.vmap(lambda e: j_ext.band_extinction_mags_mw(
        jnp.asarray(nodes), jnp.asarray(weights), e))(jnp.asarray(ebv)))
    got = t_ext.band_extinction_mags_mw(
        torch.from_numpy(nodes), torch.from_numpy(weights),
        torch.from_numpy(ebv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
