"""Photometry ops and the Me2017 temperature fill of the PyTorch port
against the JAX package.

One parametrised test: each case feeds the same seeded numpy inputs to a
function of ``nmma_tpu/ops/photometry.py`` or ``nmma_tpu/ops/interp.py``
(batched with ``jax.vmap`` where the JAX function takes one live point) and
to its batch-first port, and returns the pairs to compare. Tolerance: f32
round-off, rtol 1e-5; inf and nan positions must be identical. Values that
cross 0 also get an atol: 1e-6 for ``log_expm1`` (0 at x = ln 2), and 1e-5
mag for magnitudes, which are assembled from ln F_nu of -40 to -80 whose f32
rounding (~5e-6) becomes ~5e-6 mag whatever the magnitude's own size.
"""

import jax
import numpy as np
import pytest
import torch

import nmma_tpu.ops.interp as j_interp
import nmma_tpu.ops.photometry as j_phot
import nmma_tpu_torch.ops.interp as t_interp
import nmma_tpu_torch.ops.photometry as t_phot
from nmma_tpu_torch.filters import filters_to_frequencies, filters_to_quadrature

torch.set_num_threads(1)

MAG_ATOL = 1e-5
FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
           "2massj", "2massh", "2massks"]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def photosphere(rng, b=16, t=40):
    """Inverse temperatures [B, T] of 1e3-3e4 K and radii [B, T] of
    1e13-1e16 cm, with invalid points: 1/T = inf, and radius 0."""
    inv_t = (1.0 / rng.uniform(1e3, 3e4, (b, t))).astype(np.float32)
    radius = (10.0 ** rng.uniform(13, 16, (b, t))).astype(np.float32)
    inv_t[rng.uniform(size=(b, t)) < 0.05] = np.inf
    radius[rng.uniform(size=(b, t)) < 0.05] = 0.0
    radius[:, -1] = 0.0
    return inv_t, radius


def case_log_expm1(rng):
    x = np.concatenate([10.0 ** rng.uniform(-6, 2, 500),
                        [1e-30, np.log(2.0), 19.999, 20.0, 20.001, 79.0,
                         80.0, 200.0]]).astype(np.float32)
    return [(t_phot.log_expm1(_t(x)), j_phot.log_expm1(x), 1e-5, 1e-6)]


def case_ab_mags(rng):
    log_flux = rng.uniform(-80.0, -20.0, (8, 30)).astype(np.float32)
    flux = rng.uniform(-1.0, 5.0, (8, 30)).astype(np.float32)
    flux[0, :3] = 0.0
    out = [(t_phot.ab_mag_from_log_flux(_t(log_flux)),
            j_phot.ab_mag_from_log_flux(log_flux), 1e-5, MAG_ATOL)]
    for unit in ("cgs", "Jy", "mJy"):
        out.append((t_phot.flux_to_ab_mag(_t(flux), unit=unit),
                    j_phot.flux_to_ab_mag(flux, unit=unit), 1e-5, MAG_ATOL))
    out.append((t_phot.flux_to_ab_mag(_t(flux), residual_mag=3.0),
                j_phot.flux_to_ab_mag(flux, residual_mag=3.0), 1e-5,
                MAG_ATOL))
    return out


def case_banded_ab_mag(rng):
    """Band magnitudes from per-node log fluxes [B, F, K, T] with -inf
    nodes, some (filter, time) columns all -inf."""
    _, weights = filters_to_quadrature(FILTERS)
    weights = weights.astype(np.float32)
    log_flux = rng.uniform(-60.0, -40.0, (6, 9, 9, 20)).astype(np.float32)
    log_flux[rng.uniform(size=log_flux.shape) < 0.1] = -np.inf
    log_flux[:, 2, :, 5] = -np.inf
    want = jax.vmap(j_phot.banded_ab_mag_from_log_flux,
                    in_axes=(0, None))(log_flux, weights)
    return [(t_phot.banded_ab_mag_from_log_flux(_t(log_flux), _t(weights)),
             want, 1e-5, MAG_ATOL)]


def case_blackbody_banded(rng):
    """Bandpass-integrated blackbody: [B, F, K] host-frame nodes at
    redshifts up to 0.1, weights [F, K]."""
    nodes, weights = filters_to_quadrature(FILTERS)
    z = rng.uniform(0.0, 0.1, 16).astype(np.float32)
    nodes = (nodes[None].astype(np.float32)
             * (1.0 + z)[:, None, None]).astype(np.float32)
    weights = weights.astype(np.float32)
    inv_t, radius = photosphere(rng)
    want = jax.vmap(j_phot.blackbody_ab_mag_banded,
                    in_axes=(0, None, 0, 0))(nodes, weights, inv_t, radius)
    got = t_phot.blackbody_ab_mag_banded(_t(nodes), _t(weights), _t(inv_t),
                                         _t(radius))
    return [(got, want, 1e-5, MAG_ATOL)]


def case_blackbody_point(rng):
    nu = filters_to_frequencies(FILTERS).astype(np.float32)
    z = rng.uniform(0.0, 0.1, 16).astype(np.float32)
    nu_host = (nu[None] * (1.0 + z)[:, None]).astype(np.float32)
    inv_t, radius = photosphere(rng)
    want = jax.vmap(j_phot.blackbody_ab_mag)(nu_host, inv_t, radius)
    got = t_phot.blackbody_ab_mag(_t(nu_host), _t(inv_t), _t(radius))
    return [(got, want, 1e-5, MAG_ATOL)]


def case_masked_interp_linear_sorted(rng):
    """Rows with nan heads, tails and interior holes, a row with one valid
    sample and a row with none, on the model grid and on off-grid queries
    beyond both ends."""
    x = np.geomspace(0.01, 14.0, 60).astype(np.float32)
    y = (3e3 + 1e3 * np.sin(rng.uniform(0, 6, (12, 1)) + x)).astype(
        np.float32)
    y[rng.uniform(size=y.shape) < 0.2] = np.nan
    y[0, :5] = np.nan
    y[1, -7:] = np.nan
    y[2, :] = np.nan
    y[2, 30] = 4e3
    y[3, :] = np.nan
    y[4, -1] = np.inf
    xq = np.concatenate([x, rng.uniform(0.0, 20.0, 25)]).astype(np.float32)
    out = []
    for q in (x, xq):
        want = jax.vmap(j_interp.masked_interp_linear_sorted,
                        in_axes=(None, None, 0))(q, x, y)
        out.append((t_interp.masked_interp_linear_sorted(_t(q), _t(x), _t(y)),
                    want, 1e-5, 0.0))
    return out


CASES = {
    "log_expm1": case_log_expm1,
    "ab_mags": case_ab_mags,
    "banded_ab_mag": case_banded_ab_mag,
    "blackbody_banded": case_blackbody_banded,
    "blackbody_point": case_blackbody_point,
    "masked_interp_linear_sorted": case_masked_interp_linear_sorted,
}


@pytest.mark.parametrize("name", list(CASES))
def test_photometry_parity(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    pairs = CASES[name](rng)
    assert pairs
    for got, want, rtol, atol in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
