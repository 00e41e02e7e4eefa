"""The port's FITS and HEALPix I/O (``nmma_tpu_torch/io/fits.py``) and the
sky-map inclination prior against the JAX package's, on the CPU.

* BINTABLE files written by either package read back column for column,
  bit for bit, by the other (scalar and vector columns, every TFORM the
  writer emits, the header cards);
* ``uniq2nest``, ``ang2pix_nest`` and ``ang2pix_ring`` are integer maps:
  equal at 10,000 seeded sky positions and every order up to 2^10;
* ``detection_limit_from_m4opt_fits`` on NESTED and RING maps: equal;
* ``inclination_prior_from_fits`` on a seeded multi-order sky map: the
  prior's nodes (abscissae and density) within 1e-6 relative (the JAX
  package keeps them in f32, the port in float64), and ``log_prob`` on a
  grid within 1e-6 relative, -inf outside [0, pi/2] in both.

The sky maps are made here, with ``write_bintable``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.io.fits as j_fits
import nmma_tpu.priors.astro as j_astro
import nmma_tpu_torch.io.fits as t_fits
import nmma_tpu_torch.priors.astro as t_astro

RTOL = 1e-6
N_POS = 10_000


def sky_positions(seed=0, n=N_POS):
    """(theta, phi) uniform on the sphere, with the poles, the equator's
    belt edges and phi = 0 / 2 pi among them."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1.0, 1.0, n))
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    edges = np.arccos([1.0, -1.0, 2.0 / 3.0, -2.0 / 3.0, 0.0])
    theta[:5], phi[:5] = edges, [0.0, 2.0 * np.pi, 1.0, 3.0, np.pi]
    return theta, phi


def skymap_columns(seed=1, base_order=2, nodes=10, scalar_prob=False):
    """A multi-order sky map: every pixel of ``base_order``, the first 24
    of them split into their 4 children one order deeper, with the four
    cos-iota ``*_SAMPLES`` layers (positive densities, distances around 40
    Mpc) and, optionally, a scalar PROBDENSITY column."""
    rng = np.random.default_rng(seed)
    n_base = 12 * 4**base_order
    split = np.arange(24)
    uniq = [4 ** (base_order + 1) + i for i in range(n_base)
            if i not in split]
    uniq += [4 ** (base_order + 2) + 4 * i + k for i in split
             for k in range(4)]
    uniq = np.asarray(uniq, dtype=np.int64)
    n = len(uniq)
    mu = rng.uniform(30.0, 50.0, (n, nodes))
    sigma = rng.uniform(5.0, 12.0, (n, nodes))
    cols = {
        "UNIQ": uniq,
        "PROBDENSITY_SAMPLES": rng.uniform(0.1, 2.0, (n, nodes)),
        "DISTMU_SAMPLES": mu,
        "DISTSIGMA_SAMPLES": sigma,
        "DISTNORM_SAMPLES": 1.0 / (mu**2 + sigma**2),
    }
    if scalar_prob:
        cols["PROBDENSITY"] = cols["PROBDENSITY_SAMPLES"].mean(axis=1)
    return cols


def all_dtypes_columns(rng, n=37):
    return {
        "i8": rng.integers(-2**40, 2**40, n),
        "i4": rng.integers(-2**30, 2**30, n).astype(np.int32),
        "i2": rng.integers(-2**14, 2**14, n).astype(np.int16),
        "u1": rng.integers(0, 255, n).astype(np.uint8),
        "f4": rng.normal(size=n).astype(np.float32),
        "f8": rng.normal(size=n),
        "vec": rng.normal(size=(n, 10)),
        "vec4": rng.normal(size=(n, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bintable_read_by_the_other_package(tmp_path, writer):
    cols = all_dtypes_columns(np.random.default_rng(5))
    header = {"NSIDE": 64, "ORDERING": "NESTED", "PIXTYPE": "HEALPIX",
              "DISTMEAN": 40.5, "MOC": True}
    path = tmp_path / f"{writer}.fits"
    write, read = ((j_fits.write_bintable, t_fits.read_bintable)
                   if writer == "jax" else
                   (t_fits.write_bintable, j_fits.read_bintable))
    write(str(path), cols, extra_header=header)
    got, got_header = read(str(path))
    assert list(got) == list(cols)
    for k, v in cols.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    for k, v in header.items():
        assert got_header[k] == v, k
    # the two writers make the same bytes
    other = tmp_path / "other.fits"
    (t_fits.write_bintable if writer == "jax" else j_fits.write_bintable)(
        str(other), cols, extra_header=header)
    assert other.read_bytes() == path.read_bytes()


def test_uniq2nest_matches():
    rng = np.random.default_rng(2)
    order = rng.integers(0, 30, N_POS)
    nest = (rng.uniform(size=N_POS) * 12 * 4.0**order).astype(np.int64)
    uniq = 4 ** (order + 1) + nest
    got, want = t_fits.uniq2nest(uniq), j_fits.uniq2nest(uniq)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], order)
    np.testing.assert_array_equal(got[1], nest)


@pytest.mark.parametrize("scheme", ["nest", "ring"])
def test_ang2pix_matches(scheme):
    theta, phi = sky_positions()
    for order in range(11):
        nside = 2**order
        got = getattr(t_fits, f"ang2pix_{scheme}")(nside, theta, phi)
        want = getattr(j_fits, f"ang2pix_{scheme}")(nside, theta, phi)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < 12 * nside**2


@pytest.mark.parametrize("ordering", ["NESTED", "RING"])
def test_detection_limit_from_m4opt_fits_matches(tmp_path, ordering):
    nside = 16
    rng = np.random.default_rng(7)
    limmag = rng.uniform(19.0, 23.0, 12 * nside**2)
    path = str(tmp_path / "m4opt.fits")
    t_fits.write_bintable(path, {"LIMMAG": limmag},
                          extra_header={"NSIDE": nside,
                                        "ORDERING": ordering})
    ra = rng.uniform(0.0, 360.0, 50)
    dec = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, 50)))
    for r, d in zip(ra, dec):
        got = t_fits.detection_limit_from_m4opt_fits(path, r, d)
        assert got == j_fits.detection_limit_from_m4opt_fits(path, r, d)
        assert got in limmag


@pytest.mark.parametrize("case", ["max_prob_pixel", "ra_dec",
                                  "scalar_probdensity"])
def test_inclination_prior_from_fits_matches(tmp_path, case):
    cols = skymap_columns(scalar_prob=case == "scalar_probdensity")
    path = str(tmp_path / "skymap.fits")
    j_fits.write_bintable(path, cols, extra_header={"MOC": True})
    kwargs = dict(dL=40.0)
    if case == "ra_dec":
        kwargs.update(ra=197.45, dec=-23.38)
    want = j_astro.inclination_prior_from_fits(path, **kwargs)
    got = t_astro.inclination_prior_from_fits(path, **kwargs)
    assert got.minimum == 0.0 and 1.5 < got.maximum < np.pi / 2
    np.testing.assert_allclose(got.maximum, float(want.maximum), rtol=RTOL)
    for name in ("xx", "yy", "cdf"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=1e-12, err_msg=name)
    x = np.linspace(-0.2, np.pi / 2 + 0.2, 301).astype(np.float32)
    lp_want = np.asarray(want.log_prob(jnp.asarray(x)))
    lp_got = got.log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(lp_got), np.isfinite(lp_want))
    ok = np.isfinite(lp_want)
    assert ok.sum() > 200
    np.testing.assert_allclose(lp_got[ok], lp_want[ok], rtol=RTOL)
    u = np.linspace(0.0, 1.0, 101).astype(np.float32)
    np.testing.assert_allclose(
        got.transform(torch.from_numpy(u)).numpy(),
        np.asarray(want.transform(jnp.asarray(u))), rtol=RTOL, atol=1e-7)
