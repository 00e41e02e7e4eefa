"""The port's new prior kinds and its astro prior module against the JAX
package.

Seeded unit-cube draws (numpy, B=256) go through both packages' priors:
UniformComovingVolume and UniformSourceFrame on each package's Planck18
tables, WeightedCategorical, the conditional half-Gaussian iota | thetaCore,
a correlated multivariate-Gaussian block, ``create_prior_from_args`` with
the linear-decay Ebv prior and the conditional inclination, and an HDF5
multivariate prior written with h5py.

Tolerances: the f32 transforms within 2e-6 relative (the same f32 formulas;
erf, erfinv and ndtri come from different libraries and differ by an ulp or
two); the conditional inclination within 5e-5 relative, because its erfinv
argument a + u (b - a) lies near 1 when thetaCore is small, where erfinv's
slope turns an ulp of erf(b) into up to 1.7e-5 of the angle (the largest
seen); log_prob within 1e-5 absolute inside the support; the float64 host
tables equal to 1e-12; discrete draws equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.priors as jp
import nmma_tpu.priors.astro as j_astro
import nmma_tpu.priors.core as j_core
import nmma_tpu_torch.priors as tp
import nmma_tpu_torch.priors.astro as t_astro
import nmma_tpu_torch.priors.core as t_core

torch.set_num_threads(1)

B = 256
RTOL = 2e-6
IOTA_RTOL = 5e-5


def units(n_dim, seed=0):
    return np.random.default_rng(seed).uniform(
        1e-4, 1 - 1e-4, (B, n_dim)).astype(np.float32)


def transform_both(j_dict, t_dict, u):
    """Both PriorDicts' transforms of ``u`` as numpy dicts."""
    want = jax.vmap(j_dict.transform)(jnp.asarray(u))
    got = t_dict.transform(torch.from_numpy(u))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_transforms_match(j_dict, t_dict, seed=0):
    assert t_dict.sampled_names == j_dict.sampled_names
    want, got = transform_both(j_dict, t_dict, units(t_dict.ndim, seed))
    assert sorted(got) == sorted(want)   # jax.vmap sorts dict keys
    for k in want:
        rtol = IOTA_RTOL if isinstance(
            t_dict[k], t_core.ConditionalGaussianIotaGivenThetaCore) \
            else RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["UniformComovingVolume",
                                  "UniformSourceFrame"])
def test_distance_priors_match(kind):
    j_prior = getattr(j_core, kind)(minimum=10.0, maximum=800.0)
    t_prior = getattr(t_core, kind)(minimum=10.0, maximum=800.0)
    np.testing.assert_allclose(t_prior.xx, np.asarray(j_prior.xx),
                               rtol=1e-6)
    np.testing.assert_allclose(t_prior.cdf, np.asarray(j_prior.cdf),
                               rtol=0, atol=1e-7)
    u = units(1)[:, 0]
    want = np.asarray(j_prior.transform(jnp.asarray(u)))
    got = t_prior.transform(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # p(d_L) grows ~ d_L^2 at small distance: most draws lie far out
    assert np.median(got) > 500.0
    x = np.linspace(20.0, 790.0, 64, dtype=np.float32)
    np.testing.assert_allclose(
        t_prior.log_prob(torch.from_numpy(x)).numpy(),
        np.asarray(j_prior.log_prob(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_prior_file_names_parse():
    """The parser takes the new kinds under their names and the bilby
    module path of the reference's prior files."""
    text = ("luminosity_distance = bilby.gw.prior.UniformComovingVolume("
            "minimum=10., maximum=500., name='luminosity_distance')\n"
            "dl_sf = UniformSourceFrame(minimum=10., maximum=500.)\n"
            "thetaCore = Uniform(minimum=0.02, maximum=0.2)\n"
            "inclination_EM = ConditionalGaussianIotaGivenThetaCore("
            "N_sigma=2.0)\n")
    assert_transforms_match(jp.parse_prior_dict(text),
                            tp.parse_prior_dict(text))


def test_weighted_categorical_matches():
    weights = [0.5, 2.0, 0.0, 1.0, 3.5]
    j_prior = j_core.WeightedCategorical(5, weights)
    t_prior = t_core.WeightedCategorical(5, weights)
    u = units(1, seed=4)[:, 0]
    want = np.asarray(j_prior.transform(jnp.asarray(u)))
    got = t_prior.transform(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 2.5 not in got      # the zero-weight category is never drawn
    x = np.array([-0.5, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5], dtype=np.float32)
    np.testing.assert_allclose(
        t_prior.log_prob(torch.from_numpy(x)).numpy(),
        np.asarray(j_prior.log_prob(jnp.asarray(x))), rtol=1e-6)


def test_conditional_iota_given_thetacore_matches():
    def build(core):
        return core.PriorDict({
            "thetaCore": core.Uniform(minimum=0.02, maximum=0.3),
            "inclination_EM": core.ConditionalGaussianIotaGivenThetaCore(
                N_sigma=1.5, minimum=0.0, maximum=np.pi / 2)})
    assert_transforms_match(build(j_core), build(t_core), seed=5)


def test_multivariate_block_matches():
    mean = [1.4, 12.0, -0.5]
    cov = [[0.04, 0.05, 0.001], [0.05, 0.5, 0.02], [0.001, 0.02, 0.09]]
    names = ["mass", "radius", "tilt"]
    j_dict = j_core.PriorDict(j_core.multivariate_gaussian_priors(
        names, mean, cov))
    t_dict = t_core.PriorDict(t_core.multivariate_gaussian_priors(
        names, mean, cov))
    assert_transforms_match(j_dict, t_dict, seed=6)
    got = t_dict.transform(torch.from_numpy(units(3, seed=6)))
    sample = np.stack([got[n].numpy() for n in names], axis=1)
    np.testing.assert_allclose(np.cov(sample, rowvar=False), cov,
                               atol=0.05)
    x = np.linspace(0.8, 2.0, 16, dtype=np.float32)
    np.testing.assert_allclose(
        t_dict["mass"].log_prob(torch.from_numpy(x)).numpy(),
        np.asarray(j_dict["mass"].log_prob(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("conditional", [False, True])
def test_create_prior_from_args_matches(tmp_path, conditional):
    path = tmp_path / "grb.prior"
    path.write_text(
        "inclination_EM = Uniform(minimum=0., maximum=0.6)\n"
        "log10_E0 = Uniform(minimum=49., maximum=54.)\n"
        "thetaCore = Uniform(minimum=0.01, maximum=0.3)\n"
        "luminosity_distance = UniformComovingVolume(minimum=50., "
        "maximum=400.)\n"
        "timeshift = 0.0\n")
    kwargs = dict(Ebv_max=0.4, use_Ebv=True,
                  conditional_gaussian_prior_thetaObs=conditional,
                  conditional_gaussian_prior_N_sigma=2.0,
                  sample_hubble=True, hubble_kind="planck")
    j_dict = j_astro.create_prior_from_args(str(path), **kwargs)
    t_dict = t_astro.create_prior_from_args(str(path), **kwargs)
    assert list(t_dict.keys()) == list(j_dict.keys())
    assert t_dict.sampled_names[-1] == ("inclination_EM" if conditional
                                        else "Ebv")
    assert_transforms_match(j_dict, t_dict, seed=7)
    ebv = t_dict.transform(torch.from_numpy(units(t_dict.ndim, 7)))["Ebv"]
    # linear decay: P(Ebv < Ebv_max / 2) = 3/4
    assert abs(float((ebv < 0.2).float().mean()) - 0.75) < 0.08


def test_h5_multivariate_prior_matches(tmp_path):
    import h5py

    rng = np.random.default_rng(8)
    z = rng.normal(size=(4000, 2))
    samples = {"mass_1": 1.4 + 0.1 * z[:, 0],
               "lambda_1": 400.0 + 80.0 * (0.6 * z[:, 0] + 0.8 * z[:, 1])}
    h5 = tmp_path / "eos_samples.h5"
    with h5py.File(h5, "w") as f:
        for k, v in samples.items():
            f[k] = v
    text = (f"eos_h5 = NMMADummyPrior(setup_props='{h5}')\n"
            "timeshift = Uniform(minimum=-0.1, maximum=0.1)\n")
    j_dict = j_astro.adjust_priors_for_nmma(jp.parse_prior_dict(text))
    t_dict = t_astro.adjust_priors_for_nmma(tp.parse_prior_dict(text))
    assert sorted(t_dict.sampled_names) == \
        ["lambda_1", "mass_1", "timeshift"]
    assert_transforms_match(j_dict, t_dict, seed=9)


LOG_PROB_X = np.array([-1e3, -1.0, 0.0, 0.25, 0.5, 1.0, 5.0, 10.0, 20.0,
                       499.0, 500.0, 1e3, 1e4], dtype=np.float32)


@pytest.mark.parametrize("kind", ["Interped", "UniformComovingVolume",
                                  "UniformSourceFrame"])
def test_log_prob_outside_the_support_matches_jax(kind):
    """-inf where the density is 0, as the JAX package's f32
    log(max(dens, 1e-300)), whose floor rounds to 0: outside the support,
    and at x = 0 of an Interped density x^2; inside it within 1e-5 (the
    support tests above)."""
    if kind == "Interped":
        xx = np.linspace(0.0, 1.0, 50)
        j_prior, t_prior = (mod.Interped(xx, xx ** 2)
                            for mod in (j_core, t_core))
    else:
        j_prior, t_prior = (getattr(mod, kind)(minimum=10.0, maximum=500.0)
                            for mod in (j_core, t_core))
    want = np.asarray(j_prior.log_prob(jnp.asarray(LOG_PROB_X)))
    got = t_prior.log_prob(torch.from_numpy(LOG_PROB_X)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() >= 4 and not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)
