"""Module-level parity of the PyTorch port against the JAX package.

One parametrised test: each case feeds the same seeded numpy inputs to a
JAX-package function and to its port, and returns the pairs to compare with
the tolerance stated beside them. Unless a case says otherwise the
tolerance is f32 round-off: rtol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.cosmology as j_cosmo
import nmma_tpu.io.photometry as j_phot
import nmma_tpu.likelihood.systematics as j_sys
import nmma_tpu.ops.extinction as j_ext
import nmma_tpu.ops.interp as j_interp
import nmma_tpu.priors as j_priors
import nmma_tpu_torch.cosmology as t_cosmo
import nmma_tpu_torch.io.photometry as t_phot
import nmma_tpu_torch.likelihood.systematics as t_sys
import nmma_tpu_torch.ops.extinction as t_ext
import nmma_tpu_torch.ops.interp as t_interp
import nmma_tpu_torch.priors as t_priors
from nmma_tpu_torch.filters import filters_to_quadrature

torch.set_num_threads(1)

SVD_FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
               "2massj", "2massh", "2massks"]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def case_cosmology(rng):
    d_l = rng.uniform(1.0, 2000.0, 512).astype(np.float32)
    z = rng.uniform(0.0, 0.4, 512).astype(np.float32)
    tc, jc = t_cosmo.get_cosmology(), j_cosmo.get_cosmology()
    return [
        (tc.redshift_at_dl(_t(d_l)), jc.redshift_at_dl(d_l), 1e-5, 0.0),
        (tc.luminosity_distance(_t(z)), jc.luminosity_distance(z), 1e-5, 0.0),
        (t_cosmo.distance_modulus(_t(d_l)), j_cosmo.distance_modulus(d_l),
         1e-5, 0.0),
    ]


def case_extinction(rng):
    """P92-SMC band extinction over the surrogate's 9 bandpasses. atol 1e-6
    mag besides rtol: at Ebv -> 0 the attenuation itself goes to 0."""
    nodes, weights = filters_to_quadrature(SVD_FILTERS)
    ebv = rng.uniform(0.0, 0.5, 64).astype(np.float32)
    z = rng.uniform(0.0, 0.1, 64).astype(np.float32)
    want = jax.vmap(lambda e, zz: j_ext.band_extinction_mags_p92_smc(
        jnp.asarray(nodes), jnp.asarray(weights), e, zz))(ebv, z)
    got = t_ext.band_extinction_mags_p92_smc(_t(nodes), _t(weights),
                                             _t(ebv), _t(z))
    return [(got, want, 1e-5, 1e-6)]


def case_interp(rng):
    """jnp.interp and the masked interpolants, with invalid samples and
    queries outside the valid range. atol 1e-6 for values near 0."""
    x = np.sort(rng.uniform(0.0, 10.0, 40)).astype(np.float32)
    y = np.sin(x).astype(np.float32)
    y[rng.choice(40, 8, replace=False)] = np.nan
    y_inf = y.copy()
    y_inf[:3] = np.inf                 # an invalid head, as model rows have
    xq = rng.uniform(-2.0, 12.0, 200).astype(np.float32)
    y_ok = np.nan_to_num(y)
    return [
        (t_interp.interp(_t(xq), _t(x), _t(y_ok)),
         jnp.interp(xq, x, y_ok), 1e-5, 1e-6),
        (t_interp.masked_interp(_t(xq), _t(x), _t(y)),
         j_interp.masked_interp(xq, x, y), 1e-5, 1e-6),
        (t_interp.masked_interp(_t(xq), _t(x), _t(y), left=-5.0, right=5.0),
         j_interp.masked_interp(xq, x, y, left=-5.0, right=5.0), 1e-5, 1e-6),
        (t_interp.masked_interp_sorted_fill(_t(xq), _t(x), _t(y_inf),
                                            math.inf),
         j_interp.masked_interp_sorted_fill(xq, x, y_inf, jnp.inf),
         1e-5, 1e-6),
    ]


PRIOR_TEXT = """
a = Uniform(minimum=-3., maximum=-1.)
b = LogUniform(minimum=1., maximum=200.)
c = Sine(minimum=0., maximum=3.14159)
d = Cosine()
e = Gaussian(mu=1.5, sigma=0.3)
f = TruncatedGaussian(mu=0., sigma=1., minimum=-1., maximum=2.)
g = PowerLaw(alpha=2., minimum=1., maximum=3.)
h = LogNormal(mu=0., sigma=0.5)
fixed = 4.5
delta = DeltaFunction(peak=2.0)
ratio = Constraint(minimum=0.2, maximum=1.0)
"""


def case_priors(rng):
    """Unit-cube transforms of every ported prior class (u kept off the
    ndtri tails: f32 ndtri differs most near 0 and 1), the fixed values,
    log-probabilities, and constraint_log_prob (0 or -inf, exactly)."""
    tp = t_priors.parse_prior_dict(PRIOR_TEXT)
    jp = j_priors.parse_prior_dict(PRIOR_TEXT)
    assert tp.sampled_names == jp.sampled_names
    u = rng.uniform(0.01, 0.99, (256, tp.ndim)).astype(np.float32)
    got, want = tp.transform(_t(u)), jp.transform(jnp.asarray(u))
    assert set(got) == set(want)
    pairs = [(got[k], want[k], 1e-5, 1e-6) for k in want]
    pairs += [(tp[k].log_prob(got[k]), jp[k].log_prob(want[k]), 1e-5, 1e-5)
              for k in tp.sampled_names]
    ratio = rng.uniform(0.0, 1.5, 256).astype(np.float32)
    pairs.append((tp.constraint_log_prob({"ratio": _t(ratio), "a": got["a"]}),
                  np.broadcast_to(jp.constraint_log_prob(
                      {"ratio": jnp.asarray(ratio)}), ratio.shape), 0.0, 0.0))
    return pairs


def case_photometry(rng, tmp_path):
    """Observation file -> load -> cut -> shift -> drop non-detections:
    host-side float64, so exactly equal."""
    trigger = 57982.5
    lines = []
    for f in ("ztfg", "ztfr", "2massks"):
        for t in rng.uniform(-1.0, 20.0, 8):
            err = np.inf if rng.uniform() < 0.25 else 0.1
            lines.append(f"{trigger + t:.6f} {f} {rng.uniform(18, 23):.4f} "
                         f"{err}\n")
    path = tmp_path / "obs.dat"
    path.write_text("".join(lines))
    pairs = []
    for mod in (t_phot, j_phot):
        data = mod.load_em_observations(str(path))
        data = mod.cut_data_to_time_range(data, trigger, 0.0, 12.0)
        shifted = mod.shift_to_trigger_time(data, trigger)
        pairs.append((shifted, mod.remove_nondetections(shifted)))
    out = []
    for got, want in zip(pairs[0], pairs[1]):
        assert sorted(got) == sorted(want)
        for f in want:
            for k in ("time", "mag", "mag_error"):
                out.append((got[f][k], want[f][k], 0.0, 0.0))
    return out


def case_systematics(rng):
    """The error budget (scalar and per filter) and the sampled em_syserr,
    broadcast to [B, F, N]: exact."""
    filters = ["ztfg", "ztfr", "ztfi"]
    times = rng.uniform(0.5, 10.0, (3, 5)).astype(np.float32)
    syserr = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    out = []
    for budget, prior_names in ((0.7, []), ({"ztfr": 0.3}, []),
                                (1.0, ["em_syserr"])):
        tm = t_sys.SystematicsModel(filters, None, budget)
        jm = j_sys.SystematicsModel(filters, None, budget)
        tm.finalize(prior_names)
        jm.finalize(prior_names)
        assert tm.prior_parameter_names() == jm.prior_parameter_names()
        want = jax.vmap(lambda s: jm({"em_syserr": s}, jnp.asarray(times)))(
            syserr)
        got = tm({"em_syserr": _t(syserr)}, _t(times))
        out.append((got, want, 0.0, 0.0))
    return out


CASES = {
    "cosmology": case_cosmology,
    "extinction_p92_smc": case_extinction,
    "interp": case_interp,
    "priors": case_priors,
    "photometry": case_photometry,
    "systematics": case_systematics,
}


@pytest.mark.parametrize("name", list(CASES))
def test_module_parity(name, tmp_path):
    rng = np.random.default_rng(sorted(CASES).index(name))
    fn = CASES[name]
    pairs = fn(rng, tmp_path) if name == "photometry" else fn(rng)
    assert pairs
    for got, want, rtol, atol in pairs:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_interp_narrow_cells_match_jnp_interp():
    """Cells narrower than jnp.interp's zero-width guard (np.spacing of the
    f32 eps, 1.42e-14) give fp[i-1] there, as in JAX: exactly [0, 10]."""
    xp = np.array([0.0, 1e-15, 2e-15, 1.0], dtype=np.float32)
    fp = np.array([0.0, 10.0, 20.0, 30.0], dtype=np.float32)
    xq = np.array([0.5e-15, 1.5e-15, 0.5], dtype=np.float32)
    want = np.asarray(jnp.interp(xq, xp, fp))
    got = t_interp.interp(_t(xq), _t(xp), _t(fp)).numpy()
    np.testing.assert_array_equal(want[:2], [0.0, 10.0])
    np.testing.assert_array_equal(got, want)
