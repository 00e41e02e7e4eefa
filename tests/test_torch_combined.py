"""The combined (flux-summed) light-curve model of the PyTorch port against
``nmma_tpu.models.combined``: Me2017 + TrPi2018, the model of BASELINE
config 4, on seeded numpy draws.

Tolerances: magnitudes within 1e-3 mag, the Me2017 detector tolerance
(tests/test_torch_em_slice.py) and the fused-mode TrPi2018 one
(tests/test_torch_grb.py), since a flux sum moves by no more than its
largest part; inf positions identical. The JAX side runs TrPi2018 with
NMMA_TPU_GRB_CONTRACT=fused, the semantics of the port's K3. Live points
where the JAX side's Me2017 photosphere has a near-tie (its two smallest
|tau - 1| within 1e-5) are dropped and counted, as in the Me2017 tests;
points fainter than mag 45 are counted and not compared, as in the
TrPi2018 tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import nmma_tpu.models as j_models
import nmma_tpu.models.combined as j_combined
import nmma_tpu_torch.models as t_models
from test_torch_grb import FAINT_MAG, SMALL
from test_torch_me2017 import jax_near_ties

torch.set_num_threads(1)

NAMES = ("log10_mej", "log10_vej", "beta", "log10_kappa_r", "log10_E0",
         "thetaCore", "thetaWing", "inclination_EM", "log10_n0", "p",
         "log10_epsilon_e", "log10_epsilon_B", "luminosity_distance",
         "timeshift")
LO = np.array([-3.0, -2.0, 1.0, -1.0, 49.0, 0.01, 0.4, 0.0, -4.0, 2.01,
               -3.0, -5.0, 40.0, -0.1])
HI = np.array([-0.5, -0.5, 5.0, 2.0, 54.0, 0.3, 0.4, 0.5, 1.0, 2.9, -0.3,
               -0.5, 400.0, 0.1])
FILTERS = ["ztfg", "ztfr", "2massks", "X-ray-1keV", "radio-6GHz"]
TIMES = np.geomspace(0.05, 14.0, 100)


def test_stack_magnitudes_matches():
    rng = np.random.default_rng(4)
    rows = rng.uniform(15.0, 30.0, (3, 2, 4, 6)).astype(np.float32)
    rows[0, 0, 1] = np.inf          # one sub-model dark in a filter
    rows[:, 1, 2] = np.inf          # all dark: the sum is dark
    want = np.asarray(jax.vmap(lambda r: j_combined.stack_magnitudes(
        list(r)), in_axes=1)(jnp.asarray(rows)))
    got = t_models.stack_magnitudes(list(torch.from_numpy(rows))).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_combined_detector_matches(monkeypatch):
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    t_model = t_models.make_combined_source_model(
        "Me2017_TrPi2018_parity", [t_models.get_source_model("Me2017"),
                                   t_models.get_source_model("TrPi2018")],
        register=False)
    j_model = j_combined.make_combined_source_model(
        "Me2017_TrPi2018_parity", [j_models.get_source_model("Me2017"),
                                   j_models.get_source_model("TrPi2018")],
        register=False)
    assert t_model.banded and t_model.needs_filters
    assert set(t_model.parameter_names) == set(j_model.parameter_names)
    theta = np.random.default_rng(211211).uniform(
        LO, HI, (16, len(NAMES))).astype(np.float32)
    t_det = t_models.DetectorLightCurveModel(
        t_model, FILTERS, sample_times=TIMES, model_kwargs=SMALL,
        device="cpu")
    j_det = j_models.DetectorLightCurveModel(
        j_model, FILTERS, sample_times=TIMES, model_kwargs=SMALL)
    t_times, t_mags = t_det({n: torch.from_numpy(theta[:, i].copy())
                             for i, n in enumerate(NAMES)})
    j_times, j_mags = jax.jit(jax.vmap(j_det))(
        {n: jnp.asarray(theta[:, i]) for i, n in enumerate(NAMES)})
    np.testing.assert_allclose(t_times.numpy(), np.asarray(j_times),
                               rtol=1e-6, atol=1e-6)
    got, want = t_mags.numpy(), np.asarray(j_mags)
    assert got.shape == want.shape == (16, 5, 100)

    gap, _ = jax_near_ties(theta[:, 0], theta[:, 1], theta[:, 2],
                           (10.0 ** theta[:, 3]).astype(np.float32), TIMES)
    keep = ~(gap < 1e-5).any(axis=1)
    assert keep.sum() >= 14
    got, want = got[keep], want[keep]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    sel = fin & (want < FAINT_MAG)
    print(f"combined: dropped {int((~keep).sum())} of 16 live points with a "
          f"near-tie; {int((fin & ~sel).sum())} faint points; max |dmag| "
          f"{np.abs(got[sel] - want[sel]).max():.3e}")
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=1e-3)
