"""The port's GP surrogate backends (``nmma_tpu_torch.training.gp`` and
``gp_compact``) against the JAX package's, on the CPU.

The grid is 24 points of the sparse Bu2019lm surrogate through the JAX
package's model (``test_torch_training.jax_grid``), decomposed by the JAX
package's SVD code. Tolerances:

* the summed negative log marginal likelihood at the initial point: rtol
  1e-5; its gradient: rtol 1e-3 with atol 1e-3 of the largest component
  (f32 batched Cholesky and solves, in another order);
* a matrix that is not positive definite: NaN in both, where
  ``torch.linalg.cholesky`` alone would raise;
* fault 3h (fixed in the port): the port bounds the white noise below at
  1e-5 of each GP's amplitude, so on 3h's own input (256 points, 9 x 10
  GPs; the test fits the GP that fails first) the fit runs its 400 steps
  with a finite NLL; without the bound it stops at the last finite NLL;
* five adam steps, before the bound binds: the hyperparameters within 1e-4
  (adam moves each by about its learning rate a step, so the sign of the
  gradient rules);
* the compact GP's alphas: rtol 1e-3 of their largest (one 24 x 24 f32
  Cholesky of a matrix with jitter 1e-6);
* magnitudes through ``svd_gp_surrogate_mags``: atol 1e-3 mag, inf at the
  same times outside the trained range; the files either package writes
  load in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.training.gp as j_gp
import nmma_tpu.training.gp_compact as j_cgp
import nmma_tpu.training.svd as j_svd
import nmma_tpu_torch.training.gp as t_gp
import nmma_tpu_torch.training.gp_compact as t_cgp
from test_torch_training import jax_grid

torch.set_num_threads(1)

T_OUT = np.geomspace(0.05, 20.0, 33)     # beyond the trained range at both ends


@pytest.fixture(scope="module")
def decomposed():
    svd, params, mags = jax_grid(24)
    names = list(svd.parameter_names)
    entries = [{"params": {k: float(params[k][i]) for k in names},
                "t": np.linspace(0.1, 14.0, 40),
                "mags": {f: mags[i, j] for j, f in enumerate(svd.filters)}}
               for i in range(len(mags))]
    cfg = j_svd.SVDTrainingConfig(n_coeff=4, tmin=0.2, tmax=12.0,
                                  n_tsteps=30)
    meta, x, coeffs = j_gp._svd_decompose(entries, names,
                                          ["ztfg", "ztfr", "ztfi"], cfg)
    return entries, names, cfg, meta, x, coeffs


def _jax_total_nll(params, x, y):
    def one(i):
        return j_gp._gp_nll({k: v[i] for k, v in params.items()}, x, y[i])
    return jnp.sum(jax.vmap(one)(jnp.arange(y.shape[0])))


def test_nll_and_gradient_match_jax(decomposed):
    *_, x, coeffs = decomposed
    n = x.shape[0]
    y = coeffs.reshape(n, -1).T.astype(np.float32)
    xt, yt = torch.tensor(x, dtype=torch.float32), torch.tensor(y)
    init = t_gp.initial_gp_params(yt, x.shape[1])
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    total = t_gp.gp_nll(params, xt, yt).sum()
    total.backward()
    jp = {k: jnp.asarray(v.numpy()) for k, v in init.items()}
    want, grads = jax.value_and_grad(_jax_total_nll)(
        jp, jnp.asarray(x, jnp.float32), jnp.asarray(y))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    for k, g in grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max())


def test_cholesky_keeps_the_nan_of_jax():
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], dtype=np.float32)
    good = np.array([[2.0, 0.5], [0.5, 1.0]], dtype=np.float32)
    got = t_gp.cholesky(torch.tensor(np.stack([bad, good])))
    assert torch.isnan(got[0]).all()
    np.testing.assert_allclose(got[1].numpy(),
                               np.asarray(jnp.linalg.cholesky(good)),
                               rtol=1e-6)
    assert np.isnan(np.asarray(jnp.linalg.cholesky(bad))).any()


@pytest.mark.parametrize("grid", ["grid24", "fault_3h"])
def test_fit_steps_match_jax(request, grid):
    """Five adam steps, before the noise bound binds (the port holds the
    JAX package's steps until then), on the 24-point grid and on fault
    3h's GP."""
    if grid == "grid24":
        *_, x, coeffs = request.getfixturevalue("decomposed")
    else:
        x, coeffs = request.getfixturevalue("input_3h")
        coeffs = coeffs[GP_3H]
    want = j_gp.fit_gp_coefficients(x, coeffs, n_steps=5)
    got = t_gp.fit_gp_coefficients(x, coeffs, n_steps=5, device="cpu")
    assert got.bound_from is None
    for k in ("log_amp", "log_length", "log_alpha"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-4)
    assert len(got.nll_history) == 5
    assert got.nll_history[-1] < got.nll_history[0]
    assert np.isfinite(got.alpha_vecs.numpy()).all()


def test_compact_gp_matches_jax(decomposed):
    *_, x, coeffs = decomposed
    want = j_cgp.fit_compact_gp(x, coeffs)
    got = t_cgp.fit_compact_gp(x, coeffs, device="cpu")
    np.testing.assert_array_equal(got.scale.numpy(), want.scale)
    np.testing.assert_allclose(got.alpha_vecs.numpy(), want.alpha_vecs,
                               rtol=0, atol=1e-3 * np.abs(want.alpha_vecs).max())
    xs = np.random.default_rng(1).uniform(0, 1, (5, x.shape[1]))
    kj = np.asarray(j_cgp.compact_kernel(xs, x, want.scale))
    kt = t_cgp.compact_kernel(torch.tensor(xs, dtype=torch.float32),
                              torch.tensor(x, dtype=torch.float32),
                              got.scale).numpy()
    np.testing.assert_allclose(kt, kj, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["sklearn_gp", "api_gp"])
def test_gp_surrogate_mags_and_files_match_jax(decomposed, backend,
                                               tmp_path):
    """A surrogate the port fits, written by the JAX package's
    ``save_gp_surrogate`` as its own dataclass, loads in the port; the port's
    file loads in the JAX package; both give the same magnitudes."""
    entries, names, cfg, *_ = decomposed
    filters = ["ztfg", "ztfr", "ztfi"]
    if backend == "api_gp":
        t_meta, fitted = t_cgp.train_svd_compact_gp_model(
            entries, names, filters, cfg, device="cpu")
        gp = j_cgp.CompactGPSurrogate(**{
            k: getattr(fitted, k).numpy() for k in ("x_train", "alpha_vecs",
                                                    "scale")},
            shape=fitted.shape)
    else:
        t_meta, fitted = t_gp.train_svd_gp_model(
            entries, names, filters, cfg, n_steps=20, verbose=False,
            device="cpu")
        gp = j_gp.GPSurrogate(**{
            k: getattr(fitted, k).numpy() for k in (
                "x_train", "alpha_vecs", "log_amp", "log_length",
                "log_alpha")}, shape=fitted.shape)
    meta = dict(t_meta)
    j_gp.save_gp_surrogate(tmp_path / "jax.npz", meta, gp)
    t_meta, t_model = t_gp.load_gp_surrogate(tmp_path / "jax.npz",
                                             device="cpu")
    theta = np.random.default_rng(2).uniform(
        meta["param_mins"], meta["param_maxs"], (4, len(names)))
    want = np.stack([np.asarray(j_gp.svd_gp_surrogate_mags(
        meta, gp, dict(zip(names, row)), jnp.asarray(T_OUT)))
        for row in theta])
    got = t_gp.svd_gp_surrogate_mags(
        t_meta, t_model, {k: torch.tensor(theta[:, i], dtype=torch.float32)
                          for i, k in enumerate(names)},
        torch.tensor(T_OUT, dtype=torch.float32)).numpy()
    assert got.shape == (4, 3, len(T_OUT))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-3)
    # the port's file back into the JAX package
    t_gp.save_gp_surrogate(tmp_path / "port.npz", t_meta, t_model)
    j_meta, j_model = j_gp.load_gp_surrogate(tmp_path / "port.npz")
    assert type(j_model) is type(gp)
    np.testing.assert_array_equal(j_model.alpha_vecs, gp.alpha_vecs)
    assert j_meta["filters"] == tuple(filters)


def test_train_svd_gp_model_fits(decomposed):
    entries, names, cfg, *_ = decomposed
    meta, gp = t_gp.train_svd_gp_model(entries, names, ["ztfg"], cfg,
                                       n_steps=30, verbose=False,
                                       device="cpu")
    assert gp.shape == (1, 4) and tuple(gp.alpha_vecs.shape) == (4, 24)
    assert gp.nll_history[-1] < gp.nll_history[0]
    x = torch.tensor(np.random.default_rng(0).uniform(0, 1, (3, 2)),
                     dtype=torch.float32)
    assert tuple(gp.predict(x).shape) == (3, 1, 4)


@pytest.fixture(scope="module")
def input_3h(tmp_path_factory):
    """Fault 3h's input: 1,024 seeded points of the production Bu2019lm
    surrogate on its own grid (the port's plain K1 on the CPU, seed 18)
    written as bulla files, the first 256 in file order read back and
    decomposed at C = 10 on 100 times: x [256, 4], coefficients [256, 9,
    10] (chip_smoke.py's [svd_train] grid and [gp_train] subset)."""
    from nmma_tpu_torch.models import SVDModelData
    from nmma_tpu_torch.training import read_bulla_grid
    from nmma_tpu_torch.training.svd import (SVDTrainingConfig,
                                             write_bulla_grid)

    prod = SVDModelData.load("artifacts/Bu2019lm_production_svd.npz",
                             device="cpu")
    names = list(prod.parameter_names)
    theta = np.random.default_rng(18).uniform(
        prod.host["param_mins"], prod.host["param_maxs"], (1024, len(names)))
    with torch.no_grad():
        mags = prod({k: torch.tensor(theta[:, i], dtype=torch.float32)
                     for i, k in enumerate(names)},
                    torch.tensor(prod.tt, dtype=torch.float32)).numpy()
    grid = tmp_path_factory.mktemp("grid_3h")
    write_bulla_grid(grid, "Bu2019lm",
                     {k: theta[:, i] for i, k in enumerate(names)}, prod.tt,
                     mags, list(prod.filters))
    files = sorted(str(p) for p in grid.iterdir())[:256]
    entries, pnames, filters = read_bulla_grid(files, model="Bu2019lm")
    _, x, coeffs = t_gp._svd_decompose(
        entries, pnames, filters, SVDTrainingConfig(n_coeff=10,
                                                    n_tsteps=100))
    return x, coeffs


# the GP of fault 3h's input whose NLL goes NaN first without the noise
# bound (every GP's adam trajectory is its own, so alone it fails as in the
# full fit)
GP_3H = (slice(None), slice(2, 3), slice(0, 1))


def test_fit_stops_at_the_last_finite_step(input_3h, monkeypatch):
    """Fault 3h, fixed in the port: on 3h's own input the white noise is
    held at or above 1e-5 of the amplitude, and the fit runs its 400 adam
    steps with a finite NLL at every step (the JAX package's goes NaN by
    step 160). Without the bound the same fit reaches a matrix the f32
    Cholesky cannot factor; the guard then stops it and keeps the
    hyperparameters of the last finite NLL, whose NLL it recomputes within
    rtol 1e-5."""
    x, coeffs = input_3h
    coeffs = coeffs[GP_3H]
    got = t_gp.fit_gp_coefficients(x, coeffs, n_steps=400, device="cpu")
    assert got.stopped_at is None and got.bound_from is not None
    assert len(got.nll_history) == 400
    assert np.isfinite(got.nll_history).all()
    assert np.isfinite(got.alpha_vecs.numpy()).all()
    assert got.nll_history[-1] < got.nll_history[0]
    relative = (got.log_noise - got.log_amp).numpy()
    assert (relative >= np.float32(t_gp.LOG_NOISE_FLOOR) - 1e-5).all()

    monkeypatch.setattr(t_gp, "LOG_NOISE_FLOOR", -np.inf)
    unbounded = t_gp.fit_gp_coefficients(x, coeffs, n_steps=400,
                                         device="cpu")
    assert unbounded.stopped_at is not None
    assert len(unbounded.nll_history) == unbounded.stopped_at - 1
    assert np.isfinite(unbounded.nll_history).all()
    assert np.isfinite(unbounded.alpha_vecs.numpy()).all()
    n = x.shape[0]
    y = torch.tensor(coeffs.reshape(n, -1).T.astype(np.float32))
    kept = {k: getattr(unbounded, k) for k in ("log_amp", "log_length",
                                                "log_alpha", "log_noise")}
    nll = t_gp.gp_nll(kept, torch.tensor(x, dtype=torch.float32), y).sum()
    np.testing.assert_allclose(float(nll), unbounded.nll_history[-1],
                               rtol=1e-5)
