"""The port's EOS emulators (``nmma_tpu_torch.eos.emulator`` and ``lec``)
against the JAX package's, on the CPU.

Both emulators are made with seeded weights and saved by the JAX package
(its npz layout); the port loads those files. Tolerances:

* ``TOVEmulator.forward`` and the conversion step: rtol 1e-5 (f32 tanh
  MLP), the 0.0 entries beyond M_TOV in the same places;
* the training targets of two NEP EOS: M_TOV and R(x) rtol 1e-4 (the TOV
  solvers agree to ~1e-6 in M and R, test_torch_eos.py; the targets add an
  interpolation on the stable branch), log Lambda(x) atol 5e-3 from x = 0.5
  (f32 k2 cancels as C^-4 at low mass in both packages);
* ``decompose_masses`` in both modes and the LEC set: rtol 1e-5, the NaN
  R_1.4 of a too-light M_TOV in both;
* a small ``train_tov_emulator`` (port only) reproduces its own solver's
  M_TOV within 0.05 Msun and R_1.4 within 0.3 km at held-out points.
"""

import numpy as np
import pytest
import torch

import nmma_tpu.eos.emulator as j_emu
import nmma_tpu.eos.lec as j_lec
import nmma_tpu_torch.eos.emulator as t_emu
import nmma_tpu_torch.eos.lec as t_lec
from test_torch_eos import crust_table

torch.set_num_threads(1)

RTOL = 1e-5


def _jax_emulator(seed=0, hidden=16):
    rng = np.random.default_rng(seed)
    n_x = len(j_emu._X_GRID)
    out_dim = 1 + 2 * n_x
    out_mean = np.concatenate([[2.1], np.full(n_x, 12.0), np.full(n_x, 5.0)])
    out_std = np.concatenate([[0.3], np.full(n_x, 0.5), np.full(n_x, 1.0)])
    return j_emu.TOVEmulator(
        ["S0", "L"], [28.0, 30.0], [36.0, 90.0], j_emu._X_GRID, out_mean,
        out_std, rng.normal(0, 0.7, (2, hidden)), rng.normal(0, 0.1, hidden),
        rng.normal(0, 0.3, (hidden, out_dim)), rng.normal(0, 0.1, out_dim))


def _params(rng, n, with_masses=True):
    p = {"S0": rng.uniform(28, 36, n), "L": rng.uniform(30, 90, n)}
    if with_masses:
        p["mass_1_source"] = rng.uniform(1.0, 2.6, n)
        p["mass_2_source"] = rng.uniform(0.9, 1.6, n)
    return p


def test_tov_emulator_from_jax_file(tmp_path):
    jax_emu = _jax_emulator()
    jax_emu.save(tmp_path / "emu.npz")
    port = t_emu.TOVEmulator.load(tmp_path / "emu.npz", device="cpu")
    assert port.param_names == ("S0", "L")
    rng = np.random.default_rng(1)
    p = _params(rng, 16)
    got = port({k: torch.tensor(v, dtype=torch.float32)
                for k, v in p.items()})
    for i in range(16):
        want = jax_emu({k: np.float32(v[i]) for k, v in p.items()})
        for k in ("TOV_mass", "R_14", "R_16", "TOV_radius", "radius_1",
                  "lambda_1", "radius_2", "lambda_2"):
            w, g = float(want[k]), float(got[k][i])
            assert (w == 0.0) == (g == 0.0), (k, i, w, g)
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=k)
    port.save(tmp_path / "back.npz")
    again = j_emu.TOVEmulator.load(tmp_path / "back.npz")
    np.testing.assert_array_equal(again.w2, jax_emu.w2.astype(np.float32))


def test_emulator_targets_match_jax():
    crust = crust_table()
    thetas = np.array([[30.0, 45.0], [35.0, 85.0]])
    keep, got = t_emu.emulator_targets(thetas, ["S0", "L"], crust,
                                       device="cpu")
    assert list(keep) == [0, 1]
    n_x = len(t_emu.X_GRID)
    from_half = t_emu.X_GRID >= 0.5
    for row, (s0, lsym) in zip(got, thetas):
        mtov, radii, loglam = j_emu._macro_targets(s0, lsym, crust,
                                                   j_emu._X_GRID)
        np.testing.assert_allclose(row[0], mtov, rtol=1e-4)
        np.testing.assert_allclose(row[1:1 + n_x], radii, rtol=1e-4)
        np.testing.assert_allclose(row[1 + n_x:][from_half],
                                   loglam[from_half], rtol=0, atol=5e-3)


@pytest.mark.parametrize("split", [None, (20, 10), (15, 10, 1.8)])
def test_decompose_masses_matches_jax(split):
    mtov = np.array([1.5, 1.9, 2.1, 2.6], dtype=np.float32)
    want = np.asarray(j_lec.decompose_masses(mtov, 30, split))
    got = t_lec.decompose_masses(torch.tensor(mtov), 30, split).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _jax_lec(split, seed=2):
    rng = np.random.default_rng(seed)
    n_p, n_m = len(j_lec.LEC13_PARAMETERS), 30

    def layers(out, scale):
        return ((rng.normal(0, 0.3, (n_p, 16)), rng.normal(0, 0.1, 16)),
                (rng.normal(0, scale, (16, out)), rng.normal(0, 0.1, out)))
    return j_lec.LECEmulatorSet(
        parameter_names=j_lec.LEC13_PARAMETERS,
        feat_loc=rng.normal(0, 1, n_p), feat_scale=rng.uniform(0.5, 2, n_p),
        mass_layers=((rng.normal(0, 0.3, (n_p, 16)), rng.normal(0, 0.1, 16)),
                     (rng.normal(0, 0.05, (16, 1)), np.array([2.1]))),
        radius_layers=layers(n_m, 0.2), lambda_layers=layers(n_m, 0.2),
        radius_loc=np.full(n_m, 12.0), radius_scale=np.full(n_m, 0.5),
        lambda_loc=np.linspace(3.5, 0.5, n_m), lambda_scale=np.full(n_m, 0.2),
        n_mass_samples=n_m if split is None else sum(split[:2]), split=split)


@pytest.mark.parametrize("split", [None, (20, 10)])
def test_lec_set_from_jax_file(split, tmp_path):
    jax_set = _jax_lec(split)
    jax_set.save(tmp_path / "lec.npz")
    port = t_lec.LECEmulatorSet.load(tmp_path / "lec.npz", device="cpu")
    assert port.split == jax_set.split
    rng = np.random.default_rng(3)
    n = 8
    p = {k: rng.normal(0, 1, n) for k in j_lec.LEC13_PARAMETERS}
    p["mass_1_source"] = rng.uniform(1.0, 2.5, n)
    p["mass_2_source"] = rng.uniform(1.0, 1.5, n)
    got = port({k: torch.tensor(v, dtype=torch.float32)
                for k, v in p.items()})
    for i in range(n):
        want = jax_set({k: np.float32(v[i]) for k, v in p.items()})
        for k in ("TOV_mass", "TOV_radius", "R_14", "R_16", "radius_1",
                  "lambda_1", "radius_2", "lambda_2"):
            w, g = float(want[k]), float(got[k][i])
            assert np.isnan(w) == np.isnan(g), (k, i)
            if not np.isnan(w):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    port.save(tmp_path / "back.npz")
    back = j_lec.LECEmulatorSet.load(tmp_path / "back.npz")
    assert back.split == jax_set.split
    np.testing.assert_array_equal(back.mass_layers[1][1],
                                  np.float32(jax_set.mass_layers[1][1]))


def test_train_tov_emulator_reproduces_its_solver():
    crust = crust_table()
    timings = {}
    steps = []
    orig = torch.optim.Adam.step

    def count(self, *a, **k):
        steps.append(1)
        return orig(self, *a, **k)
    torch.optim.Adam.step = count
    try:
        emu = t_emu.train_tov_emulator(crust, n_train=40, hidden=32,
                                       n_epochs=600, device="cpu",
                                       timings=timings)
    finally:
        torch.optim.Adam.step = orig
    # exactly 600 epochs, not the JAX package's 1,000 (fault 3g)
    assert timings["epochs"] == len(steps) == 600
    assert timings["n_eos"] >= 30
    held = np.array([[31.0, 50.0], [34.0, 70.0], [29.0, 80.0]])
    keep, want = t_emu.emulator_targets(held, ["S0", "L"], crust,
                                        device="cpu")
    got = emu({"S0": torch.tensor(held[keep, 0], dtype=torch.float32),
               "L": torch.tensor(held[keep, 1], dtype=torch.float32)})
    np.testing.assert_allclose(got["TOV_mass"].numpy(), want[:, 0],
                               atol=0.05)
    r14 = [np.interp(1.4 / row[0], t_emu.X_GRID, row[1:25]) for row in want]
    np.testing.assert_allclose(got["R_14"].numpy(), r14, atol=0.3)
