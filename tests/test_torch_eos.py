"""The port's EOS modules (``nmma_tpu_torch.eos``) and NS population against
the JAX package's, on the CPU.

The EOS tables are made here: a numpy crust (``crust_table``: a Gamma = 4/3
polytrope below 0.1 fm^-3, a feature neither package has) under the NEP
outer core of ``eos_from_nep``, or under CSE draws. Tolerances:

* NEP and CSE-node functions (numpy in both packages): equal;
* ``EOSTable``'s interpolators: rtol 2e-6 (f32 interpolation, libm ulps);
* ``cse_extend``: rtol 2e-5 (512 f32 RK4 steps in log space);
* ``tov_solve``/``construct_family``: M and R rtol 1e-5 on the stable
  branch (measured <= 1.2e-6 over nine NEP tables); k2 and Lambda rtol
  5e-3 from 1.0 Msun (measured <= 3.1e-3 there, <= 1.0e-3 from 1.2 Msun).
  Both packages evaluate k2 in f32, and its denominator is a difference of
  O(C) terms that cancel to O(C^5): one ulp of a libm pow or log in either
  moves Lambda by ~C^-4 ulps, so the two read 4% apart at 0.7 Msun and 33%
  at 0.5 Msun, where neither is accurate;
* ``TabulatedEOSSet``: the index, TOV mass and radius, R_1.4 and R_1.6
  equal; radius and lambda rtol 2e-6 (a row-wise interpolation: XLA may
  contract its multiply and add into an FMA, one or two f32 ulps), with the
  zeros beyond MTOV in the same places;
* constraints and the population: rtol 1e-5 (f32 log_ndtr, logpdf);
* ``tabulate_weighted_eos``: the same sorted files (rtol 1e-6) and
  weights (rtol 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.eos as j_eos
import nmma_tpu_torch.eos as t_eos
from nmma_tpu.eos import likelihood as j_lk
from nmma_tpu.eos import tov as j_tov
from nmma_tpu.population import NeutronStarPopulation as JaxPopulation
from nmma_tpu_torch.eos import likelihood as t_lk
from nmma_tpu_torch.eos import tov as t_tov
from nmma_tpu_torch.population import NeutronStarPopulation

torch.set_num_threads(1)

M_RTOL, LAMBDA_RTOL, LAMBDA_FROM = 1e-5, 5e-3, 1.0


def crust_table(n_rows=120, n_max=0.0999, p_top=0.3, gamma=4.0 / 3.0):
    """(n [fm^-3], p, eps [MeV fm^-3]) rows of a polytropic crust below the
    NEP core's 0.1 fm^-3. chip_smoke.py:crust_table is a copy: keep the two
    in step."""
    n = np.geomspace(1e-8, n_max, n_rows)
    p = p_top * (n / 0.1) ** gamma
    return np.column_stack([n, p, n * 939.565 + p / (gamma - 1.0)])


def low_density_eos():
    """The crust under a NEP core up to 0.4 fm^-3: the low-density input
    of the CSE extension."""
    table = j_eos.eos_from_nep(32.0, 60.0, crust_table(), n_max=0.4)
    return {"n": table[:, 0], "p": table[:, 1], "e": table[:, 2]}


def write_macro_set(directory, slopes=np.linspace(40.0, 90.0, 10)):
    """One macro file (R, M, Lambda) a NEP table, made by the port's TOV;
    returns the paths."""
    os.makedirs(directory, exist_ok=True)
    tables = [t_eos.nep_eos_table(32.0, L, crust_table()) for L in slopes]
    paths = []
    families = t_eos.construct_families(tables, device="cpu")
    for i, (r, m, lam, _) in enumerate(families):
        path = os.path.join(directory, f"{i}.dat")
        np.savetxt(path, np.column_stack([r.numpy(), m.numpy(),
                                          lam.numpy()]))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def macro_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eos_macro")
    write_macro_set(root)
    return str(root)


def test_nep_functions_are_the_jax_packages():
    import nmma_tpu.eos.generation as j_gen
    import nmma_tpu_torch.eos.generation as t_gen
    n = np.linspace(0.05, 1.5, 200)
    kw = dict(Ksym=-80.0, Qsat=100.0, Zsym=50.0)
    np.testing.assert_array_equal(
        t_gen.nep_energy_per_particle(n, 31.0, 55.0, **kw),
        j_gen.nep_energy_per_particle(n, 31.0, 55.0, **kw))
    np.testing.assert_array_equal(t_gen.nep_pressure(n, 31.0, 55.0, **kw),
                                  j_gen.nep_pressure(n, 31.0, 55.0, **kw))
    np.testing.assert_array_equal(
        t_eos.eos_from_nep(31.0, 55.0, crust_table(), **kw),
        j_eos.eos_from_nep(31.0, 55.0, crust_table(), **kw))
    micro = np.column_stack([crust_table()[:, 0], crust_table()[:, 2],
                             crust_table()[:, 1]])
    np.testing.assert_array_equal(t_eos.crust_from_micro_table(micro),
                                  j_eos.crust_from_micro_table(micro))


def test_eos_table_interpolators_match_jax():
    tj = j_eos.nep_eos_table(32.0, 60.0, crust_table())
    tt = t_eos.nep_eos_table(32.0, 60.0, crust_table())
    np.testing.assert_array_equal(tt.log_h, tj.log_h)
    assert tt.pressure_range == tj.pressure_range
    rng = np.random.default_rng(3)
    p = np.exp(rng.uniform(np.log(1e-9), np.log(2e3), 256)).astype(
        np.float32)
    h = np.exp(rng.uniform(tj.log_h[0], tj.log_h[-1], 256)).astype(
        np.float32)
    pt, ht = torch.from_numpy(p), torch.from_numpy(h)
    for name, arg_j, arg_t in (
            ("energy_density_from_pressure", p, pt),
            ("pseudo_enthalpy_from_pressure", p, pt),
            ("pressure_from_pseudo_enthalpy", h, ht),
            ("energy_density_from_pseudo_enthalpy", h, ht),
            ("dedp_from_pressure", p, pt),
            ("log_dedp_from_log_pressure", np.log(p), torch.log(pt))):
        want = np.asarray(getattr(tj, name)(jnp.asarray(arg_j)))
        got = getattr(tt, name)(arg_t).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=name)


def _compare_families(got, want):
    rt, mt, lt = got
    rj, mj, lj = want
    stable = slice(0, int(np.argmax(mj)) + 1)
    np.testing.assert_allclose(mt[stable], mj[stable], rtol=M_RTOL)
    np.testing.assert_allclose(rt[stable], rj[stable], rtol=M_RTOL)
    heavy = mj[stable] >= LAMBDA_FROM
    assert heavy.sum() > 10
    np.testing.assert_allclose(lt[stable][heavy], lj[stable][heavy],
                               rtol=LAMBDA_RTOL)


@pytest.mark.parametrize("kind", ["nep", "cse"])
def test_construct_family_matches_jax(kind):
    """tov_solve over a whole family (64 central pressures) in both
    packages, on a NEP table and on a CSE draw."""
    if kind == "nep":
        tj = j_eos.nep_eos_table(30.0, 70.0, crust_table(), Ksym=-50.0)
        tt = t_eos.nep_eos_table(30.0, 70.0, crust_table(), Ksym=-50.0)
    else:
        tj = j_eos.cse_eos_family(low_density_eos(), n_connect=0.3,
                                  n_lim=1.5, seed=5, cs2_limit=0.6)[0]
        tt = t_eos.cse_eos_family(low_density_eos(), n_connect=0.3,
                                  n_lim=1.5, seed=5, cs2_limit=0.6,
                                  device="cpu")[0]
    rj, mj, lj, pj = map(np.asarray, j_tov.construct_family(tj))
    rt, mt, lt, pt = (a.numpy()
                      for a in t_tov.construct_family(tt, device="cpu"))
    np.testing.assert_allclose(pt, pj, rtol=1e-6)
    assert 1.5 < mj.max() < 3.5
    _compare_families((rt, mt, lt), (rj, mj, lj))
    # the geometric-unit solver itself, at a few central pressures
    pcs = pj[::9]
    m_j, r_j, k_j = map(np.asarray, jax.vmap(
        lambda pc: j_tov.tov_solve(tj, pc))(jnp.asarray(pcs)))
    m_t, r_t, k_t = (a.numpy() for a in t_tov.tov_solve(
        tt, torch.from_numpy(pcs.copy())))
    np.testing.assert_allclose(m_t, m_j, rtol=M_RTOL)
    np.testing.assert_allclose(r_t, r_j, rtol=M_RTOL)
    heavy = mj[::9] >= LAMBDA_FROM
    np.testing.assert_allclose(k_t[heavy], k_j[heavy], rtol=LAMBDA_RTOL)


def test_construct_families_solves_tables_of_any_length_together():
    """Every family in one batch (tables padded to the longest) equals each
    family solved alone."""
    tables = [t_eos.nep_eos_table(32.0, L, crust_table(n_rows=n))
              for L, n in ((45.0, 120), (70.0, 80), (85.0, 150))]
    together = t_eos.construct_families(tables, n_points=16,
                                        device="cpu")
    for table, (r, m, lam, pcs) in zip(tables, together):
        r1, m1, l1, p1 = t_tov.construct_family(table, n_points=16,
                                                device="cpu")
        np.testing.assert_array_equal(pcs.numpy(), p1.numpy())
        np.testing.assert_allclose(m.numpy(), m1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(r.numpy(), r1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(lam.numpy(), l1.numpy(), rtol=1e-5)


def test_cse_extend_matches_jax():
    low = low_density_eos()
    p_c, e_c, cs2_c = t_eos.cse.connection_state(low["n"], low["p"],
                                                 low["e"], 0.3)
    assert (p_c, e_c, cs2_c) == j_eos.cse.connection_state(
        low["n"], low["p"], low["e"], 0.3)
    nodes = t_eos.cse.draw_cs2_nodes(11, 0.3, 1.6, cs2_c, n_draws=6)
    np.testing.assert_array_equal(
        nodes, j_eos.cse.draw_cs2_nodes(11, 0.3, 1.6, cs2_c, n_draws=6))
    want = [np.asarray(a) for a in jax.vmap(
        j_eos.cse_extend, in_axes=(0, None, None, None, None, None))(
        jnp.asarray(nodes), p_c, e_c, 0.3, 1.6, 512)]
    got = [a.numpy() for a in t_eos.cse_extend(
        torch.as_tensor(nodes, dtype=torch.float32), p_c, e_c, 0.3, 1.6,
        512)]
    np.testing.assert_allclose(got[0], want[0][0], rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=2e-5)
    # the family's tables: crust rows below n_connect, then the draws
    tj = j_eos.cse_eos_family(low, n_connect=0.3, n_lim=1.6, seed=11,
                              n_draws=6)
    tt = t_eos.cse_eos_family(low, n_connect=0.3, n_lim=1.6, seed=11,
                              n_draws=6, device="cpu")
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(a.log_p, b.log_p, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(a.log_h, b.log_h, rtol=2e-5, atol=2e-5)
    mix_t = t_eos.mixed_low_density_eos(low, {**low, "p": 2 * low["p"]})
    mix_j = j_eos.mixed_low_density_eos(low, {**low, "p": 2 * low["p"]})
    for k in ("n", "p", "e"):
        np.testing.assert_array_equal(mix_t[k], mix_j[k])


def test_load_macro_eos_set_matches_jax(macro_dir):
    tj = j_eos.load_macro_eos_set(macro_dir)
    tt = t_eos.load_macro_eos_set(macro_dir)
    assert tt.n_eos == tj.n_eos == 10
    for name in ("radii", "log_lambdas", "tov_mass", "tov_radius", "r14",
                 "r16"):
        np.testing.assert_array_equal(getattr(tt, name),
                                      np.asarray(getattr(tj, name)), name)
    # the TOV masses the NEP slopes give: all support a 2 Msun pulsar
    assert 2.0 < tt.tov_mass.min() < tt.tov_mass.max() < 2.5


def test_tabulated_eos_set_call_matches_jax(macro_dir):
    """B = 64: every EOS index (fractional samples, both clip edges), the
    masses on both sides of each row's MTOV."""
    tj = j_eos.load_macro_eos_set(macro_dir)
    tt = t_eos.load_macro_eos_set(macro_dir)
    rng = np.random.default_rng(17)
    eos = rng.uniform(-0.5, 10.5, 64).astype(np.float32)
    idx = np.clip(np.floor(eos), 0, 9).astype(int)
    mtov = tt.tov_mass[idx]
    m1 = (mtov + rng.uniform(-0.6, 0.3, 64)).astype(np.float32)
    m2 = rng.uniform(0.4, 1.6, 64).astype(np.float32)
    params = {"EOS": eos, "mass_1_source": m1, "mass_2_source": m2}
    want = jax.vmap(tj)({k: jnp.asarray(v) for k, v in params.items()})
    got = tt({k: torch.from_numpy(v) for k, v in params.items()})
    assert sorted(got) == sorted(want)
    beyond = m1 > mtov
    assert 10 < beyond.sum() < 54
    np.testing.assert_array_equal(got["EOS_index"].numpy(),
                                  np.asarray(want["EOS_index"]))
    for k in ("TOV_mass", "TOV_radius", "R_14", "R_16"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("radius_1", "radius_2", "lambda_1", "lambda_2"):
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(g == 0.0, w == 0.0, err_msg=k)
        np.testing.assert_allclose(g, w, rtol=2e-6, err_msg=k)
    # beyond the next grid node past MTOV the star is a black hole
    grid = tt.mass_grid
    past = m1 > grid[np.searchsorted(grid, mtov)]
    assert past.any()
    assert (got["radius_1"].numpy()[past] == 0.0).all()
    assert (got["lambda_1"].numpy()[past] == 0.0).all()


def _mr_samples():
    rng = np.random.default_rng(8)
    return np.column_stack([rng.normal(1.4, 0.1, 4000),
                            rng.normal(11.5, 0.6, 4000)])


CONSTRAINTS = {
    "lower": lambda mod, mr: mod.LowerMTOVConstraint(2.1, 0.05),
    "upper": lambda mod, mr: mod.UpperMTOVConstraint(2.15, 0.1),
    "mass_radius": lambda mod, mr: mod.MassRadiusConstraint(
        file_path=mr),
    "joint": lambda mod, mr: mod.JointEoSConstraint(
        mod.LowerMTOVConstraint(2.0, 0.04),
        mod.MassRadiusConstraint(file_path=mr)),
}


@pytest.mark.parametrize("case", list(CONSTRAINTS))
def test_constraints_match_jax(case, macro_dir, tmp_path):
    mr = tmp_path / "mr.dat"
    np.savetxt(mr, _mr_samples())
    cj, ct = CONSTRAINTS[case](j_lk, str(mr)), CONSTRAINTS[case](t_lk,
                                                                 str(mr))
    tj = j_eos.load_macro_eos_set(macro_dir)
    tt = t_eos.load_macro_eos_set(macro_dir)
    idx = np.random.default_rng(2).integers(0, 10, 32)
    grid = jnp.asarray(tj.mass_grid)
    want = np.asarray(jax.vmap(lambda i: cj(
        {"TOV_mass": tj.tov_mass[i]},
        {"masses": grid, "radii": tj.radii[i]}))(jnp.asarray(idx)))
    it = torch.from_numpy(idx)
    got = ct({"TOV_mass": tt.rows(it, "tov_mass")},
             {"masses": tt.mass_grid, "radii": tt.rows(it)}).numpy()
    assert np.isfinite(want).all() and np.ptp(want) > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tabulate_weighted_eos_matches_jax(macro_dir, tmp_path):
    mr = tmp_path / "mr.dat"
    np.savetxt(mr, _mr_samples())
    out = {}
    for side, eos_mod, lk, kw in (("jax", j_eos, j_lk, {}),
                                  ("port", t_eos, t_lk, {"device": "cpu"})):
        constraint = lk.JointEoSConstraint(
            lk.LowerMTOVConstraint(2.1, 0.05),
            lk.MassRadiusConstraint(file_path=str(mr)))
        prev = np.linspace(1.0, 2.0, 10)
        out[side] = eos_mod.tabulate_weighted_eos(
            eos_mod.load_macro_eos_set(macro_dir), constraint,
            str(tmp_path / side), previous_weights=prev, **kw)
    (wj, dj, nj, vj), (wt, dt, nt, vt) = out["jax"], out["port"]
    assert nt == nj == 10
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    np.testing.assert_allclose(np.loadtxt(wt), np.loadtxt(wj), rtol=1e-5)
    for i in range(1, nj + 1):
        np.testing.assert_allclose(np.loadtxt(f"{dt}/{i}.dat"),
                                   np.loadtxt(f"{dj}/{i}.dat"), rtol=1e-6)


@pytest.mark.parametrize("model", ["flat", "peak"])
def test_population_matches_jax(model):
    rng = np.random.default_rng(4)
    p = {"mass_1_source": rng.uniform(0.9, 3.3, 64).astype(np.float32),
         "mass_2_source": rng.uniform(0.9, 2.3, 64).astype(np.float32),
         "mass_ratio": rng.uniform(0.5, 1.0, 64).astype(np.float32)}
    want = np.asarray(JaxPopulation(model, beta=1.5)(
        {k: jnp.asarray(v) for k, v in p.items()}))
    got = NeutronStarPopulation(model, beta=1.5)(
        {k: torch.from_numpy(v) for k, v in p.items()}).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert 5 < np.isfinite(want).sum() < 64
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
    with pytest.raises(ValueError):
        NeutronStarPopulation("gaussian")
