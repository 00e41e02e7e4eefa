"""TrPi2018 and K3, the GRB EATS stage of the PyTorch port, against the JAX
package.

The same seeded numpy parameters go through both packages on the CPU: the
port's stage 1 and its plain K3 (what a CPU tensor runs), and the JAX
package's ``grb_afterglow_flux_density`` with its ``_eats_stage2`` operands
captured by swapping the function inside the test (as
tests/test_pallas_grb.py:17-44 does), ``eats_flux_pallas(interpret=True)``
and ``jax.vmap(_eats_stage2_xla)``.

Tolerances, with their reasons:
- K3 and the flux density: relative error <= 1e-4 where |ref| > 1e-6
  max|ref|. The port's K3 follows the XLA path's "fused" mode (an f32 hat
  normalised by max(hat_sum, 1)), so the JAX side runs with
  NMMA_TPU_GRB_CONTRACT=fused, set with monkeypatch before a fresh trace
  (the mode is read at trace time, grb.py:564). The f32 readings are
  <= 1.8e-5 here; the JAX default's bf16 hat reads 3e-4 to 7e-4 against
  the same plain K3 (test_k3_tolerance_rejects_a_bf16_hat), so 1e-4 tells
  the two apart. It is tighter than the JAX package's own 5e-3 for K3
  (tests/test_pallas_grb.py:56-61), which a bf16 hat would pass.
- Stage-1 operands: t_delay, r_grid and scal within rtol 1e-5 (cumulative
  trapezoid sums in another order); the log tracks within atol 2e-3 (in the
  non-relativistic tail gamma - 1 cancels in f32, which amplifies the
  round-off of the swept-mass integral into ~2e-4 in log nu_m', log nu_c'
  and log em; 2e-3 in a log is 0.2% in the quantity), except at the nodes
  where XLA flushed a denormal magnetic field to zero (counted, < 1%; see
  test_stage1_operands_match). The fluxes agree there all the same.
- Magnitudes: 1e-3 mag of the fused JAX model (1e-4 relative flux is
  ~1.1e-4 mag; ~1.1e-5 mag seen), 1e-2 mag of its default bf16 hat
  (~0.003 mag, grb.py:566-573); inf positions identical. Points fainter
  than mag 45 (4e-12 mJy, ten decades below any detection) are counted
  and not compared, and must stay under 7% of the finite points (6.2%
  seen): there the flux comes from Newtonian-tail nodes whose field terms
  underflow f32's normal range, which XLA flushes to zero and PyTorch
  keeps.
- logL: rtol 1e-4 / atol 1e-2, as on the other paths of the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.analysis as j_analysis
import nmma_tpu.filters as j_filters
import nmma_tpu.models as j_models
import nmma_tpu.models.grb as G
import nmma_tpu_torch.analysis as t_analysis
import nmma_tpu_torch.filters as t_filters
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.grb as TG
from nmma_tpu.ops.pallas_grb import eats_flux_pallas
from nmma_tpu_torch import _kernels as t_kernels
from nmma_tpu_torch.ops import grb_dynamics_kernel as k4
from nmma_tpu_torch.ops import grb_kernel as k3

torch.set_num_threads(1)

REL_TOL = 1e-4
SMALL = dict(n_theta=8, n_phi=4, n_r=128)
FULL = dict(n_theta=48, n_phi=16, n_r=256)
T_OBS = np.geomspace(0.1, 300.0, 64).astype(np.float32)
NU = np.array([1.4e14, 2.4e17, 6e9], dtype=np.float32)
# the parameter ranges of tests/test_pallas_grb.py:19-30
NAMES = ("log10_E0", "thetaCore", "thetaWing", "inclination_EM", "log10_n0",
         "p", "log10_epsilon_e", "log10_epsilon_B", "luminosity_distance")
LO = np.array([51.0, 0.02, 0.35, 0.0, -4.0, 2.1, -2.0, -4.0, 30.0])
HI = np.array([54.0, 0.3, 0.7, 0.6, 0.0, 2.8, -0.5, -1.0, 300.0])

# BASELINE config 3 (scripts/bench_grb_pe.py:17-50)
GRB_FILTERS = ["ztfg", "ztfr", "ztfi", "X-ray-1keV", "radio-6GHz"]
GRB_PRIOR = """\
log10_E0 = Uniform(minimum=49., maximum=54.)
thetaCore = Uniform(minimum=0.01, maximum=0.3)
thetaWing = 0.4
inclination_EM = Uniform(minimum=0., maximum=0.5)
log10_n0 = Uniform(minimum=-4., maximum=1.)
p = Uniform(minimum=2.01, maximum=2.9)
log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)
log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)
xi_N = 1.0
luminosity_distance = 350.0
timeshift = Uniform(minimum=-0.1, maximum=0.1)
"""
GRB_INJECTION = dict(log10_E0=51.5, thetaCore=0.1, thetaWing=0.4,
                     inclination_EM=0.05, log10_n0=-1.5, p=2.4,
                     log10_epsilon_e=-1.2, log10_epsilon_B=-3.0, xi_N=1.0,
                     luminosity_distance=350.0, timeshift=0.0)
TRIGGER = 59000.0
SENTINEL = -1e29
FAINT_MAG = 45.0
FAINT_SHARE = 0.07


def draw(b, seed):
    return np.random.default_rng(seed).uniform(LO, HI, (b, len(NAMES))) \
        .astype(np.float32)


def as_port(theta, names=NAMES):
    return {n: torch.from_numpy(theta[:, i].copy())
            for i, n in enumerate(names)}


def as_jax(theta, names=NAMES):
    return {n: jnp.asarray(theta[:, i]) for i, n in enumerate(names)}


def rel_err(got, want):
    """Max relative error where |want| > 1e-6 max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), 1e-6 * scale)).max())


def capture_stage2(theta, t_obs=T_OBS, nu=NU, **kw):
    """The JAX package's K3 operands and fluxes, one sample at a time."""
    rec = []
    orig = G._eats_stage2
    G._eats_stage2 = lambda *a: (rec.append(a), orig(*a))[1]
    try:
        flux = [np.asarray(G.grb_afterglow_flux_density(
            t_obs, nu, {n: float(v) for n, v in zip(NAMES, row)}, **kw))
            for row in theta]
    finally:
        G._eats_stage2 = orig
    ops = [jnp.stack([a[k] for a in rec]) for k in range(4)] + list(rec[0][4:])
    return ops, np.stack(flux)


def port_operands(jax_ops):
    """JAX operands as the port's: numpy copies, nu_obs per live point."""
    ops = [torch.from_numpy(np.array(o, dtype=np.float32)) for o in jax_ops]
    ops[7] = ops[7].expand(ops[0].shape[0], -1).contiguous()
    return ops


@pytest.fixture(scope="module")
def captured():
    cache = {}

    def get(b, kw_name):
        key = (b, kw_name)
        if key not in cache:
            theta = draw(b, 1000 + b)
            cache[key] = (theta,) + capture_stage2(
                theta, **(SMALL if kw_name == "small" else FULL))
        return cache[key]

    return get


# -- filters ----------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "radio-6GHz", "radio-3GHz", "X-ray-1keV", "X-ray-5keV", "radio-1.4GHz",
    "X-ray-0.3keV", "sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
    "2massj", "2massh", "2massks"])
def test_filter_tables_match(name):
    """Frequencies, bandpass quadrature and name resolution equal the JAX
    package's to f32 rounding (the tables are host float64)."""
    np.testing.assert_allclose(t_filters.filters_to_frequencies([name]),
                               j_filters.filters_to_frequencies([name]),
                               rtol=6e-8)
    for got, want in zip(t_filters.filters_to_quadrature([name]),
                         j_filters.filters_to_quadrature([name])):
        np.testing.assert_allclose(got, want, rtol=6e-8)
    assert t_filters.resolve_filter(name) == j_filters.resolve_filter(name)


def test_masked_interp_sorted_fill_rows():
    """The row form used by trpi2018_mags ([B, F, N] magnitudes on one grid)
    equals the JAX function row by row: inf fill outside each row's valid
    range, identical inf positions, values within f32 round-off."""
    from nmma_tpu.ops.interp import masked_interp_sorted_fill as j_fill
    from nmma_tpu_torch.ops.interp import masked_interp_sorted_fill

    rng = np.random.default_rng(12)
    x = np.sort(rng.uniform(-3.0, 4.0, 64)).astype(np.float32)
    y = rng.normal(20.0, 3.0, (3, 4, 64)).astype(np.float32)
    y[0, 0, :10] = np.inf                 # invalid head
    y[1, 2, 50:] = np.inf                 # invalid tail
    y[2, 1, ::3] = np.inf                 # holes
    y[2, 3, 1:] = np.inf                  # one valid sample: all fill
    xq = np.linspace(-4.0, 5.0, 40).astype(np.float32)
    got = masked_interp_sorted_fill(torch.from_numpy(xq),
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    np.inf).numpy()
    want = np.asarray(jax.vmap(jax.vmap(
        lambda row: j_fill(jnp.asarray(xq), jnp.asarray(x), row, jnp.inf)))(
        jnp.asarray(y)))
    assert got.shape == want.shape == (3, 4, 40)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[2, 3]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-5)


# -- K3 ----------------------------------------------------------------------

@pytest.mark.parametrize("b,kw_name", [(1, "small"), (5, "small"),
                                       (2, "full")])
def test_k3_plain_matches_pallas_interpret(captured, b, kw_name):
    _, jax_ops, _ = captured(b, kw_name)
    want = np.asarray(eats_flux_pallas(*jax_ops, interpret=True))
    got = k3.eats_flux(*port_operands(jax_ops)).numpy()
    assert got.shape == want.shape
    err = rel_err(got, want)
    print(f"K3 plain vs Pallas interpret, B={b} {kw_name}: {err:.3e}")
    assert err < REL_TOL


@pytest.mark.parametrize("b,kw_name", [(1, "small"), (5, "small"),
                                       (2, "full")])
def test_k3_plain_matches_xla_fused(captured, monkeypatch, b, kw_name):
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    _, jax_ops, _ = captured(b, kw_name)
    want = np.asarray(jax.jit(jax.vmap(
        G._eats_stage2_xla,
        in_axes=(0, 0, 0, 0, None, None, None, None)))(*jax_ops))
    got = k3.eats_flux(*port_operands(jax_ops)).numpy()
    assert got.shape == want.shape
    err = rel_err(got, want)
    print(f"K3 plain vs fused XLA, B={b} {kw_name}: {err:.3e}")
    assert err < REL_TOL


@pytest.mark.parametrize("b,kw_name", [(1, "small"), (5, "small"),
                                       (2, "full")])
def test_k3_tolerance_rejects_a_bf16_hat(captured, monkeypatch, b, kw_name):
    """REL_TOL tells K3's f32 hat from the JAX default's bf16 hat with its
    1e-3 clamp (grb.py:565-589): that hat lies outside it on the same
    operands, so a K3 that fell back to it would fail these tests."""
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "einsum")
    _, jax_ops, _ = captured(b, kw_name)
    bf16 = np.asarray(jax.jit(jax.vmap(
        G._eats_stage2_xla,
        in_axes=(0, 0, 0, 0, None, None, None, None)))(*jax_ops))
    err = rel_err(k3.eats_flux(*port_operands(jax_ops)).numpy(), bf16)
    print(f"K3 plain vs bf16-hat XLA, B={b} {kw_name}: {err:.3e}")
    assert err > REL_TOL


def test_k3_batch_rows_are_independent(captured):
    """A B=3 batch's first row equals that row alone (the plain version
    chunks over (live point, ring) rows)."""
    _, jax_ops, _ = captured(5, "small")
    ops = port_operands(jax_ops)
    three = [o[:3].contiguous() if i in (0, 1, 2, 3, 7) else o
             for i, o in enumerate(ops)]
    one = [o[:1].contiguous() if i in (0, 1, 2, 3, 7) else o
           for i, o in enumerate(ops)]
    np.testing.assert_allclose(k3.eats_flux(*three)[:1].numpy(),
                               k3.eats_flux(*one).numpy(), rtol=1e-6)
    # and chunks of one row at a time give the same result
    old = k3._HAT_ELEMENTS
    k3._HAT_ELEMENTS = 1
    try:
        chunked = k3.eats_flux(*three).numpy()
    finally:
        k3._HAT_ELEMENTS = old
    np.testing.assert_allclose(chunked, k3.eats_flux(*three).numpy(),
                               rtol=1e-6)


def test_k3_wrapper_checks_its_operands(captured):
    _, jax_ops, _ = captured(1, "small")
    ops = port_operands(jax_ops)
    with pytest.raises(TypeError, match="float32"):
        k3.eats_flux(ops[0].double(), *ops[1:])
    with pytest.raises(ValueError, match="contiguous"):
        k3.eats_flux(*ops[:1], ops[1].transpose(2, 3).contiguous()
                     .transpose(2, 3), *ops[2:])
    with pytest.raises(ValueError, match="log_tracks has shape"):
        k3.eats_flux(ops[0], ops[1][:, :4].contiguous(), *ops[2:])
    with pytest.raises(ValueError, match="nu_obs has shape"):
        k3.eats_flux(*ops[:7], ops[7][0])
    with pytest.raises(ValueError, match="is on meta"):
        k3.eats_flux(*ops[:7], ops[7].to("meta"))
    with pytest.raises(ValueError, match="no K3 kernel for device meta"):
        k3.eats_flux(*(o.to("meta") for o in ops))
    # queries are shared [T] or one a row [B, 1]
    with pytest.raises(ValueError, match="log_q has shape"):
        k3.eats_flux(*ops[:4], ops[4][None, :2].contiguous(), *ops[5:])


# -- K3's two live hat nodes ------------------------------------------------
#
# After the cummax a log-time row is non-decreasing, so at most the two nodes
# that bracket a query, j = max{r : log_t[r] <= lq} and j + 1, carry hat
# weight; the kernel searches for them instead of sweeping all R radii. The
# cases: the stage-2 operands of the captured JAX model, and hand-made rows
# (k3.edge_operands) with cummax plateaus, a query on a node, queries on a
# plateau value, at log_t[0] and log_t[-1], and outside the row.

EDGE_R = (2, 100, 256)
HAT_CASES = ["captured-small", "captured-full"] + [f"edges-{r}"
                                                   for r in EDGE_R]


def edge_rows(n_r):
    """Hand-made K3 operands: 3 live points x 4 rings, T = 37, Ph = 5,
    F = 3."""
    return k3.edge_operands(3, 4, n_r, 37, 5, 3, seed=n_r)


def hat_case(captured, case):
    if case.startswith("edges-"):
        return edge_rows(int(case.split("-")[1]))
    b, kw_name = {"captured-small": (5, "small"),
                  "captured-full": (2, "full")}[case]
    return port_operands(captured(b, kw_name)[1])


def hat_rows(ops):
    """The plain K3's log-time rows [N, Ph, R], the tracks with a ones lane
    [N, R, 6], and j = max{r : log_t[r] <= lq} per query [N, Ph, T]."""
    t_delay, log_tracks, r_grid, scal, log_q, cphi = ops[:6]
    n_b, n_th, n_r = t_delay.shape
    point = torch.arange(n_b).repeat_interleave(n_th)
    tracks = log_tracks.transpose(1, 2).reshape(-1, k3.N_TRACKS, n_r)
    log_t = k3.log_time_rows(t_delay.reshape(-1, n_r), tracks,
                             r_grid[point], scal[point], cphi)
    tr1 = torch.cat([tracks, torch.ones_like(tracks[:, :1])], 1)
    lq = log_q.expand(*log_t.shape[:2], -1).contiguous()
    j = torch.searchsorted(log_t.contiguous(), lq, right=True) - 1
    return log_t, tr1.transpose(1, 2), j


def fma(acc, h, tr):
    """acc + h * tr in f32, the product exact (in float64): the same
    multiply-add on both sides of a comparison."""
    return (acc.double() + h.double() * tr.double()).float()


@pytest.mark.parametrize("case", HAT_CASES)
def test_k3_hat_lives_on_the_two_bracketing_nodes(captured, case):
    """Every nonzero of the dense hat lies on node j or j + 1."""
    ops = hat_case(captured, case)
    log_t, _, j = hat_rows(ops)
    hat = k3.hat_basis(log_t, ops[4])                       # [N, Ph, T, R]
    r = torch.arange(log_t.shape[-1])
    bracket = (r == j[..., None]) | (r == j[..., None] + 1)
    live = hat != 0
    print(f"{case}: {int(live.any(-1).sum())} of {j.numel()} queries with "
          f"weight, {int((live.sum(-1) == 2).sum())} on two nodes")
    assert not (live & ~bracket).any()
    assert (live.sum(-1) == 2).any()


@pytest.mark.parametrize("case", HAT_CASES)
def test_k3_two_node_sums_equal_dense_sums(captured, case):
    """The five track sums and the hat sum over all R radii, in r order,
    equal the sums over nodes j and j + 1 alone, their hats taken with the
    dense form's expressions: bit for bit."""
    ops = hat_case(captured, case)
    log_t, tr1, j = hat_rows(ops)
    n_r = log_t.shape[-1]
    lq = ops[4][None, None, :]
    hat = k3.hat_basis(log_t, ops[4])
    dense = torch.zeros(j.shape + (k3.N_TRACKS + 1,))
    for r in range(n_r):
        dense = fma(dense, hat[..., r, None], tr1[:, None, None, r])
    two = torch.zeros_like(dense)
    rows = torch.arange(len(j))[:, None, None]
    for n in (0, 1):
        r = j + n
        node = r.clamp(0, n_r - 1)
        x = torch.gather(log_t, 2, node)
        x_l = torch.gather(log_t, 2, (node - 1).clamp(min=0))
        x_r = torch.gather(log_t, 2, (node + 1).clamp(max=n_r - 1))
        up = (lq - x_l) / torch.clamp(x - x_l, min=1e-12)
        dn = (x_r - lq) / torch.clamp(x_r - x, min=1e-12)
        h = torch.clamp(torch.minimum(up, dn), 0.0, 1.0)
        h = torch.where((r >= 0) & (r < n_r), h, 0.0)
        two = fma(two, h[..., None], tr1[rows, node])
    assert (dense[..., -1] > 0).any()
    assert torch.equal(two, dense)


@pytest.mark.parametrize("n_r", EDGE_R)
def test_k3_edge_rows_reach_their_cases(n_r):
    """The hand-made rows hold what they are made for: rows starting at
    log t = 0 and ending at the cap of 60, rows that end below 60 or start
    above 0, queries 0 and 60, queries below and above every row, and
    (where R leaves room) plateaus at 0 and at the cap and a query on a
    node whose neighbours differ."""
    ops = edge_rows(n_r)
    log_t, _, _ = hat_rows(ops)
    first, last = log_t[..., 0], log_t[..., -1]
    log_q = ops[4]
    assert (log_q == 0).any() and (log_q == 60).any()
    assert (log_q < first.min()).any() and (log_q > last.max()).any()
    assert (first == 0).any() and (first > 0).any()
    assert (last == 60).any() and (last < 60).any()
    if n_r >= 4:
        zero = log_t == 0
        assert (zero[..., 1:] & zero[..., :-1]).any()
        assert (log_t[..., -2] == 60).any()
        on_node = zero[..., 1:-1] & (log_t[..., :-2] < 0) & (log_t[..., 2:] > 0)
        assert on_node.any()


@pytest.mark.parametrize("n_r", EDGE_R)
def test_k3_edge_rows_match_xla_fused(monkeypatch, n_r):
    """The plain K3 on the hand-made rows against the fused XLA path:
    within REL_TOL, with zeros (queries outside every row) in the same
    places."""
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    ops = edge_rows(n_r)
    want = np.asarray(jax.jit(jax.vmap(
        G._eats_stage2_xla, in_axes=(0, 0, 0, 0, None, None, None, 0)))(
        *(jnp.asarray(o.numpy()) for o in ops)))
    got = k3.eats_flux(*ops).numpy()
    assert got.shape == want.shape == (3, 4, 3, 37)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).any() and (got != 0).any()
    err = rel_err(got, want)
    print(f"K3 plain vs fused XLA on hand-made rows, R={n_r}: {err:.3e}")
    assert err < REL_TOL


# -- stage 1 and the flux density -------------------------------------------

@pytest.mark.parametrize("b,kw_name", [(5, "small"), (2, "full")])
def test_stage1_operands_match(captured, b, kw_name):
    theta, jax_ops, _ = captured(b, kw_name)
    kw = SMALL if kw_name == "small" else FULL
    ops, d_cos, inv_dl26 = TG.grb_stage1(
        torch.from_numpy(T_OBS), torch.from_numpy(NU), as_port(theta), **kw)
    assert ops[0].shape == (b, kw["n_theta"], 128)
    want = [np.asarray(o) for o in jax_ops]
    for i, name in enumerate(("t_delay", "log_tracks", "r_grid", "scal",
                              "log_q", "cphi", "wphi")):
        got = ops[i].numpy()
        assert got.shape == want[i].shape, name
        if name == "log_tracks":
            # where the JAX side's field terms fell below f32's normal
            # range, XLA flushed them to zero and PyTorch did not:
            # nu_m', nu_c' and the emission differ there. Those nodes lie
            # deep in the Newtonian tail; they are counted, not compared.
            flushed = flushed_field(theta, want[i][:, 0])
            print(f"stage 1, B={b} {kw_name}: {int(flushed.sum())} of "
                  f"{flushed.size} nodes with a flushed field term")
            assert flushed.mean() < 0.01
            np.testing.assert_allclose(got[:, 0::4], want[i][:, 0::4],
                                       rtol=0, atol=2e-3, err_msg=name)
            np.testing.assert_allclose(
                got[:, 1:4].transpose(1, 0, 2, 3)[:, ~flushed],
                want[i][:, 1:4].transpose(1, 0, 2, 3)[:, ~flushed],
                rtol=0, atol=2e-3, err_msg=name)
        else:
            np.testing.assert_allclose(got, want[i], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    np.testing.assert_array_equal(ops[7].numpy(), np.tile(NU, (b, 1)))


def flushed_field(theta, log_gamma):
    """[B, Th, R] nodes where an f32 term of the magnetic field (B^2 / c^2
    or sigma_T B^2, grb.py:389-395) lies below the smallest normal f32,
    with a margin of 4: recomputed in float64 from the JAX side's Lorentz
    factors and the live points' eps_B and n0."""
    tiny = 4.0 * np.finfo(np.float32).tiny
    eps_b = 10.0 ** np.clip(theta[:, NAMES.index("log10_epsilon_B")], -20, 0)
    n0 = 10.0 ** np.clip(theta[:, NAMES.index("log10_n0")], -20, 20)
    g = np.exp(log_gamma.astype(np.float64))
    arg = (32.0 * np.pi * eps_b[:, None, None] * g * (g - 1.0 + 1e-12)
           * n0[:, None, None] * G._MP)
    return (arg < tiny) | (G._SIGMA_T * arg * G.c_cgs**2 < tiny)


FLUX_CASES = {
    "gaussian": dict(),
    "full_width": dict(FULL),
    "tophat": dict(jet_type=TG.JET_TOPHAT),
    "powerlaw": dict(jet_type=TG.JET_POWERLAW),
    "spread_off": dict(spread=False),
    "trumpet_off": dict(trumpet=False),
}


@pytest.mark.parametrize("case", list(FLUX_CASES) + ["injection",
                                                     "pinned_dl"])
def test_flux_density_matches(monkeypatch, case):
    """grb_afterglow_flux_density [B, F, T] against jax.vmap of the JAX
    function (fused mode) over the jet types, spreading and trumpet
    switches, L0/q/ts energy injection, and the reference's pinned
    d_L = 3.09e19 cm of tests/test_grb.py:359-377."""
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    theta = draw(3, 77)
    names = list(NAMES)
    kw = dict(SMALL, **FLUX_CASES.get(case, {}))
    if case == "full_width":
        theta = theta[:2]
    if kw.get("jet_type") == TG.JET_POWERLAW:
        names.append("b")
        theta = np.concatenate([theta, np.float32([[2.0], [6.0], [9.0]])], 1)
    if case == "injection":
        names += ["log10_L0", "q", "ts"]
        theta = np.concatenate([theta, np.float32(
            [[46.0, 0.5, 100.0], [47.5, 1.0, 1e3], [45.0, 2.0, 1e4]])], 1)
    if case == "pinned_dl":
        names[names.index("luminosity_distance")] = "d_L"
        theta[:, names.index("d_L")] = 3.0899999686877e19
    t_grid = np.geomspace(0.1, 41.0, 32).astype(np.float32)
    jet = kw.pop("jet_type", TG.JET_GAUSSIAN)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: G.grb_afterglow_flux_density(
            t_grid, NU, p, jet_type=jet, **kw)))(as_jax(theta, names)))
    got = TG.grb_afterglow_flux_density(
        torch.from_numpy(t_grid), torch.from_numpy(NU),
        as_port(theta, names), jet_type=jet, **kw).numpy()
    assert got.shape == want.shape == (len(theta), 3, 32)
    assert np.isfinite(got).all() and (got > 0).any()
    err = rel_err(got, want)
    print(f"flux density {case}: {err:.3e}")
    assert err < REL_TOL


def test_static_switches():
    """spread/trumpet steer control flow: one value over the batch (a
    DeltaFunction prior's constant tensor) is taken, a varying one raises."""
    theta = draw(2, 5)
    t, nu = torch.from_numpy(T_OBS), torch.from_numpy(NU)
    off = TG.grb_afterglow_flux_density(t, nu, as_port(theta), spread=False,
                                        **SMALL)
    params = dict(as_port(theta), spread=torch.zeros(2))
    np.testing.assert_array_equal(
        TG.grb_afterglow_flux_density(t, nu, params, **SMALL).numpy(),
        off.numpy())
    params["spread"] = torch.tensor([0.0, 1.0])
    with pytest.raises(ValueError, match="varies over the batch"):
        TG.grb_afterglow_flux_density(t, nu, params, **SMALL)


# -- the energy ramp (nmma_tpu/models/grb.py:715-749) ------------------------
#
# Every node of the 64-node internal time grid has its own blast-wave energy,
# so the port folds the nodes into the batch: row (b, i) runs stage 1 with
# its own time (t_obs_day [rows, 1]) and K3 with its own query (log_q
# [rows, 1]), in chunks of models/grb.py:ramp_chunk_rows rows.

RAMP_NAMES = ("thetaCore", "thetaWing", "inclination_EM", "log10_n0", "p",
              "log10_epsilon_e", "log10_epsilon_B", "xi_N", "d_L",
              "energy_exponential", "log10_Eend", "t_start",
              "injection_duration")
RAMP_T = np.geomspace(0.05, 200.0, 40).astype(np.float32)


def ramp_draws(b, seed):
    """Ramp parameters around tests/test_grb.py:287-293's point: t_start
    1e4-5e4 s and the ramp's end 1e6-3e6 s fall inside the 0.05-201 d
    grid, so every live point has nodes before, on and after its ramp."""
    rng = np.random.default_rng(seed)
    lo = np.array([0.05, 0.3, 0.0, -3.0, 2.2, -1.5, -3.5, 1.0, 3.086e19,
                   0.8, 52.0, 1e4, 1e6])
    hi = np.array([0.12, 0.4, 0.1, -1.0, 2.6, -0.8, -2.5, 1.0, 3.086e19,
                   1.4, 53.0, 5e4, 3e6])
    return rng.uniform(lo, hi, (b, len(RAMP_NAMES))).astype(np.float32)


@pytest.mark.parametrize("mode,tol", [("fused", 1e-3), ("einsum", 1e-2)])
def test_e0_ramp_mags_match(monkeypatch, mode, tol):
    """trpi2018_mags on ramp inputs against jax.vmap of the JAX function,
    at the SMALL resolution and the gates of test_detector_mags_match:
    identical inf, 1e-3 mag of the fused JAX model (1e-2 of its bf16 hat),
    points fainter than FAINT_MAG counted, not compared."""
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", mode)
    theta = ramp_draws(4, 41)
    nu = np.array([5e14, 2.4e17, 6e9], dtype=np.float32)
    got = TG.trpi2018_mags(as_port(theta, RAMP_NAMES),
                           torch.from_numpy(RAMP_T),
                           torch.from_numpy(nu)[None].expand(4, -1),
                           **SMALL).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda q: G.trpi2018_mags(q, RAMP_T, nu, **SMALL)))(
            as_jax(theta, RAMP_NAMES)))
    assert got.shape == want.shape == (4, 3, 40)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    faint = fin & (want >= FAINT_MAG)
    sel = fin & ~faint
    print(f"TrPi2018 ramp vs JAX {mode}: max |dmag| "
          f"{np.abs(got[sel] - want[sel]).max():.3e}; {int(faint.sum())} of "
          f"{int(fin.sum())} finite points fainter than {FAINT_MAG}")
    assert fin.mean() > 0.9 and faint.sum() < FAINT_SHARE * fin.sum()
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=tol)


def test_e0_ramp_chunks_do_not_change_the_flux(monkeypatch):
    """The folded rows in chunks of 50 give the one-chunk magnitudes within
    1e-5 mag, a few f32 ulps: a chunk boundary moves the split between
    PyTorch's vectorised and scalar CPU loops and the plain K3's batched
    products."""
    theta = ramp_draws(3, 42)
    args = (as_port(theta, RAMP_NAMES), torch.from_numpy(RAMP_T),
            torch.from_numpy(NU)[None].expand(3, -1))
    whole = TG.trpi2018_mags(*args, **SMALL).numpy()
    row_bytes = TG._STAGE1_ROW_TENSORS * 4 * SMALL["n_theta"] * SMALL["n_r"]
    monkeypatch.setattr(TG, "RAMP_CHUNK_BYTES", 50 * row_bytes)
    assert TG.ramp_chunk_rows(SMALL["n_theta"], SMALL["n_r"]) == 50
    chunked = TG.trpi2018_mags(*args, **SMALL).numpy()
    np.testing.assert_array_equal(np.isinf(chunked), np.isinf(whole))
    fin = np.isfinite(whole)
    np.testing.assert_allclose(chunked[fin], whole[fin], rtol=0, atol=1e-5)
    assert TG.ramp_chunk_rows() == 50 * SMALL["n_theta"] * SMALL["n_r"] \
        // (TG.N_THETA * TG.N_R)


def test_ramp_log10_e0_matches_jax():
    """The ramp's log10 E0 at each node: held before t_start, the ramp,
    log10_Eend after the injection (f32, within 1e-5)."""
    theta = ramp_draws(6, 43)
    t_grid = np.geomspace(0.05, 201.0, 64).astype(np.float32)
    got = TG._ramp_log10_e0(as_port(theta, RAMP_NAMES),
                            torch.from_numpy(t_grid)).numpy()
    p = as_jax(theta, RAMP_NAMES)
    t_sec = jnp.asarray(t_grid) * 86400.0
    a, le = p["energy_exponential"][:, None], p["log10_Eend"][:, None]
    ts, te = p["t_start"][:, None], p["injection_duration"][:, None]
    want = np.asarray(jnp.where(
        t_sec <= ts, le + a * jnp.log10(ts / te),
        jnp.where(t_sec >= te, le, le + a * jnp.log10(t_sec / te))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[:, 0] < got[:, -1]).all()


def test_stage1_per_row_time_matches_a_loop_of_the_shared_form():
    """grb_stage1 with one time a row ([rows, 1]) against a loop that runs
    the shared form ([1]) on each row alone: every operand equal (rtol
    1e-6: PyTorch's vectorised and scalar CPU loops may round an
    elementwise function differently)."""
    theta = draw(5, 44)
    times = torch.from_numpy(T_OBS[[0, 10, 30, 50, 63]].copy())
    nu = torch.from_numpy(NU)[None].expand(5, -1).contiguous()
    params = dict(as_port(theta), d_L=3.086e19)
    rows = TG.grb_stage1(times[:, None], nu, params, **SMALL)
    assert rows[0][4].shape == (5, 1)
    for i in range(5):
        one = TG.grb_stage1(times[i:i + 1], nu[i:i + 1],
                            {k: (v[i:i + 1] if isinstance(v, torch.Tensor)
                                 else v) for k, v in params.items()},
                            **SMALL)
        for k, (got, want) in enumerate(zip(rows[0], one[0])):
            got = got if k in (5, 6) else got[i:i + 1]
            np.testing.assert_allclose(got.reshape(want.shape).numpy(),
                                       want.numpy(), rtol=1e-6, atol=0)
        for got, want in zip(rows[1:], one[1:]):
            np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                       rtol=1e-6, atol=0)


def test_k3_per_row_queries_equal_the_shared_mode_one_row_at_a_time():
    """The plain K3 with one query a row (log_q [B, 1]) equals, row by
    row, the shared mode given that row and its one query, bit for bit,
    on the hand-made edge rows (each live point's query cycles through the
    37: on a node, on a plateau, at both ends, outside the rows)."""
    ops = k3.edge_operands(8, 4, 100, 37, 5, 3, seed=45)
    per_row = ops[4][torch.arange(8) * 5 % 37][:, None].contiguous()
    got = k3.eats_flux(*ops[:4], per_row, *ops[5:])
    assert got.shape == (8, 4, 3, 1)
    for b in range(8):
        one = [o[b:b + 1].contiguous() for o in ops[:4]]
        want = k3.eats_flux(*one, per_row[b], *ops[5:7],
                            ops[7][b:b + 1].contiguous())
        assert torch.equal(got[b:b + 1], want), b
    assert (got == 0).any() and (got != 0).any()


# -- the detector model and the likelihood ----------------------------------

DET_NAMES = tuple(GRB_INJECTION)


def detector_draws(b, seed):
    """Config-3 prior draws (thetaWing 0.4, xi_N 1, 350 Mpc); the last
    live point has thetaWing = 2.0, which the sanity mask makes all-inf."""
    rng = np.random.default_rng(seed)
    lo = np.array([49.0, 0.01, 0.4, 0.0, -4.0, 2.01, -3.0, -5.0, 1.0, 350.0,
                   -0.1])
    hi = np.array([54.0, 0.3, 0.4, 0.5, 1.0, 2.9, -0.3, -0.5, 1.0, 350.0,
                   0.1])
    theta = rng.uniform(lo, hi, (b, len(DET_NAMES))).astype(np.float32)
    theta[-1, DET_NAMES.index("thetaWing")] = 2.0
    return theta


@pytest.mark.parametrize("mode,tol", [("fused", 1e-3), ("einsum", 1e-2)])
def test_detector_mags_match(monkeypatch, mode, tol):
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", mode)
    times = np.geomspace(0.05, 40.0, 64)
    theta = detector_draws(8, 31)
    t_det = t_models.DetectorLightCurveModel(
        "TrPi2018", GRB_FILTERS, sample_times=times, model_kwargs=SMALL,
        device="cpu")
    j_det = j_models.DetectorLightCurveModel(
        "TrPi2018", GRB_FILTERS, sample_times=times, model_kwargs=SMALL)
    t_times, t_mags = t_det(as_port(theta, DET_NAMES))
    j_times, j_mags = jax.jit(jax.vmap(j_det))(as_jax(theta, DET_NAMES))
    np.testing.assert_allclose(t_times.numpy(), np.asarray(j_times),
                               rtol=1e-6, atol=1e-6)
    got, want = t_mags.numpy(), np.asarray(j_mags)
    assert got.shape == want.shape == (8, 5, 64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[-1]).all() and not np.isnan(got).any()
    fin = np.isfinite(want)
    assert fin[:-1].mean() > 0.5
    # fainter than mag 45 (4e-12 mJy) the flux comes from nodes whose field
    # terms underflow f32's normal range (see test_stage1_operands_match):
    # counted, not compared
    faint = fin & (want >= FAINT_MAG)
    sel = fin & ~faint
    print(f"TrPi2018 detector vs JAX {mode}: max |dmag| "
          f"{np.abs(got[sel] - want[sel]).max():.3e}; {int(faint.sum())} of "
          f"{int(fin.sum())} finite points fainter than {FAINT_MAG}")
    assert faint.sum() < FAINT_SHARE * fin.sum()
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=tol)


@pytest.fixture(scope="module")
def grb_files(tmp_path_factory):
    """Config-3 photometry of the JAX TrPi2018 model at the injection of
    scripts/bench_grb_pe.py:20-23: 6 epochs per filter in 0.1-30 d, 0.1 mag
    noise, an upper limit at the last epoch of every second filter; an
    observation file in MJD with the prior file."""
    times = np.geomspace(0.05, 40.0, 64)
    det = j_models.DetectorLightCurveModel("TrPi2018", GRB_FILTERS,
                                           sample_times=times)
    t_obs, mags = jax.jit(det)(
        {k: jnp.asarray(v) for k, v in GRB_INJECTION.items()})
    t_obs, mags = np.asarray(t_obs), np.asarray(mags)
    rng = np.random.default_rng(2018)
    lines = []
    for i, f in enumerate(GRB_FILTERS):
        t = np.concatenate([[0.1], np.sort(rng.uniform(0.3, 30.0, 5))])
        m = np.interp(t, t_obs, mags[i]) + rng.normal(0.0, 0.1, t.size)
        assert np.all(np.isfinite(m))
        err = np.full(t.size, 0.1)
        if i % 2 == 0:
            m[-1] -= 1.0
            err[-1] = np.inf
        lines += [f"{float(TRIGGER + ti)!r} {f} {float(mi)!r} {ei}\n"
                  for ti, mi, ei in zip(t, m, err)]
    root = tmp_path_factory.mktemp("grb_slice")
    (root / "obs.dat").write_text("".join(lines))
    (root / "grb.prior").write_text(GRB_PRIOR)
    return str(root / "obs.dat"), str(root / "grb.prior")


def grb_config(module, files, model_kwargs):
    data, prior = files
    return module.EMAnalysisConfig(
        model="TrPi2018", prior_file=prior, light_curve_data=data,
        trigger_time=TRIGGER, tmin=0.05, tmax=40.0, n_tsteps=64,
        error_budget=0.5, filters=GRB_FILTERS, model_kwargs=model_kwargs)


@pytest.mark.parametrize("b,kw_name", [(32, "small"), (4, "full")])
def test_batched_logl_matches(grb_files, monkeypatch, b, kw_name):
    """EMAnalysis("TrPi2018").batched_logl on config-3 data: sentinel
    positions identical, finite logL within rtol 1e-4 / atol 1e-2 of the
    fused JAX model; at a reduced resolution through model_kwargs and at
    full width."""
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    kw = SMALL if kw_name == "small" else {}
    j_ana = j_analysis.EMAnalysis(grb_config(j_analysis, grb_files, kw))
    t_ana = t_analysis.EMAnalysis(grb_config(t_analysis, grb_files, kw),
                                  device="cpu")
    assert t_ana.filters == j_ana.filters == sorted(GRB_FILTERS)
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    assert t_ana.model.model_kwargs == kw
    u = np.random.default_rng(300 + b).uniform(
        size=(b, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(jax.jit(j_ana.batched_logl)(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (b,)
    dead = want <= SENTINEL
    np.testing.assert_array_equal(got <= SENTINEL, dead)
    assert (~dead).sum() >= b // 2
    np.testing.assert_array_equal(got[dead], want[dead])
    print(f"TrPi2018 logL {kw_name}: max |dlogL| "
          f"{np.abs(got[~dead] - want[~dead]).max():.3e}")
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=1e-4, atol=1e-2)


def test_model_kwargs_reach_the_source_model():
    """Only the options a source model's mags_fn accepts are forwarded:
    jet_type reaches trpi2018_mags, an option it does not take is dropped,
    and a model without options gets none."""
    seen = []

    def spy(params, t_days, nu_host, jet_type=TG.JET_GAUSSIAN, n_theta=48,
            n_phi=16, n_r=256):
        seen.append(dict(jet_type=jet_type, n_theta=n_theta))
        return TG.trpi2018_mags(params, t_days, nu_host, jet_type=jet_type,
                                n_theta=n_theta, n_phi=n_phi, n_r=n_r)

    source = t_models.SourceModel(
        name="TrPi2018_spy", mags_fn=spy,
        parameter_names=t_models.get_source_model("TrPi2018").parameter_names)
    kw = dict(SMALL, jet_type=TG.JET_TOPHAT, not_an_option=3)
    det = t_models.DetectorLightCurveModel(
        source, ["ztfr"], sample_times=np.geomspace(0.1, 10.0, 16),
        model_kwargs=kw, device="cpu")
    assert det.model_kwargs == dict(SMALL, jet_type=TG.JET_TOPHAT)
    theta = detector_draws(2, 4)
    _, mags = det(as_port(theta, DET_NAMES))
    assert seen == [dict(jet_type=TG.JET_TOPHAT, n_theta=8)]
    tophat = t_models.DetectorLightCurveModel(
        "TrPi2018", ["ztfr"], sample_times=np.geomspace(0.1, 10.0, 16),
        model_kwargs=kw, device="cpu")(as_port(theta, DET_NAMES))[1]
    gauss = t_models.DetectorLightCurveModel(
        "TrPi2018", ["ztfr"], sample_times=np.geomspace(0.1, 10.0, 16),
        model_kwargs=SMALL, device="cpu")(as_port(theta, DET_NAMES))[1]
    np.testing.assert_array_equal(mags.numpy(), tophat.numpy())
    fin = torch.isfinite(gauss[0])
    assert not torch.allclose(tophat[0][fin], gauss[0][fin])
    me = t_models.DetectorLightCurveModel("Me2017", ["ztfr"],
                                          model_kwargs=kw, device="cpu")
    assert me.model_kwargs == {}


# -- K4, stage 1 on the card (ops/grb_dynamics_kernel.py) --------------------
#
# The kernel runs only on a CUDA card (chip_smoke.py holds it to the plain
# stage 1 there); on the CPU the dispatch, the wrapper's checks, the slots
# the parameters map onto and the cached phi nodes are tested.

def test_cpu_stage1_is_the_plain_version_and_loads_no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU stage 1 loaded {name}")

    monkeypatch.setattr(t_kernels, "load", refuse)
    theta = draw(3, 21)
    args = (torch.from_numpy(T_OBS), torch.from_numpy(NU), as_port(theta))
    got = TG.grb_stage1(*args, **SMALL)
    want = TG.grb_stage1_plain(*args, **SMALL)
    for g, w in zip(tuple(got[0]) + got[1:], tuple(want[0]) + want[1:]):
        assert torch.equal(g, w)
    assert TG.grb_afterglow_flux_density(*args, **SMALL).shape == (3, 3, 64)


def k4_inputs(n_b=4, n_th=8, n_r=128, device="cpu"):
    values = [torch.full((n_b,), 0.1, device=device)] + \
        [1.0] * (len(k4.SLOTS) - 1)
    return (values, torch.ones(16, device=device),
            torch.linspace(0.0, 1.0, n_th + 1, device=device),
            torch.linspace(0.0, 1.0, n_r, device=device))


K4_FLAGS = dict(jet_type=TG.JET_GAUSSIAN, spread=True, trumpet=True,
                injection=k4.INJ_NONE, wing_from_core=False, dist_coef=1e26)


@pytest.mark.parametrize("case", [
    "cpu", "float64_column", "float64_times", "matrix_column",
    "wrong_length_column", "strided_times", "time_shape", "edge_shape",
    "int_value", "slot_count", "jet_type", "injection"])
def test_k4_wrapper_refuses_before_any_launch(monkeypatch, case):
    """The wrapper checks devices, dtypes, shapes and contiguity before it
    loads the library; a CPU tensor reaches it only when called directly,
    and is refused."""
    def refuse(name):
        raise AssertionError(f"the wrapper loaded {name}")

    monkeypatch.setattr(t_kernels, "load", refuse)
    values, t_obs, edge, frac = k4_inputs()
    flags = dict(K4_FLAGS)
    error = ValueError
    if case == "float64_column":
        values[1], error = torch.ones(4, dtype=torch.float64), TypeError
    elif case == "float64_times":
        t_obs, error = t_obs.double(), TypeError
    elif case == "matrix_column":
        values[2] = torch.ones(4, 1)
    elif case == "wrong_length_column":
        values[3] = torch.ones(3)
    elif case == "strided_times":
        t_obs = torch.ones(32)[::2]
    elif case == "time_shape":
        t_obs = torch.ones(4, 2)
    elif case == "edge_shape":
        edge = torch.ones(1)
    elif case == "int_value":
        values[4], error = 2, TypeError
    elif case == "slot_count":
        values = values[:-1]
    elif case == "jet_type":
        flags["jet_type"] = 2
    elif case == "injection":
        flags["injection"] = 4
    with pytest.raises(error, match=None if case != "cpu" else "device"):
        k4.grb_dynamics(values, t_obs, edge, frac, **flags)


def test_k4_kernel_names_are_not_k3s():
    """The benchmark finds K3's launches by the substring grb_eats
    (portbench/counts/trpi2018.py KERNEL): no kernel of K4 may carry it."""
    import re
    with open(os.path.join(os.path.dirname(t_kernels.__file__), "csrc",
                           "grb_dynamics.cu")) as f:
        source = f.read()
    names = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*"
                       r"\)\s*)?(?:void\s+)?(\w+)\s*\(", source)
    assert names == ["grb_dynamics_kernel"]
    assert not any("grb_eats" in n for n in names)


@pytest.mark.parametrize("case,injection,l0", [
    ("none", k4.INJ_NONE, 0.0), ("zero_constant", k4.INJ_NONE, 0.0),
    ("constant", k4.INJ_CONST, 3e46 / 1e50), ("log10", k4.INJ_LOG10, None),
    ("column", k4.INJ_RAW, None)])
def test_k4_slots_follow_the_plain_parameters(monkeypatch, case, injection,
                                              l0):
    """_stage1_k4 hands K4 the parameters the plain stage 1 reads, with its
    defaults, the injection in the form it takes, the distance's units and
    thetaWing's default; and returns the plain version's operand layout."""
    seen = {}

    def fake(values, t_obs, edge, frac, **flags):
        seen.update(values=values, t_obs=t_obs, edge=edge, frac=frac, **flags)
        n_b, n_th, n_r = values[0].shape[0], edge.shape[0] - 1, frac.shape[0]
        z = torch.zeros
        return (z(n_b, n_th, n_r), z(n_b, 5, n_th, n_r), z(n_b, n_r),
                z(n_b, 8), torch.log(t_obs * 86400.0), z(n_b, n_th), z(n_b))

    monkeypatch.setattr(k4, "grb_dynamics", fake)
    theta = draw(3, 22)
    p = as_port(theta)
    del p["thetaWing"]
    if case == "zero_constant":
        p["L0"] = 0.0
    elif case == "constant":
        p.update(L0=3e46, q=0.5)
    elif case == "log10":
        p.update(log10_L0=torch.tensor([45.0, 46.0, 47.0]), ts=300.0)
    elif case == "column":
        p["L0"] = torch.tensor([1e46, 0.0, 2e46], dtype=torch.float64)
    ops, d_cos, inv_dl26 = TG._stage1_k4(
        torch.from_numpy(T_OBS), torch.from_numpy(NU), p, jet_type=0,
        spread=None, trumpet=False, **SMALL)
    values = dict(zip(k4.SLOTS, seen["values"]))
    assert seen["injection"] == injection
    assert seen["wing_from_core"] and not seen["trumpet"] and seen["spread"]
    assert seen["dist_coef"] == 1e26 / TG._MPC_CM
    assert values["distance"] is p["luminosity_distance"]
    assert (values["xi_N"], values["redshift"], values["b"]) == \
        (1.0, 0.0, 6.0)
    assert values["q"] == (0.5 if case == "constant" else 0.0)
    assert values["ts"] == (300.0 if case == "log10" else 0.0)
    if l0 is not None:
        assert values["L0"] == l0
    else:
        assert values["L0"].dtype == torch.float32
    torch.testing.assert_close(seen["edge"], torch.linspace(
        0.0, 1.0, 9) ** 1.3, rtol=0, atol=0)
    torch.testing.assert_close(seen["frac"], torch.arange(128.0) / 127,
                               rtol=0, atol=0)
    want = TG.grb_stage1_plain(torch.from_numpy(T_OBS),
                               torch.from_numpy(NU), as_port(theta), **SMALL)
    for g, w in zip(ops, want[0]):
        assert g.shape == w.shape
    torch.testing.assert_close(ops[5:], want[0][5:], rtol=0, atol=0)


def test_phi_nodes_are_cached_gauss_legendre():
    """The phi nodes and weights equal leggauss on (0, pi), weights summing
    to n_phi, made once per (n_phi, device)."""
    cphi, wphi = TG.phi_nodes(16, torch.device("cpu"))
    x, w = np.polynomial.legendre.leggauss(16)
    phi = torch.tensor(np.float32((x + 1.0) * (np.pi / 2.0)))
    assert torch.equal(cphi, torch.cos(phi))
    np.testing.assert_array_equal(wphi.numpy(), np.float32(w * 8.0))
    assert cphi.dtype == wphi.dtype == torch.float32
    again = TG.phi_nodes(16, "cpu")
    assert again[0] is cphi and again[1] is wphi
    assert TG.phi_nodes(4, "cpu")[0].shape == (4,)
