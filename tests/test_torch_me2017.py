"""K2, the Me2017 shell dynamics of the PyTorch port, against the JAX package.

The same seeded numpy parameters (the ranges of tests/test_pallas_kernel.py)
go through the port's wrapper on the CPU (its plain version) and through
``me2017_dynamics_pallas(interpret=True)`` and ``jax.vmap(_me2017_dynamics_xla)``
on the main path's grid ``geomspace(0.01, 14, 150)``.

Tolerances, those of the JAX package's own kernel test
(tests/test_pallas_kernel.py:28-32): ltot within 2e-3 relative where
ltot > 1e-4, r_photo within 1e-4 relative. The photosphere is the shell whose
|tau - 1| is smallest; where the reference's two smallest |tau - 1| lie within
1e-5 of each other (a near-tie), two correct implementations that round tau
differently may pick either shell, so there r_photo must equal ``vm t`` of
one of the two (``compare_dynamics``). The reference side's tie data come
from the JAX package's shell setup and the tau of ``_me2017_dynamics_xla``
(models/kilonova.py:140-141), for both JAX references. Every comparison
fails if more than 1% of its (live point, time) points are near-ties.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmma_tpu.constants import msun_cgs
from nmma_tpu.models.kilonova import _me2017_dynamics_xla, _me2017_setup
from nmma_tpu.ops.pallas_me2017 import me2017_dynamics_pallas
from nmma_tpu_torch.ops import me2017_kernel as k2

torch.set_num_threads(1)

T_DAYS = np.geomspace(0.01, 14.0, 150).astype(np.float32)


def jax_near_ties(log10_mej, log10_vej, beta, kappa_r, t_days):
    """Reference-side tie data as numpy: ``gap`` [B, T] between the two
    smallest |tau - 1| (inf at the last time) and ``r_cand`` [B, T, 2],
    ``vm t`` of those two shells (0 at the last time)."""
    t_days = jnp.asarray(t_days, dtype=jnp.float32)

    def one(lm, lv, be, ka):
        params = {"log10_mej": lm, "log10_vej": lv, "beta": be,
                  "log10_kappa_r": jnp.log10(ka)}
        _, _, _, kappa_r, t, m, vm, xn0, xr, _ = _me2017_setup(params, t_days)
        m_s, vm_s, xn0_s, xr_s = m[:-1], vm[:-1], xn0[:-1], xr[:-1]
        t_j = t[:-1, None]
        xn = xn0_s[None, :] * jnp.exp(-t_j / 900.0)
        kappa = 0.4 * (1.0 - xn - xr_s[None, :]) + kappa_r * xr_s[None, :]
        tau = (m_s * msun_cgs)[None, :] * kappa / (
            4.0 * jnp.pi * (t_j * vm_s[None, :]) ** 2)
        neg_dev, idx = jax.lax.top_k(-jnp.abs(tau - 1.0), 2)
        gap = jnp.concatenate([neg_dev[:, 0] - neg_dev[:, 1],
                               jnp.full((1,), jnp.inf)])
        r_cand = jnp.concatenate([vm_s[idx] * t_j, jnp.zeros((1, 2))])
        return gap, r_cand

    gap, r_cand = jax.vmap(one)(*(jnp.asarray(a) for a in
                                  (log10_mej, log10_vej, beta, kappa_r)))
    return np.array(gap), np.array(r_cand)


def draw(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, -0.5, b).astype(np.float32),
            rng.uniform(-2, -0.5, b).astype(np.float32),
            rng.uniform(1, 5, b).astype(np.float32),
            (10 ** rng.uniform(-1, 2, b)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_runs():
    """Both JAX references and their tie data, once per batch size."""
    cache = {}

    def get(b):
        if b not in cache:
            params = draw(b, 2017 + b)
            args = [jnp.asarray(a) for a in params]
            pallas = me2017_dynamics_pallas(*args, jnp.asarray(T_DAYS),
                                            interpret=True)
            xla = jax.vmap(_me2017_dynamics_xla,
                           in_axes=(0, 0, 0, 0, None))(*args,
                                                       jnp.asarray(T_DAYS))
            cache[b] = (params, {"pallas": pallas, "xla": xla},
                        jax_near_ties(*params, T_DAYS))
        return cache[b]

    return get


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("b", [1, 12, 64])
def test_k2_matches_jax(jax_runs, b, ref):
    params, refs, (gap, r_cand) = jax_runs(b)
    ltot, r_photo = k2.me2017_dynamics(
        *(torch.from_numpy(a) for a in params), torch.from_numpy(T_DAYS))
    assert ltot.shape == r_photo.shape == (b, 150)
    want_ltot, want_r = (torch.from_numpy(np.array(a)) for a in refs[ref])
    stats = k2.compare_dynamics(ltot, r_photo, want_ltot, want_r,
                                torch.from_numpy(gap),
                                torch.from_numpy(r_cand))
    print(ref, b, stats)
    assert stats["mismatches"] == 0, stats
    assert stats["near_ties"] <= 0.01 * stats["points"], stats
    assert stats["ok"]
    # the last time index is 0 on both sides
    assert not ltot[:, -1].any() and not r_photo[:, -1].any()


def test_tie_rule_on_tied_shells():
    """Each odd shell is given the m/vm^2 and composition of the even shell
    before it, so the two have equal tau at every step: wherever such a pair
    holds the photosphere, the gap is exactly 0. The plain version takes the
    first shell of the pair (the larger vm); a result that takes the second
    passes the rule there, one that is 3e-4 off both does not, and a result
    moved where no tie excuses it fails too."""
    params = [torch.from_numpy(a) for a in draw(1, 7)]
    shells, per_sample, per_step = k2.me2017_operands(
        *params, torch.from_numpy(T_DAYS))
    shells = k2.tied_operands(shells, 1)
    ltot, r_photo, gap, r_cand = k2.me2017_dynamics_plain(
        shells, per_sample, per_step, with_ties=True)
    tied = gap == 0
    assert int(tied.sum()) > 100, "the pairs never hold the photosphere"
    assert torch.equal(r_photo[tied], r_cand.amax(dim=-1)[tied])
    stats = k2.compare_dynamics(ltot, r_photo, ltot, r_photo, gap, r_cand)
    assert stats["mismatches"] == 0 and stats["near_ties"] == int(tied.sum())
    # so many ties make the comparison fail as a whole
    assert not stats["ok"]

    second = torch.where(tied, r_cand.amin(dim=-1), r_photo)
    assert (second != r_photo).any()
    stats = k2.compare_dynamics(ltot, second, ltot, r_photo, gap, r_cand)
    assert stats["mismatches"] == 0, stats

    off = torch.where(tied, r_photo * 1.0003, r_photo)
    stats = k2.compare_dynamics(ltot, off, ltot, r_photo, gap, r_cand)
    assert stats["mismatches"] == int(tied.sum()), stats

    # without the pairs: near-ties are rare, and a moved photosphere where
    # there is no tie is a mismatch
    shells, per_sample, per_step = k2.me2017_operands(
        *params, torch.from_numpy(T_DAYS))
    ltot, r_photo, gap, r_cand = k2.me2017_dynamics_plain(
        shells, per_sample, per_step, with_ties=True)
    stats = k2.compare_dynamics(ltot, r_photo, ltot, r_photo, gap, r_cand)
    assert stats["ok"], stats
    moved = r_photo.clone()
    j = int(torch.nonzero((gap[0] >= k2.NEAR_TIE) & (r_photo[0] > 0))[0])
    moved[0, j] *= 1.0003
    stats = k2.compare_dynamics(ltot, moved, ltot, r_photo, gap, r_cand)
    assert stats["mismatches"] == 1 and not stats["ok"]


def test_wrapper_checks_its_operands():
    params = [torch.from_numpy(a) for a in draw(3, 1)]
    shells, per_sample, per_step = k2.me2017_operands(
        *params, torch.from_numpy(T_DAYS))
    assert shells.shape == (6, 3, k2.N_SHELLS)
    assert per_sample.shape == (2, 3) and per_step.shape == (7, 150)
    with pytest.raises(TypeError, match="float32"):
        k2.me2017_dynamics_from_operands(shells.double(), per_sample,
                                         per_step)
    with pytest.raises(ValueError, match="contiguous"):
        k2.me2017_dynamics_from_operands(
            shells.transpose(1, 2).contiguous().transpose(1, 2), per_sample,
            per_step)
    with pytest.raises(ValueError, match="shells has shape"):
        k2.me2017_dynamics_from_operands(shells[:, :, :298].contiguous(),
                                         per_sample, per_step)
    with pytest.raises(ValueError, match="per_sample has shape"):
        k2.me2017_dynamics_from_operands(shells, per_sample[:, :2].contiguous(),
                                         per_step)
    with pytest.raises(ValueError, match="per_step has shape"):
        k2.me2017_dynamics_from_operands(shells, per_sample,
                                         per_step[:6].contiguous())
    with pytest.raises(ValueError, match="is on meta"):
        k2.me2017_dynamics_from_operands(shells, per_sample.to("meta"),
                                         per_step)
    with pytest.raises(ValueError, match="no K2 kernel for device meta"):
        k2.me2017_dynamics_from_operands(
            shells.to("meta"), per_sample.to("meta"), per_step.to("meta"))
    # an empty batch is fine on the plain route
    empty = k2.me2017_dynamics_from_operands(
        shells[:, :0].contiguous(), per_sample[:, :0].contiguous(), per_step)
    assert empty[0].shape == (0, 150)


# --- the kernel's arithmetic, emulated on the CPU -------------------------
#
# csrc/me2017_dynamics.cu lays the 299 shells out as lane l, slot k <->
# shell l + 32 k (slot 9 live in lanes 0-10 only). The emulations below
# follow that layout and the kernel's order of operations, so that the CPU
# pins what the card is held to: r_photo bit for bit, ltot within 1e-4.

LANES = 32
SLOTS = (k2.N_SHELLS + LANES - 1) // LANES
LTOT_REL = 1e-4          # the card's gate on ltot (chip_smoke.py [k2])


def _slots(a, fill):
    """[B, 299] -> [B, SLOTS, LANES], the masked tail filled with `fill`."""
    pad = torch.full((a.shape[0], SLOTS * LANES - k2.N_SHELLS), fill,
                     dtype=a.dtype)
    return torch.cat([a, pad], dim=1).reshape(a.shape[0], SLOTS, LANES)


def _fma32(a, b, c):
    """f32 FMA: the product exact in float64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sum(v):
    """The kernel's sum of the lane partials v [B, LANES]: from 0, in lane
    order, rounded to f32 at each step."""
    s = torch.zeros(v.shape[0])
    for lane in range(LANES):
        s = s + v[:, lane]
    return s


def emulate_k2(shells, per_sample, per_step):
    """(ltot [B, T], r_photo [B, T]) as the kernel computes them: tau
    rounded op by op as the plain version rounds it; per lane the first
    minimal |tau - 1| over the slots (strict <) and its vm; the minimum
    over the lanes, then the largest vm over the lanes that hold it. The
    luminosity chain: one f32 reciprocal of denom, FMAs for denom, edot,
    the lane sums and the ene update; the lanes summed in lane order."""
    mvm = _slots(shells[0], 1.0)
    mvm2, vm, xn0, xr, dm = (_slots(a, 0.0) for a in shells[1:])
    live = _slots(torch.ones_like(shells[0], dtype=torch.bool), False)
    kappa_r, c_tdiff = per_sample[0][:, None, None], per_sample[1][:, None,
                                                                  None]
    kxr = kappa_r * xr
    n_b, n_t = shells.shape[1], per_step.shape[1]
    ltot = torch.zeros((n_b, n_t))
    r_photo = torch.zeros((n_b, n_t))
    ene = torch.zeros_like(mvm)
    for j in range(n_t - 1):
        t_j, dt_j, exp_j, edotr_j, tauc_j, toc_j, dtt_j = per_step[:, j]
        q = c_tdiff / t_j
        xn = xn0 * exp_j
        kappa = 0.4 * ((1.0 - xn) - xr) + kxr
        tau = (tauc_j * kappa) * mvm2
        dev = torch.where(live, (tau - 1.0).abs(), math.inf)
        lmin = torch.full((n_b, LANES), math.inf)
        lvm = vm[:, 0].clone()
        for k in range(SLOTS):
            better = dev[:, k] < lmin
            lmin = torch.where(better, dev[:, k], lmin)
            lvm = torch.where(better, vm[:, k], lvm)
        gmin = lmin.amin(dim=1, keepdim=True)
        r_photo[:, j] = torch.where(lmin == gmin, lvm, 0.0).amax(dim=1) * t_j

        tdiff = (q * kappa) * mvm
        denom = _fma32(toc_j, vm, tdiff)
        r = (1.0 / denom.double()).float()
        lum = ene * r
        part = torch.zeros((n_b, LANES))
        for k in range(SLOTS):
            part = _fma32(lum[:, k], dm[:, k], part)
        ltot[:, j] = _lane_sum(part)
        factor = _fma32(-dt_j, r, 1.0 - dtt_j).clamp(0.0, 1.0)
        edot = _fma32(torch.tensor(3.2e14), xn, edotr_j)
        ene = _fma32(factor, ene, dt_j * edot)
    return ltot, r_photo


def _operands(b, seed):
    return k2.me2017_operands(*(torch.from_numpy(a) for a in draw(b, seed)),
                              torch.from_numpy(T_DAYS))


@pytest.mark.parametrize("case", ["main_b1", "main_b64", "ties_lanes",
                                  "ties_slots"])
def test_k2_lane_reduction_equals_plain_photosphere(case):
    """The kernel's lane/slot reduction picks the plain version's
    photosphere shell bit for bit: on main-path operands, and where pairs
    of shells are exactly tied in two lanes (stride 1) or in two slots of
    one lane (stride 32), where the first shell of the pair must win."""
    shells, per_sample, per_step = _operands(
        1 if case == "main_b1" else 64, 9)
    if case.startswith("ties"):
        shells = k2.tied_operands(shells, 1 if case == "ties_lanes" else 32)
    _, r_plain, gap, r_cand = k2.me2017_dynamics_plain(
        shells, per_sample, per_step, with_ties=True)
    _, r_emu = emulate_k2(shells, per_sample, per_step)
    assert torch.equal(r_emu, r_plain)
    if case.startswith("ties"):
        tied = gap == 0
        assert int(tied.sum()) > 100, "the pairs never hold the photosphere"
        # the first shell of a pair (the larger vm) wins
        assert torch.equal(r_plain[tied], r_cand.amax(dim=-1)[tied])
        # and on most of them the two shells' vm differ (off the vm = c
        # plateau), so the tie-break decides r_photo
        differ = r_cand[tied][:, 0] != r_cand[tied][:, 1]
        assert int(differ.sum()) > 100


def test_tied_operands_place_the_pairs():
    """stride 1 ties shell 2i + 1 to 2i; stride 32 ties s + 32 to s for s in
    the even slots; vm is never copied."""
    shells, _, _ = _operands(2, 3)
    for stride in (1, 32):
        tied = k2.tied_operands(shells, stride)
        assert torch.equal(tied[[0, 2, 5]], shells[[0, 2, 5]])
        src = torch.tensor([s for s in range(k2.N_SHELLS - stride)
                            if (s // stride) % 2 == 0])
        assert len(src) > 100
        for row in (1, 3, 4):
            assert torch.equal(tied[row][:, src + stride],
                               shells[row][:, src])
        untouched = torch.ones(k2.N_SHELLS, dtype=torch.bool)
        untouched[src + stride] = False
        assert torch.equal(tied[:, :, untouched], shells[:, :, untouched])


def test_k2_lane_reduction_on_the_masked_tail_slot():
    """Late in the grid every shell is optically thin and the photosphere
    is the last shell, 298, in the last slot, whose lanes 11-31 are
    masked: the reduction must take it there and agree bit for bit."""
    shells, per_sample, per_step = _operands(64, 11)
    _, r_plain = k2.me2017_dynamics_plain(shells, per_sample, per_step)
    _, r_emu = emulate_k2(shells, per_sample, per_step)
    vm = shells[2]
    t = per_step[0]
    in_tail = torch.zeros_like(r_plain, dtype=torch.bool)
    for s in range(LANES * (SLOTS - 1), k2.N_SHELLS):
        in_tail |= (r_plain == vm[:, s:s + 1] * t) & (r_plain > 0)
    assert int(in_tail.sum()) > 0, "no photosphere in the last slot"
    assert int(in_tail.any(dim=1).sum()) > 0
    assert torch.equal(r_emu, r_plain)


def test_k2_reciprocal_chain_stays_within_the_card_gate():
    """The kernel's luminosity chain (one f32 reciprocal of denom, FMAs,
    the lanes summed in lane order) stays within 1e-4 relative of the plain
    version's ltot wherever ltot > 1e-4, on the main path's grid at
    B = 64: the gate chip_smoke.py holds the card to."""
    shells, per_sample, per_step = _operands(64, 2017)
    l_plain, _ = k2.me2017_dynamics_plain(shells, per_sample, per_step)
    l_emu, _ = emulate_k2(shells, per_sample, per_step)
    sel = l_plain > 1e-4
    assert int(sel.sum()) > 1000
    rel = ((l_emu - l_plain).abs() / l_plain)[sel]
    print("ltot max rel", float(rel.max()))
    assert float(rel.max()) <= LTOT_REL
    # the emulation does round otherwise: it is not the plain loop itself
    assert not torch.equal(l_emu, l_plain)
    assert not l_emu[:, -1].any()
