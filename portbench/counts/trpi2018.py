"""Counted work of the trpi2018 configuration: K3, the equal-arrival-time
surface (``csrc/grb_eats.cu``), GRB stage 1, the ring sum and photometry,
and the shared likelihood passes. K3's counts are ``chip_smoke.k3_work``'s:
the arrival-time map of every (row, ring, phi, radius), the in-range test
of every query, and for each query in range the search, the two hat nodes
and the epilogue. The queries in range depend on the rows, so they are
counted on the rows of the traced calls themselves, through the
benchmark's reference stage 1."""

import math

import torch

from . import common
from ..reference import trpi2018 as ref_model

KERNEL = "grb_eats"
K3_OPS_MAP = 11
K3_OPS_RANGE = 2
K3_OPS_SEARCH_STEP = 2
K3_OPS_NODE = 24
K3_OPS_PAIR = 52
K3_OPS_PAIR_F = 9
# stage 1 per (row, ring, radius) on the full radius grid: the two
# Lorentz-factor solutions, the sound speed and spreading integral, the
# trumpet's swept-mass integral, the shock speed and the two time
# integrals (74, counted from the reference's stage 1 line by line)
STAGE1_OPS = 74
# per (row, ring, radius) of the stage-2 subgrid: the field, the two
# Lorentz factors and frequencies, the emissivity and the five logs with
# their clamps
STAGE1_SUB_OPS = 61
# per (row, ring, filter, time): the solid-angle weight and the ring sum
RING_SUM_OPS = 3
# per (row, filter, node time): mJy to AB (4), and per (row, filter, grid
# time) the interpolation from the 64 nodes (a search and 8)
MAG_OPS = 4
GRID_INTERP_OPS = 8
N_NODES = 64


def queries_in_range(ops, rows=256):
    """The (row, ring, phi, t) queries whose log time lies inside the
    row's arrival-time span, the ones that carry flux."""
    t_delay, tracks, r_grid, scal, log_q, cphi = ops[:6]
    count = 0
    for s in range(0, t_delay.shape[0], rows):
        sc = scal[s:s + rows, :, None, None, None]
        th_r = torch.exp(tracks[s:s + rows, 4])[:, :, None, :]
        t_obs = (1.0 + sc[:, 0]) * (
            t_delay[s:s + rows, :, None, :]
            + ref_model.one_minus_mu(sc[:, 4], sc[:, 2], th_r,
                                     cphi[:, None])
            * r_grid[s:s + rows, None, None, :] / ref_model._C)
        log_t = torch.log(torch.clamp(t_obs, min=1e-10))
        lo = torch.clamp(log_t[..., :1], max=60.0)
        hi = torch.clamp(log_t.amax(-1, keepdim=True), max=60.0)
        count += int(((log_q >= lo) & (log_q <= hi)).sum())
    return count


def stage1_operands(ref, u):
    ph = ref.photometry
    p = ph.parameters(u)
    t_days = ph.sample_times
    t_start = torch.clamp(t_days.min(), min=1e-5)
    frac = torch.arange(N_NODES, dtype=t_days.dtype,
                        device=t_days.device) / (N_NODES - 1)
    t_grid = t_start * torch.pow((t_days.max() + 1.0) / t_start, frac)
    p["d_L"] = torch.full_like(p["thetaCore"], 3.086e19)
    nu_obs = ph.nu_0[None].expand(u.shape[0], -1)
    return ref_model.stage1(t_grid, nu_obs, p, ref.n_theta, ref.n_phi,
                            ref.n_r, t_days.dtype)[0]


def k3_work(ops, in_range):
    n_b, n_th, n_r = ops[0].shape
    n_t, n_phi, n_f = ops[4].shape[-1], ops[5].shape[0], ops[7].shape[1]
    queries = n_b * n_th * n_phi * n_t
    n_ops = (n_b * n_th * n_phi * n_r * K3_OPS_MAP + queries * K3_OPS_RANGE
             + in_range * (K3_OPS_SEARCH_STEP * math.ceil(math.log2(n_r))
                           + 2 * K3_OPS_NODE + K3_OPS_PAIR
                           + K3_OPS_PAIR_F * n_f))
    n_bytes = 4.0 * (sum(t.numel() for t in ops) + n_b * n_th * n_f * n_t)
    return n_ops, n_bytes


def kernel_work(ref, u, block=2048):
    """[(operations, bytes)] of the one K3 launch of a call on ``u``."""
    n_ops = n_bytes = 0.0
    for s in range(0, u.shape[0], block):
        ops = stage1_operands(ref, u[s:s + block])
        o, b = k3_work(ops, queries_in_range(ops))
        n_ops, n_bytes = n_ops + o, n_bytes + b
    # the parameters and the sample times are read once a launch, not a
    # block: the difference is under a millionth of the bytes
    return [(n_ops, n_bytes)]


def step_ops(ref, u, kernel_ops):
    ph = ref.photometry
    n_b = u.shape[0]
    n_f, n_t = len(ph.filters), ph.sample_times.shape[0]
    n_r = ref.n_r
    n_sub = n_r // 2 if n_r >= 256 else n_r
    return (kernel_ops
            + n_b * ref.n_theta * (n_r * STAGE1_OPS + n_sub * STAGE1_SUB_OPS)
            + n_b * ref.n_theta * n_f * N_NODES * RING_SUM_OPS
            + n_b * n_f * (N_NODES * MAG_OPS + n_t * (
                GRID_INTERP_OPS + common.search_ops(N_NODES)))
            + common.likelihood_ops(n_b, n_f, n_t, int(ph.valid.sum())))
