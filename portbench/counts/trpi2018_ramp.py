"""Counted work of the trpi2018_ramp configuration: K3 in its per-row
query mode (``csrc/grb_eats.cu``), stage 1 of every folded (live point,
node) row, the ring sums, photometry and the shared likelihood passes.

A call on B live points asks for B x 64 rows, each with its own blast-wave
energy and its own single time. K3's work on them is ``trpi2018.k3_work``
on operands whose ``log_q`` is [rows, 1], counted node by node through the
benchmark's reference stage 1 (``reference/trpi2018_ramp.py``): at one node
every row asks for that node's time, so its queries in range are counted by
``trpi2018.queries_in_range`` against that one time. The count is of rows,
not of the program's chunks: it holds whatever chunk size the program
takes."""

import torch

from . import common, trpi2018 as base
from ..reference import trpi2018 as ref_model
from ..reference import trpi2018_ramp as ref_ramp

KERNEL = "grb_eats"
N_NODES = ref_ramp.N_NODES
# per (live point, node): the ramp's log10 E0 (two logs, a divide, a
# multiply-add, two compares and two selects)
RAMP_OPS = 8


def node_operands(ref, u):
    """K3's operands of the B rows of ``u`` at each node in turn, as the
    program's per-row mode takes them (``log_q`` [B, 1])."""
    ph = ref.photometry
    p = ph.parameters(u)
    t_grid = ref_ramp.node_grid(ph.sample_times)
    p["d_L"] = torch.full_like(p["thetaCore"], 3.086e19)
    nu_obs = ph.nu_0[None].expand(u.shape[0], -1)
    log10_e0 = ref_ramp.ramp_log10_e0(p, t_grid)
    for i in range(N_NODES):
        p["log10_E0"] = log10_e0[:, i]
        yield ref_model.stage1(t_grid[i:i + 1], nu_obs, p, ref.n_theta,
                               ref.n_phi, ref.n_r, t_grid.dtype)[0]


def kernel_work(ref, u, block=1024):
    """[(operations, bytes)] of K3 over the B x 64 rows of a call on
    ``u``: one entry a call, however many launches the program makes."""
    n_ops = n_bytes = 0.0
    for s in range(0, u.shape[0], block):
        for ops in node_operands(ref, u[s:s + block]):
            in_range = base.queries_in_range(ops)
            rows = ops[0].shape[0]
            per_row = ops[:4] + (ops[4].expand(rows, 1),) + ops[5:]
            o, b = base.k3_work(per_row, in_range)
            n_ops, n_bytes = n_ops + o, n_bytes + b
    # the phi nodes are read once a launch, not a node: the difference is
    # under a millionth of the bytes
    return [(n_ops, n_bytes)]


def step_ops(ref, u, kernel_ops):
    ph = ref.photometry
    n_b = u.shape[0]
    rows = n_b * N_NODES
    n_f, n_t = len(ph.filters), ph.sample_times.shape[0]
    n_r = ref.n_r
    n_sub = n_r // 2 if n_r >= 256 else n_r
    return (kernel_ops
            + rows * ref.n_theta * (n_r * base.STAGE1_OPS
                                    + n_sub * base.STAGE1_SUB_OPS)
            + rows * ref.n_theta * n_f * base.RING_SUM_OPS
            + rows * RAMP_OPS
            + n_b * n_f * (N_NODES * base.MAG_OPS + n_t * (
                base.GRID_INTERP_OPS + common.search_ops(N_NODES)))
            + common.likelihood_ops(n_b, n_f, n_t, int(ph.valid.sum())))
