"""k4_roofline [%]: K4, TrPi2018's stage 1 (nmma_tpu_torch/csrc/
grb_dynamics.cu): the counted bound of stage 1 over K4's device time,
launch by launch over the first counted calls of the traced slice.

Stage 1 is counted from the configuration's shapes, whatever implements it:
``STAGE1_OPS`` per (row, ring, radius) and ``STAGE1_SUB_OPS`` per (row,
ring, subgrid radius) (``counts/trpi2018.py``); the bytes of K3's operands
written once (t_delay and five tracks per (row, ring, subgrid radius),
r_grid, d_cos, the eight scalars and inv_dl26 of a row) and of the 15
parameters a row reads. A call of more than ``MAX_BATCH`` rows is split
into parts of that size (``EMAnalysis.MAX_BATCH``), one launch each. A
program without K4 has no launch of it in the trace and reads None.
"""

from portbench import peaks
from portbench.counts.trpi2018 import STAGE1_OPS, STAGE1_SUB_OPS

KERNEL = "grb_dynamics"
MAX_BATCH = 8192
N_PARAMS = 15
N_ROW_OUTPUTS = 9


def work(rows, n_theta, n_r):
    """(f32 operations, bytes) of stage 1 on ``rows`` rows."""
    n_sub = (n_r + 1) // 2 if n_r >= 256 else n_r
    n_ops = rows * n_theta * (n_r * STAGE1_OPS + n_sub * STAGE1_SUB_OPS)
    n_bytes = 4.0 * rows * (6 * n_theta * n_sub + n_sub + n_theta
                            + N_ROW_OUTPUTS + N_PARAMS)
    return n_ops, n_bytes


def read(r):
    if r.trace is None or r.reference is None:
        return None
    launches = r.trace.kernels(KERNEL)
    parts = [min(MAX_BATCH, u.shape[0] - s) for u in r.counted_inputs()
             for s in range(0, u.shape[0], MAX_BATCH)]
    n = min(len(launches), len(parts))
    if n == 0:
        return None
    ref = r.reference
    bound = sum(peaks.roofline_ms(*work(rows, ref.n_theta, ref.n_r))
                for rows in parts[:n])
    device = sum(e["dur"] for e in launches[:n]) / 1e3
    return 100.0 * bound / device
