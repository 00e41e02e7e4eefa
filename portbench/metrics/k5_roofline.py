"""k5_roofline [%]: K5, the banded blackbody photometry (nmma_tpu_torch/
csrc/bb_photometry.cu): the counted bound of Me2017's photometry over K5's
device time, launch by launch over the first counted calls of the traced
slice.

The photometry is counted from the configuration's shapes, whatever
implements it: ``TEMPERATURE_OPS`` per (row, time) and ``BLACKBODY_OPS``
per (row, filter, node, time) (``counts/me2017.py``); the bytes of L / 1e40
and the radius [B, T], the grid [T], the nodes [B, F, K] and the weights
[F, K] read once and of the magnitudes [B, F, T] written once. A call of
more than ``MAX_BATCH`` rows is split into parts of that size
(``EMAnalysis.MAX_BATCH``), one launch each. A program without K5 has no
launch of it in the trace and reads None.
"""

from portbench import peaks
from portbench.counts.me2017 import BLACKBODY_OPS, TEMPERATURE_OPS

KERNEL = "bb_photometry"
MAX_BATCH = 8192


def work(rows, n_f, n_k, n_t):
    """(f32 operations, bytes) of the photometry on ``rows`` rows, ``n_f``
    filters of ``n_k`` nodes and ``n_t`` grid times."""
    n_ops = rows * n_t * (TEMPERATURE_OPS + n_f * n_k * BLACKBODY_OPS)
    n_bytes = 4.0 * (2 * rows * n_t + n_t + rows * n_f * n_k + n_f * n_k
                     + rows * n_f * n_t)
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
    ph = r.reference.photometry
    n_f, n_k = ph.nu_nodes.shape
    n_t = ph.sample_times.shape[0]
    bound = sum(peaks.roofline_ms(*work(rows, n_f, n_k, n_t))
                for rows in parts[:n])
    device = sum(e["dur"] for e in launches[:n]) / 1e3
    return 100.0 * bound / device
