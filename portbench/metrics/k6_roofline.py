"""k6_roofline [%]: K6, the EM likelihood from the source's magnitudes
(nmma_tpu_torch/csrc/em_likelihood.cu): the counted bound of the detector
frame, the interpolation onto the epochs and the likelihood terms over K6's
device time, launch by launch over the first counted calls of the traced
slice.

The work is counted from the reference's shapes, whatever implements it:
the operations of ``counts/common.py:likelihood_ops`` on the part's rows,
the filters, the grid and the valid observations; the bytes of the
magnitudes [B, F, T] and sigma_sys [B, F, N] read once, of the redshift,
timeshift, distance modulus and E(B-V) [B], of the data [F, N] (epochs,
magnitudes and errors in f32, the valid mask in bytes) and of logL [B]
written once. A call of more than ``MAX_BATCH`` rows is split into parts of
that size (``EMAnalysis.MAX_BATCH``), one launch each. A program without K6
has no launch of it in the trace and reads None.
"""

from portbench import peaks
from portbench.counts.common import likelihood_ops

KERNEL = "em_likelihood"
MAX_BATCH = 8192
# the [B] vectors a row reads: redshift, timeshift, distance modulus, E(B-V)
ROW_VECTORS = 4
# bytes of one data entry: epoch, magnitude and error (f32), valid (bool)
DATA_BYTES = 3 * 4 + 1


def work(rows, n_f, n_t, n_pad, n_obs):
    """(f32 operations, bytes) of the likelihood on ``rows`` rows, ``n_f``
    filters, ``n_t`` grid times and ``n_obs`` valid observations in a data
    array of ``n_f`` x ``n_pad`` entries."""
    n_ops = likelihood_ops(rows, n_f, n_t, n_obs)
    n_bytes = (4.0 * rows * (n_f * n_t + n_f * n_pad + ROW_VECTORS + 1)
               + DATA_BYTES * n_f * n_pad)
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
    n_f, n_pad = ph.valid.shape
    n_t = ph.sample_times.shape[0]
    n_obs = int(ph.valid.sum())
    bound = sum(peaks.roofline_ms(*work(rows, n_f, n_t, n_pad, n_obs))
                for rows in parts[:n])
    device = sum(e["dur"] for e in launches[:n]) / 1e3
    return 100.0 * bound / device
