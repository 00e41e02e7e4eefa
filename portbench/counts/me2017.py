"""Counted work of the me2017 configuration: K2, the Metzger (2017) shell
dynamics (``csrc/me2017_dynamics.cu``), the banded blackbody photometry and
the shared likelihood passes. K2's counts are ``chip_smoke.py``'s
(``K2_OPS_SHELL_STEP``, ``K2_OPS_STEP`` and its bytes)."""

from . import common

KERNEL = "me2017_dynamics"
N_SHELLS = 299
# f32 operations per (row, shell, step) in the K2 loop body, and per
# (row, step) outside it
K2_OPS_SHELL_STEP = 31
K2_OPS_STEP = 2
# K2's operands: shells [6, B, S], per_sample [2, B], per_step [7, T]
SHELL_ROWS, SAMPLE_ROWS, STEP_ROWS = 6, 2, 7
# the banded blackbody per (row, filter, node, time): x = h nu / kT (2),
# the validity tests (3), log(expm1 x) (4), the log flux sum (4), the
# weighted log-sum-exp over the nodes (3) and the magnitude (2, per node
# share)
BLACKBODY_OPS = 18
# per (row, time): the effective temperature from L and R (7), its
# interpolation over the grid (12) and 1 / T (2)
TEMPERATURE_OPS = 21


def k2_work(n_b, n_t):
    """(operations, bytes) of one K2 call on ``n_b`` rows and ``n_t`` grid
    times."""
    ops = (n_t - 1) * n_b * (K2_OPS_SHELL_STEP * N_SHELLS + K2_OPS_STEP)
    n_bytes = 4.0 * (SHELL_ROWS * n_b * N_SHELLS + SAMPLE_ROWS * n_b
                     + STEP_ROWS * n_t) + 4.0 * 2 * n_b * n_t
    return ops, n_bytes


def kernel_work(ref, u):
    return [k2_work(u.shape[0], ref.photometry.sample_times.shape[0])]


def step_ops(ref, u, kernel_ops):
    ph = ref.photometry
    n_b = u.shape[0]
    n_f, n_t = len(ph.filters), ph.sample_times.shape[0]
    n_k = ph.nu_nodes.shape[1]
    return (kernel_ops + n_b * n_t * TEMPERATURE_OPS
            + n_b * n_f * n_k * n_t * BLACKBODY_OPS
            + common.likelihood_ops(n_b, n_f, n_t, int(ph.valid.sum())))
