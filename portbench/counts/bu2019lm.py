"""Counted work of the bu2019lm configuration: K1, the SVD-surrogate MLP
(``csrc/svd_mlp.cu``), and the shared likelihood passes. K1's arithmetic
is ``chip_smoke.k1_bound``'s: 2 operations an FMA over the three
products, each input read once and the output written once."""

from . import common

KERNEL = "svd_mlp"


def _dims(ref):
    n_f, p, h = ref.w1.shape
    return n_f, p, h, ref.w2.shape[2], ref.va_q.shape[2]


def k1_work(n_b, n_f, p, h, c, q):
    """(operations, bytes) of one K1 call on ``n_b`` rows."""
    ops = 2.0 * n_b * n_f * (p * h + h * c + c * q)
    n_bytes = 4.0 * (n_b * p + n_f * (p * h + h + h * c + c + c * q + q)
                     + n_b * n_f * q)
    return ops, n_bytes


def kernel_work(ref, u):
    """[(operations, bytes)] of the kernel launches of one call on the rows
    ``u`` [B, ndim]."""
    return [k1_work(u.shape[0], *_dims(ref))]


def step_ops(ref, u, kernel_ops):
    """Operations of one likelihood call on ``u``: K1 and the shared
    passes."""
    ph = ref.photometry
    n_f, n_t = len(ph.filters), ph.sample_times.shape[0]
    return kernel_ops + common.likelihood_ops(
        u.shape[0], n_f, n_t, int(ph.valid.sum()))
