"""K1, the batched SVD-surrogate evaluation: CUDA kernel and plain version.

Replaces ``svd_surrogate_mags_pallas`` (``nmma_tpu/ops/pallas_svd.py:59``).
Per live point and filter it computes ``relu(x W1 + b1) W2 + b2`` and
projects the C coefficients through ``va_q`` (denormalisation and time
interpolation folded in, ``models/svd.py: operator_rankc``) onto Q times.
The CUDA kernel (``csrc/svd_mlp.cu``) keeps the hidden activations
``[B, F, H]`` on the SM; only ``[B, F, Q]`` is written. The surrogates of the
main paths, (P, C) = (4, 10) and (2, 10), take specialised instantiations;
every other P up to 16 with any C (the other grid families, other
``--svd-ncoeff``) takes a general kernel of the same library
(``kernel_route``).

CUDA tensors go to the kernel and CPU tensors to the plain version; there
is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .. import _kernels, tracing

# (P, C) of the specialised instantiations: the production Bu2019lm (4, 10)
# and the sparse Bu2019lm of the joint path (2, 10); every other P up to
# MAX_P, with any C, takes the general kernel
SPECIALISED = ((4, 10), (2, 10))
MAX_P = 16


def kernel_route(p, c):
    """Which K1 kernel a surrogate of P inputs and C coefficients takes:
    ``"specialised"`` or ``"general"``; raises ValueError for a shape no
    kernel takes (P outside 1..MAX_P, C < 1)."""
    if not 1 <= p <= MAX_P:
        raise ValueError(f"the K1 kernel takes P from 1 to {MAX_P}; got P={p}")
    if c < 1:
        raise ValueError(f"the K1 kernel needs C >= 1; got C={c}")
    return "specialised" if (p, c) in SPECIALISED else "general"


def svd_surrogate_mags_plain(x, w1, b1, w2c, b2, va_q, off_q):
    """The same function in three einsums, laid out as the JAX rank-C
    batched eval (nmma_tpu models/svd.py:238-242) lays it out."""
    n_f = w1.shape[0]
    xb = x.unsqueeze(0).expand(n_f, *x.shape)                   # [F, B, P]
    hid = torch.relu(torch.einsum("fbp,fph->fbh", xb, w1)
                     + b1[:, None, :])                          # [F, B, H]
    c = torch.einsum("fbh,fhc->fbc", hid, w2c) + b2[:, None, :]
    m = torch.einsum("fbc,fcq->fbq", c, va_q) + off_q[:, None, :]
    return m.permute(1, 0, 2)                                   # [B, F, Q]


def _check_operands(x, w1, b1, w2c, b2, va_q, off_q):
    tensors = {"x": x, "w1": w1, "b1": b1, "w2c": w2c, "b2": b2,
               "va_q": va_q, "off_q": off_q}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, p = x.shape
    n_f, _, h = w1.shape
    c = w2c.shape[2]
    q = va_q.shape[2]
    expected = {"w1": (n_f, p, h), "b1": (n_f, h), "w2c": (n_f, h, c),
                "b2": (n_f, c), "va_q": (n_f, c, q), "off_q": (n_f, q)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")


def svd_surrogate_mags(x, w1, b1, w2c, b2, va_q, off_q):
    """Surrogate magnitudes ``[B, F, Q]``.

    x [B, P] normalised inputs; w1 [F, P, H]; b1 [F, H]; w2c [F, H, C];
    b2 [F, C]; va_q [F, C, Q]; off_q [F, Q]; all float32 on one device.
    """
    _check_operands(x, w1, b1, w2c, b2, va_q, off_q)
    if x.device.type == "cpu":
        return svd_surrogate_mags_plain(x, w1, b1, w2c, b2, va_q, off_q)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    b, p = x.shape
    n_f, _, h = w1.shape
    c, q = w2c.shape[2], va_q.shape[2]
    kernel_route(p, c)
    out = torch.empty((b, n_f, q), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _kernels.load("svd_mlp")
    with tracing.span("kernel.k1", batch=x), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nmma_svd_mlp_mags(
            *[t.data_ptr() for t in (x, w1, b1, w2c, b2, va_q, off_q)],
            out.data_ptr(),
            b, p, h, c, q, n_f, x.device.index, stream)
    _kernels.check(lib, code, "svd_mlp_mags launch")
    tracing.count(tracing.K1_LAUNCHES)
    return out
