"""K5, the banded blackbody photometry: the CUDA kernel's wrapper.

From a photosphere to band AB magnitudes [B, F, T] in one launch
(``csrc/bb_photometry.cu``), with no [B, F, K, T] tensor in device memory.
It replaces no Pallas kernel: the JAX package leaves the chain to XLA's
fusion. Its plain versions are ``models/kilonova.py:_me2017_photometry_plain``
(the photosphere's temperature, its fill over the grid and the blackbody,
about 146 eager kernels) and ``ops/photometry.py:
blackbody_ab_mag_banded_plain`` (the blackbody alone, about 46).

Two entries, one kernel: :func:`me2017_bb_mags` takes Me2017's L / 1e40 and
radius and runs the kernel's prologue (the temperature and its fill);
:func:`bb_mags` takes 1/T and the radius of any other photosphere. The
callers send CPU tensors to the plain versions and everything else here;
this wrapper checks devices, dtypes, shapes and contiguity, launches nothing
off a CUDA device and has no fallback.
"""

from __future__ import annotations

import torch

from .. import _kernels, tracing

MAX_K = 16          # quadrature nodes a filter (held in registers)
MAX_T = 1024
MAX_FK = 1024


def _check(first_name, first, radius, t_days, nu_nodes, weights, log_dist2):
    """(B, F, K, T) of the operands, or raise before any launch."""
    named = [(first_name, first), ("radius", radius), ("nu_nodes", nu_nodes),
             ("weights", weights)]
    if t_days is not None:
        named.append(("t_days", t_days))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {first_name} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not isinstance(log_dist2, (int, float)):
        raise TypeError("log_dist2 must be a Python number")
    if first.dim() != 2:
        raise ValueError(f"{first_name} has shape {tuple(first.shape)}, "
                         "expected (B, T)")
    n_b, n_t = first.shape
    if tuple(radius.shape) != (n_b, n_t):
        raise ValueError(f"radius has shape {tuple(radius.shape)}, expected "
                         f"({n_b}, {n_t})")
    if t_days is not None and tuple(t_days.shape) != (n_t,):
        raise ValueError(f"t_days has shape {tuple(t_days.shape)}, expected "
                         f"({n_t},)")
    if nu_nodes.dim() != 3 or nu_nodes.shape[0] != n_b:
        raise ValueError(f"nu_nodes has shape {tuple(nu_nodes.shape)}, "
                         f"expected ({n_b}, F, K)")
    n_f, n_k = nu_nodes.shape[1:]
    if tuple(weights.shape) != (n_f, n_k):
        raise ValueError(f"weights has shape {tuple(weights.shape)}, "
                         f"expected ({n_f}, {n_k})")
    if not (1 <= n_k <= MAX_K and n_f >= 1 and n_f * n_k <= MAX_FK
            and 1 <= n_t <= MAX_T):
        raise ValueError(f"K5 is not built for F={n_f}, K={n_k}, T={n_t} "
                         f"(limits: 1 <= K <= {MAX_K}, F K <= {MAX_FK}, "
                         f"T <= {MAX_T})")
    if first.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {first.device}; CPU "
                         "tensors take the plain photometry")
    return n_b, n_f, n_k, n_t


def _launch(first_name, first, radius, t_days, nu_nodes, weights,
            log_dist2):
    n_b, n_f, n_k, n_t = _check(first_name, first, radius, t_days, nu_nodes,
                                weights, log_dist2)
    dev = first.device
    mags = torch.empty((n_b, n_f, n_t), dtype=torch.float32, device=dev)
    if n_b == 0:
        return mags
    lib = _kernels.load("bb_photometry")
    if not lib.nmma_bb_photometry_supported(n_b, n_f, n_k, n_t):
        raise ValueError(f"K5 is not built for B={n_b}, F={n_f}, K={n_k}, "
                         f"T={n_t} (limits: nmma_bb_photometry_supported "
                         "in csrc/bb_photometry.cu)")
    with tracing.span("kernel.k5", batch=mags), torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nmma_bb_photometry(
            first.data_ptr(), radius.data_ptr(),
            None if t_days is None else t_days.data_ptr(),
            nu_nodes.data_ptr(), weights.data_ptr(), mags.data_ptr(), n_b,
            n_f, n_k, n_t, int(t_days is not None), float(log_dist2),
            dev.index, stream)
    _kernels.check(lib, code, "bb_photometry launch")
    tracing.count(tracing.K5_LAUNCHES)
    return mags


def me2017_bb_mags(ltot40, r_photo, t_days, nu_nodes, weights, log_dist2):
    """Me2017's band magnitudes [B, F, T] by K5 with its prologue: from
    L / 1e40 erg/s and the photospheric radius [B, T] on the ascending grid
    ``t_days`` [T], through the temperature filled over the grid, to the
    blackbody at the quadrature nodes ``nu_nodes`` [B, F, K] averaged with
    ``weights`` [F, K]; ``log_dist2`` is ln D^2 of the absolute-magnitude
    distance. All f32, contiguous, on one CUDA device."""
    return _launch("ltot40", ltot40, r_photo, t_days, nu_nodes, weights,
                   log_dist2)


def bb_mags(nu_nodes, weights, inv_temp, radius, log_dist2):
    """Band magnitudes [B, F, T] by K5 without its prologue: the blackbody
    of 1/T and the radius [B, T] at ``nu_nodes`` [B, F, K], averaged with
    ``weights`` [F, K]. All f32, contiguous, on one CUDA device."""
    return _launch("inv_temp", inv_temp, radius, None, nu_nodes, weights,
                   log_dist2)
