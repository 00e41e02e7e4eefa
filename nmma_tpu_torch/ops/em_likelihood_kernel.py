"""K6, the EM likelihood from the source's magnitudes: the CUDA kernel's
wrapper.

From the source's magnitudes [B, F, T] to logL [B] in one launch a
``MAX_BATCH`` part (``csrc/em_likelihood.cu``): the detector frame (band
extinction, distance modulus, redshift correction, the "fewer than 2 finite
samples" rule, observer times), the interpolation onto the epochs with
composite filters, and the truncated-Gaussian and survival terms with their
sentinels, with no [B, F, K, T] tensor in device memory. It replaces no
Pallas kernel: the JAX package leaves the chain to XLA's fusion. Its plain
version is ``DetectorLightCurveModel.observe`` followed by the rest of
``EMLikelihood.log_likelihood`` (about 245 eager kernels).

``EMLikelihood.log_likelihood`` sends CPU tensors to the plain chain and
everything else here; this wrapper checks devices, dtypes, shapes and
contiguity, launches nothing off a CUDA device and has no fallback.
"""

from __future__ import annotations

import torch

from .. import _kernels, tracing

# rows a launch: a call of more rows is split into parts of this size, as
# EMAnalysis.batched_logl splits its calls
MAX_BATCH = 8192
LAWS = {"P92_SMC_host": 0, "G23_MW": 1}
MAX_T = 4096
MAX_F = 512
MAX_FK = 2048
MAX_FO = 512
MAX_KH = 16


def _check(ops):
    """(B, F, K, T, Fo, Kh, N) of the operands, or raise before any
    launch."""
    mags = ops["mags"]
    dtypes = {"helper_rows": torch.int32, "valid": torch.bool}
    for name, t in ops.items():
        if name == "dm" and t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != mags.device:
            raise ValueError(f"{name} is on {t.device}, mags on "
                             f"{mags.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mags.dim() != 3:
        raise ValueError(f"mags has shape {tuple(mags.shape)}, expected "
                         "(B, F, T)")
    n_b, n_f, n_t = mags.shape
    n_k = ops["nu_nodes"].shape[-1] if ops["nu_nodes"].dim() == 2 else -1
    n_fo, n_obs = ops["times"].shape if ops["times"].dim() == 2 else (-1, -1)
    n_kh = (ops["helper_rows"].shape[-1] if ops["helper_rows"].dim() == 2
            else -1)
    want = {"t_grid": (n_t,), "z": (n_b,), "timeshift": (n_b,),
            "dm": (n_b,), "ebv": (n_b,), "nu_nodes": (n_f, n_k),
            "nu_weights": (n_f, n_k), "helper_rows": (n_fo, n_kh),
            "helper_weights": (n_fo, n_kh), "times": (n_fo, n_obs),
            "data_mags": (n_fo, n_obs), "sigmas": (n_fo, n_obs),
            "valid": (n_fo, n_obs), "detection_limit": (n_fo,),
            "sigma_sys": (n_b, n_fo, n_obs)}
    for name, shape in want.items():
        t = ops[name]
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not (2 <= n_t <= MAX_T and 1 <= n_f <= MAX_F and n_k >= 1
            and n_f * n_k <= MAX_FK and 1 <= n_fo <= MAX_FO
            and 1 <= n_kh <= MAX_KH and n_obs >= 1):
        raise ValueError(f"K6 is not built for F={n_f}, K={n_k}, T={n_t}, "
                         f"Fo={n_fo}, Kh={n_kh}, N={n_obs} (limits: 2 <= T "
                         f"<= {MAX_T}, F <= {MAX_F}, F K <= {MAX_FK}, Fo <= "
                         f"{MAX_FO}, Kh <= {MAX_KH})")
    if mags.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {mags.device}; CPU "
                         "tensors take the plain likelihood")
    return n_b, n_f, n_k, n_t, n_fo, n_kh, n_obs


def em_log_likelihood(mags, t_grid, z, timeshift, dm, ebv, nu_nodes,
                      nu_weights, helper_rows, helper_weights, times,
                      data_mags, sigmas, valid, detection_limit, sigma_sys,
                      extinction_law):
    """logL [B] by K6, one launch a ``MAX_BATCH`` part: the source's
    magnitudes ``mags`` [B, F, T] in the detector's filter order on the
    ascending grid ``t_grid`` [T] days; the redshift, timeshift, distance
    modulus (None for a source that samples an apparent amplitude) and
    E(B-V) [B]; the detector's quadrature ``nu_nodes``/``nu_weights``
    [F, K] (observer frame) and its ``extinction_law``; the observed
    filters' helper rows (int32) and weights [Fo, Kh]; the data [Fo, N]
    (epochs, magnitudes, errors with inf for an upper limit, the bool
    ``valid``), the detection limits [Fo] and sigma_sys [B, Fo, N]. All
    f32 unless named, contiguous, on one CUDA device."""
    ops = dict(mags=mags, t_grid=t_grid, z=z, timeshift=timeshift, dm=dm,
               ebv=ebv, nu_nodes=nu_nodes, nu_weights=nu_weights,
               helper_rows=helper_rows, helper_weights=helper_weights,
               times=times, data_mags=data_mags, sigmas=sigmas, valid=valid,
               detection_limit=detection_limit, sigma_sys=sigma_sys)
    if extinction_law not in LAWS:
        raise ValueError(f"unknown extinction_law {extinction_law!r}")
    n_b, n_f, n_k, n_t, n_fo, n_kh, n_obs = _check(ops)
    dev = mags.device
    logl = torch.empty((n_b,), dtype=torch.float32, device=dev)
    if n_b == 0:
        return logl
    lib = _kernels.load("em_likelihood")
    if not lib.nmma_em_likelihood_supported(n_b, n_f, n_k, n_t, n_fo, n_kh,
                                            n_obs):
        raise ValueError(f"K6 is not built for B={n_b}, F={n_f}, K={n_k}, "
                         f"T={n_t}, Fo={n_fo}, Kh={n_kh}, N={n_obs} "
                         "(limits: nmma_em_likelihood_supported in "
                         "csrc/em_likelihood.cu)")
    ptrs = [None if t is None else t.data_ptr() for t in ops.values()]
    law = LAWS[extinction_law]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for row0 in range(0, n_b, MAX_BATCH):
            rows = min(MAX_BATCH, n_b - row0)
            with tracing.span("kernel.k6", rows=rows):
                code = lib.nmma_em_likelihood(
                    *ptrs, logl.data_ptr(), row0, rows, n_f, n_k, n_t, n_fo,
                    n_kh, n_obs, law, dev.index, stream)
            _kernels.check(lib, code, "em_likelihood launch")
            tracing.count(tracing.K6_LAUNCHES)
    return logl
