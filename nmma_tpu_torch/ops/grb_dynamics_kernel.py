"""K4, TrPi2018's stage 1: the CUDA kernel's wrapper.

Stage 1 is the blast-wave dynamics of every (live point, theta ring) on a
log-R grid, up to K3's operands (``ops/grb_kernel.py``). It replaces no
Pallas kernel: the JAX package leaves the chain to XLA's fusion
(``nmma_tpu/models/grb.py:102-497``). Its plain version is
``models/grb.py:grb_stage1_plain``, about 224 eager kernels over
[B, Th, R] tensors; the kernel (``csrc/grb_dynamics.cu``) goes from the
sampled parameters to K3's operands in one pass, with the running integrals
of each ring in registers, and writes nothing [B, Th, R]-sized but those
operands.

:func:`grb_dynamics` takes the parameters as they come, one entry of
``SLOTS`` each: a tensor (a column [B], or one value [] or [1], any stride)
that the kernel reads in place, or a Python float. ``models/grb.py`` maps a
parameter dictionary onto the slots (:func:`models.grb.grb_stage1` sends
CPU tensors to the plain version and everything else here); this wrapper
checks devices, dtypes, shapes and contiguity, launches nothing off a CUDA
device and has no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels, tracing
from .grb_kernel import N_SCAL, N_TRACKS

# the kernel's parameters, in the order of ``enum Slot`` in
# csrc/grb_dynamics.cu
SLOTS = ("thetaCore", "log10_E0", "thetaWing", "inclination_EM", "log10_n0",
         "p", "log10_epsilon_e", "log10_epsilon_B", "xi_N", "distance",
         "redshift", "b", "L0", "q", "ts")
JET_TYPES = (-1, 0, 4)     # tophat, Gaussian, power law (models/grb.py)
# the energy injection's form: none; 10 ** (log10_L0 - 50); L0 1e-25 1e-25;
# a positive constant L0 / 1e50
INJ_NONE, INJ_LOG10, INJ_RAW, INJ_CONST = range(4)


def subgrid(n_r):
    """Radii of stage 2's subgrid: every second radius from 256 on."""
    return (n_r + 1) // 2 if n_r >= 256 else n_r


def _check(values, t_obs_day, edge_frac, r_frac, jet_type, injection):
    """(B, device) of the operands, or raise before any launch."""
    if jet_type not in JET_TYPES or injection not in range(4):
        raise ValueError(f"no K4 for jet type {jet_type}, injection form "
                         f"{injection}")
    if len(values) != len(SLOTS):
        raise ValueError(f"{len(values)} parameter values, expected "
                         f"{len(SLOTS)} ({', '.join(SLOTS)})")
    core = values[0]
    if not isinstance(core, torch.Tensor) or core.dim() != 1:
        raise ValueError("thetaCore must be a [B] tensor")
    n_b, dev = core.shape[0], core.device
    named = [("t_obs_day", t_obs_day), ("edge_frac", edge_frac),
             ("r_frac", r_frac)]
    named += [(name, v) for name, v in zip(SLOTS, values)
              if isinstance(v, torch.Tensor)]
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, thetaCore on {dev}")
    for name, t in named[:3]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in zip(SLOTS, values):
        if isinstance(v, torch.Tensor):
            if v.dim() > 1 or (v.dim() == 1 and v.shape[0] not in (1, n_b)):
                raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                                 f"expected (), (1,) or ({n_b},)")
        elif not isinstance(v, float):
            raise TypeError(f"{name} must be a tensor or a float, got "
                            f"{type(v).__name__}")
    if t_obs_day.dim() != 1 and tuple(t_obs_day.shape) != (n_b, 1):
        raise ValueError(f"t_obs_day has shape {tuple(t_obs_day.shape)}, "
                         f"expected (T,) or ({n_b}, 1)")
    if edge_frac.dim() != 1 or edge_frac.shape[0] < 2:
        raise ValueError(f"edge_frac has shape {tuple(edge_frac.shape)}, "
                         "expected (Th + 1,)")
    if r_frac.dim() != 1:
        raise ValueError(f"r_frac has shape {tuple(r_frac.shape)}, "
                         "expected (R,)")
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}; CPU tensors take "
                         "models/grb.py:grb_stage1_plain")
    return n_b, dev


def grb_dynamics(values, t_obs_day, edge_frac, r_frac, *, jet_type, spread,
                 trumpet, injection, wing_from_core, dist_coef):
    """Stage 1 of TrPi2018 by K4, up to K3's operands.

    ``values``: one entry of ``SLOTS`` each (``distance`` is d_L or the
    luminosity distance, scaled by ``dist_coef``: inv_dl26 = dist_coef /
    distance; ``L0`` is read as ``injection`` says, and with
    ``wing_from_core`` thetaWing is 4 thetaCore), ``t_obs_day`` [T] shared
    by the batch or [B, 1] one time a row, ``edge_frac`` [Th + 1] the ring
    edges' fractions of theta_max, ``r_frac`` [R] the radius grid's
    exponents, all f32 on one CUDA device. Returns (t_delay [B, Th, R'],
    log_tracks [B, 5, Th, R'], r_grid [B, R'], scal [B, 8], log_q [T] or
    [B, 1], d_cos [B, Th], inv_dl26 [B]).
    """
    n_b, dev = _check(values, t_obs_day, edge_frac, r_frac, jet_type,
                      injection)
    n_th, n_r = edge_frac.shape[0] - 1, r_frac.shape[0]
    n_t = t_obs_day.shape[0] if t_obs_day.dim() == 1 else 1
    per_row = int(t_obs_day.dim() == 2)
    lib = _kernels.load("grb_dynamics")
    if not lib.nmma_grb_dynamics_supported(n_b, n_th, n_r, n_t, per_row,
                                           jet_type, injection):
        raise ValueError(
            f"K4 is not built for B={n_b}, Th={n_th}, R={n_r}, T={n_t} "
            f"(limits: nmma_grb_dynamics_supported in csrc/grb_dynamics.cu)")
    n_sub = subgrid(n_r)
    f32 = torch.float32
    t_delay = torch.empty((n_b, n_th, n_sub), dtype=f32, device=dev)
    tracks = torch.empty((n_b, N_TRACKS, n_th, n_sub), dtype=f32, device=dev)
    r_grid = torch.empty((n_b, n_sub), dtype=f32, device=dev)
    scal = torch.empty((n_b, N_SCAL), dtype=f32, device=dev)
    log_q = torch.empty((n_b, 1) if per_row else (n_t,), dtype=f32,
                        device=dev)
    d_cos = torch.empty((n_b, n_th), dtype=f32, device=dev)
    inv_dl26 = torch.empty((n_b,), dtype=f32, device=dev)
    outs = (t_delay, tracks, r_grid, scal, d_cos, inv_dl26, log_q)
    if n_b == 0:
        return t_delay, tracks, r_grid, scal, log_q, d_cos, inv_dl26
    n = len(SLOTS)
    cols = (ctypes.c_void_p * n)(*(
        v.data_ptr() if isinstance(v, torch.Tensor) else None
        for v in values))
    strides = (ctypes.c_longlong * n)(*(
        v.stride(0) if isinstance(v, torch.Tensor) and v.dim() == 1
        and v.shape[0] == n_b and n_b > 1 else 0 for v in values))
    vals = (ctypes.c_float * n)(*(
        0.0 if isinstance(v, torch.Tensor) else v for v in values))
    with tracing.span("kernel.k4", batch=t_delay), torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nmma_grb_dynamics(
            cols, strides, vals, t_obs_day.data_ptr(), edge_frac.data_ptr(),
            r_frac.data_ptr(), *(t.data_ptr() for t in outs), n_b, n_th, n_r,
            n_t, per_row, jet_type, int(bool(spread)), int(bool(trumpet)),
            injection, int(bool(wing_from_core)), dist_coef, dev.index,
            stream)
    _kernels.check(lib, code, "grb_dynamics launch")
    tracing.count(tracing.K4_LAUNCHES)
    return t_delay, tracks, r_grid, scal, log_q, d_cos, inv_dl26
