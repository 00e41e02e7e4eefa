"""K2, the Me2017 shell dynamics: CUDA kernel and plain version.

Replaces ``me2017_dynamics_pallas`` (``nmma_tpu/ops/pallas_me2017.py:100``,
kernel ``_me2017_dynamics_kernel`` :35). For each live point, 299 ejecta
mass shells are Euler-stepped through the T-1 intervals of the time grid;
each step emits the total luminosity ``ltot40`` (L / 1e40 erg/s) and the
photospheric radius ``r_photo`` = ``vm * t`` of the shell whose optical depth
is nearest 1 (first shell on a tie). The last time index is 0, as in the
reference (nmma/em/lightcurve_generation.py:566-652 fills 0..T-2).

The per-(live point, shell) quantities and the per-step scalars are computed
once here with PyTorch ops shared by both versions, so the kernel
(``csrc/me2017_dynamics.cu``) and the plain loop read identical values; the
kernel evaluates kappa, tau and |tau - 1| with the plain version's operation
order and rounding, so both pick the same photosphere shell wherever the
data allow it. Shells whose |tau - 1| lie within float rounding of each other
can still be picked differently by two correct implementations:
:func:`compare_dynamics` is the rule that every comparison of K2 uses.

CUDA tensors go to the kernel and CPU tensors to the plain version; there is
no fallback from one to the other.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels, tracing
from ..constants import LN10, c_cgs, msun_cgs, seconds_a_day

N_SHELLS = 299          # mass shells stepped (the reference's 300-point grid)
_MPREC = N_SHELLS + 1
_L_SCALE = 1e40         # luminosities carried as L / 1e40
# |tau - 1| gaps below this make a (live point, time) a near-tie
NEAR_TIE = 1e-5


def _thermalisation_efficiency(t_day, ca=0.56, cb=0.17, cd=0.74):
    """Barnes+16 eq. 34 fit (reference :423-428)."""
    timescale_factor = 2.0 * cb * t_day ** cd
    eff = torch.exp(-ca * t_day) + torch.log1p(timescale_factor) \
        / timescale_factor
    return 0.36 * eff


def me2017_operands(log10_mej, log10_vej, beta, kappa_r, t_days):
    """The kernel's operands, shared by both versions.

    Returns ``(shells [6, B, S], per_sample [2, B], per_step [7, T])``:
    shells = (m/vm, m/vm^2, vm, xn0, 1 - xn0, dm Msun/1e40) with S = 299,
    per_sample = (kappa_r, 0.24 Msun / c / beta), and per_step = (t, dt,
    exp(-t/900), 2.1e10 eth t^-1.3, Msun/(4 pi) / t^2, t / c, dt / t), the
    last column of dt and dt/t being 0. The shell grid follows the Pallas
    kernel's (geometric masses from 1e-8 Msun to mej, v = v0 (m/mej)^(-1/beta)
    capped at c).
    """
    dev = log10_mej.device
    f32 = torch.float32
    log10_mej = log10_mej.to(f32)[:, None]
    log10_vej = log10_vej.to(f32)[:, None]
    beta = beta.to(f32)[:, None]
    kappa_r = kappa_r.to(f32)
    t_days = t_days.to(f32)

    lane = torch.arange(N_SHELLS, dtype=f32, device=dev)
    frac = lane / (_MPREC - 1)
    log_m = -8.0 + (log10_mej + 8.0) * frac                      # [B, S]
    m = torch.exp(LN10 * log_m)
    v0 = torch.exp(LN10 * log10_vej) * c_cgs
    vm = v0 * torch.exp((-1.0 / beta) * LN10 * (log_m - log10_mej))
    vm = torch.clamp(vm, max=c_cgs)
    xn0 = (0.8 * 2.0 / math.pi) * torch.atan(1e-8 / m)
    g_ratio = torch.exp(LN10 * (log10_mej + 8.0) / (_MPREC - 1))
    dm = m * (g_ratio - 1.0)
    shells = torch.stack([m / vm, m / (vm * vm), vm, xn0, 1.0 - xn0,
                          dm * (msun_cgs / _L_SCALE)])
    per_sample = torch.stack([kappa_r, (0.24 * msun_cgs / c_cgs) / beta[:, 0]])

    t = t_days * seconds_a_day
    dt = torch.cat([t[1:] - t[:-1], torch.zeros_like(t[:1])])
    eth = _thermalisation_efficiency(t_days)
    per_step = torch.stack([
        t, dt, torch.exp(-t / 900.0), 2.1e10 * eth * t_days ** (-1.3),
        (msun_cgs / (4.0 * math.pi)) / (t * t), t * (1.0 / c_cgs), dt / t])
    return shells.contiguous(), per_sample.contiguous(), per_step.contiguous()


def me2017_dynamics_plain(shells, per_sample, per_step, with_ties=False):
    """The kernel's function as a Python loop over the T-1 steps on
    [B, 299] tensors, in the kernel's operation order.

    Returns ``(ltot40 [B, T], r_photo [B, T])``; with ``with_ties`` also
    ``gap [B, T]``, the difference of the two smallest |tau - 1| (+inf at
    the last time), and ``r_cand [B, T, 2]``, ``vm t`` of those two shells.
    """
    mvm, mvm2, vm, xn0, xr, dm_eff = shells
    kappa_r, c_tdiff = per_sample[0][:, None], per_sample[1][:, None]
    n_b, n_t = mvm.shape[0], per_step.shape[1]
    ltot = torch.zeros((n_b, n_t), dtype=mvm.dtype, device=mvm.device)
    r_photo = torch.zeros_like(ltot)
    if with_ties:
        gap = torch.full_like(ltot, math.inf)
        r_cand = torch.zeros((n_b, n_t, 2), dtype=mvm.dtype,
                             device=mvm.device)
    ene = torch.zeros_like(mvm)
    for j in range(n_t - 1):
        t_j, dt_j, exp_j, edotr_j, tauc_j, toc_j, dtt_j = per_step[:, j]
        xn = xn0 * exp_j
        edot = 3.2e14 * xn + edotr_j
        kappa = 0.4 * (1.0 - xn - xr) + kappa_r * xr
        tdiff = (c_tdiff / t_j) * kappa * mvm
        denom = tdiff + toc_j * vm
        lum = ene / denom
        ltot[:, j] = (lum * dm_eff).sum(dim=1)
        tau = tauc_j * kappa * mvm2
        dev = (tau - 1.0).abs()
        dev_min = dev.amin(dim=1, keepdim=True)
        # first match on a tie: vm does not increase with the shell index,
        # so the largest vm among the minimal shells is the first one's
        r_photo[:, j] = torch.where(dev <= dev_min, vm, 0.0).amax(dim=1) * t_j
        if with_ties:
            best2 = dev.topk(2, dim=1, largest=False)
            gap[:, j] = best2.values[:, 1] - best2.values[:, 0]
            r_cand[:, j] = vm.gather(1, best2.indices) * t_j
        factor = torch.clamp(1.0 - dtt_j - dt_j / denom, 0.0, 1.0)
        ene = factor * ene + dt_j * edot
    if with_ties:
        return ltot, r_photo, gap, r_cand
    return ltot, r_photo


def tied_operands(shells, stride):
    """``shells`` with exact photosphere ties: shell s + ``stride`` takes
    the m/vm^2, xn0 and xr of shell s wherever s // stride is even, so the
    two have equal tau at every step while s keeps the larger vm. With
    stride 1 the pair sits in two neighbouring lanes of the kernel's layout
    (shell s in lane s % 32, slot s // 32), with stride 32 in one lane and
    two neighbouring slots."""
    out = shells.clone()
    src = torch.arange(N_SHELLS - stride, device=shells.device)
    src = src[(src // stride) % 2 == 0]
    for row in (1, 3, 4):                  # m/vm^2, xn0, xr
        out[row, :, src + stride] = shells[row, :, src]
    return out


def _check_operands(shells, per_sample, per_step):
    for name, t in (("shells", shells), ("per_sample", per_sample),
                    ("per_step", per_step)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != shells.device:
            raise ValueError(f"{name} is on {t.device}, shells on "
                             f"{shells.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if shells.dim() != 3 or shells.shape[0] != 6 \
            or shells.shape[2] != N_SHELLS:
        raise ValueError(f"shells has shape {tuple(shells.shape)}, expected "
                         f"(6, B, {N_SHELLS})")
    n_b = shells.shape[1]
    if tuple(per_sample.shape) != (2, n_b):
        raise ValueError(f"per_sample has shape {tuple(per_sample.shape)}, "
                         f"expected (2, {n_b})")
    if per_step.dim() != 2 or per_step.shape[0] != 7 or per_step.shape[1] < 2:
        raise ValueError(f"per_step has shape {tuple(per_step.shape)}, "
                         "expected (7, T) with T >= 2")


def me2017_dynamics_from_operands(shells, per_sample, per_step):
    """``(ltot40 [B, T], r_photo [B, T])`` from :func:`me2017_operands`:
    the CUDA kernel for CUDA tensors, the plain loop for CPU tensors."""
    _check_operands(shells, per_sample, per_step)
    if shells.device.type == "cpu":
        return me2017_dynamics_plain(shells, per_sample, per_step)
    if shells.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {shells.device}")
    n_b, n_t = shells.shape[1], per_step.shape[1]
    ltot = torch.empty((n_b, n_t), dtype=torch.float32, device=shells.device)
    r_photo = torch.empty_like(ltot)
    if n_b == 0:
        return ltot, r_photo
    lib = _kernels.load("me2017_dynamics")
    with tracing.span("kernel.k2", batch=ltot), \
            torch.cuda.device(shells.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nmma_me2017_dynamics(
            shells.data_ptr(), per_sample.data_ptr(), per_step.data_ptr(),
            ltot.data_ptr(), r_photo.data_ptr(), n_b, N_SHELLS, n_t,
            shells.device.index, stream)
    _kernels.check(lib, code, "me2017_dynamics launch")
    tracing.count(tracing.K2_LAUNCHES)
    return ltot, r_photo


def me2017_dynamics(log10_mej, log10_vej, beta, kappa_r, t_days):
    """Batched Me2017 dynamics: parameters [B] (kappa_r linear, not log10)
    and the source-frame grid t_days [T] -> (ltot40 [B, T], r_photo [B, T])
    in f32, the signature of ``me2017_dynamics_pallas``."""
    return me2017_dynamics_from_operands(
        *me2017_operands(log10_mej, log10_vej, beta, kappa_r, t_days))


def compare_dynamics(ltot, r_photo, ltot_ref, r_ref, gap_ref, r_cand_ref,
                     ltot_rtol=2e-3, ltot_floor=1e-4, r_rtol=1e-4):
    """Hold (ltot, r_photo) against a reference under the near-tie rule.

    A (live point, time) is a near-tie when the reference's two smallest
    |tau - 1| lie within ``NEAR_TIE`` of each other (``gap_ref``). There
    ``r_photo`` must match ``vm t`` of one of those two shells
    (``r_cand_ref`` [B, T, 2]) within ``r_rtol``; elsewhere it must match
    ``r_ref`` within ``r_rtol``. ``ltot`` must match within ``ltot_rtol``
    where ``ltot_ref > ltot_floor`` (the tolerances of the JAX package's
    kernel test, tests/test_pallas_kernel.py:28-32).

    Returns a dict: ``ok``, the max relative errors, ``points``,
    ``near_ties``, ``tie_samples`` (live points with any near-tie), and
    ``mismatches`` (points outside the rule).
    """
    def rel(a, b):          # relative error; where b == 0, a must be 0
        return torch.where(b != 0, (a - b).abs() / b.abs().clamp(min=1e-30),
                           (a != b).to(a.dtype))

    sel = ltot_ref > ltot_floor
    ltot_err = rel(ltot, ltot_ref)
    tie = gap_ref < NEAR_TIE
    r_err = rel(r_photo, r_ref)
    cand_err = rel(r_photo[..., None], r_cand_ref).amin(dim=-1)
    bad = torch.where(tie, cand_err > r_rtol, r_err > r_rtol)
    bad |= sel & (ltot_err > ltot_rtol)
    bad |= ~torch.isfinite(ltot) | ~torch.isfinite(r_photo)
    out = {
        "ltot_max_rel": float(ltot_err[sel].max()) if sel.any() else 0.0,
        "r_max_rel_non_tie": float(r_err[~tie].max()) if (~tie).any()
        else 0.0,
        "points": int(tie.numel()),
        "near_ties": int(tie.sum()),
        "tie_samples": int(tie.any(dim=1).sum()),
        "mismatches": int(bad.sum()),
    }
    out["ok"] = out["mismatches"] == 0 \
        and out["near_ties"] <= 0.01 * out["points"]
    return out
