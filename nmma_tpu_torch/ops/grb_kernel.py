"""K3, the GRB equal-arrival-time-surface (EATS) stage: CUDA kernel and plain
version.

Replaces ``eats_flux_pallas`` (``nmma_tpu/ops/pallas_grb.py:178``, kernel
``_eats_kernel`` :47). For each live point and theta ring, the ring's five
log dynamical tracks (Lorentz factor, nu_m', nu_c', emission, ring angle),
tabulated on R radii, are resampled onto the observer times of every phi
element of the equal-arrival-time surface by a hat basis in log time; the
Doppler factor and the SPN98 synchrotron spectrum then give the element's
flux at each frequency, summed over phi with the quadrature weights. The
semantics are those of ``_eats_stage2_xla`` in its "fused" mode
(``nmma_tpu/models/grb.py:510-647``): an f32 hat normalised by
``max(hat_sum, 1)``, and no emission where ``log_q`` lies outside
``[log_t[0], log_t[-1]]`` (``grb.py:606``).

The plain version repeats that function batch-first, in chunks of
(live point, ring) rows so that its dense [rows, Ph, T, R] hat stays under
about 1 GB. The CUDA kernel (``csrc/grb_eats.cu``) builds the arrival-time
map and its cummax in shared memory, and for each query finds by a binary
search of the monotone log-time row the two nodes whose hats can be nonzero
(``log_time_rows`` and ``hat_basis`` below are the map and the dense hat;
the tests hold the two-node sums to the dense ones).

``log_q`` is either shared by the batch, [T], or one query a row, [B, 1]
(the TrPi2018 energy ramp, whose observer-time nodes are rows of their own).

CUDA tensors go to the kernel and CPU tensors to the plain version; there is
no fallback from one to the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from ..constants import c_cgs

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

N_TRACKS = 5
N_SCAL = 8
# elements of the plain version's dense hat per chunk: 2^26 f32 = 256 MB,
# about 1 GB with the temporaries that live beside it
_HAT_ELEMENTS = 1 << 26


def one_minus_mu(theta_v, sin_tv, th, cphi):
    """1 - mu without cancellation near mu = 1:
    2 sin^2((theta_v - th)/2) + sin(theta_v) sin(th) (1 - cos(phi))."""
    return (2.0 * torch.sin(0.5 * (theta_v - th)) ** 2
            + sin_tv * torch.sin(th) * (1.0 - cphi))


def synchrotron_shape(nu, nu_m, nu_c, p):
    """Broken power-law synchrotron spectrum (SPN98), slow + fast cooling
    (``_synchrotron_shape``, nmma_tpu/models/grb.py:694)."""
    slow = torch.where(
        nu < nu_m,
        torch.pow(nu / nu_m, 1.0 / 3.0),
        torch.where(nu < nu_c,
                    torch.pow(nu / nu_m, -(p - 1.0) / 2.0),
                    torch.pow(nu_c / nu_m, -(p - 1.0) / 2.0)
                    * torch.pow(nu / nu_c, -p / 2.0)))
    fast = torch.where(
        nu < nu_c,
        torch.pow(nu / nu_c, 1.0 / 3.0),
        torch.where(nu < nu_m,
                    torch.pow(nu / nu_c, -0.5),
                    torch.pow(nu_m / nu_c, -0.5)
                    * torch.pow(nu / nu_m, -p / 2.0)))
    return torch.where(nu_m <= nu_c, slow, fast)


def log_time_rows(t_delay, tracks, r_grid, scal, cphi):
    """The log arrival-time map of N (live point, ring) rows, its cummax
    along R and the cap at 60: t_delay [N, R], tracks [N, 5, R],
    r_grid [N, R], scal [N, 8] -> [N, Ph, R], non-decreasing along R."""
    col = scal[:, :, None, None]                            # [N, 8, 1, 1]
    z, sin_tv, theta_v = col[:, 0], col[:, 2], col[:, 4]
    # arrival times follow the (possibly moving) ring material
    th_r = torch.exp(tracks[:, 4])[:, None, :]              # [N, 1, R]
    t_obs = (1.0 + z) * (t_delay[:, None, :] + one_minus_mu(
        theta_v, sin_tv, th_r, cphi[None, :, None])
        * r_grid[:, None, :] / c_cgs)
    log_t = torch.log(torch.clamp(t_obs, min=1e-10))
    return torch.clamp(torch.cummax(log_t, dim=-1).values, max=60.0)


def _queries(log_q):
    """log_q [T] (shared) or [N, T] (per row) as [N or 1, 1, T]."""
    return log_q[None, None, :] if log_q.dim() == 1 else log_q[:, None, :]


def hat_basis(log_t, log_q):
    """The dense hat of every query on every node: log_t [N, Ph, R],
    log_q [T] or [N, T] -> [N, Ph, T, R]. Neighbours are clamped at the
    row's ends and widths at 1e-12, so a node takes no weight from a flat
    side."""
    x_l = torch.cat([log_t[..., :1], log_t[..., :-1]], dim=-1)
    x_r = torch.cat([log_t[..., 1:], log_t[..., -1:]], dim=-1)
    dl = torch.clamp(log_t - x_l, min=1e-12)[:, :, None, :]
    dr = torch.clamp(x_r - log_t, min=1e-12)[:, :, None, :]
    lq = _queries(log_q)[..., None]                         # [., 1, T, 1]
    up = (lq - x_l[:, :, None, :]) / dl                     # [N, Ph, T, R]
    dn = (x_r[:, :, None, :] - lq) / dr
    return torch.clamp(torch.minimum(up, dn), 0.0, 1.0)


def _eats_rows(t_delay, tracks, r_grid, scal, log_q, cphi, wphi, nu_obs):
    """The EATS stage for N independent (live point, ring) rows:
    t_delay [N, R], tracks [N, 5, R], r_grid [N, R], scal [N, 8],
    log_q [T] or [N, T], nu_obs [N, F] -> phi-summed flux [N, F, T]."""
    n, n_r = t_delay.shape
    n_t, n_phi = log_q.shape[-1], cphi.shape[0]
    col = scal[:, :, None, None]                            # [N, 8, 1, 1]
    z, sin_tv, p, theta_v = col[:, 0], col[:, 2], col[:, 3], col[:, 4]
    one_p_z = 1.0 + z                                       # [N, 1, 1]
    cphi_r = cphi[None, :, None]                            # [1, Ph, 1]

    log_t = log_time_rows(t_delay, tracks, r_grid, scal, cphi)
    hat = hat_basis(log_t, log_q)                           # [N, Ph, T, R]
    # the five tracks and a ones lane (the hat row sum), contracted over R
    tr1 = torch.cat([tracks, torch.ones_like(tracks[:, :1])], dim=1)
    raw = torch.bmm(hat.reshape(n, n_phi * n_t, n_r),
                    tr1.transpose(1, 2)).reshape(n, n_phi, n_t, N_TRACKS + 1)
    del hat
    denom = torch.clamp(raw[..., N_TRACKS], min=1.0)
    vals = torch.exp(raw[..., :N_TRACKS] / denom[..., None])
    g, num, nuc, em50, th_t = vals.unbind(-1)               # [N, Ph, T] each
    lq = _queries(log_q)
    in_range = (lq >= log_t[..., :1]) & (lq <= log_t[..., -1:])
    em50 = torch.where(in_range, em50, 0.0)

    # Doppler pattern follows the resampled (moving) ring angle
    omm = one_minus_mu(theta_v, sin_tv, th_t, cphi_r)
    u2 = torch.clamp(g * g - 1.0, min=1e-12)
    be = torch.sqrt(u2) / g
    one_m_be = 1.0 / (g * g * (1.0 + be))   # 1 - beta, without cancellation
    a_fac = one_m_be + be * omm                              # 1 - beta mu
    doppler = 1.0 / (g * a_fac)
    s_sh = torch.sqrt(1.0 + 1.0 / u2)
    one_m_bs = (3.0 - 4.0 / (s_sh + 1.0)) / (4.0 * u2 + 3.0)
    ashock = one_m_bs + (1.0 - one_m_bs) * omm               # 1 - beta_sh mu
    nu_prime = (nu_obs[:, None, :, None] * one_p_z[..., None]
                * (g * a_fac)[:, :, None, :])                # [N, Ph, F, T]
    shape = synchrotron_shape(nu_prime, num[:, :, None, :],
                              nuc[:, :, None, :], p[..., None])
    flux = (one_p_z[..., None] * (doppler * doppler / ashock)[:, :, None, :]
            * em50[:, :, None, :] * shape)
    return (wphi[None, :, None, None] * flux).sum(dim=1)     # [N, F, T]


def eats_flux_plain(t_delay, log_tracks, r_grid, scal, log_q, cphi, wphi,
                    nu_obs):
    """The kernel's function in PyTorch, in chunks of (live point, ring)
    rows; the operands of :func:`eats_flux` -> [B, Th, F, T]."""
    n_b, n_th, n_r = t_delay.shape
    n_t, n_phi, n_f = log_q.shape[-1], cphi.shape[0], nu_obs.shape[1]
    rows = n_b * n_th
    td = t_delay.reshape(rows, n_r)
    tracks = log_tracks.transpose(1, 2).reshape(rows, N_TRACKS, n_r)
    point = torch.arange(n_b, device=t_delay.device).repeat_interleave(n_th)
    out = t_delay.new_empty((rows, n_f, n_t))
    chunk = max(1, _HAT_ELEMENTS // (n_phi * n_t * n_r))
    for s in range(0, rows, chunk):
        e = min(rows, s + chunk)
        idx = point[s:e]
        out[s:e] = _eats_rows(td[s:e], tracks[s:e], r_grid[idx], scal[idx],
                              log_q if log_q.dim() == 1 else log_q[idx],
                              cphi, wphi, nu_obs[idx])
    return out.reshape(n_b, n_th, n_f, n_t)


def edge_operands(n_b, n_th, n_r, n_t, n_phi, n_f, seed=0, device="cpu"):
    """K3 operands made by hand from a seed, to reach the hat's edge cases.

    z = 0 and r_grid = 0, so every implementation's map is
    ``log_t = min(cummax log max(t_delay, 1e-10), 60)``; where a case needs
    an exact log time, t_delay is 1.0 (log exactly 0), below 1e-10 (the
    floor) or +inf (the cap, exactly 60). log_q holds 0.0 and 60.0, -25 and
    65 (below and above every row), and n_t - 4 values drawn between them,
    sorted (n_t >= 4).
    Between those values a row is a random walk in log t whose dips make
    cummax plateaus. The (live point, ring) rows cycle through four kinds:

    0. t_delay[0] = 1: a query at log_t[0]; a tail of +inf with a finite
       value after it: a plateau at the cap, a query at log_t[-1];
    1. a head below 1 and 1.0 at the middle node, then a dip: a query on a
       plateau at 0; the row ends below 60, so query 60 lies above it;
    2. t_delay[0] = 5: query 0 lies below the row; a tail of +inf;
    3. a flat head below 1e-10, then 1.0: a query exactly on a node.

    Returns the eight operands of :func:`eats_flux`, f32, on ``device``.
    """
    rng = np.random.default_rng(seed)
    rows = n_b * n_th
    walk = np.cumsum(rng.normal(1.0, 2.0, (rows, n_r)), axis=1)
    t = np.exp(np.clip(-3.0 + walk * (45.0 / n_r), -20.0, 55.0))
    kind = np.arange(rows) % 4
    mid, tail, dip = n_r // 2, max(1, n_r // 8), max(1, n_r // 10)
    head = n_r // 4 + 1
    k = kind == 0
    t[k, 0] = 1.0
    t[k, n_r - tail:] = np.inf
    if n_r >= 4:
        t[k, n_r - 2] = 2.0
    k = kind == 1
    t[k, :mid] = np.minimum(t[k, :mid], 0.9)
    t[k, mid] = 1.0
    t[k, mid + 1:mid + 1 + dip] = 0.5
    k = kind == 2
    t[k, 0] = 5.0
    t[k, n_r - tail:] = np.inf
    k = kind == 3
    t[k, :head] = np.where(np.arange(head) % 2 == 0, 0.0, 1e-12)
    if head < n_r:
        t[k, head] = 1.0
    log_q = np.sort(np.concatenate(
        [[-25.0, 0.0, 60.0, 65.0], rng.uniform(-25.0, 65.0, n_t - 4)]))
    tracks = np.stack([
        rng.uniform(0.0, 5.0, (n_b, n_th, n_r)),        # log gamma
        rng.uniform(18.0, 28.0, (n_b, n_th, n_r)),      # log nu_m'
        rng.uniform(22.0, 34.0, (n_b, n_th, n_r)),      # log nu_c'
        rng.uniform(-5.0, 5.0, (n_b, n_th, n_r)),       # log em
        np.log(rng.uniform(0.02, 0.5, (n_b, n_th, n_r))),   # log theta
    ], axis=1)
    theta_v = rng.uniform(0.0, 0.5, n_b)
    zeros = np.zeros(n_b)
    scal = np.stack([zeros, np.cos(theta_v), np.sin(theta_v),
                     rng.uniform(2.1, 2.8, n_b), theta_v, zeros, zeros,
                     zeros], axis=1)
    x_gl, w_gl = np.polynomial.legendre.leggauss(n_phi)
    arrays = (t.reshape(n_b, n_th, n_r), tracks, np.zeros((n_b, n_r)), scal,
              log_q, np.cos((x_gl + 1.0) * (math.pi / 2.0)),
              w_gl * (n_phi / 2.0), 10.0 ** rng.uniform(9.0, 15.0, (n_b, n_f)))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def _check_operands(t_delay, log_tracks, r_grid, scal, log_q, cphi, wphi,
                    nu_obs):
    named = (("t_delay", t_delay), ("log_tracks", log_tracks),
             ("r_grid", r_grid), ("scal", scal), ("log_q", log_q),
             ("cphi", cphi), ("wphi", wphi), ("nu_obs", nu_obs))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != t_delay.device:
            raise ValueError(f"{name} is on {t.device}, t_delay on "
                             f"{t_delay.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t_delay.dim() != 3:
        raise ValueError(f"t_delay has shape {tuple(t_delay.shape)}, "
                         "expected (B, Th, R)")
    n_b, n_th, n_r = t_delay.shape
    n_phi = cphi.shape[0]
    n_f = nu_obs.shape[-1] if nu_obs.dim() == 2 else -1
    # shared queries [T], or one a row [B, 1]
    q_shape = (log_q.shape[0],) if log_q.dim() == 1 else (n_b, 1)
    expected = {"log_tracks": (n_b, N_TRACKS, n_th, n_r), "r_grid": (n_b, n_r),
                "scal": (n_b, N_SCAL), "log_q": q_shape, "cphi": (n_phi,),
                "wphi": (n_phi,), "nu_obs": (n_b, n_f)}
    for name, t in named[1:]:
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{expected[name]}")


def eats_flux(t_delay, log_tracks, r_grid, scal, log_q, cphi, wphi, nu_obs):
    """Batched [B, Th, F, T] phi-summed EATS flux elements: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    t_delay [B, Th, R], log_tracks [B, 5, Th, R], r_grid [B, R],
    scal [B, 8] (z, cos theta_v, sin theta_v, p, theta_v, 0, 0, 0),
    log_q [T] shared by the batch or [B, 1] one query a row,
    cphi/wphi [Ph] (phi nodes' cosines and weights) and nu_obs [B, F]
    (observer-frame frequencies of each live point), all f32. The signature
    of ``eats_flux_pallas`` with a per-sample ``nu_obs``; ``jax.vmap`` of
    that function over a per-row time gives it the per-row queries.
    """
    global LAUNCHES
    ops = (t_delay, log_tracks, r_grid, scal, log_q, cphi, wphi, nu_obs)
    _check_operands(*ops)
    if t_delay.device.type == "cpu":
        return eats_flux_plain(*ops)
    if t_delay.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {t_delay.device}")
    n_b, n_th, n_r = t_delay.shape
    n_t, n_phi, n_f = log_q.shape[-1], cphi.shape[0], nu_obs.shape[1]
    q_stride = 0 if log_q.dim() == 1 else 1
    lib = _kernels.load("grb_eats")
    if not lib.nmma_grb_eats_supported(n_b, n_th, n_r, n_t, n_phi, n_f,
                                       q_stride):
        raise ValueError(
            f"K3 is not built for B={n_b}, Th={n_th}, R={n_r}, T={n_t}, "
            f"Ph={n_phi}, F={n_f}, log_q {tuple(log_q.shape)} (limits: "
            "nmma_grb_eats_supported in csrc/grb_eats.cu)")
    out = torch.empty((n_b, n_th, n_f, n_t), dtype=torch.float32,
                      device=t_delay.device)
    if n_b == 0:
        return out
    with torch.cuda.device(t_delay.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nmma_grb_eats(
            *(t.data_ptr() for t in ops), out.data_ptr(), n_b, n_th, n_r,
            n_t, n_phi, n_f, q_stride, t_delay.device.index, stream)
    _kernels.check(lib, code, "grb_eats launch")
    LAUNCHES += 1
    return out
