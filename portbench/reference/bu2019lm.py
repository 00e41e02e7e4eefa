"""Plain reference of Bu2019lm, the production SVD surrogate of the
Bulla (2019) kilonova grid.

Reads the raw surrogate file (``.npz``: per-filter MLP weights, SVD basis,
min-max scales, training times and parameter bounds) itself and evaluates,
per filter, ``relu(x W1 + b1) W2 + b2`` in three einsums, the SVD basis
scaled back to magnitudes and interpolated (float64, on the host) onto the
model grid, and inf outside the trained time range. The matrix products run
in the working ``dtype`` with TF32 as the caller leaves it.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import em


def _operator(tt, va, mins, maxs, t_days):
    """(va_q [F, C, Q], off_q [F, Q], inside [Q]) in float64: the basis
    times the scale, interpolated linearly from the training times onto
    ``t_days``, zero outside the training range."""
    n = len(tt)
    pos = np.clip(np.searchsorted(tt, t_days, side="right") - 1, 0, n - 2)
    frac = (t_days - tt[pos]) / (tt[pos + 1] - tt[pos])
    wi = np.zeros((n, len(t_days)))
    np.add.at(wi, (pos, np.arange(len(t_days))), 1.0 - frac)
    np.add.at(wi, (pos + 1, np.arange(len(t_days))), frac)
    inside = (t_days >= tt[0]) & (t_days <= tt[-1])
    wi[:, ~inside] = 0.0
    scaled = va * (maxs - mins)[:, :, None]
    return np.einsum("ftc,tq->fcq", scaled, wi), mins @ wi, inside


class Reference:
    """logL of unit-cube rows for the bu2019lm configuration."""

    def __init__(self, cfg, dtype=torch.float32, device="cpu", root="."):
        self.photometry = ph = em.Photometry(cfg, dtype, device)
        with np.load(os.path.join(root, cfg["surrogate"]["file"])) as z:
            arr = {k: z[k] for k in z.files}
        self.names = [str(p) for p in arr["parameter_names"]]
        src = [str(f) for f in arr["filters"]]
        rows = [src.index(f) for f in ph.filters]

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)[rows],
                                   dtype=dtype, device=device)

        self.w1, self.b1 = dev(arr["w1"]), dev(arr["b1"])
        self.w2, self.b2 = dev(arr["w2"]), dev(arr["b2"])
        va_q, off_q, inside = _operator(
            np.asarray(arr["tt"], dtype=np.float64),
            np.asarray(arr["va"], dtype=np.float64),
            np.asarray(arr["mins"], dtype=np.float64),
            np.asarray(arr["maxs"], dtype=np.float64),
            ph.sample_times.double().cpu().numpy())
        self.va_q, self.off_q = dev(va_q), dev(off_q)
        self.inside = torch.as_tensor(inside, device=device)
        lo = np.asarray(arr["param_mins"], dtype=np.float32)
        hi = np.asarray(arr["param_maxs"], dtype=np.float32)
        span = np.where(hi > lo, hi - lo, np.float32(1.0))
        self.p_lo = torch.as_tensor(lo, dtype=dtype, device=device)
        self.p_span = torch.as_tensor(span, dtype=dtype, device=device)

    def mags(self, p, t_days, nu_host):
        x = (torch.stack([p[n] for n in self.names], dim=1) - self.p_lo) \
            / self.p_span
        hid = torch.relu(torch.einsum("bp,fph->fbh", x, self.w1)
                         + self.b1[:, None, :])
        c = torch.einsum("fbh,fhc->fbc", hid, self.w2) + self.b2[:, None, :]
        m = torch.einsum("fbc,fcq->bfq", c, self.va_q) + self.off_q[None]
        return torch.where(self.inside, m, math.inf)

    def detector(self, p):
        return self.photometry.detector(p, self.mags)

    def log_likelihood(self, u, block=8192):
        ph = self.photometry
        out = []
        for s in range(0, u.shape[0], block):
            p = ph.parameters(u[s:s + block])
            out.append(ph.log_likelihood(ph.at_epochs(*self.detector(p))))
        return torch.cat(out)
