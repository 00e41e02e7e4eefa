"""The numbers that decide ``correct``.

* ``logl_gap``: the widest gap, over the compared rows where both sides
  are finite, between the program's logL and the reference's, as a share
  of max(1, |reference|). The rows are whole calls drawn from the seed
  among every call of the window, and dead points drawn from the seed
  among every run's dead points (their stored logL against the reference
  on their stored unit-cube rows).
* ``sentinel_flips``: compared rows on which exactly one side is the
  -1e30 sentinel.
* ``logw_gap``: the widest gap between a dead point's weight as the
  sampler gave it and its weight worked out again in float64 from its logL
  and the volume decrements 1/(nlive - j), as a share of max(1, |weight|),
  over the dead points that are not the sentinel.
* ``logz_gap``: |logZ of the sampler - logZ worked out again| in nats.
* ``order_breaks``: places where the logL of the dead points, followed by
  the final live points, falls: every replacement lies above the
  threshold it was drawn under, so the sequence never falls (exact).
* ``rank_disagreement`` (several ranks): the largest difference of logZ,
  iterations and dead logL sums between rank 0 and another (exact).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SENTINEL_BELOW = -9.9e29


def logl_numbers(prog, ref):
    """(logl_gap, sentinel_flips) of the program's logL against the
    reference's on the same rows (1-D tensors or arrays)."""
    prog = torch.as_tensor(prog, dtype=torch.float64).cpu()
    ref = torch.as_tensor(ref, dtype=torch.float64).cpu()
    p_sent, r_sent = prog <= SENTINEL_BELOW, ref <= SENTINEL_BELOW
    both = ~p_sent & ~r_sent & torch.isfinite(prog) & torch.isfinite(ref)
    flips = int((p_sent ^ r_sent).sum()) + int(
        (~torch.isfinite(prog) | ~torch.isfinite(ref)).sum())
    if not bool(both.any()):
        return 0.0, flips
    gap = ((prog - ref).abs() / torch.clamp(ref.abs(), min=1.0))[both]
    return float(gap.max()), flips


def dead_weights(dead_logl, nlive, n_delete, dtype):
    """(logw of the dead points, ln X after the last) worked out in
    ``dtype`` from their logL, iteration after iteration."""
    logl = torch.as_tensor(np.asarray(dead_logl, dtype=np.float64))
    n_it = logl.shape[0] // n_delete
    decr = 1.0 / (nlive - torch.arange(n_delete, dtype=torch.float64))
    step = decr.sum()
    log_x_prev = -(torch.arange(n_it, dtype=torch.float64)[:, None] * step
                   + torch.cat([torch.zeros(1, dtype=torch.float64),
                                torch.cumsum(decr, 0)[:-1]])[None, :])
    log_dvol = log_x_prev.to(dtype) + torch.log(
        -torch.expm1(-decr.to(dtype)))[None, :]
    logw = logl.reshape(n_it, n_delete).to(dtype) + log_dvol
    return logw.reshape(-1), -(n_it * step).to(dtype)


def bookkeeping_numbers(result, nlive, n_delete, against=None):
    """(logw_gap, logz_gap, order_breaks) of one sampler result. With
    ``against`` (a dtype) the weights worked out in ``dtype`` stand in for
    the sampler's: the reading of the control."""
    logl = np.asarray(result.logl, dtype=np.float64)
    n_dead = result.niter * n_delete
    ref_w, ref_x = dead_weights(logl[:n_dead], nlive, n_delete,
                                torch.float64)
    if against is None:
        got_w = torch.as_tensor(np.asarray(result.logw[:n_dead],
                                           dtype=np.float64))
        got_z = float(result.logz)
    else:
        w, x = dead_weights(logl[:n_dead], nlive, n_delete, against)
        live = torch.as_tensor(logl[n_dead:]).to(against) + x \
            - math.log(nlive)
        got_w = w.double()
        got_z = float(torch.logsumexp(torch.cat([w, live]).double(), 0))
    live_w = torch.as_tensor(logl[n_dead:]) + ref_x - math.log(nlive)
    ref_z = float(torch.logsumexp(torch.cat([ref_w, live_w]), 0))
    real = torch.as_tensor(logl[:n_dead]) > SENTINEL_BELOW
    if bool(real.any()):
        gap = ((got_w - ref_w).abs() / torch.clamp(ref_w.abs(), min=1.0))
        logw_gap = float(gap[real].max())
    else:
        logw_gap = 0.0
    breaks = int((np.diff(logl) < 0).sum())
    return logw_gap, abs(got_z - ref_z), breaks


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}). Where the configuration sets
    no limit on ``sentinel_flips`` (its control moves no sentinel), a flip
    makes ``logl_gap`` infinite: a row whose logL is the sentinel on one
    side only is as wrong as a row can be. Any other number without a limit
    is an error in the configuration."""
    numbers = dict(numbers)
    if "sentinel_flips" not in limits and numbers.pop("sentinel_flips", 0):
        numbers["logl_gap"] = math.inf
    checks = {}
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the configuration")
        checks[name] = {"value": value, "limit": limits[name]}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
