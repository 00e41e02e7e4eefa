"""Speed-of-sound (CSE) high-density EOS extension.

PyTorch counterpart of ``nmma_tpu/eos/cse.py`` (the reference's
``EOS_with_CSE``, ``nmma/eos/eos_gen.py:68-262``): a low-density (n, p, e)
table is extended from ``n_connect`` to ``n_lim`` along a piecewise-linear
speed-of-sound curve cs2(n), integrating

    dlog p / dlog n = cs2(n) (e/p + 1)
    dlog e / dlog n = 1 + p/e

with a fixed-grid RK4 in log n. Every draw of a family is one row of the
same ``[draws]`` loop. The node draws are the JAX package's, from a numpy
``default_rng`` in the same order ('peter' scheme, eos_gen.py:140-166), so
a seed gives both packages the same nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.interp import interp_rows


def connection_state(n_low, p_low, e_low, n_connect):
    """(p, e, cs2) of the low-density table at ``n_connect``: log-log
    linear interpolation, cs2 = dp/de from the local log slope."""
    if not (n_low[0] <= n_connect <= n_low[-1]):
        raise ValueError(
            f"n_connect={n_connect} outside the low-density table range "
            f"[{n_low[0]:.3g}, {n_low[-1]:.3g}] fm^-3")
    ln_n, ln_p, ln_e = np.log(n_low), np.log(p_low), np.log(e_low)
    x = np.log(n_connect)
    p_c = np.exp(np.interp(x, ln_n, ln_p))
    e_c = np.exp(np.interp(x, ln_n, ln_e))
    i = np.clip(np.searchsorted(ln_n, x), 1, len(ln_n) - 1)
    dlogp_dloge = (ln_p[i] - ln_p[i - 1]) / (ln_e[i] - ln_e[i - 1])
    cs2_c = p_c / e_c * dlogp_dloge
    return float(p_c), float(e_c), float(cs2_c)


def draw_cs2_nodes(seed, n_connect, n_lim, cs2_at_connect, n_seg=5,
                   cs2_limit=1.0, n_draws=1):
    """[B, N_seg+2, 2] arrays of (n, cs2) nodes, 'peter' scheme."""
    if n_lim <= n_connect:
        raise ValueError(f"n_lim={n_lim} must exceed n_connect={n_connect}")
    rng = np.random.default_rng(seed)
    extend = n_lim - n_connect
    nodes = np.empty((n_draws, n_seg + 2, 2))
    nodes[:, 0] = [n_connect, cs2_at_connect]
    for b in range(n_draws):
        for k in range(1, n_seg + 1):
            lo = nodes[b, k - 1, 0]
            hi = min(lo + 1.5 * extend / n_seg, n_lim)
            nodes[b, k] = [rng.uniform(lo, hi), rng.uniform(0.0, cs2_limit)]
        nodes[b, -1] = [n_lim, rng.uniform(0.0, cs2_limit)]
    return nodes


def cse_extend(cs2_nodes, p_connect, e_connect, n_connect, n_lim,
               n_points=512):
    """Integrate the draws ``cs2_nodes`` [B, K, 2] (f32 tensor): returns
    (n [n_points], p [B, n_points], e [B, n_points])."""
    device = cs2_nodes.device
    f32 = dict(dtype=torch.float32, device=device)
    ln0 = torch.log(torch.tensor(n_connect, **f32))
    ln1 = torch.log(torch.tensor(n_lim, **f32))
    lns = ln0 + (ln1 - ln0) * torch.arange(n_points, device=device) \
        / (n_points - 1)
    h = (ln1 - ln0) / (n_points - 1)
    node_n = cs2_nodes[:, :, 0].contiguous()
    node_v = cs2_nodes[:, :, 1].contiguous()

    def deriv(ln, logp, loge):
        cs2 = interp_rows(torch.exp(ln).reshape(1, 1), node_n, node_v)[:, 0]
        r = torch.exp(loge - logp)             # e/p
        return cs2 * (r + 1.0), 1.0 + 1.0 / r

    b = cs2_nodes.shape[0]
    logp = torch.log(torch.tensor(p_connect, **f32)).expand(b).clone()
    loge = torch.log(torch.tensor(e_connect, **f32)).expand(b).clone()
    out_p, out_e = [], []
    for ln in lns:
        out_p.append(logp)
        out_e.append(loge)
        k1 = deriv(ln, logp, loge)
        k2 = deriv(ln + 0.5 * h, logp + 0.5 * h * k1[0],
                   loge + 0.5 * h * k1[1])
        k3 = deriv(ln + 0.5 * h, logp + 0.5 * h * k2[0],
                   loge + 0.5 * h * k2[1])
        k4 = deriv(ln + h, logp + h * k3[0], loge + h * k3[1])
        logp = logp + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        loge = loge + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    return (torch.exp(lns), torch.exp(torch.stack(out_p, dim=1)),
            torch.exp(torch.stack(out_e, dim=1)))


def cse_eos_family(low_density_eos, n_connect=0.16, n_lim=2.0, n_seg=5,
                   cs2_limit=1.0, seed=42, n_draws=1, n_points=512,
                   device=None):
    """Draw and integrate a family of CSE-extended EOS tables.

    ``low_density_eos``: dict with 'n', 'p', 'e' arrays (fm^-3, MeV fm^-3),
    the reference's input convention (eos_gen.py:84-93). Returns a list of
    ``EOSTable`` (the low-density rows below n_connect, then the
    integrated extension), every draw integrated in one loop on
    ``device`` (default the CUDA card).
    """
    from .eos import EOSTable

    device = resolve_device(device)
    n_low = np.asarray(low_density_eos["n"], dtype=np.float64)
    p_low = np.asarray(low_density_eos["p"], dtype=np.float64)
    e_low = np.asarray(low_density_eos["e"], dtype=np.float64)
    p_c, e_c, cs2_c = connection_state(n_low, p_low, e_low, n_connect)
    nodes = draw_cs2_nodes(seed, n_connect, n_lim, cs2_c, n_seg=n_seg,
                           cs2_limit=cs2_limit, n_draws=n_draws)
    with torch.no_grad():
        n_hi, p_hi, e_hi = cse_extend(
            torch.as_tensor(nodes, dtype=torch.float32, device=device),
            p_c, e_c, float(n_connect), float(n_lim), int(n_points))
    n_hi = n_hi.cpu().numpy().astype(np.float64)
    p_hi = p_hi.cpu().numpy().astype(np.float64)
    e_hi = e_hi.cpu().numpy().astype(np.float64)

    keep = n_low < n_connect
    tables = []
    for b in range(n_draws):
        tables.append(EOSTable(
            energy_density=np.concatenate([e_low[keep], e_hi[b]]),
            pressure=np.concatenate([p_low[keep], p_hi[b]]),
            number_density=np.concatenate([n_low[keep], n_hi])))
    return tables


def mixed_low_density_eos(soft, stiff, alpha=None, seed=42):
    """Convex soft/stiff crust mixture (eos_gen.py:95-117); ``alpha=None``
    draws Uniform(0, 1) with the given seed, as the reference. The tables
    share one density grid."""
    if alpha is None:
        alpha = float(np.random.default_rng(seed).uniform())
    n = np.asarray(soft["n"], dtype=np.float64)
    e_soft = np.asarray(soft["e"], dtype=np.float64)
    p_soft = np.asarray(soft["p"], dtype=np.float64)
    e = e_soft + alpha * (np.asarray(stiff["e"]) - e_soft)
    p = p_soft + alpha * (np.asarray(stiff["p"]) - p_soft)
    return {"n": n, "p": p, "e": e}
