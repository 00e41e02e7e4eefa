"""Linear and masked 1-D interpolation in PyTorch.

Counterparts of ``jnp.interp`` and of ``nmma_tpu/ops/interp.py``
(``masked_interp``, ``masked_interp_sorted_fill``), which re-design the
reference's ``autocomplete_data`` (``nmma/em/utils.py:626-677``): samples
with non-finite ``y`` are ignored, fewer than 2 valid samples give
``fill_value`` everywhere, and out-of-range policies are ``where`` masks.
``x``/``y`` are 1-D; queries ``xq`` may have any shape.
"""

from __future__ import annotations

import math

import torch

_BIG = 1e30  # sentinel abscissa for invalid samples; finite in f32


def interp(xq, xp, fp, left=None, right=None):
    """``jnp.interp``/``np.interp`` on tensors: ``xp`` ascending, constant
    extrapolation unless ``left``/``right`` are given."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, xq.contiguous(), right=True),
                    1, n - 1)
    x_lo, x_hi = xp[i - 1], xp[i]
    f_lo, f_hi = fp[i - 1], fp[i]
    dx = x_hi - x_lo
    # the same guard jnp.interp applies against a zero-width cell:
    # np.spacing(eps) of xp's dtype, which is eps**2 (1.42e-14 in f32)
    eps = torch.finfo(xp.dtype).eps
    dx0 = dx.abs() <= eps * eps
    f = torch.where(dx0, f_lo,
                    f_lo + ((xq - x_lo) / torch.where(dx0, 1.0, dx))
                    * (f_hi - f_lo))
    f = torch.where(xq < xp[0], fp[0] if left is None else left, f)
    return torch.where(xq > xp[-1], fp[-1] if right is None else right, f)


def interp_rows(xq, xp, fp):
    """``jnp.interp`` applied row by row: ``fp`` [B, N] against ``xp`` [N]
    or [B, N] (ascending along N), queries ``xq`` [Q] or [B, Q]; returns
    [B, Q] with constant extrapolation, by the formula of ``interp``."""
    b, n = fp.shape
    xp = xp.expand(b, n).contiguous()
    xq = xq.expand(b, xq.shape[-1]).contiguous()
    i = torch.clamp(torch.searchsorted(xp, xq, right=True), 1, n - 1)
    x_lo, x_hi = xp.gather(1, i - 1), xp.gather(1, i)
    f_lo, f_hi = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x_hi - x_lo
    eps = torch.finfo(xp.dtype).eps
    dx0 = dx.abs() <= eps * eps
    f = torch.where(dx0, f_lo,
                    f_lo + ((xq - x_lo) / torch.where(dx0, 1.0, dx))
                    * (f_hi - f_lo))
    f = torch.where(xq < xp[:, :1], fp[:, :1], f)
    return torch.where(xq > xp[:, -1:], fp[:, -1:], f)


def masked_interp(xq, x, y, valid=None, left=None, right=None,
                  fill_value=math.inf):
    """Interpolate ``y(x)`` onto ``xq`` ignoring invalid samples; constant
    (clamped) extrapolation unless ``left``/``right`` are given."""
    ok = torch.isfinite(y) & torch.isfinite(x)
    if valid is not None:
        ok = ok & valid
    n_valid = ok.sum()
    xv = torch.where(ok, x, _BIG)
    order = torch.argsort(xv, stable=True)
    xs = xv[order]
    ys = torch.where(ok, y, 0.0)[order]
    idx_last = torch.clamp(n_valid - 1, min=0)
    # pad the invalid tail with a flat continuation of the last valid sample
    ys = torch.where(torch.arange(xs.shape[0], device=xs.device) < n_valid,
                     ys, ys[idx_last])
    res = interp(xq, xs, ys)
    if left is not None:
        res = torch.where(xq < xs[0], left, res)
    if right is not None:
        res = torch.where(xq > xs[idx_last], right, res)
    return torch.where(n_valid >= 2, res, fill_value)


def masked_interp_sorted_fill(xq, x, y, fill):
    """Masked interpolation for ascending ``x`` [N] shared by every row, or
    [B, N], one grid per row of ``y`` [B, N] (``jax.vmap`` of the JAX
    function over x and y): each query of ``xq`` [Q] uses its nearest
    valid neighbours in ``y`` [..., N] (rows along the last dimension);
    queries outside a row's valid range get ``fill``. Returns [..., Q]."""
    n = x.shape[-1]
    valid = torch.isfinite(y)
    n_valid = valid.sum(-1, keepdim=True)
    idx = torch.arange(n, device=x.device).expand_as(y)
    # nearest valid index at-or-before / at-or-after each grid index
    left_of = torch.cummax(torch.where(valid, idx, -1), -1).values
    right_of = n - 1 - torch.flip(torch.cummax(
        torch.flip(torch.where(valid, n - 1 - idx, -1), (-1,)), -1).values,
        (-1,))
    if x.dim() == 1:
        pos = (xq[..., None] >= x).sum(-1)                        # [Q]
        pos = pos.expand(*y.shape[:-1], -1)
    else:
        pos = (xq[:, None] >= x[:, None, :]).sum(-1)              # [B, Q]
    x = x.expand_as(y)
    pos = torch.clamp(pos - 1, 0, n - 1)

    def at(row, index):                     # row[..., index[..., Q]]
        return torch.gather(row, -1, index.clamp(0, n - 1))

    l_idx = at(left_of, pos)
    r_idx = at(right_of, pos + 1)
    # a query beyond the last grid cell still needs the last valid point
    r_idx = torch.where(pos >= n - 1, left_of[..., n - 1:], r_idx)
    l_ok = l_idx >= 0
    r_ok = (r_idx >= 0) & (r_idx <= n - 1)
    x_l, y_l = at(x, l_idx), at(y, l_idx)
    x_r, y_r = at(x, r_idx), at(y, r_idx)
    span = torch.where(x_r > x_l, x_r - x_l, 1.0)
    w = torch.clamp((xq - x_l) / span, 0.0, 1.0)
    est = torch.where(l_ok & r_ok, y_l + w * (y_r - y_l), fill)
    x_first = at(x, right_of[..., :1])
    x_last = at(x, left_of[..., n - 1:])
    est = torch.where((xq < x_first) | (xq > x_last), fill, est)
    return torch.where(n_valid >= 2, est, fill)


def masked_interp_linear_sorted(xq, x, y, fill_value=math.inf):
    """Row-wise linear-extrapolating masked interpolation on an ascending
    grid (``masked_interp_linear_sorted``, nmma_tpu ops/interp.py:208).

    ``x`` [T] ascending, ``y`` [B, T] with non-finite entries ignored,
    ``xq`` [Q]; returns [B, Q]. Interior queries use the nearest valid
    neighbours, queries beyond the valid range extrapolate linearly from its
    two edge samples, and rows with fewer than 2 valid samples are
    ``fill_value``.
    """
    n = x.shape[0]
    valid = torch.isfinite(y)
    n_valid = valid.sum(dim=1, keepdim=True)
    idx = torch.arange(n, device=y.device).expand_as(y)

    def rows(index):                        # [B, K] indices -> y[b, index]
        return torch.gather(y, 1, index)

    left_of = torch.cummax(torch.where(valid, idx, -1), 1).values
    right_of = n - 1 - torch.flip(torch.cummax(
        torch.flip(torch.where(valid, n - 1 - idx, -1), (1,)), 1).values,
        (1,))

    pos = torch.clamp((xq[:, None] >= x).sum(-1) - 1, 0, n - 1)       # [Q]
    l_idx = left_of[:, pos]                                           # [B, Q]
    r_idx = right_of[:, torch.clamp(pos + 1, 0, n - 1)]

    # edge-valid indices for two-point extrapolation, [B, 1]
    i0 = torch.clamp(right_of[:, :1], 0, n - 1)
    i1 = torch.clamp(torch.gather(right_of, 1, torch.clamp(i0 + 1, 0, n - 1)),
                     0, n - 1)
    i_last = torch.clamp(left_of[:, -1:], 0, n - 1)
    i_m = torch.clamp(torch.gather(left_of, 1,
                                   torch.clamp(i_last - 1, 0, n - 1)),
                      0, n - 1)

    l_safe = torch.clamp(l_idx, 0, n - 1)
    r_safe = torch.clamp(r_idx, 0, n - 1)
    x_l, y_l = x[l_safe], rows(l_safe)
    x_r, y_r = x[r_safe], rows(r_safe)
    span = torch.where(x_r > x_l, x_r - x_l, 1.0)
    w = torch.clamp((xq - x_l) / span, 0.0, 1.0)
    res = y_l + w * (y_r - y_l)
    # interior queries in an invalid head/tail cell: the nearest valid value
    y0, y1, y_last, y_m = rows(i0), rows(i1), rows(i_last), rows(i_m)
    x0, x1, x_last, x_m = x[i0], x[i1], x[i_last], x[i_m]
    res = torch.where(l_idx < 0, y0, res)
    res = torch.where(r_idx > n - 1, y_last, res)

    lo_slope = (y1 - y0) / torch.where(x1 != x0, x1 - x0, 1.0)
    hi_slope = (y_last - y_m) / torch.where(x_last != x_m, x_last - x_m, 1.0)
    res = torch.where(xq < x0, y0 + lo_slope * (xq - x0), res)
    res = torch.where(xq > x_last, y_last + hi_slope * (xq - x_last), res)
    return torch.where(n_valid >= 2, res, fill_value)
