"""Gaussian-process SVD-surrogate backend (``--interpolation-type
sklearn_gp``).

Port of ``nmma_tpu/training/gp.py`` (the reference's
``SklearnGPTrainingModel``, nmma/em/training.py:412-453): one exact GP per
(filter, coefficient), G of them, with a RationalQuadratic kernel of
per-dimension length scales and white noise. Their hyperparameters are fitted
together: every adam step factors the ``[G, N, N]`` kernel matrices in one
batched Cholesky and back-propagates through it with autograd. Prediction is
one batched kernel contraction, batch-first.

``torch.linalg.cholesky`` raises on a matrix that is not positive definite,
where ``jnp.linalg.cholesky`` returns NaN; ``cholesky`` here keeps the JAX
semantics (``cholesky_ex``, NaN where the factorisation failed). The white
noise is bounded below at 1e-5 of each GP's amplitude, as sklearn's
``WhiteKernel`` bounds its noise level on normalised targets: without the
bound adam drives it down until the f32 Cholesky fails, and the JAX package
goes on with NaN hyperparameters (fault 3h).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device


#: the white noise's lower bound, ln of its ratio to the GP's amplitude
LOG_NOISE_FLOOR = math.log(1e-5)


def cholesky(k):
    """Lower Cholesky factors of ``k`` [..., N, N]; NaN for each matrix
    that is not positive definite (``jnp.linalg.cholesky``'s semantics)."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(chol, math.nan), chol)


def _rq_kernel(x1, x2, log_amp, log_length, log_alpha):
    """RationalQuadratic kernel matrices [G, n1, n2] of G GPs: x1 [n1, P],
    x2 [n2, P], log_amp [G], log_length [G, P], log_alpha [G]."""
    length = torch.exp(log_length)[:, None, None, :]           # [G,1,1,P]
    d2 = (((x1[:, None, :] - x2[None, :, :]) / length) ** 2).sum(-1)
    alpha = torch.exp(log_alpha)[:, None, None]
    return torch.exp(log_amp)[:, None, None] * torch.pow(
        1.0 + d2 / (2.0 * alpha), -alpha)


def gp_nll(params, x, y):
    """Negative log marginal likelihood of every GP [G]: params as in
    ``fit_gp_coefficients``, x [N, P], y [G, N]."""
    n = x.shape[0]
    k = _rq_kernel(x, x, params["log_amp"], params["log_length"],
                   params["log_alpha"])
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = k + (torch.exp(params["log_noise"]) + 1e-6)[:, None, None] * eye
    chol = cholesky(k)
    alpha = torch.cholesky_solve(y[..., None], chol)[..., 0]    # [G, N]
    return (0.5 * (y * alpha).sum(-1)
            + torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * n * math.log(2.0 * math.pi))


def initial_gp_params(y_all, p):
    """The JAX package's starting point: amplitude from each GP's target
    spread, unit length scales and alpha, noise 6 e-folds below."""
    g = y_all.shape[0]
    y_std = torch.std(y_all, dim=1, unbiased=False) + 1e-6
    zeros = torch.zeros(g, device=y_all.device)
    return {"log_amp": 2.0 * torch.log(y_std),
            "log_length": torch.zeros((g, p), device=y_all.device),
            "log_alpha": zeros,
            "log_noise": 2.0 * torch.log(y_std) - 6.0}


@dataclass
class GPSurrogate:
    """Stacked exact GPs, one per (filter, coefficient), on one device."""

    x_train: torch.Tensor       # [N, P] normalised parameters
    alpha_vecs: torch.Tensor    # [G, N] K^-1 y per GP
    log_amp: torch.Tensor       # [G]
    log_length: torch.Tensor    # [G, P]
    log_alpha: torch.Tensor     # [G]
    shape: tuple                # (F, C)

    def predict(self, x_star):
        """Coefficients [B, F, C] at normalised points x_star [B, P]."""
        length = torch.exp(self.log_length)                       # [G, P]
        alpha = torch.exp(self.log_alpha)[None, :, None]          # [1, G, 1]
        diff = (x_star[:, None, None, :] - self.x_train[None, None]) \
            / length[None, :, None, :]                            # [B,G,N,P]
        d2 = (diff * diff).sum(-1)                                # [B, G, N]
        k_star = torch.exp(self.log_amp)[None, :, None] * torch.pow(
            1.0 + d2 / (2.0 * alpha), -alpha)
        coeffs = (k_star * self.alpha_vecs[None]).sum(-1)         # [B, G]
        return coeffs.reshape(-1, *self.shape)

    def arrays(self):
        return {"backend": "sklearn_gp",
                **{k: getattr(self, k).detach().cpu().numpy() for k in
                   ("x_train", "alpha_vecs", "log_amp", "log_length",
                    "log_alpha")}}


def fit_gp_coefficients(x, coeffs, n_steps=400, learning_rate=0.05,
                        seed=0, verbose=False, device=None) -> GPSurrogate:
    """Fit all (F, C) GPs together on ``device``: x [N, P]; coeffs
    [N, F, C].

    Up to ``n_steps`` adam steps on the summed NLL. After each step the
    white noise is projected back onto its bound, exp(log_noise) >= 1e-5
    exp(log_amp) per GP (``LOG_NOISE_FLOOR``): that keeps every kernel
    matrix's condition number below about N / 1e-5, which the f32 Cholesky
    factors, so the fit runs all its steps (fault 3h: the JAX package has
    no bound, and its NLL goes NaN by step 160 on 256 points). Until the
    bound first binds the steps are the JAX package's. As a guard, a step
    whose NLL is not finite still stops the fit, which keeps the last
    hyperparameters with a finite NLL. The result's ``nll_history`` holds
    the NLL before each step taken, ``stopped_at`` the step whose NLL was
    not finite (None if all were), ``bound_from`` the first step after
    which the bound bound (None if it never did) and ``log_noise`` the
    fitted noise, which prediction does not need."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    n, p = x.shape
    f_n, c_n = coeffs.shape[1], coeffs.shape[2]
    y_all = torch.as_tensor(
        np.asarray(coeffs, dtype=np.float32).reshape(n, f_n * c_n).T.copy(),
        device=device)                                            # [G, N]
    params = {k: v.requires_grad_(True)
              for k, v in initial_gp_params(y_all, p).items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    block = max(1, n_steps // (5 if verbose else 1))
    history, stopped_at, bound_from = [], None, None
    last = {k: v.detach().clone() for k, v in params.items()}
    for step in range(1, n_steps + 1):
        opt.zero_grad(set_to_none=True)
        loss = gp_nll(params, x, y_all).sum()
        if not bool(torch.isfinite(loss)):
            # back to the hyperparameters of the last finite NLL
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(last[k])
            stopped_at = step
            if verbose:
                print(f"gp step {step:4d} nll not finite: stopped, keeping "
                      f"step {step - 1}")
            break
        last = {k: v.detach().clone() for k, v in params.items()}
        loss.backward()
        opt.step()
        with torch.no_grad():
            floor = params["log_amp"] + LOG_NOISE_FLOOR
            if bound_from is None and bool((params["log_noise"]
                                            < floor).any()):
                bound_from = step
            params["log_noise"].copy_(torch.maximum(params["log_noise"],
                                                    floor))
        history.append(loss.detach())
        if verbose and (step % block == 0 or step == n_steps):
            print(f"gp step {step:4d} nll {float(loss):.3f}")

    with torch.no_grad():
        params = {k: v.detach() for k, v in params.items()}
        k = _rq_kernel(x, x, params["log_amp"], params["log_length"],
                       params["log_alpha"])
        k = k + (torch.exp(params["log_noise"]) + 1e-6)[:, None, None] \
            * torch.eye(n, device=device)
        alpha_vecs = torch.cholesky_solve(y_all[..., None],
                                          cholesky(k))[..., 0]
    gp = GPSurrogate(x_train=x, alpha_vecs=alpha_vecs,
                     log_amp=params["log_amp"],
                     log_length=params["log_length"],
                     log_alpha=params["log_alpha"], shape=(f_n, c_n))
    gp.nll_history = (torch.stack(history).cpu().numpy() if history
                      else np.zeros(0))
    gp.stopped_at = stopped_at
    gp.bound_from = bound_from
    gp.log_noise = params["log_noise"]
    return gp


def _svd_decompose(entries, parameter_names, filters, config=None):
    """Grid -> (meta, normalised params x, SVD coefficients): the basis and
    min-max normalisation every GP backend shares (reference
    ``BaseTrainingModel.generate_svd_model``, nmma/em/training.py:118-176)."""
    from .svd import SVDTrainingConfig, _interp_grid, _normalize_and_decompose
    cfg = config or SVDTrainingConfig()
    tt = np.linspace(cfg.tmin, cfg.tmax, cfg.n_tsteps)
    data = _interp_grid(entries, filters, tt,
                        spline=cfg.univariate_spline,
                        spline_s=cfg.univariate_spline_s)
    params = np.asarray([[e["params"][p] for p in parameter_names]
                         for e in entries])
    (p_mins, p_maxs, x, mins, maxs, va,
     coeffs) = _normalize_and_decompose(data, params, cfg.n_coeff)
    meta = dict(filters=tuple(filters), parameter_names=tuple(parameter_names),
                tt=tt, va=va, mins=mins, maxs=maxs, param_mins=p_mins,
                param_maxs=p_maxs)
    return meta, x, coeffs


def train_svd_gp_model(entries, parameter_names, filters, config=None,
                       n_steps=400, verbose=True, device=None):
    """SVD + exact-GP surrogate; returns (meta, GPSurrogate). Evaluate with
    ``svd_gp_surrogate_mags``."""
    meta, x, coeffs = _svd_decompose(entries, parameter_names, filters,
                                     config)
    gp = fit_gp_coefficients(x, coeffs, n_steps=n_steps, verbose=verbose,
                             device=device)
    return meta, gp


def save_gp_surrogate(path, meta, gp):
    """One npz for either GP backend, in the JAX package's layout
    (``meta_*`` keys, ``backend``, the surrogate's arrays, ``shape``)."""
    payload = {f"meta_{k}": np.asarray(v) for k, v in meta.items()}
    payload.update(gp.arrays(), shape=np.asarray(gp.shape))
    np.savez_compressed(path, **payload)


def load_gp_surrogate(path, device=None):
    """Inverse of ``save_gp_surrogate`` -> (meta, surrogate on
    ``device``); reads what either package wrote."""
    from .gp_compact import CompactGPSurrogate
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    meta = {k[5:]: data[k] for k in data if k.startswith("meta_")}
    meta["filters"] = tuple(str(f) for f in meta["filters"])
    meta["parameter_names"] = tuple(str(p) for p in meta["parameter_names"])
    shape = tuple(int(s) for s in data["shape"])

    def dev(key):
        return torch.as_tensor(np.asarray(data[key], dtype=np.float32),
                               device=device)
    if str(data["backend"]) == "api_gp":
        gp = CompactGPSurrogate(x_train=dev("x_train"),
                                alpha_vecs=dev("alpha_vecs"),
                                scale=dev("scale"), shape=shape)
    else:
        gp = GPSurrogate(x_train=dev("x_train"), alpha_vecs=dev("alpha_vecs"),
                         log_amp=dev("log_amp"), log_length=dev("log_length"),
                         log_alpha=dev("log_alpha"), shape=shape)
    return meta, gp


def svd_gp_surrogate_mags(meta, gp, params, t_days):
    """Magnitudes [B, F, Q] through either GP backend: params {name: [B]}
    on the surrogate's device, t_days [Q]; inf outside the trained range."""
    from ..ops.interp import masked_interp_sorted_fill
    device = gp.x_train.device

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    theta = torch.stack([torch.as_tensor(params[p], dtype=torch.float32,
                                         device=device)
                         for p in meta["parameter_names"]], dim=-1)
    x = (theta - dev(meta["param_mins"])) / (
        dev(meta["param_maxs"]) - dev(meta["param_mins"]))
    c = gp.predict(x)                                           # [B, F, C]
    m = torch.einsum("ftc,bfc->bft", dev(meta["va"]), c)
    mins = dev(meta["mins"])
    m = m * (dev(meta["maxs"]) - mins) + mins
    return masked_interp_sorted_fill(
        torch.as_tensor(t_days, dtype=torch.float32, device=device),
        dev(meta["tt"]), m, math.inf)
