"""Compact-kernel GP SVD-surrogate backend (``--interpolation-type
api_gp``).

Port of ``nmma_tpu/training/gp_compact.py`` (the reference's
``GPAPITrainingModel``, nmma/em/training.py:455-516): a fixed Wendland C2
kernel of support ``kernel_coeff`` times each dimension's range. It has no
trained hyperparameter, so every (filter, coefficient) GP shares one
train-train matrix: one Cholesky and one solve with G right-hand sides.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .gp import cholesky


def compact_kernel(x1, x2, scale):
    """Wendland C2 kernel matrix [n1, n2]: k(r) = (1 - r)^4 (4 r + 1) for
    r < 1, else 0, with r^2 = sum_d ((x1_d - x2_d) / scale_d)^2."""
    d2 = (((x1[:, None, :] - x2[None, :, :]) / scale) ** 2).sum(-1)
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    return torch.clamp(1.0 - r, min=0.0) ** 4 * (4.0 * r + 1.0)


@dataclass
class CompactGPSurrogate:
    """Fixed-kernel GPs sharing one factorisation, on one device."""

    x_train: torch.Tensor       # [N, P] normalised parameters
    alpha_vecs: torch.Tensor    # [G, N] K^-1 y per GP
    scale: torch.Tensor         # [P] support radii
    shape: tuple                # (F, C)

    def predict(self, x_star):
        """Coefficients [B, F, C] at normalised points x_star [B, P]."""
        k_star = compact_kernel(x_star, self.x_train, self.scale)  # [B, N]
        return (k_star @ self.alpha_vecs.T).reshape(-1, *self.shape)

    def arrays(self):
        return {"backend": "api_gp",
                **{k: getattr(self, k).detach().cpu().numpy()
                   for k in ("x_train", "alpha_vecs", "scale")}}


def fit_compact_gp(x, coeffs, kernel_coeff=0.5, train_err=None,
                   jitter=1e-6, device=None) -> CompactGPSurrogate:
    """Fit all (F, C) compact GPs with one shared Cholesky on ``device``.

    x [N, P] normalised to [0, 1]; coeffs [N, F, C]. The support per
    dimension is ``kernel_coeff`` times the data's range there (the
    reference's CompactKernel ``coeffs=[0.5]*nd``); ``train_err`` an
    optional per-point noise standard deviation.
    """
    device = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    f_n, c_n = coeffs.shape[1], coeffs.shape[2]
    y_all = torch.as_tensor(np.asarray(coeffs, dtype=np.float32)
                            .reshape(n, f_n * c_n), device=device)
    span = x.max(axis=0) - x.min(axis=0)
    scale = np.where(span > 0, kernel_coeff * span, 1.0).astype(np.float32)
    x_dev = torch.as_tensor(x, device=device)
    scale_dev = torch.as_tensor(scale, device=device)

    k = compact_kernel(x_dev, x_dev, scale_dev)
    if train_err is not None:
        k = k + torch.diag(torch.as_tensor(
            np.asarray(train_err, dtype=np.float32), device=device) ** 2)
    k = k + jitter * torch.eye(n, device=device)
    alpha = torch.cholesky_solve(y_all, cholesky(k))            # [N, G]
    return CompactGPSurrogate(x_train=x_dev, alpha_vecs=alpha.T.contiguous(),
                              scale=scale_dev, shape=(f_n, c_n))


def train_svd_compact_gp_model(entries, parameter_names, filters,
                               config=None, kernel_coeff=0.5, device=None):
    """SVD + compact-GP surrogate; returns (meta, CompactGPSurrogate).
    Evaluate with ``training.gp.svd_gp_surrogate_mags``."""
    from .gp import _svd_decompose
    meta, x, coeffs = _svd_decompose(entries, parameter_names, filters,
                                     config)
    return meta, fit_compact_gp(x, coeffs, kernel_coeff=kernel_coeff,
                                device=device)
