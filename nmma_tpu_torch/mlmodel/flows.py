"""Masked autoregressive normalising flow.

Port of ``nmma_tpu/mlmodel/flows.py`` (the reference's nflows stack,
nmma/mlmodel/normalizingflows.py:66-90): MADE transforms with a context
input, fixed permutations between them, a standard-normal base. The masks
and the ``default_rng(0)`` permutations are the JAX package's number for
number; ``log_prob`` is batch-first and ``sample`` inverts each transform one
dimension at a time.

Weights start as flax's do (truncated lecun-normal kernels, zero biases):
the same distributions, not the same values (``lecun_init``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def lecun_init(module):
    """Initialise every Linear and Conv1d under ``module`` as flax does:
    kernels truncated normal at two standard deviations with variance
    1 / fan_in (``nn.initializers.lecun_normal``), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            # flax divides by the truncated unit normal's standard deviation
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def made_masks(dim, hidden, n_hidden_layers=1):
    """Binary masks enforcing the autoregressive property, each [out, in]
    (the transposes of the JAX package's ``_made_masks``)."""
    degrees_in = np.arange(1, dim + 1)
    degrees_hidden = (np.arange(hidden) % max(dim - 1, 1)) + 1
    masks = []
    prev = degrees_in
    for _ in range(n_hidden_layers):
        masks.append((degrees_hidden[:, None] >= prev[None, :]).astype(
            np.float32))
        prev = degrees_hidden
    # output mask: strict inequality (outputs depend on strictly earlier dims)
    out_degrees = np.tile(degrees_in, 2)   # shift + log_scale per dim
    masks.append((out_degrees[:, None] > prev[None, :]).astype(np.float32))
    return masks


class MaskedLinear(nn.Linear):
    """Linear layer whose weight is multiplied by a fixed 0/1 mask."""

    def __init__(self, in_features, out_features, mask):
        super().__init__(in_features, out_features)
        self.register_buffer("mask", torch.as_tensor(mask))

    def forward(self, x):
        return nn.functional.linear(x, self.weight * self.mask, self.bias)


class MADEBlock(nn.Module):
    """One masked affine autoregressive transform with an optional context
    (flax ``MADEBlock``: MaskedDense_0, Dense_0, MaskedDense_1, Dense_1)."""

    def __init__(self, dim, hidden=90, context_dim=None):
        super().__init__()
        self.dim = dim
        masks = made_masks(dim, hidden)
        self.inp = MaskedLinear(dim, hidden, masks[0])
        self.out = MaskedLinear(hidden, 2 * dim, masks[-1])
        self.ctx_hidden = self.ctx_out = None
        if context_dim is not None:
            self.ctx_hidden = nn.Linear(context_dim, hidden)
            # a direct context path to every output: the output mask keeps
            # the first dimension from all hidden units
            self.ctx_out = nn.Linear(context_dim, 2 * dim)

    def forward(self, x, context=None):
        h = self.inp(x)
        if context is not None:
            h = h + self.ctx_hidden(context)
        out = self.out(torch.relu(h))
        if context is not None:
            out = out + self.ctx_out(context)
        shift, log_scale = out[..., :self.dim], out[..., self.dim:]
        return shift, torch.tanh(log_scale) * 3.0   # stability clamp


class MaskedAutoregressiveFlow(nn.Module):
    """MADE transforms with fixed permutations between them."""

    def __init__(self, dim, n_transforms=9, hidden=90, context_dim=None):
        super().__init__()
        self.dim = dim
        self.blocks = nn.ModuleList(MADEBlock(dim, hidden, context_dim)
                                    for _ in range(n_transforms))
        rng = np.random.default_rng(0)
        perms = [rng.permutation(dim) for _ in range(n_transforms)]
        self.register_buffer("perms", torch.as_tensor(np.stack(perms)))
        lecun_init(self)

    def log_prob(self, x, context=None):
        """log q(x | context) [B]; x [B, dim], context [B, C] or None."""
        log_det = torch.zeros(x.shape[:-1], device=x.device)
        z = x
        for block, perm in zip(self.blocks, self.perms):
            z = z[..., perm]
            shift, log_scale = block(z, context)
            # inverse (data -> noise) pass of the affine transform
            z = (z - shift) * torch.exp(-log_scale)
            log_det = log_det - log_scale.sum(-1)
        base = -0.5 * (z * z).sum(-1) - 0.5 * self.dim * math.log(2.0 * math.pi)
        return base + log_det

    def sample(self, n, context=None, generator=None, z=None):
        """n draws [n, dim] (noise -> data, sequential in dim). ``z`` [n, dim]
        gives the base noise; else it is drawn with ``generator``. A 1-D
        context is shared by every draw."""
        device = self.perms.device
        if z is None:
            z = torch.randn((n, self.dim), generator=generator, device=device)
        if context is not None and context.dim() == 1:
            context = context.expand(n, context.shape[-1])
        x = z
        for block, perm in zip(reversed(self.blocks), reversed(self.perms)):
            y = torch.zeros_like(x)
            for d in range(self.dim):
                shift, log_scale = block(y, context)
                y = y.clone()
                y[..., d] = x[..., d] * torch.exp(log_scale[..., d]) \
                    + shift[..., d]
            x = y[..., torch.argsort(perm)]
        return x
