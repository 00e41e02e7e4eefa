"""VICReg similarity pre-training for the light-curve embedding.

Port of ``nmma_tpu/mlmodel/vicreg.py`` (the reference's self-supervised
embedding stage, nmma/mlmodel/embedding.py:17-284): a trunk producing a
low-dimensional representation, an expander head on top, trained so that
augmented views of one light curve expand alike (invariance) while the batch
stays spread out (variance hinge) and decorrelated (covariance penalty). The
frozen representation then conditions the flow
(``train_flow_posterior(..., raw_context=True)``).

The augmentations are numpy, and the minibatch permutations are drawn before
the augmentations from one generator, as in the JAX package: with one seed
both packages see the same views.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .embedding import LightCurveEmbedding
from .flows import lecun_init


def vicreg_loss(x, y, wt_repr=1.0, wt_cov=1.0, wt_std=1.0):
    """Variance-Invariance-Covariance regularisation (Bardes+22) of two
    batches [N, D]: returns (total, repr_loss, cov_loss, std_loss). The
    covariance term is the batch covariance's squared off-diagonal (the
    published formula; the JAX package's choice)."""
    n, d = x.shape
    repr_loss = torch.mean((x - y) ** 2)
    xc = x - x.mean(0)
    yc = y - y.mean(0)
    std_x = torch.sqrt(xc.var(0, unbiased=False) + 1e-4)
    std_y = torch.sqrt(yc.var(0, unbiased=False) + 1e-4)
    std_loss = (torch.relu(1.0 - std_x).mean() / 2
                + torch.relu(1.0 - std_y).mean() / 2)
    xn, yn = xc / std_x, yc / std_y
    cov_x = xn.T @ xn / (n - 1)
    cov_y = yn.T @ yn / (n - 1)
    off = 1.0 - torch.eye(d, device=x.device)
    cov_loss = ((cov_x * off) ** 2).sum() / d + ((cov_y * off) ** 2).sum() / d
    total = wt_repr * repr_loss + wt_cov * cov_loss + wt_std * std_loss
    return total, repr_loss, cov_loss, std_loss


class SimilarityEmbedder(nn.Module):
    """Embedding trunk (a 64-wide ``LightCurveEmbedding``), contraction to
    ``num_dim`` and a tanh expander head; ``forward`` returns (expanded,
    representation). flax names: LightCurveEmbedding_0, Dense_0 (the
    contraction), Dense_1 .. Dense_{1+h} (the expander), then the final
    Dense."""

    def __init__(self, n_filters, num_dim=7, num_dim_final=10,
                 num_hidden_layers_h=1, expander_hidden=20,
                 trunk_channels=32):
        super().__init__()
        self.trunk = LightCurveEmbedding(n_filters, embed_dim=64,
                                         channels=trunk_channels)
        self.contraction = nn.Linear(64, num_dim)
        self.expander = nn.ModuleList(
            [nn.Linear(num_dim, expander_hidden)]
            + [nn.Linear(expander_hidden, expander_hidden)
               for _ in range(num_hidden_layers_h)])
        self.final = nn.Linear(expander_hidden, num_dim_final)
        lecun_init(self)

    def forward(self, lc):
        representation = self.contraction(self.trunk(lc))
        h = representation
        for layer in self.expander:
            h = torch.tanh(layer(h))
        return self.final(h), representation

    @torch.no_grad()
    def represent(self, lcs, batch=8192):
        """The frozen representation [N, num_dim] (numpy) of light curves
        [N, F, T] (numpy), ``batch`` at a time."""
        device = self.final.weight.device
        lcs = np.asarray(lcs, dtype=np.float32)
        return np.concatenate([
            self(torch.as_tensor(lcs[i:i + batch], device=device))[1]
            .cpu().numpy() for i in range(0, len(lcs), batch)])


def augment_lightcurves(rng, lcs, max_shift=4, mag_jitter=0.1):
    """Random time-shift and photometric-jitter views of [N, F, T] curves
    (numpy, the JAX package's draws in its order); shifted-in entries are
    NaN, so the embedding's sentinel masking holds."""
    lcs = np.asarray(lcs, dtype=np.float32)
    n = lcs.shape[0]
    shifts = rng.integers(-max_shift, max_shift + 1, size=n)
    out = np.empty_like(lcs)
    for i, s in enumerate(shifts):
        if s == 0:
            out[i] = lcs[i]
        elif s > 0:
            out[i, :, s:] = lcs[i, :, :-s]
            out[i, :, :s] = np.nan
        else:
            out[i, :, :s] = lcs[i, :, -s:]
            out[i, :, s:] = np.nan
    return out + rng.normal(0.0, mag_jitter, out.shape).astype(np.float32)


def pretrain_similarity_embedding(lightcurves, num_dim=7, num_dim_final=10,
                                  n_epochs=100, batch_size=128,
                                  learning_rate=1e-3, max_shift=4,
                                  mag_jitter=0.1, wt_repr=25.0, wt_cov=1.0,
                                  wt_std=25.0, seed=0, verbose=True,
                                  device=None, init_embedder=None):
    """Self-supervised VICReg pre-training on ``device``; returns
    (embedder, loss history [steps]). An epoch is one shuffled pass in
    minibatches; the loss weights are the VICReg paper's (25, 1, 25).
    ``init_embedder`` gives the starting weights."""
    device = resolve_device(device)
    lcs = np.asarray(lightcurves, dtype=np.float32)
    n = len(lcs)
    rng = np.random.default_rng(seed)
    if init_embedder is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            init_embedder = SimilarityEmbedder(
                lcs.shape[1], num_dim=num_dim, num_dim_final=num_dim_final)
    embedder = init_embedder.to(device)
    opt = torch.optim.Adam(embedder.parameters(), lr=learning_rate)
    bsz = min(batch_size, n)
    steps_per_epoch = max(1, n // bsz)
    step_indices = np.concatenate([
        rng.permutation(n)[:steps_per_epoch * bsz]
        .reshape(steps_per_epoch, bsz) for _ in range(n_epochs)])  # [S, B]
    block = 64
    history = []
    for s0 in range(0, len(step_indices), block):
        idx = step_indices[s0:s0 + block]
        orig_block = lcs[idx]                              # [k, B, F, T]
        aug_block = np.stack([
            augment_lightcurves(rng, orig_block[j], max_shift=max_shift,
                                mag_jitter=mag_jitter)
            for j in range(len(idx))])
        aug_dev = torch.as_tensor(aug_block, device=device)
        orig_dev = torch.as_tensor(orig_block, device=device)
        losses = []
        for aug, orig in zip(aug_dev, orig_dev):
            opt.zero_grad(set_to_none=True)
            ex, _ = embedder(aug)
            ey, _ = embedder(orig)
            total = vicreg_loss(ex, ey, wt_repr=wt_repr, wt_cov=wt_cov,
                                wt_std=wt_std)[0]
            total.backward()
            opt.step()
            losses.append(total.detach())
        history.extend(torch.stack(losses).cpu().tolist())
        if verbose:
            done = min(s0 + block, len(step_indices)) // steps_per_epoch
            print(f"vicreg epoch {done:5d}/{n_epochs} loss {history[-1]:.4f}")
    embedder.eval()
    return embedder, np.asarray(history)
