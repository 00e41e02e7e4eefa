"""Likelihood-free inference: simulate -> train a conditional flow -> sample.

Port of ``nmma_tpu/mlmodel/inference.py`` (the reference's ``--sampler
neuralnet``, nmma/em/analysis.py:176-307): a normalising-flow posterior
q(theta | light curve) trained on simulated pairs, then ~20k posterior draws
for the observed data in one pass. The simulations go through the analysis's
model (the SVD surrogates through K1 on the card); the noise and the
observed-data interpolation are numpy, as in the JAX package, and the
minibatch indices come from the same numpy calls in the same order, so with
one seed the two packages see the same batches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .embedding import LightCurveEmbedding
from .flows import MaskedAutoregressiveFlow, lecun_init

# most simulations evaluated in one call of the model
SIM_BATCH = 8192


class RawContextProjection(nn.Module):
    """A precomputed context vector (a frozen embedding's) through a small
    trainable projection: Dense, tanh, Dense (flax Dense_0, Dense_1)."""

    def __init__(self, context_dim, embed_dim=20):
        super().__init__()
        self.dense0 = nn.Linear(context_dim, embed_dim)
        self.dense1 = nn.Linear(embed_dim, embed_dim)
        lecun_init(self)

    def forward(self, ctx):
        return self.dense1(torch.tanh(self.dense0(ctx)))


class ConditionalFlowNet(nn.Module):
    """The embedding (a light-curve ConvNet over ``n_inputs`` filters, or
    with ``raw_context`` a projection of ``n_inputs``-wide context
    vectors) feeding the flow's context."""

    def __init__(self, dim, n_inputs, n_transforms=6, hidden=90,
                 embed_dim=20, raw_context=False):
        super().__init__()
        self.raw_context = raw_context
        self.embedding = (RawContextProjection(n_inputs, embed_dim)
                          if raw_context
                          else LightCurveEmbedding(n_inputs, embed_dim))
        self.flow = MaskedAutoregressiveFlow(dim, n_transforms, hidden,
                                             context_dim=embed_dim)

    def log_prob(self, theta, lc):
        return self.flow.log_prob(theta, self.embedding(lc))

    def sample(self, n, lc, generator=None, z=None):
        ctx = self.embedding(lc)
        if ctx.dim() == 2:
            ctx = ctx[0]
        return self.flow.sample(n, ctx, generator=generator, z=z)


@dataclass
class LFIPosterior:
    """Trained amortised posterior with its standardisation."""

    net: ConditionalFlowNet
    theta_mean: np.ndarray
    theta_std: np.ndarray
    parameter_names: tuple

    @property
    def device(self):
        return next(self.net.parameters()).device

    def _lc(self, lightcurve):
        lc = torch.as_tensor(np.asarray(lightcurve, dtype=np.float32),
                             device=self.device)
        # one light curve [F, T] (one context vector [C]) -> a batch of one
        return lc[None] if lc.dim() == (1 if self.net.raw_context else 2) \
            else lc

    @torch.no_grad()
    def sample(self, n, lightcurve, generator=None, z=None):
        """n posterior draws {name: [n]} (numpy) for one light curve [F, T]
        (or context vector)."""
        x = self.net.sample(n, self._lc(lightcurve), generator, z)
        theta = x.cpu().numpy() * self.theta_std + self.theta_mean
        return {name: theta[:, i]
                for i, name in enumerate(self.parameter_names)}

    @torch.no_grad()
    def log_prob(self, theta_dict, lightcurve):
        theta = np.stack([np.asarray(theta_dict[p], dtype=np.float32)
                          for p in self.parameter_names], axis=-1)
        z = torch.as_tensor((theta - self.theta_mean) / self.theta_std,
                            dtype=torch.float32, device=self.device)
        return self.net.log_prob(z, self._lc(lightcurve))


def train_flow_posterior(theta, lightcurves, parameter_names,
                         n_transforms=6, hidden=90, n_epochs=500,
                         batch_size=256, learning_rate=1e-3, seed=0,
                         verbose=True, raw_context=False, device=None,
                         init_net=None) -> LFIPosterior:
    """Fit q(theta | lc) by maximum likelihood on simulated pairs, one
    minibatch an epoch, on ``device``.

    theta [N, D]; lightcurves [N, F, T] (non-finite magnitudes become the
    embedding's sentinel), or context vectors [N, C] with ``raw_context``.
    ``init_net`` gives the starting weights (a ``ConditionalFlowNet``).
    Exactly ``n_epochs`` epochs run; with ``verbose`` the loss is printed
    every n_epochs // 5 epochs and after the last. (The JAX package runs
    whole blocks of n_epochs // 5 when verbose, so it rounds the count up,
    fault 3g; its first ``n_epochs`` minibatches are these.)
    """
    device = resolve_device(device)
    theta = np.asarray(theta, dtype=np.float32)
    lightcurves = np.asarray(lightcurves, dtype=np.float32)
    n, dim = theta.shape
    t_mean = theta.mean(axis=0)
    t_std = theta.std(axis=0) + 1e-8
    z_all = torch.as_tensor((theta - t_mean) / t_std, device=device)
    lc_all = torch.as_tensor(lightcurves, device=device)

    if init_net is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            init_net = ConditionalFlowNet(dim, lightcurves.shape[1],
                                          n_transforms, hidden,
                                          raw_context=raw_context)
    net = init_net.to(device)
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    bsz = min(batch_size, n)
    block = max(1, n_epochs // (5 if verbose else 1))
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_epochs:
        idx_block = torch.as_tensor(np.stack([
            rng.choice(n, size=bsz, replace=False)
            for _ in range(min(block, n_epochs - done))]), device=device)
        for idx in idx_block:
            opt.zero_grad(set_to_none=True)
            loss = -net.log_prob(z_all[idx], lc_all[idx]).mean()
            loss.backward()
            opt.step()
        done += len(idx_block)
        if verbose:
            print(f"flow epoch {done:5d} "
                  f"nll {float(loss.detach()):.4f}")
    net.eval()
    return LFIPosterior(net=net, theta_mean=t_mean, theta_std=t_std,
                        parameter_names=tuple(parameter_names))


def simulate(analysis, u, batch=SIM_BATCH):
    """The model's magnitudes [N, F, T] (numpy) at unit-cube points u
    [N, ndim], ``batch`` points a call."""
    out = []
    with torch.no_grad():
        for chunk in u.split(batch):
            _, mags = analysis.model(analysis.priors.transform(chunk))
            out.append(mags.cpu().numpy())
    return np.concatenate(out)


def observed_representation(analysis, shape):
    """The observed photometry on the model's time grid [F, T]: each
    filter's valid detections interpolated, NaN outside their span or for
    a filter with fewer than two."""
    data = analysis.likelihood.data
    times, mags = data.times.cpu().numpy(), data.mags.cpu().numpy()
    valid, sigmas = data.valid.cpu().numpy(), data.sigmas.cpu().numpy()
    t_grid = analysis.model.sample_times.cpu().numpy()
    obs = np.full(shape, np.nan, dtype=np.float32)
    for i in range(shape[0]):
        good = valid[i] & np.isfinite(sigmas[i])
        if good.sum() < 2:
            continue
        obs[i] = np.interp(t_grid, times[i][good], mags[i][good],
                           left=np.nan, right=np.nan)
    return obs, t_grid


def pretrained_input(batch_lcs, rows, t_grid):
    """Light curves [N, F, T] -> the pretrained embedding's input
    [N, 3, 121]: the ztf rows resampled onto 121 times, non-detections and
    anything fainter at the reference's detection limit 22.0."""
    t121 = np.linspace(t_grid[0], t_grid[-1], 121)
    sel = batch_lcs[:, rows, :]
    out = np.empty((len(sel), 3, 121), dtype=np.float32)
    for i in range(len(sel)):
        for c in range(3):
            row = sel[i, c]
            good = np.isfinite(row)
            out[i, c] = (np.interp(t121, t_grid[good], row[good])
                         if good.sum() >= 2 else 22.0)
    return np.minimum(np.nan_to_num(out, nan=22.0), 22.0)


def nnanalysis(analysis, n_train=3000, n_epochs=400, n_posterior=20000,
               noise_scale=None, seed=0, verbose=True,
               pretrained_embedding=None, vicreg_pretrain=False,
               vicreg_epochs=60, timings=None):
    """Amortised-posterior analysis of an assembled ``EMAnalysis``
    (reference ``nnanalysis``, nmma/em/analysis.py:176-307).

    Draws ``n_train`` prior points with a ``torch.Generator`` seeded with
    ``seed``, simulates them through the model, adds numpy noise at the
    observed error scale, masks them with the observation's coverage and
    trains the flow; then draws ``n_posterior`` samples for the observed
    data. ``pretrained_embedding`` (a path to the reference's
    ``similarity_embedding_weights.pth``, or a loaded
    ``SimilarityEmbedding``) conditions on that frozen embedding of the ztf
    bands; ``vicreg_pretrain`` on a VICReg-pretrained one. A dict
    ``timings`` receives the seconds of each stage. Returns
    (posterior {name: [n]}, LFIPosterior).
    """
    priors, device = analysis.priors, analysis.device
    names = list(priors.sampled_names)
    gen = torch.Generator(device=device).manual_seed(seed)
    clock = {}

    t0 = time.perf_counter()
    u = priors.sample_units(gen, n_train)
    with torch.no_grad():
        theta_dict = priors.transform(u)
    theta = np.column_stack([theta_dict[k].cpu().numpy() for k in names])
    mags = simulate(analysis, u)                          # [N, F, T]
    clock["simulate_s"] = time.perf_counter() - t0

    if noise_scale is None:
        sig = analysis.likelihood.data.sigmas.cpu().numpy()
        valid = analysis.likelihood.data.valid.cpu().numpy() \
            & np.isfinite(sig)
        noise_scale = float(np.median(sig[valid])) if valid.any() else 0.1
    rng = np.random.default_rng(seed)
    lcs = mags + rng.normal(0.0, noise_scale, mags.shape)
    obs, t_grid = observed_representation(analysis, mags.shape[1:])
    # train under the observation's coverage mask, so the observed context
    # is in distribution
    lcs = np.where(np.isfinite(obs)[None], lcs, np.nan)

    t0 = time.perf_counter()
    raw_context = False
    if pretrained_embedding is not None and pretrained_embedding is not False:
        from .pretrained import SimilarityEmbedding
        ztf = ("ztfg", "ztfr", "ztfi")
        filt_list = list(analysis.filters)
        missing = [f for f in ztf if f not in filt_list]
        if missing:
            raise ValueError(
                f"pretrained_embedding needs the ztf bands; missing "
                f"{missing} (reference embedding.py bands)")
        encoder = (pretrained_embedding
                   if isinstance(pretrained_embedding, nn.Module)
                   else SimilarityEmbedding.load(pretrained_embedding,
                                                 device=device))
        rows = [filt_list.index(f) for f in ztf]
        ctx_train = encoder.represent(pretrained_input(lcs, rows, t_grid))
        ctx_obs = encoder.represent(pretrained_input(obs[None], rows,
                                                     t_grid))[0]
        lcs, obs, raw_context = ctx_train, ctx_obs, True
    elif vicreg_pretrain:
        from .vicreg import pretrain_similarity_embedding
        embedder, _ = pretrain_similarity_embedding(
            lcs, n_epochs=vicreg_epochs, seed=seed, verbose=verbose,
            device=device)
        clock["vicreg_s"] = time.perf_counter() - t0
        lcs = embedder.represent(lcs)
        obs = embedder.represent(obs[None])[0]
        raw_context = True
    t1 = time.perf_counter()
    posterior = train_flow_posterior(theta, lcs, names, n_epochs=n_epochs,
                                     seed=seed, verbose=verbose,
                                     raw_context=raw_context, device=device)
    clock["train_s"] = time.perf_counter() - t1
    t0 = time.perf_counter()
    samples = posterior.sample(n_posterior, obs, generator=gen)
    clock["sample_s"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(clock)
    return samples, posterior

