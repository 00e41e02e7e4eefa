"""Batched affine-invariant ensemble MCMC (Goodman & Weare 2010).

PyTorch counterpart of ``nmma_tpu/inference/mcmc.py``: an independent
posterior sampler with the nested sampler's contract (``logl_fn: u [B, ndim]
-> logl [B]`` on the unit cube), for cross-sampler checks and the
reference's ``--sampler`` surface (nmma/em/analysis.py).

W walkers are split into red and black halves; each sweep moves one half
against the other with the stretch move (z ~ g(z) ∝ 1/sqrt(z) on [1/a, a];
accept with ln-prob (d-1) ln z + beta dlogl, the unit cube the prior), at
every rung of an optional parallel-tempering ladder, then swaps walkers
between neighbouring rungs. The walkers' state ``x [K, W, d]`` and
``logl [K, W]`` stay on the device, and so do the acceptance counts. One
``torch.Generator`` on the device is drawn in a fixed order per sweep
(z, j, accept for each half, then the two swaps), so the chain does not
depend on ``chunk_sweeps``: that only sets how often the kept sweeps are
copied to the host and progress is printed. ``evidence=True`` adds a
beta = 0 rung and a stepping-stone ln Z.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device


@dataclass
class EnsembleMCMCConfig:
    walkers: int = 256           # total walkers (even; >= 2*ndim + 2)
    sweeps: int = 1500           # full red+black update sweeps
    burn_frac: float = 0.3       # fraction of sweeps discarded
    thin: int = 2                # keep every thin-th sweep
    chunk_sweeps: int = 500      # sweeps between host copies and progress
    stretch_a: float = 2.0       # stretch-move scale parameter
    temps: int = 1               # parallel-tempering ladder size
    t_max: float = 64.0          # hottest temperature (geometric ladder)
    evidence: bool = False       # stepping-stone ln Z (appends a beta=0
    #                              prior rung; needs temps >= 2)
    seed: int = 42


class EnsembleMCMCResult(NamedTuple):
    samples_u: np.ndarray        # [n_kept * walkers, ndim] unit cube
    chain_u: np.ndarray          # [n_kept, walkers, ndim]
    logl: np.ndarray             # [n_kept * walkers]
    acceptance: float
    rhat: np.ndarray             # [ndim] split-chain Gelman-Rubin
    n_call: int
    logz: float = float("nan")   # stepping-stone evidence (evidence=True)
    logz_err: float = float("nan")

    def posterior_indices(self, rng=None):
        """MCMC draws are equal-weight posterior samples: every index, so
        the nested result's posterior path takes either result."""
        return np.arange(self.logl.shape[0])


def _rhat(chain: np.ndarray) -> np.ndarray:
    """Split-chain Gelman-Rubin over walkers, [n, W, d] -> [d]; a
    stationarity diagnostic (walkers are correlated through the ensemble
    move)."""
    n = chain.shape[0] // 2
    if n < 2:
        return np.full(chain.shape[-1], np.nan)
    halves = np.concatenate([chain[:n], chain[n:2 * n]], axis=1)
    means = halves.mean(axis=0)                       # [m, d]
    variances = halves.var(axis=0, ddof=1)            # [m, d]
    w = variances.mean(axis=0)
    b = n * means.var(axis=0, ddof=1)
    var_post = (n - 1) / n * w + b / n
    return np.sqrt(var_post / np.maximum(w, 1e-300))


class EnsembleMCMC:
    """Batched stretch-move sampler bound to a unit-cube likelihood, on the
    CUDA card unless the caller passes ``device``."""

    def __init__(self, logl_fn: Callable, ndim: int,
                 config: EnsembleMCMCConfig = EnsembleMCMCConfig(),
                 device=None):
        if config.walkers % 2:
            raise ValueError("walkers must be even (red/black halves)")
        if config.walkers < 2 * ndim + 2:
            raise ValueError(
                f"walkers={config.walkers} too few for ndim={ndim}; "
                f"need >= {2 * ndim + 2}")
        if config.evidence and config.temps < 2:
            raise ValueError("evidence=True needs a tempering ladder "
                             "(temps >= 2)")
        self.logl_fn = logl_fn
        self.ndim = ndim
        self.config = config
        self.device = resolve_device(device)

    @property
    def _betas(self):
        """Geometric f32 inverse-temperature ladder [K], beta_0 = 1 (cold);
        evidence mode appends an exact beta = 0 (prior) rung."""
        cfg = self.config
        if cfg.temps == 1:
            return torch.ones(1)
        frac = torch.arange(cfg.temps, dtype=torch.float32) / (cfg.temps - 1)
        ladder = torch.pow(torch.tensor(cfg.t_max, dtype=torch.float32), -frac)
        if cfg.evidence:
            ladder = torch.cat([ladder, torch.zeros(1)])
        return ladder

    def _half_update(self, gen, x_move, l_move, x_ref, betas):
        """Stretch-move one half [K, half, d] against the other at every
        temperature; proposals stay within their rung, and acceptance uses
        the tempered posterior beta * logl. Returns the new half, its logl
        and the cold rung's acceptances (a device scalar)."""
        a = self.config.stretch_a
        k, half, d = x_move.shape
        dev = x_move.device
        z = ((a - 1.0) * torch.rand((k, half), generator=gen, device=dev)
             + 1.0) ** 2 / a                                  # g(z)
        j = torch.randint(0, half, (k, half), generator=gen, device=dev)
        ref = torch.gather(x_ref, 1, j[:, :, None].expand(k, half, d))
        y = ref + z[:, :, None] * (x_move - ref)              # [K, half, d]
        # the sampled cube is [eps, 1-eps]: a proposal outside is rejected
        # outright (accepting a clipped point whose Hastings factor used the
        # unclipped z would break detailed balance); the clip only shields
        # the likelihood call on rows that are rejected anyway
        eps = 1e-6
        in_cube = ((y > eps) & (y < 1.0 - eps)).all(dim=-1)
        y_safe = torch.clamp(y, eps, 1.0 - eps)
        l_y = self.logl_fn(y_safe.reshape(-1, d)).reshape(k, half)
        ln_acc = (d - 1.0) * torch.log(z) + betas[:, None] * (l_y - l_move)
        accept = in_cube & (torch.log(torch.rand(
            (k, half), generator=gen, device=dev)) < ln_acc)
        x_new = torch.where(accept[:, :, None], y_safe, x_move)
        l_new = torch.where(accept, l_y, l_move)
        return x_new, l_new, accept[0].sum()

    @staticmethod
    def _swap(gen, x, logl, betas, odd):
        """Replica exchange between adjacent rungs, the even or the odd
        pairs; per-walker Metropolis swap with
        ln p = (beta_k - beta_{k+1}) (logl_{k+1} - logl_k)."""
        k_temps, w, _ = x.shape
        if k_temps - 1 <= odd:
            return x, logl
        lo = torch.arange(odd, k_temps - 1, 2, device=x.device)
        u = torch.rand((lo.numel(), w), generator=gen, device=x.device)
        d_beta = betas[lo] - betas[lo + 1]                    # [P]
        d_logl = logl[lo + 1] - logl[lo]                      # [P, w]
        do = torch.log(u) < d_beta[:, None] * d_logl          # [P, w]
        x_lo, x_hi = x[lo], x[lo + 1]
        l_lo, l_hi = logl[lo], logl[lo + 1]
        x, logl = x.clone(), logl.clone()
        x[lo] = torch.where(do[:, :, None], x_hi, x_lo)
        x[lo + 1] = torch.where(do[:, :, None], x_lo, x_hi)
        logl[lo] = torch.where(do, l_hi, l_lo)
        logl[lo + 1] = torch.where(do, l_lo, l_hi)
        return x, logl

    def _sweep(self, gen, x, logl, betas):
        w2 = self.config.walkers // 2
        xa, la, na = self._half_update(gen, x[:, :w2], logl[:, :w2],
                                       x[:, w2:], betas)
        xb, lb, nb = self._half_update(gen, x[:, w2:], logl[:, w2:], xa,
                                       betas)
        x = torch.cat([xa, xb], dim=1)
        logl = torch.cat([la, lb], dim=1)
        x, logl = self._swap(gen, x, logl, betas, 0)
        x, logl = self._swap(gen, x, logl, betas, 1)
        return x, logl, na + nb

    @torch.no_grad()
    def run(self, generator: torch.Generator = None,
            verbose: bool = False) -> EnsembleMCMCResult:
        """Run the chain from ``generator`` (a device generator seeded with
        ``config.seed`` by default)."""
        cfg = self.config
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(cfg.seed)
        betas = self._betas.to(dev)
        kt = betas.shape[0]
        x = 1e-4 + (1.0 - 2e-4) * torch.rand(
            (kt, cfg.walkers, self.ndim), generator=generator, device=dev)
        logl = self.logl_fn(x.reshape(-1, self.ndim)).reshape(
            kt, cfg.walkers)

        burn = int(cfg.sweeps * cfg.burn_frac)
        chunk = max(1, min(int(cfg.chunk_sweeps), cfg.sweeps))
        n_acc = torch.zeros((), dtype=torch.int64, device=dev)
        xs_parts, ls_parts = [], []
        done = 0
        while done < cfg.sweeps:
            nb = min(chunk, cfg.sweeps - done)
            kept_x, kept_l = [], []
            for s in range(done, done + nb):
                x, logl, na = self._sweep(generator, x, logl, betas)
                n_acc += na
                if s >= burn and (s - burn) % cfg.thin == 0:
                    kept_x.append(x[0])
                    kept_l.append(logl)
            if kept_x:
                xs_parts.append(torch.stack(kept_x).cpu().numpy())
                ls_parts.append(torch.stack(kept_l).cpu().numpy())
            done += nb
            if verbose:
                print(f"ensemble-mcmc: sweep {done}/{cfg.sweeps} cold "
                      f"acceptance {int(n_acc) / (done * cfg.walkers):.2f}",
                      flush=True)
        xs = (np.concatenate(xs_parts) if xs_parts else
              np.empty((0, cfg.walkers, self.ndim), np.float32))  # [n, W, d]
        ls_all = (np.concatenate(ls_parts) if ls_parts else
                  np.empty((0, kt, cfg.walkers), np.float32))     # [n, K, W]
        acc = int(n_acc) / (cfg.sweeps * cfg.walkers)
        rhat = _rhat(xs)
        logz, logz_err = (self._stepping_stone(ls_all, betas.cpu().numpy())
                          if cfg.evidence else (float("nan"), float("nan")))
        if verbose:
            print(f"ensemble-mcmc: {xs.shape[0]} kept sweeps x "
                  f"{cfg.walkers} walkers x {kt} temps, cold acceptance "
                  f"{acc:.2f}, max R-hat {np.nanmax(rhat):.3f}", flush=True)
        return EnsembleMCMCResult(
            samples_u=xs.reshape(-1, self.ndim),
            chain_u=xs,
            logl=ls_all[:, 0].reshape(-1),
            acceptance=acc,
            rhat=rhat,
            n_call=(int(cfg.sweeps) * cfg.walkers + cfg.walkers) * kt,
            logz=logz,
            logz_err=logz_err,
        )

    @staticmethod
    def _stepping_stone(ls_all, betas):
        """Stepping-stone evidence from the tempered chains [n, K, W]:
        ln Z = sum_j ln E_{beta_j}[exp((beta_{j+1} - beta_j) L)] over the
        ascending ladder 0 = b_0 < ... < b_M = 1 (Xie et al. 2011), each
        expectation over its own rung's kept sweeps; the error is the block
        standard error over 8 sweep blocks."""
        order = np.argsort(betas)
        bs = betas[order]                                   # ascending
        chains = ls_all[:, order, :]                        # [n, K, W]

        def lnz_of(block):
            total = 0.0
            for j in range(len(bs) - 1):
                db = bs[j + 1] - bs[j]
                lj = block[:, j, :].ravel()
                m = lj.max()
                total += db * m + np.log(
                    np.mean(np.exp(db * (lj - m))))
            return total

        lnz = lnz_of(chains)
        n = chains.shape[0]
        n_blocks = min(8, n)
        blocks = [chains[i * n // n_blocks:(i + 1) * n // n_blocks]
                  for i in range(n_blocks)]
        vals = [lnz_of(b) for b in blocks if b.shape[0] > 0]
        err = float(np.std(vals) / np.sqrt(len(vals))) if len(vals) > 1 \
            else float("nan")
        return float(lnz), err
