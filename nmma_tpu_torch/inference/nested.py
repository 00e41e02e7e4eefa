"""Batched nested sampling on a PyTorch device.

Port of ``nmma_tpu/inference/nested.py``, the replacement of the
reference's external samplers (``nmma/core/base.py:290-369``):

* the live set is a dense ``[nlive, ndim]`` unit-cube tensor on the device;
* each iteration deletes the ``n_delete`` worst points at once and refills
  them with ``n_delete`` parallel constrained random-walk chains started
  from surviving live points, preconditioned by the live-set Cholesky
  factor (the batched analogue of dynesty's 'rwalk');
* every chain step evaluates the likelihood on the whole chain batch;
* deleting the j-th of K points from a set of n shrinks ln X by 1/(n - j);
* the iteration loop is a Python loop; the host reads the state once per
  ``chunk_size`` iterations to test termination and to checkpoint, as the
  JAX package does after each jitted chunk (reference cadence semantics:
  ``check_point_delta_t``).

Proposal-scale adaptation is Robbins-Monro toward a target acceptance rate.
The random numbers come from a seeded ``torch.Generator``, so a run does
not reproduce the JAX package's draws, only its statistics. A checkpoint
holds the generator's state beside the sampler's, so a resumed run draws
what the uninterrupted one would have drawn.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch

from .. import resolve_device

NEG_INF = -1e30


@dataclass(frozen=True)
class NestedSamplerConfig:
    nlive: int = 1024
    n_delete: int = 128          # points replaced per iteration
    walks: int = 24              # MCMC steps per replacement chain
    dlogz: float = 0.1           # evidence stopping criterion (reference default)
    target_acceptance: float = 0.40
    max_iter: int = 100_000      # outer iterations (each kills n_delete)
    chunk_size: int = 20         # iterations between termination checks
    seed: int = 42
    max_seconds: float = math.inf  # wall-clock cap, tested after each chunk
    check_point_delta_t: float = 1800.0   # seconds (reference parsing.py:125)


@dataclass
class NSState:
    u_live: torch.Tensor         # [nlive, ndim]
    logl_live: torch.Tensor      # [nlive]
    log_x: torch.Tensor          # current prior-volume estimate (scalar)
    logz: torch.Tensor           # accumulated evidence (scalar)
    logzvar: torch.Tensor        # accumulated evidence variance (scalar)
    h_info: torch.Tensor         # information (scalar)
    scale: torch.Tensor          # rwalk proposal scale (scalar)
    n_accept: torch.Tensor       # accepted proposals (scalar)
    n_propose: int
    n_call: int                  # total likelihood evaluations
    it: int                      # iteration counter
    rng_state: torch.Tensor = None  # the generator's state, on checkpoints


@dataclass
class NestedSamplerResult:
    samples_u: np.ndarray        # dead + final live points, unit cube
    logl: np.ndarray
    logw: np.ndarray             # unnormalised ln posterior weights
    logz: float
    logz_err: float
    ncall: int
    niter: int
    h_info: float
    log_x: np.ndarray

    @property
    def log_weights(self):
        return self.logw - np.logaddexp.reduce(self.logw)

    def posterior_indices(self, rng=None):
        """Rejection-sample equal-weight posterior indices
        (reference: ``rejection_sample``, nmma/core/utils.py:181-183)."""
        rng = rng or np.random.default_rng(0)
        w = np.exp(self.log_weights - self.log_weights.max())
        keep = rng.uniform(size=len(w)) < w
        return np.flatnonzero(keep)


def _volume_decrements(nlive: int, n_delete: int) -> np.ndarray:
    """ln-volume shrink per deletion: 1/(n), 1/(n-1), ..."""
    return 1.0 / (nlive - np.arange(n_delete))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class NestedSampler:
    """Batched nested sampler bound to a batched log-likelihood.

    ``logl_fn`` maps ``u [B, ndim]`` (unit cube, on ``device``) to ``[B]``
    log-likelihoods; invalid points return exactly ``-1e30`` and finite
    values stay above ``-9.9e29`` (the sentinel contract of the JAX
    package's sampler). The run is on the CUDA card unless the caller
    passes ``device``.
    """

    def __init__(self, logl_fn: Callable, ndim: int,
                 config: NestedSamplerConfig = NestedSamplerConfig(),
                 device=None):
        self.logl_fn = logl_fn
        self.ndim = ndim
        self.config = config
        self.device = resolve_device(device)
        # f32 like every other tensor of the run (the JAX package's
        # jnp.asarray of the float64 decrements)
        self._decr = torch.as_tensor(
            _volume_decrements(config.nlive, config.n_delete),
            dtype=torch.float32, device=self.device)

    def init_state(self, generator: torch.Generator) -> NSState:
        cfg = self.config
        u = torch.rand((cfg.nlive, self.ndim), generator=generator,
                       device=self.device)
        logl = self.logl_fn(u)

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=self.device)

        return NSState(
            u_live=u, logl_live=logl, log_x=scalar(0.0),
            logz=scalar(NEG_INF), logzvar=scalar(0.0), h_info=scalar(0.0),
            scale=scalar(1.0), n_accept=scalar(0.0), n_propose=0,
            n_call=cfg.nlive, it=0)

    def _replace_batch(self, gen, u_live, logl_live, threshold, scale,
                       start_idx):
        """Run K parallel constrained random-walk chains; return end states."""
        cfg = self.config
        n_k = cfg.n_delete
        # live-set preconditioner: Cholesky of the unit-cube covariance
        centred = u_live - u_live.mean(dim=0)
        cov = centred.T @ centred / u_live.shape[0] \
            + 1e-10 * torch.eye(self.ndim, device=self.device)
        chol = torch.linalg.cholesky_ex(cov).L     # no host sync on info

        u = u_live[start_idx]                      # [K, ndim]
        logl = logl_live[start_idx]                # [K]
        step_norm = 2.38 / math.sqrt(self.ndim)
        # when the threshold is the -inf sentinel, accept anything in-cube
        # so the initial phase mixes as a prior random walk
        thresh_eff = torch.where(threshold <= NEG_INF * 0.99,
                                 -math.inf, threshold)
        # likelihood-plateau guard: when no live point strictly exceeds the
        # threshold, accept '>=' for this iteration (JAX package
        # nested.py:161-170)
        plateau = ~torch.any(logl_live > threshold)
        thresh_eff = torch.where(
            plateau, torch.nextafter(thresh_eff, thresh_eff.new_tensor(
                -math.inf)), thresh_eff)

        acc = torch.zeros((), device=self.device)
        for _ in range(cfg.walks):
            z = torch.randn((n_k, self.ndim), generator=gen,
                            device=self.device)
            prop = u + scale * step_norm * (z @ chol.T)
            in_cube = torch.all((prop > 0.0) & (prop < 1.0), dim=1)
            prop = torch.clamp(prop, 1e-7, 1.0 - 1e-7)
            logl_prop = self.logl_fn(prop)
            ok = in_cube & (logl_prop > thresh_eff)
            u = torch.where(ok[:, None], prop, u)
            logl = torch.where(ok, logl_prop, logl)
            acc = acc + ok.sum()
        return u, logl, acc, n_k * cfg.walks

    def _iteration(self, st: NSState, gen):
        """One deletion/refill step; returns the dead points
        (u, logl, logw, log_x after each deletion) and updates ``st``."""
        cfg = self.config
        n_k = cfg.n_delete

        # 1. worst K points, ascending logL
        neg_topk, dead_idx = torch.topk(-st.logl_live, n_k)
        dead_u = st.u_live[dead_idx]
        dead_logl = -neg_topk
        threshold = dead_logl[-1]

        # 2. volume bookkeeping (sequential shrinkage)
        log_x_after = st.log_x - torch.cumsum(self._decr, 0)
        log_x_prev = torch.cat([st.log_x[None], log_x_after[:-1]])
        log_dvol = log_x_prev + torch.log(-torch.expm1(-self._decr))
        logw = dead_logl + log_dvol

        logz_new = torch.logaddexp(st.logz, torch.logsumexp(logw, 0))
        lzterm = torch.exp(logw - logz_new) * dead_logl
        h_new = torch.where(torch.isfinite(lzterm), lzterm, 0.0).sum() \
            + torch.exp(st.logz - logz_new) * (st.h_info + st.logz) \
            - logz_new
        h_new = torch.where(torch.isfinite(h_new), h_new, st.h_info)
        # dynesty's variance recursion, per-dead-point volume decrement,
        # skipping the transients while dead points still carry -1e30
        # (JAX package nested.py:258-277)
        dh = h_new - st.h_info
        dlnx = self._decr.sum() / n_k
        sane = torch.isfinite(dh) & (dh.abs() < 1e6) & \
            (dead_logl[0] > NEG_INF * 0.99)
        logzvar_new = st.logzvar + torch.where(sane, 2.0 * dh * dlnx, 0.0)

        # 3. chain starts: uniform draws among survivors, re-drawn twice on
        # collision with a dead point, the best point as the fallback
        draws = torch.randint(0, cfg.nlive, (3, n_k), generator=gen,
                              device=self.device)
        alive = st.logl_live > threshold
        alive = torch.where(torch.any(alive), alive,
                            st.logl_live >= threshold)
        start = torch.argmax(st.logl_live).expand(n_k)
        for attempt in (2, 1, 0):
            cand = draws[attempt]
            start = torch.where(alive[cand], cand, start)
        u_new, logl_new, acc, n_prop = self._replace_batch(
            gen, st.u_live, st.logl_live, threshold, st.scale, start)

        st.u_live = st.u_live.index_copy(0, dead_idx, u_new)
        st.logl_live = st.logl_live.index_copy(0, dead_idx, logl_new)

        # 4. Robbins-Monro scale adaptation toward the target acceptance
        lr = 1.0 / math.sqrt(1.0 + st.it)
        st.scale = torch.clamp(
            st.scale * torch.exp(lr * (acc / n_prop - cfg.target_acceptance)),
            1e-4, 10.0)
        st.log_x = log_x_after[-1]
        st.logz, st.logzvar, st.h_info = logz_new, logzvar_new, h_new
        st.n_accept = st.n_accept + acc
        st.n_propose += n_prop
        st.n_call += n_prop
        st.it += 1
        return dead_u, dead_logl, logw, log_x_after

    def run(self, verbose=True, checkpoint_path=None,
            resume=False) -> NestedSamplerResult:
        """Sample until ``dlogz``, ``max_iter`` or ``max_seconds``.

        With ``checkpoint_path`` the state is written there every
        ``check_point_delta_t`` seconds (tested after each chunk), and
        SIGTERM, SIGINT and SIGUSR1 write it and end the run after the
        chunk in progress (reference signal discipline,
        nmma/core/mpi_setup.py:639-649); the handlers are restored on
        return. ``resume=True`` continues from the checkpoint when one
        exists."""
        interrupted = {"flag": False}
        old_handlers = {}
        if checkpoint_path is not None:
            import signal

            def _handler(signum, frame):
                interrupted["flag"] = True

            for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1):
                try:
                    old_handlers[sig] = signal.signal(sig, _handler)
                except (ValueError, OSError):   # not the main thread
                    pass
        try:
            return self._run_loop(verbose, checkpoint_path, resume,
                                  interrupted)
        finally:
            if old_handlers:
                import signal
                for sig, handler in old_handlers.items():
                    signal.signal(sig, handler)

    def _run_loop(self, verbose, checkpoint_path, resume, interrupted):
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        loaded = self.load_checkpoint(checkpoint_path) \
            if resume and checkpoint_path is not None else None
        if loaded is not None:
            st, dead = loaded
            gen.set_state(st.rng_state)
        else:
            st, dead = self.init_state(gen), ([], [], [], [])
        t0 = t_last_ckpt = time.time()
        n_call_0 = st.n_call
        while st.it < cfg.max_iter:
            chunk = ([], [], [], [])
            for _ in range(min(cfg.chunk_size, cfg.max_iter - st.it)):
                for parts, new in zip(chunk, self._iteration(st, gen)):
                    parts.append(new)
            # one device -> host transfer per chunk
            for parts, new in zip(dead, chunk):
                parts.append(_host(torch.stack(new)).reshape(
                    -1, *new[0].shape[1:]))
            logz = float(st.logz)
            logz_remain = float(st.logl_live.max()) + float(st.log_x)
            dlogz = float(np.logaddexp(logz, logz_remain) - logz)
            elapsed = time.time() - t0
            if verbose:
                eff = float(st.n_accept) / max(st.n_propose, 1)
                rate = (st.n_call - n_call_0) / max(elapsed, 1e-9)
                print(f"it={st.it:6d} ncall={st.n_call:9d} "
                      f"logz={logz:10.3f} dlogz={dlogz:8.4f} "
                      f"eff={eff:5.3f} scale={float(st.scale):7.4f} "
                      f"evals/s={rate:8.0f}", flush=True)
            if checkpoint_path is not None and (
                    interrupted["flag"]
                    or time.time() - t_last_ckpt > cfg.check_point_delta_t):
                st.rng_state = gen.get_state()
                self.save_checkpoint(checkpoint_path, st, dead)
                t_last_ckpt = time.time()
            if interrupted["flag"]:
                print("interrupt received: checkpoint written, exiting run "
                      "loop (resume with resume=True)", flush=True)
                break
            if dlogz < cfg.dlogz or elapsed > cfg.max_seconds:
                break
        return self._finalise(st, *dead)

    # -- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, path, state: NSState, dead):
        """Write the state, the generator's state and the dead points to
        ``path`` (an .npz), atomically by ``os.replace``."""
        arrays = {f.name: _host(getattr(state, f.name))
                  for f in fields(NSState)}
        tmp = str(path) + ".tmp.npz"
        np.savez(tmp, **arrays, **{
            name: np.concatenate(parts) if parts else empty
            for name, parts, empty in zip(
                ("dead_u", "dead_logl", "dead_logw", "dead_logx"), dead,
                (np.zeros((0, self.ndim), np.float32),
                 *[np.zeros(0, np.float32)] * 3))})
        os.replace(tmp, str(path))

    def load_checkpoint(self, path):
        """(state, dead points) from a checkpoint, the state's tensors on
        the sampler's device and ``rng_state`` on the host; None when
        ``path`` does not exist."""
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            values = {}
            for f in fields(NSState):
                a = z[f.name]
                if f.name == "rng_state":
                    values[f.name] = torch.from_numpy(a.copy())
                elif f.name in ("n_propose", "n_call", "it"):
                    values[f.name] = int(a)
                else:
                    values[f.name] = torch.from_numpy(a.copy()).to(
                        self.device)
            dead = tuple([z[name]] for name in (
                "dead_u", "dead_logl", "dead_logw", "dead_logx"))
        return NSState(**values), dead

    def _finalise(self, state, dead_u, dead_logl, dead_logw, dead_logx):
        """Result from the final live set and the dead points, on the host
        in numpy exactly as the JAX package's ``_finalise``."""
        cfg = self.config
        # final live points: uniform volume assignment X_final/nlive each
        u_live = _host(state.u_live)
        logl_live = _host(state.logl_live)
        order = np.argsort(logl_live)
        log_x_final = float(state.log_x)
        live_logw = logl_live[order] + log_x_final - np.log(cfg.nlive)
        live_logx = np.full(cfg.nlive, log_x_final)

        samples_u = np.concatenate(list(dead_u) + [u_live[order]], axis=0)
        logl = np.concatenate(list(dead_logl) + [logl_live[order]])
        logw = np.concatenate(list(dead_logw) + [live_logw])
        logx = np.concatenate(list(dead_logx) + [live_logx])

        logz = float(np.logaddexp.reduce(logw))
        h = float(state.h_info)
        # accumulated dynesty-style variance; classic sqrt(H/nlive) as the
        # fallback when the recursion is degenerate
        lzvar = float(state.logzvar)
        if np.isfinite(lzvar) and lzvar > 0.0:
            logz_err = float(np.sqrt(lzvar))
        else:
            logz_err = float(np.sqrt(max(h, 0.0) / cfg.nlive))
        return NestedSamplerResult(
            samples_u=samples_u, logl=logl, logw=logw, logz=logz,
            logz_err=logz_err, ncall=int(state.n_call),
            niter=int(state.it), h_info=h, log_x=logx,
        )
