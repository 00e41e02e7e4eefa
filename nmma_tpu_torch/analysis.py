"""EM-analysis orchestration: data -> model -> likelihood -> sampler.

PyTorch counterpart of ``nmma_tpu/analysis.py`` (the reference's
``analysis_setup``, nmma/em/analysis.py:110-173, and ``bilby_sampling``,
nmma/core/base.py:290-369): a batched unit-cube log-likelihood
(prior transform -> light-curve model -> photometric likelihood ->
constraints) on one device, driven by the batched nested sampler or the
ensemble MCMC.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from . import __version__, resolve_device, tracing
from .inference import (EnsembleMCMC, EnsembleMCMCConfig, NestedSampler,
                        NestedSamplerConfig)
from .io import (cut_data_to_time_range, load_em_observations,
                 remove_nondetections, save_posterior_csv,
                 shift_to_trigger_time)
from .likelihood import EMLikelihood, PhotometryData, SystematicsModel
from .models import DetectorLightCurveModel
from .priors import PriorDict, adjust_priors_for_nmma, load_prior_file


@dataclass
class EMAnalysisConfig:
    model: str = "Me2017"
    prior_file: str = None
    light_curve_data: str = None
    trigger_time: float = 0.0
    data_tmin: float = 0.0
    data_tmax: float = np.inf
    filters: list = None
    tmin: float = 0.01
    tmax: float = 14.0
    n_tsteps: int = 150
    timescale: str = "log"       # model grid: 'log' (geomspace) | 'linear'
    extinction_law: str = "P92_SMC_host"
    time_format: str = "mjd"
    error_budget: float = 1.0
    systematics_file: str = None
    detection_limit: float = np.inf
    remove_nondetections: bool = False
    outdir: str = "outdir"
    label: str = "injection"
    # static options forwarded to the source model (only the keys its
    # mags_fn accepts), e.g. jet_type or n_theta/n_phi/n_r of TrPi2018
    model_kwargs: dict = field(default_factory=dict)
    sampler: NestedSamplerConfig = field(default_factory=NestedSamplerConfig)


class EMAnalysis:
    """Single-messenger photometric parameter estimation on one device
    (``cuda`` unless the caller passes ``device``; raises without a card)."""

    # largest batch evaluated at once: bounds the [B, F, K, N] and
    # [B, F, Q] intermediates; larger batches run in sequential chunks
    MAX_BATCH = 8192

    def __init__(self, config: EMAnalysisConfig, data=None, priors=None,
                 device=None):
        self.device = resolve_device(device)
        self.config = cfg = config

        if data is None:
            data = load_em_observations(cfg.light_curve_data,
                                        time_format=cfg.time_format)
        data = cut_data_to_time_range(data, cfg.trigger_time, cfg.data_tmin,
                                      cfg.data_tmax)
        data = shift_to_trigger_time(data, cfg.trigger_time)
        if cfg.remove_nondetections:
            data = remove_nondetections(data)
        if cfg.filters:
            data = {f: data[f] for f in cfg.filters if f in data}
        self.data_dict = data
        self.filters = sorted(data.keys())
        # detection check (reference check_detections, em/analysis.py:49-60)
        n_det = sum(int(np.sum(np.isfinite(
            np.atleast_1d(data[f]["mag_error"])))) for f in self.filters)
        if not self.filters or n_det == 0:
            raise ValueError(
                "no detections in the light-curve data after cuts/filter "
                "selection — nothing to fit (reference behavior: abort)")

        if cfg.timescale == "linear":
            sample_times = np.linspace(cfg.tmin, cfg.tmax, cfg.n_tsteps)
        else:
            sample_times = np.geomspace(cfg.tmin, cfg.tmax, cfg.n_tsteps)
        self.model = DetectorLightCurveModel(
            cfg.model, self.filters, sample_times=sample_times,
            extinction_law=cfg.extinction_law,
            model_kwargs=cfg.model_kwargs, device=self.device)

        if priors is None:
            priors = adjust_priors_for_nmma(load_prior_file(cfg.prior_file))
        self.priors: PriorDict = priors

        photo, _ = PhotometryData.from_dict(data, self.filters,
                                            device=self.device)
        systematics = SystematicsModel(
            self.filters, cfg.systematics_file, cfg.error_budget,
            model_time_range=(cfg.tmin, cfg.tmax))
        # yaml-requested systematics parameters join the sampled priors
        # (reference create_prior_from_args wiring, em/prior.py:221-244)
        sys_priors = systematics.create_priors()
        if sys_priors:
            self.priors = PriorDict({**self.priors.priors, **sys_priors})
        systematics.finalize(list(self.priors.keys()))
        self.likelihood = EMLikelihood(
            self.model, photo, self.filters, systematics,
            detection_limit=cfg.detection_limit)

    def _unit_logl(self, u):
        with tracing.span("priors.transform"):
            params = self.priors.transform(u)
        logl = self.likelihood.log_likelihood(params)
        with tracing.span("priors.constraint"):
            constraint = self.priors.constraint_log_prob(params)
        return torch.where(torch.isfinite(constraint), logl, -1e30)

    def _split_logl(self, u):
        with tracing.span("analysis.split", batch=u):
            return self._unit_logl(u)

    @torch.no_grad()
    def batched_logl(self, u_batch):
        """Unit-cube batch ``[B, ndim]`` -> log-likelihoods ``[B]``."""
        with tracing.span(tracing.LOGL_CALL, batch=u_batch):
            u = torch.as_tensor(u_batch, dtype=torch.float32,
                                device=self.device)
            if u.shape[0] <= self.MAX_BATCH:
                return self._unit_logl(u)
            return torch.cat([self._split_logl(c)
                              for c in u.split(self.MAX_BATCH)])

    # -- sampling -----------------------------------------------------------
    def checkpoint_path(self):
        cfg = self.config
        return os.path.join(cfg.outdir, f"{cfg.label}_checkpoint_resume.npz")

    def sampler(self):
        return NestedSampler(self.batched_logl, self.priors.ndim,
                             self.config.sampler, device=self.device)

    def run(self, verbose=True, checkpoint=True):
        """Nested sampling, then the result files. With ``checkpoint`` the
        run writes ``{label}_checkpoint_resume.npz`` in the output directory
        and resumes from it when it is there."""
        os.makedirs(self.config.outdir, exist_ok=True)
        ckpt = self.checkpoint_path() if checkpoint else None
        self.result = self.sampler().run(
            verbose=verbose, checkpoint_path=ckpt, resume=checkpoint)
        self.save_result()
        return self.result

    def run_mcmc(self, mcmc_config=None, verbose=True):
        """The posterior from the affine-invariant ensemble MCMC, an
        independent check of the nested sampler (no evidence unless the
        config asks for a ladder with ``evidence``). Writes
        ``{label}_mcmc_result.npz`` and ``{label}_mcmc_posterior_samples.csv``
        with the JAX package's keys, keeps the EnsembleMCMCResult as
        ``mcmc_result`` and returns the posterior dict."""
        cfg = self.config
        os.makedirs(cfg.outdir, exist_ok=True)
        mcfg = mcmc_config or EnsembleMCMCConfig(seed=cfg.sampler.seed)
        sampler = EnsembleMCMC(self.batched_logl, self.priors.ndim, mcfg,
                               device=self.device)
        res = sampler.run(verbose=verbose)
        self.mcmc_result = res
        max_rhat = float(np.nanmax(res.rhat))
        if max_rhat > 1.1:
            print(f"WARNING: ensemble-mcmc max R-hat {max_rhat:.3f} > 1.1 "
                  f"— chains not converged; increase sweeps (e.g. "
                  f"--mcmc-sweeps {2 * mcfg.sweeps}) or use the nested "
                  f"sampler", flush=True)
        post = self.posterior_samples(result=res)
        np.savez(os.path.join(cfg.outdir, f"{cfg.label}_mcmc_result.npz"),
                 acceptance=res.acceptance, rhat=res.rhat,
                 ncall=res.n_call, logz=res.logz, logz_err=res.logz_err,
                 **{f"posterior_{k}": v for k, v in post.items()})
        save_posterior_csv(
            os.path.join(cfg.outdir,
                         f"{cfg.label}_mcmc_posterior_samples.csv"), post)
        return post

    # -- posterior ----------------------------------------------------------
    def _transform_host(self, u):
        u = torch.as_tensor(np.atleast_2d(u), dtype=torch.float32,
                            device=self.device)
        return {k: v.cpu().numpy() for k, v in self.priors.transform(u).items()}

    def posterior_samples(self, result=None, rng=None):
        result = result or self.result
        idx = result.posterior_indices(rng)
        out = self._transform_host(result.samples_u[idx])
        out["log_likelihood"] = result.logl[idx]
        return out

    def bestfit_parameters(self, result=None):
        result = result or self.result
        best = self._transform_host(result.samples_u[int(np.argmax(
            result.logl))])
        return {k: float(v[0]) for k, v in best.items()}

    def save_result(self, result=None):
        cfg = self.config
        result = result or self.result
        post = self.posterior_samples(result)
        np.savez(os.path.join(cfg.outdir, f"{cfg.label}_result.npz"),
                 logz=result.logz, logz_err=result.logz_err,
                 ncall=result.ncall, niter=result.niter,
                 **{f"posterior_{k}": v for k, v in post.items()})
        # result metadata sidecar (reference stores args/versions in every
        # result, mpi_setup.py:497-512 / generation.py:42-49)
        meta = {
            "nmma_tpu_torch_version": __version__,
            "torch_version": torch.__version__,
            "device": str(self.device),
            "config": {k: (v if isinstance(v, (int, float, str, bool,
                                               type(None), list)) else str(v))
                       for k, v in asdict(cfg).items()},
            "log_evidence": result.logz,
            "log_evidence_err": result.logz_err,
            "num_likelihood_evaluations": result.ncall,
            "sampling_time_iterations": result.niter,
            "parameters": self.priors.sampled_names,
        }
        with open(os.path.join(cfg.outdir, f"{cfg.label}_result_meta.json"),
                  "w") as f:
            json.dump(meta, f, indent=2, default=str)
        save_posterior_csv(
            os.path.join(cfg.outdir, f"{cfg.label}_posterior_samples.csv"),
            post)
        bestfit = self.bestfit_parameters(result)
        bestfit["log_likelihood"] = float(result.logl.max())
        bestfit["log_evidence"] = result.logz
        bestfit["log_evidence_err"] = result.logz_err
        with open(os.path.join(cfg.outdir, f"{cfg.label}_bestfit_params.json"),
                  "w") as f:
            json.dump(bestfit, f, indent=2)
