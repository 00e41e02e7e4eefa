"""The program of an EM configuration: ``nmma_tpu_torch.analysis.EMAnalysis``
built as the command line builds it, from the run's photometry and prior
files, with the traffic's sampler settings.

A program module has one function, ``build(spec, data_path, prior_path,
out_dir, seed, device, root)``, returning ``(logl, ndim, sampler_config)``:
the batched likelihood the nested sampler calls, the number of sampled
parameters, and the ``NestedSamplerConfig`` of the cell. A configuration
names its program with ``"program"`` (``em`` when it names none).
"""

from __future__ import annotations

import numpy as np


def sampler_config(traffic, seed):
    from nmma_tpu_torch.inference import NestedSamplerConfig
    return NestedSamplerConfig(
        nlive=traffic["nlive"], n_delete=traffic["n_delete"],
        walks=traffic["walks"], dlogz=traffic["dlogz"],
        chunk_size=traffic["chunk_size"],
        target_acceptance=traffic["target_acceptance"], seed=seed)


def build(spec, data_path, prior_path, out_dir, seed, device, root):
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig

    cfg = spec.config
    data, grid = cfg["data"], cfg["model_grid"]
    analysis = EMAnalysis(EMAnalysisConfig(
        model=cfg["model"], prior_file=prior_path,
        light_curve_data=data_path, trigger_time=data["trigger_mjd"],
        data_tmin=data.get("data_tmin", 0.0),
        data_tmax=(np.inf if data.get("data_tmax") is None
                   else data["data_tmax"]),
        filters=cfg["filters"], tmin=grid["tmin"], tmax=grid["tmax"],
        n_tsteps=grid["n_tsteps"], error_budget=cfg["error_budget"],
        model_kwargs=dict(cfg.get("resolution", {})),
        outdir=out_dir, label="portbench",
        sampler=sampler_config(spec.traffic, seed)), device=device)
    return analysis.batched_logl, analysis.priors.ndim, \
        analysis.config.sampler
