"""Combined light-curve models: flux-sum stacking of sub-models.

PyTorch counterpart of ``nmma_tpu/models/combined.py`` (the reference's
``CombinedLightCurveModelContainer`` / ``stack_magnitudes``,
nmma/em/model.py:1342-1510): sub-model magnitudes combine as fluxes,
    m_total = -2.5 log10( sum_i 10^(-0.4 m_i) ),
evaluated as a logsumexp so inf (no-flux) rows contribute exactly zero. All
sub-models run on the shared sample-time grid.
"""

from __future__ import annotations

import math

import torch

from .base import SourceModel, _filter_kwargs, register_source_model

_LN10_04 = 0.4 * math.log(10.0)


def stack_magnitudes(mag_rows):
    """Flux-sum a list of [..., F, T] magnitude tensors (logsumexp form)."""
    stacked = torch.stack(mag_rows)                  # [N, ..., F, T]
    return -torch.logsumexp(-_LN10_04 * stacked, dim=0) / _LN10_04


def make_combined_source_model(name, sub_models, register=True):
    """Compose SourceModels into one flux-summed model.

    Parameter names are the union; each sub-model reads its own keys from
    the shared dict. The model is banded when any sub-model is, and the
    bandpass quadrature goes only to the banded sub-models; the other static
    options go to each sub-model whose ``mags_fn`` accepts them.
    """
    sub_models = list(sub_models)
    param_names = []
    for sub in sub_models:
        for key in sub.parameter_names:
            if key not in param_names:
                param_names.append(key)

    def mags_fn(params, t_days, nu_host, filters=None, nu_nodes=None,
                nu_weights=None, **model_kwargs):
        rows = []
        for sub in sub_models:
            kw = _filter_kwargs(sub.mags_fn, model_kwargs)
            if sub.banded and nu_nodes is not None:
                kw.update(nu_nodes=nu_nodes, nu_weights=nu_weights)
            if sub.needs_filters:
                kw["filters"] = filters
            m = sub.mags_fn(params, t_days, nu_host, **kw)      # [B, F_s, T]
            if sub.filter_names is not None and filters is not None:
                src = list(sub.filter_names)
                m = torch.stack([m[:, src.index(f)] if f in src
                                 else torch.full_like(m[:, 0], math.inf)
                                 for f in filters], dim=1)
            rows.append(m)
        return stack_magnitudes(rows)

    model = SourceModel(
        name=name,
        parameter_names=tuple(param_names),
        mags_fn=mags_fn,
        banded=any(sub.banded for sub in sub_models),
        needs_filters=True,
        default_time_grid=sub_models[0].default_time_grid,
        citation=" + ".join(s.name for s in sub_models),
    )
    if register:
        register_source_model(model)
    return model
