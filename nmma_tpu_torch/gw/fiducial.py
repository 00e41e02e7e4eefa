"""Maximum-likelihood fiducial search for relative binning.

PyTorch counterpart of ``nmma_tpu/gw/fiducial.py``. On real data there is
no injection to build the relative-binning fiducial from, so it comes from
a stochastic search: a batch of prior draws scored by the time- and
phase-marginalised dense likelihood, then rounds of draws shrunk around the
running best, each round one batched call on the device. The draws come
from a seeded ``torch.Generator``, so the search does not reproduce the JAX
package's draws, only what it finds.
"""

from __future__ import annotations

import numpy as np
import torch

from .likelihood import GWTransientLikelihood

_U_MIN, _U_MAX = 1e-4, 1.0 - 1e-4


def find_fiducial(interferometers, priors, waveform, trigger_time,
                  n_rounds=4, batch=256, shrink=0.35, seed=0,
                  fixed=None, transform=None, device=None):
    """Search the prior volume for a high-likelihood fiducial point.

    ``priors`` is the sampling ``PriorDict`` (the search runs in its unit
    cube); ``fixed`` pins parameters (e.g. a sky location); ``transform``
    is the conversion chain applied after the prior transform. Returns the
    best parameter dict (with ``geocent_time`` refined at the peak of the
    time-marginalisation FFT) and its marginalised logL.
    """
    lk = GWTransientLikelihood(
        interferometers, waveform=waveform, trigger_time=trigger_time,
        phase_marginalization=True, time_marginalization=True,
        device=device)
    device = lk.device
    fixed = dict(fixed or {})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ndim = priors.ndim

    def parameters(u):
        params = priors.transform(u)
        params.update({k: torch.full_like(u[:, 0], float(v))
                       for k, v in fixed.items()})
        return transform(params) if transform is not None else params

    @torch.no_grad()
    def batched(u):
        logl = lk.log_likelihood_ratio(parameters(u))
        return torch.nan_to_num(logl, nan=-np.inf).cpu().numpy()

    u = _U_MIN + (_U_MAX - _U_MIN) * torch.rand(
        (batch, ndim), generator=gen, device=device)
    logls = batched(u)
    best_u = u[int(np.argmax(logls))]
    best_logl = float(np.max(logls))

    width = 0.5
    for _ in range(n_rounds):
        width *= shrink
        prop = best_u[None, :] + width * torch.randn(
            (batch, ndim), generator=gen, device=device)
        prop = torch.clamp(prop, _U_MIN, _U_MAX)
        logls = batched(prop)
        i = int(np.argmax(logls))
        if logls[i] > best_logl:
            best_logl = float(logls[i])
            best_u = prop[i]

    with torch.no_grad():
        best = parameters(best_u[None, :])
    params = {k: float(v.reshape(-1)[0]) for k, v in best.items()
              if isinstance(v, torch.Tensor) and v.numel() == 1}
    params["geocent_time"] = params.get("geocent_time", 0.0) + \
        _time_peak(lk, params)
    return params, best_logl


@torch.no_grad()
def _time_peak(lk, parameters):
    """Coalescence-time offset maximising |<d|h>(dt)| (the FFT peak)."""
    batch = {k: torch.tensor([v], dtype=torch.float32, device=lk.device)
             for k, v in parameters.items()}
    dh_t, _ = lk.time_series(batch)
    k = int(torch.argmax(torch.abs(dh_t[0])))
    n = lk._tm_n[0]
    dur = lk.ifos[0].duration
    dt = int(lk._tm_idx[k]) / n * dur
    return dt - dur if dt > dur / 2 else dt
