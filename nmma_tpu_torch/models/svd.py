"""SVD light-curve surrogates: batched MLP + projection through kernel K1.

PyTorch counterpart of ``nmma_tpu/models/svd.py`` (the reference's
``SVDLightCurveModel`` + ``eval_svd_model``, nmma/em/model.py:535-731 and
nmma/em/lightcurve_generation.py:142-217). The per-filter networks are
stacked into ``[F, ...]`` weight tensors and one call evaluates every filter
for every live point:

    x    = (theta - pmin) / (pmax - pmin)              [B, P]
    c    = relu(x . W1[f] + b1[f]) . W2[f] + b2[f]     [B, F, C]
    mags = c . va_q[f] + off_q[f]                      [B, F, Q]

where ``va_q``/``off_q`` fold the SVD basis, the min-max denormalisation and
the interpolation onto the requested times into one rank-C operator
(``operator_rankc``); the chain is kernel K1 (``ops/svd_kernel.py``).
Outside the trained time range the magnitudes are ``inf`` (reference
``calc_svd_lc`` :147-178). Only the JAX package's ``rankc`` mode is ported:
its ``dense``/``batched`` forms are TPU layout heuristics.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops import svd_kernel
from .base import SourceModel, register_source_model

ARRAY_NAMES = ("w1", "b1", "w2", "b2", "va", "mins", "maxs", "tt",
               "param_mins", "param_maxs", "filters", "parameter_names")


class SVDModelData(nn.Module):
    """Stacked surrogate of one model family, weights on one device.

    Built from the arrays of the ``.npz`` artifact: w1 [F, P, H], b1 [F, H],
    w2 [F, H, C], b2 [F, C], va [F, T, C], mins/maxs [F, T], tt [T],
    param_mins/param_maxs [P], filters [F], parameter_names [P].
    """

    def __init__(self, arrays: dict, device=None):
        super().__init__()
        missing = [k for k in ARRAY_NAMES if k not in arrays]
        if missing:
            raise KeyError(f"surrogate arrays missing {missing}")
        device = resolve_device(device)
        # the host arrays as given, for save and continued training
        self.host = {k: np.asarray(arrays[k]) for k in
                     ("tt", "va", "mins", "maxs", "param_mins",
                      "param_maxs")}
        self.filters = tuple(str(f) for f in arrays["filters"])
        self.parameter_names = tuple(str(p) for p in arrays["parameter_names"])
        self.tt = np.asarray(arrays["tt"], dtype=np.float64)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)

        param_mins = np.asarray(arrays["param_mins"], dtype=np.float32)
        param_maxs = np.asarray(arrays["param_maxs"], dtype=np.float32)
        # zero-span guard: a parameter constant across the training grid
        # normalises to 0, not 0/0 (training.svd.normalize_params)
        p_span = np.where(param_maxs > param_mins, param_maxs - param_mins,
                          np.float32(1.0))
        self.register_buffer("param_mins", f32(param_mins))
        self.register_buffer("p_span", f32(p_span))
        self.register_buffer("w1", f32(arrays["w1"]))
        self.register_buffer("b1", f32(arrays["b1"]))
        self.register_buffer("w2", f32(arrays["w2"]))
        self.register_buffer("b2", f32(arrays["b2"]))
        # denormalisation folded into the SVD basis, kept in float64 on the
        # host until an output grid is known
        va = np.asarray(arrays["va"], dtype=np.float64)
        mins = np.asarray(arrays["mins"], dtype=np.float64)
        scale = np.asarray(arrays["maxs"], dtype=np.float64) - mins
        self._va_scaled = va * scale[:, :, None]              # [F, T, C]
        self._mins = mins                                     # [F, T]
        self._ops: dict = {}

    @classmethod
    def load(cls, path, device=None) -> "SVDModelData":
        """Read an ``.npz`` surrogate artifact onto ``device``."""
        with np.load(path, allow_pickle=False) as z:
            return svd_from_numpy({k: z[k] for k in z.files}, device)

    def save(self, path):
        """Write the ``.npz`` artifact under the JAX package's keys
        (nmma_tpu/models/svd.py: SVDModelData.save), so either package
        loads what the other trained."""
        np.savez_compressed(
            path, **self.host,
            **{k: getattr(self, k).detach().cpu().numpy()
               for k in ("w1", "b1", "w2", "b2")},
            filters=np.asarray(self.filters),
            parameter_names=np.asarray(self.parameter_names))

    @property
    def n_coeff(self):
        return self.w2.shape[-1]

    def _interp_weights(self, t_days):
        """Hat-basis interpolation matrix wi [T, Q] and inside mask [Q]."""
        grid = self.tt
        t, q = len(grid), len(t_days)
        pos = np.clip(np.searchsorted(grid, t_days, side="right") - 1,
                      0, t - 2)
        frac = (t_days - grid[pos]) / (grid[pos + 1] - grid[pos])
        wi = np.zeros((t, q))
        np.add.at(wi, (pos, np.arange(q)), 1.0 - frac)
        np.add.at(wi, (pos + 1, np.arange(q)), frac)
        inside = (t_days >= grid[0]) & (t_days <= grid[-1])
        return wi, inside

    def operator_rankc(self, t_days):
        """(va_q [F, C, Q], off_q [F, Q], inside [Q]) on the weights' device
        for the output times ``t_days``: the output operator kept factored
        through the C-dim SVD bottleneck, zero at times outside the trained
        range. Cached per time-grid tensor, so the hot path never copies the
        grid back to the host."""
        hit = self._ops.get(id(t_days))
        # the entry keeps t_days alive, so its id cannot be recycled
        if hit is not None and hit[0] is t_days:
            return hit[1]
        tq = np.asarray(torch.as_tensor(t_days).cpu(), dtype=np.float64)
        wi, inside = self._interp_weights(tq)
        # times outside the trained range come out as inf (forward); the
        # JAX package extrapolates the weights there, which only amplifies
        # f32 round-off in values that are thrown away, so zero them
        wi[:, ~inside] = 0.0
        va_q = np.einsum("ftc,tq->fcq", self._va_scaled, wi)
        device = self.w1.device
        ops = (torch.as_tensor(va_q.astype(np.float32), device=device),
               torch.as_tensor((self._mins @ wi).astype(np.float32),
                               device=device),
               torch.as_tensor(inside, device=device))
        self._ops[id(t_days)] = (t_days, ops)
        return ops

    def truncated(self, n_coeff):
        """The surrogate with only its first ``n_coeff`` SVD coefficients:
        the dropped columns of W2 and b2 and rows of the basis are zeroed,
        so K1 keeps its C and the dropped terms add exact zeros (the JAX
        package's ``mag_ncoeff`` slices them away; the values agree). The
        weights are shared with ``self`` where unchanged."""
        if n_coeff is None or n_coeff >= self.n_coeff:
            return self
        out = copy.copy(self)
        out._buffers = dict(self._buffers)
        out.w2 = self.w2.clone()
        out.w2[..., n_coeff:] = 0.0
        out.b2 = self.b2.clone()
        out.b2[..., n_coeff:] = 0.0
        out._va_scaled = self._va_scaled.copy()
        out._va_scaled[..., n_coeff:] = 0.0
        out._ops = {}
        return out

    def forward(self, params, t_days):
        """params {name: [B]} -> absolute magnitudes [B, F, Q] at t_days."""
        theta = torch.stack([params[p] for p in self.parameter_names], dim=1)
        x = ((theta - self.param_mins) / self.p_span).contiguous()
        va_q, off_q, inside = self.operator_rankc(t_days)
        m = svd_kernel.svd_surrogate_mags(x, self.w1, self.b1, self.w2,
                                          self.b2, va_q, off_q)
        # beyond the trained time range the surrogate is not trusted
        return torch.where(inside, m, math.inf)


def svd_from_numpy(arrays: dict, device=None) -> SVDModelData:
    """The port's surrogate from the ``.npz`` arrays (w1 [F,4,H], b1, w2
    [F,H,C], b2, va, mins, maxs, tt, param_mins, param_maxs, filters,
    parameter_names), with its weights on ``device``."""
    return SVDModelData(arrays, device)


def make_svd_source_model(name: str, svd: SVDModelData,
                          mag_ncoeff=None) -> SourceModel:
    """Register ``svd`` as source model ``name``, with its first
    ``mag_ncoeff`` SVD coefficients when that is given."""
    svd = svd.truncated(mag_ncoeff)

    def mags_fn(params, t_days, nu_host):
        return svd(params, t_days)

    return register_source_model(SourceModel(
        name=name,
        parameter_names=tuple(svd.parameter_names),
        mags_fn=mags_fn,
        default_time_grid=lambda: svd.tt,
        citation="SVD surrogate (nmma-compatible)",
        filter_names=tuple(svd.filters),
    ))


# ---------------------------------------------------------------------------
# Ingestion of reference-format artifacts
# ---------------------------------------------------------------------------
def _read_keras_h5_dense_stack(path):
    """(W1, b1, W2, b2) of a legacy keras Sequential .h5 file: the
    reference's '_tf' models are Dense(P->H, relu) [+Dropout] ->
    Dense(H->C) (nmma/em/training.py:336-397), read with h5py (no
    tensorflow)."""
    import h5py
    with h5py.File(path, "r") as f:
        g = f["model_weights"]
        dense_names = sorted(
            (k for k in g.keys() if "dense" in k),
            key=lambda k: int(k.split("_")[-1]) if k.split("_")[-1].isdigit()
            else 0)
        mats = []
        for name in dense_names:
            sub = g[name]
            # descend to the weight datasets
            while not any(k.endswith(":0") for k in sub.keys()):
                sub = sub[list(sub.keys())[0]]
            mats.append((np.asarray(sub["kernel:0"]),
                         np.asarray(sub["bias:0"])))
    if len(mats) != 2:
        raise ValueError(f"expected 2 dense layers in {path}, got {len(mats)}")
    (w1, b1), (w2, b2) = mats
    return w1, b1, w2, b2


def ingest_nmma_svd_model(model_dir, model_name, filters=None,
                          filter_dir=None, device=None) -> SVDModelData:
    """A reference svdmodel directory as the port's ``SVDModelData`` on
    ``device`` (the CUDA card unless the caller passes one).

    The reference layout: a ``{model_name}.joblib`` core (per filter VA,
    mins, maxs, tt, n_coeff, param bounds and names;
    nmma/em/training.py:291-299) and per-filter ``{filt}.h5`` /
    ``{filt}.keras`` MLP weights, stacked into the ``[F, ...]`` tensors K1
    reads. ``filter_dir`` is where the weights live when it is not
    ``model_dir`` (the registry puts them under ``{home}/{model_name}/``,
    core/gitlab.py:225-232). ``joblib`` and ``h5py`` are imported here
    only.
    """
    device = resolve_device(device)
    import joblib
    core = joblib.load(os.path.join(model_dir, f"{model_name}.joblib"))
    filter_dir = filter_dir or model_dir
    filters = list(core.keys()) if filters is None else list(filters)

    n_coeff = min(int(core[f]["n_coeff"]) for f in filters)
    stacks = {k: [] for k in ("va", "mins", "maxs", "w1", "b1", "w2", "b2")}
    for f in filters:
        sub = core[f]
        stacks["va"].append(np.asarray(sub["VA"])[:, :n_coeff])
        stacks["mins"].append(np.asarray(sub["mins"]))
        stacks["maxs"].append(np.asarray(sub["maxs"]))
        for ext in (".h5", ".keras"):
            path = os.path.join(filter_dir, f + ext)
            if os.path.exists(path):
                break
        w1, b1, w2, b2 = _read_keras_h5_dense_stack(path)
        stacks["w1"].append(w1)
        stacks["b1"].append(b1)
        stacks["w2"].append(w2[:, :n_coeff])
        stacks["b2"].append(b2[:n_coeff])

    first = core[filters[0]]
    if not first.get("model_parameters"):
        raise ValueError(f"{model_name}.joblib names no model_parameters")
    return svd_from_numpy({
        **{k: np.stack(v) for k, v in stacks.items()},
        "tt": np.asarray(first["tt"]),
        "param_mins": np.asarray(first["param_mins"]),
        "param_maxs": np.asarray(first["param_maxs"]),
        "filters": np.asarray(filters),
        "parameter_names": np.asarray(first["model_parameters"]),
    }, device)
