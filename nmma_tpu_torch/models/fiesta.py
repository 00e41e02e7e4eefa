"""fiesta surrogates: per-filter light-curve MLPs and flux-grid MLPs,
batch-first.

PyTorch counterpart of ``nmma_tpu/models/fiesta.py`` (the reference's
``FiestaModel`` / ``FiestaKilonovaModel`` / ``FiestaGRBModel``,
nmma/em/model.py:411-491,734-801,846-888, which wrap the external ``fiesta``
package). A surrogate is ingested once into plain stacked arrays
(``FiestaSurrogateData``, host numpy, the same fields and native ``.npz`` as
the JAX package's) and evaluated for a ``[B]`` batch of live points:

* ``kind="lightcurve"`` (fiesta ``BullaLightcurveModel``): one MLP per
  filter, stacked into ``[F, d_in, d_out]`` weights; every layer is one
  batched product ``[F, B, d_in] -> [F, B, d_out]`` with ReLU between
  layers, giving absolute magnitudes on the trained time grid;
* ``kind="flux"`` (fiesta ``BullaFlux`` / ``AfterglowFlux``): one network
  ``[B, P] -> [B, Nu*T]`` giving ``log10 F_nu`` (mJy at 10 pc, source frame)
  on a ``[Nu, T]`` grid, read off by linear interpolation in log frequency
  at each live point's redshifted filter frequencies (or integrated over
  the filters' quadrature nodes); a frequency outside the grid gets the
  log-flux floor -99, an infinite magnitude for the likelihood;
* CVAE decoders reduce to the same MLP form: at inference the latent input
  is the prior mean (zeros), so its rows of the first kernel drop.

The output is interpolated onto the requested times (inf outside the
trained range), and the GRB sanity gate (``alphaWing -> thetaWing``, the
thetaWing and thetaCore window, ``epsilon_e + epsilon_B <= 1``) sets a live
point's whole light curve to inf. fiesta's networks are plain products
outside any Pallas kernel in the JAX package, so no hand-written kernel
lies on this path. The weights move to a device on first use there.

Two on-disk formats load: the native ``.npz`` of
``FiestaSurrogateData.save``, and fiesta's own artifact directories
(pickled metadata, networks as flax msgpack or pickled parameter trees),
read without flax (``io/msgpack.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..io.msgpack import msgpack_restore
from ..ops.interp import masked_interp_sorted_fill
from .base import SourceModel, register_source_model

FIESTA_ENV = "NMMA_FIESTA_SURROGATES"
_LN10 = math.log(10.0)
# log10 as ln x times 1/ln 10, the form XLA lowers jnp.log10 to: it reads the
# frequency grid's cells as the JAX package does
_INV_LN10 = 1.0 / _LN10
_LOG_FLUX_FLOOR = -99.0


@dataclass(frozen=True)
class FiestaSurrogateData:
    """Stacked surrogate arrays of one fiesta-style model (host numpy)."""

    name: str
    kind: str                       # "lightcurve" | "flux"
    parameter_names: tuple          # P names, network input order
    parameter_distributions: dict   # name -> (lo, hi) trained support
    times: np.ndarray               # [T] source-frame days
    x_min: np.ndarray               # [P] input min-max scaler
    x_max: np.ndarray               # [P]
    # layer weights, input -> output. lightcurve: per-filter stacks
    # [F, d_in, d_out] and [F, d_out]; flux: one network [d_in, d_out]
    kernels: tuple
    biases: tuple
    y_min: np.ndarray               # output scaler; lightcurve [F, T],
    y_max: np.ndarray               # flux [Nu*T] (or broadcastable)
    filters: tuple | None = None    # lightcurve kind
    nus: np.ndarray | None = None   # [Nu] Hz, flux kind
    # f32 tensors on each device used so far
    _on: dict = field(default_factory=dict, init=False, repr=False,
                      compare=False)

    def __post_init__(self):
        if self.kind not in ("lightcurve", "flux"):
            raise ValueError(f"unknown fiesta surrogate kind {self.kind!r}")
        if self.kind == "lightcurve" and not self.filters:
            raise ValueError("lightcurve surrogate needs filters")
        if self.kind == "flux" and self.nus is None:
            raise ValueError("flux surrogate needs a frequency grid")

    # -- persistence (the JAX package's native .npz) -----------------------
    def save(self, path):
        meta = {
            "name": self.name,
            "kind": self.kind,
            "parameter_names": list(self.parameter_names),
            "parameter_distributions": {
                k: [float(v[0]), float(v[1])]
                for k, v in self.parameter_distributions.items()},
            "filters": list(self.filters) if self.filters else None,
            "n_layers": len(self.kernels),
        }
        arrays = {
            "meta_json": np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8),
            "times": self.times, "x_min": self.x_min, "x_max": self.x_max,
            "y_min": self.y_min, "y_max": self.y_max,
        }
        if self.nus is not None:
            arrays["nus"] = self.nus
        for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
            arrays[f"kernel_{i}"] = k
            arrays[f"bias_{i}"] = b
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path, device=None):
        """Read a native ``.npz``; its weights go to ``device`` (default
        the CUDA card)."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            n = int(meta["n_layers"])
            data = cls(
                name=meta["name"], kind=meta["kind"],
                parameter_names=tuple(meta["parameter_names"]),
                parameter_distributions={
                    k: tuple(v)
                    for k, v in meta["parameter_distributions"].items()},
                times=z["times"], x_min=z["x_min"], x_max=z["x_max"],
                kernels=tuple(z[f"kernel_{i}"] for i in range(n)),
                biases=tuple(z[f"bias_{i}"] for i in range(n)),
                y_min=z["y_min"], y_max=z["y_max"],
                filters=tuple(meta["filters"]) if meta["filters"] else None,
                nus=z["nus"] if "nus" in z.files else None)
        data.tensors(resolve_device(device))
        return data

    def check_vs_priors(self, priors):
        """Trained-support containment check (reference
        ``FiestaModel.check_vs_priors``, nmma/em/model.py:434-445)."""
        problems = []
        for key, (lo, hi) in self.parameter_distributions.items():
            prior = getattr(priors, "priors", priors).get(key)
            if prior is None:
                continue
            p_lo = getattr(prior, "minimum", None)
            p_hi = getattr(prior, "maximum", None)
            below = p_lo is not None and p_lo < lo
            above = p_hi is not None and p_hi > hi
            if below or above:
                problems.append(f"{key}: prior [{p_lo}, {p_hi}] outside "
                                f"trained support [{lo}, {hi}]")
        if problems:
            raise ValueError("fiesta surrogate support violated: "
                             + "; ".join(problems))

    # -- the batched forward pass ----------------------------------------
    def tensors(self, device):
        """The f32 weights, scalers and grids on ``device`` (made once)."""
        key = str(device)
        if key not in self._on:
            def f32(a):
                return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                       device=device)
            t = {"x_min": f32(self.x_min), "x_max": f32(self.x_max),
                 "y_min": f32(self.y_min), "y_max": f32(self.y_max),
                 "times": f32(self.times),
                 "kernels": [f32(k) for k in self.kernels],
                 "biases": [f32(b) for b in self.biases]}
            if self.kind == "lightcurve":
                # [F, 1, d_out]: the per-filter bias of the [F, B, d] layout
                t["biases"] = [b[:, None, :] for b in t["biases"]]
                t["y_min"] = t["y_min"][:, None, :]
                t["y_max"] = t["y_max"][:, None, :]
            else:
                t["log_nu"] = torch.log(f32(self.nus)) * _INV_LN10
            self._on[key] = t
        return self._on[key]

    def magnitudes(self, params, t_days, nu_host, nu_nodes=None,
                   nu_weights=None):
        """params {name: [B]} -> absolute AB magnitudes [B, F, Q] at
        ``t_days`` [Q]; ``nu_host`` [B, F] are the host-frame filter
        frequencies (the flux kind), or ``nu_nodes`` [B, F, K] with
        ``nu_weights`` [F, K] their band quadrature."""
        t = self.tensors(t_days.device)
        ok = grb_gate(params)
        theta = torch.stack([params[k] for k in self.parameter_names], 1)
        x = (theta - t["x_min"]) / (t["x_max"] - t["x_min"])     # [B, P]
        if self.kind == "lightcurve":
            mags = _lightcurve_forward(x, t)                     # [B, F, T]
        else:
            mags = _flux_forward(x, t, len(self.nus), len(self.times),
                                 nu_host, nu_nodes, nu_weights)
        out = masked_interp_sorted_fill(t_days, t["times"], mags, math.inf)
        return torch.where(ok[:, None, None], out, math.inf)


def grb_gate(params):
    """[B] bool: the GRB-mixin sanity window of each live point (reference
    GRBMixin, nmma/em/model.py:805-845): thetaWing = alphaWing thetaCore
    when alphaWing is sampled, thetaWing <= pi/2, thetaCore > pi/1800 and
    epsilon_e + epsilon_B <= 1 (linear or log10 keys)."""
    p = dict(params)
    like = next(iter(p.values()))
    ok = torch.ones(like.shape, dtype=torch.bool, device=like.device)
    if "alphaWing" in p and "thetaCore" in p:
        p["thetaWing"] = p["alphaWing"] * p["thetaCore"]
    if "thetaWing" in p and "thetaCore" in p:
        ok = ok & (p["thetaWing"] <= math.pi / 2) \
            & (p["thetaCore"] > math.pi / 1800.0)
    eps_tot = None
    if "epsilon_e" in p and "epsilon_B" in p:
        eps_tot = p["epsilon_e"] + p["epsilon_B"]
    elif "log10_epsilon_e" in p and "log10_epsilon_B" in p:
        eps_tot = 10.0 ** p["log10_epsilon_e"] + 10.0 ** p["log10_epsilon_B"]
    if eps_tot is not None:
        ok = ok & (eps_tot <= 1.0)
    return ok


def _lightcurve_forward(x, t):
    """Per-filter MLPs: x [B, P] -> magnitudes [B, F, T], one batched
    product per layer over the [F, d_in, d_out] stacks."""
    h = torch.matmul(x, t["kernels"][0]) + t["biases"][0]         # [F, B, d]
    for w, b in zip(t["kernels"][1:], t["biases"][1:]):
        h = torch.baddbmm(b, torch.relu(h), w)
    mags = h * (t["y_max"] - t["y_min"]) + t["y_min"]
    return mags.transpose(0, 1)


def _flux_forward(x, t, n_nu, n_t, nu_host, nu_nodes, nu_weights):
    """One network x [B, P] -> log10 F_nu [B, Nu, T], read at the filters'
    frequencies (or integrated over their nodes) -> magnitudes [B, F, T]."""
    h = x
    last = len(t["kernels"]) - 1
    for i, (w, b) in enumerate(zip(t["kernels"], t["biases"])):
        h = torch.addmm(b, h, w)
        if i != last:
            h = torch.relu(h)
    y = h * (t["y_max"] - t["y_min"]) + t["y_min"]
    log_flux = y.reshape(-1, n_nu, n_t)
    grid = t["log_nu"]

    def flux_rows(nu_q):
        """log10 F_nu at each live point's queries nu_q [B, Q] -> [B, Q, T];
        the floor outside the grid (constant extrapolation would feed
        finite, wrong magnitudes to the likelihood)."""
        log_nu_q = torch.log(nu_q) * _INV_LN10
        idx = torch.clamp(torch.searchsorted(grid, log_nu_q.contiguous())
                          - 1, 0, n_nu - 2)
        lo, hi = grid[idx], grid[idx + 1]
        w = torch.clamp((log_nu_q - lo) / (hi - lo), 0.0, 1.0)[..., None]
        gather = idx[..., None].expand(-1, -1, n_t)
        rows = (1 - w) * log_flux.gather(1, gather) \
            + w * log_flux.gather(1, gather + 1)
        in_grid = ((log_nu_q >= grid[0]) & (log_nu_q <= grid[-1]))[..., None]
        return torch.where(in_grid, rows, _LOG_FLUX_FLOOR)

    if nu_nodes is not None:
        # transmission-weighted band integral over the flux grid (the
        # quadrature of the blackbody and spectral models)
        n_b, n_f, n_k = nu_nodes.shape
        log_f_nodes = flux_rows(nu_nodes.reshape(n_b, n_f * n_k)).reshape(
            n_b, n_f, n_k, n_t) * _LN10                              # ln F
        logw = torch.log(torch.clamp(nu_weights, min=1e-30))[:, :, None]
        log_f = torch.logsumexp(log_f_nodes + logw, dim=2) / _LN10
    else:
        log_f = flux_rows(nu_host)                                   # [B, F, T]
    # log10 F_nu [mJy at 10 pc] -> absolute AB magnitude
    return -2.5 * log_f + 16.4


def fiesta_from_numpy(fields: dict, device=None) -> FiestaSurrogateData:
    """The port's surrogate from the numpy fields of the JAX package's
    ``FiestaSurrogateData`` (``dataclasses.asdict`` of it), with its weights
    on ``device`` (default the CUDA card)."""
    names = [f.name for f in dataclasses.fields(FiestaSurrogateData)
             if f.init]
    data = FiestaSurrogateData(**{k: fields[k] for k in names if k in fields})
    data.tensors(resolve_device(device))
    return data


# name -> FiestaSurrogateData of every registered fiesta source, so the
# trained-support guard applies on reuse too (a model registered by an
# earlier run in the same process skips the resolution path)
_REGISTERED: dict = {}


def registered_fiesta_data(name):
    """The FiestaSurrogateData behind a registered source model, if any."""
    return _REGISTERED.get(name)


def make_fiesta_source_model(name: str,
                             data: FiestaSurrogateData) -> SourceModel:
    """Register ``data`` as source model ``name``. The flux kind is
    banded: the detector hands it the filters' quadrature; the lightcurve
    kind emits band magnitudes per trained filter."""
    if data.kind == "flux":
        def mags_fn(params, t_days, nu_host, nu_nodes=None,
                    nu_weights=None):
            return data.magnitudes(params, t_days, nu_host, nu_nodes,
                                   nu_weights)
    else:
        def mags_fn(params, t_days, nu_host):
            return data.magnitudes(params, t_days, nu_host)

    model = register_source_model(SourceModel(
        name=name,
        parameter_names=tuple(data.parameter_names),
        mags_fn=mags_fn,
        default_time_grid=lambda: np.asarray(data.times),
        banded=data.kind == "flux",
        citation="fiesta surrogate (nmma FiestaModel family, "
                 "em/model.py:411-491)",
        filter_names=tuple(data.filters) if data.filters else None,
    ))
    _REGISTERED[name] = data
    return model


# ---------------------------------------------------------------------------
# ingestion of fiesta's own artifact directories
# ---------------------------------------------------------------------------

def _collect_dense_layers(tree):
    """The Dense (kernel, bias) pairs of a flax parameter tree, in order.

    A CVAE tree holds encoder and decoder submodules; inference needs only
    the decoder (the encoder maps training targets to the latent), so when
    a decoder subtree exists only its layers are kept."""
    layers = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and "bias" in node:
                layers[path] = (np.asarray(node["kernel"]),
                                np.asarray(node["bias"]))
            else:
                for k, v in node.items():
                    walk(v, path + (str(k),))

    walk(tree, ())
    dec = {p: kb for p, kb in layers.items()
           if any("decoder" in part.lower() for part in p)}
    if dec:
        layers = dec

    def order_key(path):
        # Dense_0, Dense_1, ... (flax linen naming) or layers_0 ...
        tail = path[-1] if path else ""
        digits = "".join(c for c in tail if c.isdigit())
        return (int(digits) if digits else 0, path)

    ordered = [layers[k] for k in sorted(layers, key=order_key)]
    if not ordered:
        raise ValueError("no Dense kernel/bias pairs found in params tree")
    return ordered


def _reduce_cvae_latent(layers, expected_in):
    """Drop the latent rows of a CVAE decoder's first kernel.

    At inference the latent is the prior mean (zeros), so the decoder is a
    plain parameter -> output MLP once the latent block of the first kernel
    is deleted. The latent is assumed to take the leading input slots
    (decoder(concat(z, x))), as in the JAX package; no real fiesta CVAE
    artifact is at hand to confirm it."""
    k0, b0 = layers[0]
    if k0.shape[0] == expected_in:
        return layers
    if k0.shape[0] < expected_in:
        raise ValueError(
            f"fiesta network input dim {k0.shape[0]} < expected "
            f"{expected_in} parameters")
    return [(k0[k0.shape[0] - expected_in:], b0)] + list(layers[1:])


def _load_network_file(path):
    """One fiesta network file -> ordered [(kernel, bias), ...]: flax's
    msgpack (``flax.serialization.to_bytes``) or a pickled parameter
    tree."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        tree = msgpack_restore(blob)
    except ValueError:
        tree = pickle.loads(blob)
    if isinstance(tree, dict) and isinstance(tree.get("params"), dict):
        tree = tree["params"]
    return _collect_dense_layers(tree)


def _scaler_bounds(obj):
    """(min, max) arrays from a fiesta MinMaxScalerJax-style object or
    dict."""
    for lo_key, hi_key in (("min_val", "max_val"), ("min", "max"),
                           ("data_min_", "data_max_")):
        lo = obj.get(lo_key) if isinstance(obj, dict) else \
            getattr(obj, lo_key, None)
        hi = obj.get(hi_key) if isinstance(obj, dict) else \
            getattr(obj, hi_key, None)
        if lo is not None and hi is not None:
            return np.asarray(lo, dtype=np.float64), \
                np.asarray(hi, dtype=np.float64)
    raise ValueError(f"unrecognized scaler object {type(obj)!r}")


def ingest_fiesta_directory(directory, name, filters=None, device=None):
    """A fiesta surrogate directory as :class:`FiestaSurrogateData`, its
    weights on ``device`` (default the CUDA card).

    Layout (fiesta's save conventions; the reference's FiestaKilonovaModel
    tries ``{dir}`` then ``{dir}/KN/{model}/model``, nmma/em/model.py:
    791-796): ``{name}_metadata.pkl`` (or ``metadata.pkl``) with times,
    parameter_names, parameter_distributions and scalers, and the network
    weights in ``{filt}.pkl`` per filter (lightcurve models) or
    ``{name}.pkl`` (flux models)."""
    device = resolve_device(device)
    meta_path = None
    for cand in (f"{name}_metadata.pkl", "metadata.pkl",
                 f"{name}_metadata.pickle"):
        p = os.path.join(directory, cand)
        if os.path.exists(p):
            meta_path = p
            break
    if meta_path is None:
        raise FileNotFoundError(
            f"no fiesta metadata pickle for {name!r} in {directory!r}")
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)

    times = np.asarray(meta["times"], dtype=np.float64)
    parameter_names = tuple(meta["parameter_names"])

    def _support(v):
        # (lo, hi) pairs, scalars or trained-grid arrays: the value range
        arr = np.asarray(v, dtype=np.float64).ravel()
        return float(arr.min()), float(arr.max())

    dists = {k: _support(v)
             for k, v in dict(meta.get("parameter_distributions",
                                       {})).items()}
    x_lo, x_hi = _scaler_bounds(meta.get("X_scaler", meta))

    nus = meta.get("nus")
    if nus is not None:                      # flux surrogate
        net_path = os.path.join(directory, f"{name}.pkl")
        layers = _reduce_cvae_latent(_load_network_file(net_path),
                                     len(parameter_names))
        y_lo, y_hi = _scaler_bounds(meta.get("y_scaler", meta))
        data = FiestaSurrogateData(
            name=name, kind="flux", parameter_names=parameter_names,
            parameter_distributions=dists, times=times,
            x_min=x_lo, x_max=x_hi,
            kernels=tuple(k for k, _ in layers),
            biases=tuple(b for _, b in layers),
            y_min=np.asarray(y_lo), y_max=np.asarray(y_hi),
            nus=np.asarray(nus, dtype=np.float64))
        data.tensors(device)
        return data

    # lightcurve surrogate: one network per filter, stacked
    if filters is None:
        filters = meta.get("filters")
    if not filters:
        raise ValueError("lightcurve surrogate: pass filters or include "
                         "them in the metadata")
    y_scalers = meta.get("y_scaler", {})
    per_filter, y_lo_rows, y_hi_rows = [], [], []
    for filt in filters:
        net_path = os.path.join(directory, f"{filt}.pkl")
        if not os.path.exists(net_path):
            raise FileNotFoundError(f"missing network file {net_path}")
        per_filter.append(_reduce_cvae_latent(_load_network_file(net_path),
                                              len(parameter_names)))
        sc = y_scalers.get(filt) if isinstance(y_scalers, dict) else None
        lo, hi = _scaler_bounds(sc) if sc is not None else (
            np.zeros(len(times)), np.ones(len(times)))
        y_lo_rows.append(np.broadcast_to(lo, (len(times),)))
        y_hi_rows.append(np.broadcast_to(hi, (len(times),)))
    n_layers = {len(ls) for ls in per_filter}
    if len(n_layers) != 1:
        raise ValueError("per-filter networks disagree in depth")
    depth = n_layers.pop()
    data = FiestaSurrogateData(
        name=name, kind="lightcurve", parameter_names=parameter_names,
        parameter_distributions=dists, times=times,
        x_min=x_lo, x_max=x_hi,
        kernels=tuple(np.stack([ls[i][0] for ls in per_filter])
                      for i in range(depth)),
        biases=tuple(np.stack([ls[i][1] for ls in per_filter])
                     for i in range(depth)),
        y_min=np.stack(y_lo_rows), y_max=np.stack(y_hi_rows),
        filters=tuple(filters))
    data.tensors(device)
    return data


def load_fiesta_surrogate(model_name, surrogates_dir=None, filters=None,
                          device=None):
    """Resolve and load a fiesta surrogate by name, its weights on
    ``device`` (default the CUDA card).

    Search order (the reference's constructor fallbacks, nmma/em/model.py:
    791-796, 869-881): the directory itself, ``{model}``, then
    ``KN/{model}/model`` and ``GRB/{model}/model`` under the surrogates root
    (``$NMMA_FIESTA_SURROGATES`` by default). A native ``{model}.npz`` is
    preferred where present."""
    root = surrogates_dir or os.environ.get(FIESTA_ENV)
    if not root:
        raise FileNotFoundError(
            f"fiesta surrogates dir not set: pass surrogates_dir or set "
            f"${FIESTA_ENV}")
    candidates = [
        root,
        os.path.join(root, model_name),
        os.path.join(root, "KN", model_name, "model"),
        os.path.join(root, "GRB", model_name, "model"),
    ]
    errors = []
    for d in candidates:
        npz = os.path.join(d, f"{model_name}.npz")
        if os.path.exists(npz):
            return FiestaSurrogateData.load(npz, device=device)
        if os.path.isdir(d):
            try:
                return ingest_fiesta_directory(d, model_name,
                                               filters=filters,
                                               device=device)
            except (FileNotFoundError, ValueError) as e:
                # a malformed candidate (a stray metadata.pkl at the root)
                # must not end the search before the nested layouts
                errors.append(str(e))
    raise FileNotFoundError(
        f"fiesta surrogate {model_name!r} not found under {root!r} "
        f"(tried {candidates}); {'; '.join(errors[:2])}")
