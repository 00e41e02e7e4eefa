"""SVD-surrogate training: grid ingestion -> SVD -> batched-MLP fit.

Port of ``nmma_tpu/training/svd.py`` (the reference's ``create_svdmodel``,
nmma/em/training.py:164-265). Grid reading, interpolation, normalisation and
the SVD are host numpy, with arrays equal to the JAX package's; the stacked
``[F, ...]`` MLP of every filter is trained full-batch on the device with
``torch.optim.Adam``, one step an epoch:

  1. read a training grid, the parameters parsed from the filenames;
  2. interpolate every light curve onto the surrogate time grid (f32, as the
     JAX package does it);
  3. min-max normalise per filter and time bin; SVD; project onto
     ``n_coeff`` coefficients;
  4. fit Dense(H, relu) -> Dense(C) from the normalised parameters to the
     coefficients (adam, MSE, a held-out split).

The products of the fit are ``torch.einsum``: the JAX package computes them
outside any Pallas kernel too. The trained surrogate is the port's
``SVDModelData``; its ``save`` writes the JAX package's npz keys.
"""

from __future__ import annotations

import math
import os
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.svd import SVDModelData

_NUM_RE = r"[-+]?[.]?[\d]+(?:,\d\d\d)*[\.]?\d*(?:[eE][-+]?\d+)?"
_EXTENSIONS = (".csv", ".txt", ".dat", ".hdf5", ".h5")

# filename -> parameter extraction, per grid family
# (reference: nmma/em/model_parameters.py:98-149)
GRID_PARSERS = {}


def _stem(filename):
    stem = os.path.basename(filename)
    for ext in _EXTENSIONS:
        stem = stem.replace(ext, "")
    return stem


def _register(name, parameters, indices, log_indices=()):
    def parse(filename):
        vals = [float(x) for x in re.findall(_NUM_RE, _stem(filename))]
        out = {}
        for param, idx in zip(parameters, indices):
            v = vals[idx]
            if idx in log_indices:
                v = np.log10(v)
            out[param] = v
        return out
    GRID_PARSERS[name] = (parse, list(parameters))
    return parse


_register("Bu2019lm", ["log10_mej_dyn", "log10_mej_wind", "KNphi", "KNtheta"],
          [1, 2, 3, 4], log_indices=(1, 2))
_register("Bu2019lm_sparse", ["log10_mej_dyn", "log10_mej_wind"],
          [1, 2], log_indices=(1, 2))
_register("Bu2019nsbh", ["log10_mej_dyn", "log10_mej_wind", "KNtheta"],
          [1, 2, 3], log_indices=(1, 2))
_register("Bu2022Ye", ["log10_mej_dyn", "vej_dyn", "Yedyn", "log10_mej_wind",
                       "vej_wind", "KNtheta"],
          [1, 2, 3, 4, 5, 6], log_indices=(1, 4))
_register("Ka2017", ["log10_mej", "log10_vej", "log10_Xlan"],
          [0, 1, 2], log_indices=(0, 1, 2))
_register("AnBa2022_linear", ["mtot", "mni", "vej", "mrp", "xmix"],
          [0, 2, 1, 3, 4])
_register("AnBa2022_log", ["log10_mtot", "log10_mni", "vej", "log10_mrp",
                           "xmix"], [0, 2, 1, 3, 4], log_indices=(0, 2, 3))
_register("AnBa2022_sparse", ["mrp", "xmix"], [3, 4])

_BU2023YE = ["log10_mej_dyn", "vej_dyn", "Yedyn", "log10_mej_wind",
             "vej_wind", "Yewind", "KNtheta"]


def _parse_bu2023ye(filename):
    """Bu2023Ye (reference model_parameters.py:213-246): seven leading
    numbers, |.| applied, masses in log10."""
    vals = [abs(float(x)) for x in re.findall(_NUM_RE, _stem(filename))]
    out = dict(zip(_BU2023YE, vals))
    out["log10_mej_dyn"] = np.log10(out["log10_mej_dyn"])
    out["log10_mej_wind"] = np.log10(out["log10_mej_wind"])
    return out


GRID_PARSERS["Bu2023Ye"] = (_parse_bu2023ye, list(_BU2023YE))


def _parse_cv(filename):
    """Toy 'CV' grid: the first number of the filename (0.0 without one)."""
    vals = re.findall(_NUM_RE, _stem(filename))
    return {"example_num": float(vals[0]) if vals else 0.0}


GRID_PARSERS["CV"] = (_parse_cv, ["example_num"])


def _lanl_value(info, big_digit, small, large):
    v = float(info[2:])
    if "." not in info:
        v /= small if big_digit in info else large
    return v


def _parse_lanl(filename):
    """LANL two-component grid filenames (reference
    get_knprops_from_LANLfilename, nmma/em/utils.py:1039-1140)."""
    out = {}
    for info in os.path.basename(filename).split("_"):
        if info.startswith("md"):
            out["log10_mej_dyn"] = np.log10(_lanl_value(info, "1", 100, 1000))
        elif info.startswith("vd"):
            out["vej_dyn"] = _lanl_value(info, "5", 100, 10)
        elif info.startswith("mw"):
            out["log10_mej_wind"] = np.log10(_lanl_value(info, "1", 100, 1000))
        elif info.startswith("vw"):
            out["vej_wind"] = _lanl_value(info, "5", 100, 10)
        elif info.startswith("theta") or info.startswith("angle"):
            try:
                out["KNtheta"] = float(info.lstrip("thetaangle"))
            except ValueError:
                pass
    out.setdefault("KNtheta", 0.0)
    return out


for _lanl_name in ("LANL2022", "LANLTP1", "LANLTP2", "LANLTS1", "LANLTS2"):
    GRID_PARSERS[_lanl_name] = (
        _parse_lanl,
        ["log10_mej_dyn", "vej_dyn", "log10_mej_wind", "vej_wind", "KNtheta"])


def read_bulla_grid(files, model="Bu2019lm_sparse", filters=None):
    """Read bulla-format grid files (header ``# t[days] f1 f2 ...``).

    Returns (entries, parameter names, filters); an entry is
    {"params": {name: value}, "t": [T], "mags": {filter: [T]}}. Tables are
    read by the native loader, ``np.loadtxt`` without it (reference
    read_photometry_files, 'bulla', nmma/em/io.py:352-377).
    """
    from ..native import parse_many
    parse, parameter_names = GRID_PARSERS[model]
    files = sorted(files)
    if not files:
        raise FileNotFoundError(
            f"no grid files to read for model {model!r} — the data path "
            f"matched nothing")
    entries = []
    for fn, arr in zip(files, parse_many(files)):
        with open(fn) as f:
            header = f.readline().strip().lstrip("#").split()
        cols = header[1:]                  # first column is t[days]
        mags = {c: arr[:, i + 1] for i, c in enumerate(cols)}
        entries.append({"params": parse(fn), "t": arr[:, 0], "mags": mags})
    if filters is None:
        filters = list(entries[0]["mags"].keys())
    return entries, parameter_names, list(filters)


def axial_symmetry(entries):
    """The grid with every entry also at KNtheta -> -theta and 180 - theta
    (reference ``axial_symmetry``, nmma/em/training.py:764-779)."""
    if any("KNtheta" not in e["params"] for e in entries):
        raise ValueError("unknown symmetry parameter")
    out = list(entries)
    for e in entries:
        for theta in (-e["params"]["KNtheta"],
                      180.0 - e["params"]["KNtheta"]):
            p = dict(e["params"])
            p["KNtheta"] = theta
            out.append({**e, "params": p})
    return out


@dataclass
class SVDTrainingConfig:
    n_coeff: int = 10
    hidden: int = 128
    n_epochs: int = 2000
    learning_rate: float = 1e-3
    holdout_fraction: float = 0.1
    tmin: float = 0.1
    tmax: float = 14.0
    n_tsteps: int = 100
    seed: int = 42
    # reference --use-UnivariateSpline / --UnivariateSpline-s
    univariate_spline: bool = False
    univariate_spline_s: float = 2.0


def masked_interp_linear(xq, x, y, fill_value=np.inf):
    """``y(x)`` at ``xq`` from its finite samples, extrapolated linearly from
    the two edge samples on each side; ``fill_value`` with fewer than two.

    Host f32 copy of the JAX package's ``masked_interp_linear``
    (nmma_tpu/ops/interp.py:258, which runs in f32): the same sort, the same
    ``jnp.interp`` arithmetic, so the grids equal the JAX package's.
    Returns float32 [Q].
    """
    f32 = np.float32
    xq = np.asarray(xq, dtype=f32)
    x = np.asarray(x, dtype=f32)
    y = np.asarray(y, dtype=f32)
    ok = np.isfinite(y) & np.isfinite(x)
    n_valid = int(ok.sum())
    if n_valid < 2:
        return np.full(xq.shape, fill_value, dtype=f32)
    order = np.argsort(np.where(ok, x, f32(1e30)), kind="stable")
    xs = np.where(ok, x, f32(1e30))[order]
    ys = np.where(ok, y, f32(0.0))[order]
    ys[n_valid:] = ys[n_valid - 1]
    # jnp.interp (jax/_src/numpy/lax_numpy.py: _interp)
    i = np.clip(np.searchsorted(xs, xq, side="right"), 1, len(xs) - 1)
    df = ys[i] - ys[i - 1]
    dx = xs[i] - xs[i - 1]
    delta = xq - xs[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(f32).eps)
    with np.errstate(all="ignore"):
        res = np.where(dx0, ys[i - 1],
                       ys[i - 1] + (delta / np.where(dx0, f32(1), dx)) * df)
    res = np.where(xq < xs[0], ys[0], res)
    res = np.where(xq > xs[-1], ys[-1], res)

    x0, y0, x1, y1 = xs[0], ys[0], xs[1], ys[1]
    xm, ym = xs[n_valid - 2], ys[n_valid - 2]
    xn, yn = xs[n_valid - 1], ys[n_valid - 1]
    lo = (y1 - y0) / (x1 - x0 if x1 != x0 else f32(1))
    hi = (yn - ym) / (xn - xm if xn != xm else f32(1))
    res = np.where(xq < x0, y0 + lo * (xq - x0), res)
    res = np.where(xq > xn, yn + hi * (xq - xn), res)
    return res.astype(f32)


def _interp_grid(entries, filters, tt, spline=False, spline_s=2.0):
    """[N, F, T] magnitudes on the surrogate grid (linear extrapolation,
    or smoothing-spline resampling with ``spline=True``)."""
    out = np.zeros((len(entries), len(filters), len(tt)))
    for i, e in enumerate(entries):
        for j, filt in enumerate(filters):
            if spline:
                from scipy.interpolate import UnivariateSpline
                t_i = np.asarray(e["t"], dtype=float)
                y_i = np.asarray(e["mags"][filt], dtype=float)
                good = np.isfinite(t_i) & np.isfinite(y_i)
                if good.sum() >= 4:
                    sp = UnivariateSpline(t_i[good], y_i[good], s=spline_s)
                    row = sp(np.asarray(tt))
                    row[(tt < t_i[good].min()) | (tt > t_i[good].max())] \
                        = np.nan
                    out[i, j] = row
                    continue
            out[i, j] = masked_interp_linear(tt, e["t"], e["mags"][filt],
                                             fill_value=np.nan)
    return out


def _interp_spectra(entries, tt):
    """[N, L, T] log10 fluxes on the surrogate grid, and the wavelengths:
    each wavelength bin's log10 f_nu interpolated over time (reference
    interpolate_data, nmma/em/training.py:186-192)."""
    lam = np.asarray(entries[0]["lambdas"])
    out = np.zeros((len(entries), len(lam), len(tt)))
    for i, e in enumerate(entries):
        fnu = np.asarray(e["fnu"])          # [T_i, L]
        with np.errstate(divide="ignore"):
            log_f = np.log10(np.maximum(fnu, 1e-300))
        for j in range(len(lam)):
            out[i, j] = masked_interp_linear(tt, e["t"], log_f[:, j],
                                             fill_value=np.nan)
    return out, lam


def normalize_params(params, p_mins, p_maxs):
    """Min-max parameter normalisation; a parameter constant across the
    grid maps to 0, not 0/0."""
    span = np.where(p_maxs > p_mins, p_maxs - p_mins, 1.0)
    return (params - p_mins) / span


def _normalize_and_decompose(data, params, n_coeff):
    """Min-max normalisation (NaN-safe bounds) and the per-filter SVD shared
    by the MLP and GP trainers. Returns (p_mins, p_maxs, x, mins, maxs,
    va [F, T, C], coeffs [N, F, C])."""
    p_mins, p_maxs = params.min(0), params.max(0)
    x = normalize_params(params, p_mins, p_maxs)

    with np.errstate(all="ignore"):
        mins = np.nan_to_num(np.nanmin(data, axis=0), nan=0.0)  # [F, T]
        maxs = np.nan_to_num(np.nanmax(data, axis=0), nan=0.0)
    span = np.where(maxs > mins, maxs - mins, 1.0)
    norm = np.nan_to_num((data - mins) / span, nan=0.0)

    n_c = min(n_coeff, data.shape[0], data.shape[2])
    va_list, coeff_list = [], []
    for j in range(data.shape[1]):
        _, _, vt = np.linalg.svd(norm[:, j, :], full_matrices=True)
        va_j = vt.T[:, :n_c]                            # [T, C]
        va_list.append(va_j)
        coeff_list.append(norm[:, j, :] @ va_j)         # [N, C]
    return (p_mins, p_maxs, x, mins, maxs, np.stack(va_list),
            np.stack(coeff_list, axis=1))


def stacked_mlp(x, net):
    """The surrogate's MLP for every filter at once: x [N, P] -> [N, F, C]."""
    h = torch.relu(torch.einsum("np,fph->nfh", x, net["w1"]) + net["b1"])
    return torch.einsum("nfh,fhc->nfc", h, net["w2"]) + net["b2"]


def initial_mlp(f_n, p_n, h_n, n_c, seed, device):
    """He-normal first layer, 1/sqrt(H) second, zero biases: the JAX
    package's distributions, drawn from a ``torch.Generator``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w1 = torch.randn((f_n, p_n, h_n), generator=gen) * math.sqrt(2.0 / p_n)
    w2 = torch.randn((f_n, h_n, n_c), generator=gen) * math.sqrt(1.0 / h_n)
    return {"w1": w1.to(device), "b1": torch.zeros((f_n, h_n), device=device),
            "w2": w2.to(device), "b2": torch.zeros((f_n, n_c), device=device)}


def fit_mlp(net, x_train, y_train, n_epochs, learning_rate, verbose=True,
            n_blocks=5):
    """Full-batch adam on the MSE for exactly ``n_epochs`` steps; returns
    (net, last training loss). Prints the loss after each of ``n_blocks``
    blocks of epochs when ``verbose``."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in net.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    block = max(1, n_epochs // (n_blocks if verbose else 1))
    loss = None
    for epoch in range(1, n_epochs + 1):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((stacked_mlp(x_train, params) - y_train) ** 2)
        loss.backward()
        opt.step()
        if verbose and (epoch % block == 0 or epoch == n_epochs):
            print(f"epoch {epoch:5d} train mse {float(loss.detach()):.5f}")
    net = {k: v.detach() for k, v in params.items()}
    return net, (float(loss.detach()) if loss is not None
                 else float("nan"))


def train_svd_model(entries, parameter_names, filters=None,
                    config: SVDTrainingConfig = SVDTrainingConfig(),
                    verbose=True, data_type="photometry",
                    init_model: SVDModelData = None,
                    device=None) -> SVDModelData:
    """Train the stacked-MLP SVD surrogate on ``device`` (the card unless
    given).

    ``init_model`` continues from a saved surrogate (reference
    ``continue_training``, em/training.py:142-159): its basis,
    normalisations and weights are reused and the grid is projected onto
    the saved basis. The attribute ``fit_info`` of the result holds the
    training and holdout MSE, the split's sizes and the seconds spent
    interpolating, decomposing and fitting.
    """
    device = resolve_device(device)
    cfg = config
    t0 = time.perf_counter()
    if init_model is not None:
        tt = np.asarray(init_model.host["tt"])
    else:
        tt = np.linspace(cfg.tmin, cfg.tmax, cfg.n_tsteps)
    if data_type == "spectroscopy":
        data, lam = _interp_spectra(entries, tt)        # [N, L, T] log10 f
        filters = [f"lambda_{v:.0f}" for v in lam]
    else:
        data = _interp_grid(entries, filters, tt,
                            spline=cfg.univariate_spline,
                            spline_s=cfg.univariate_spline_s)  # [N, F, T]
    params = np.asarray([[e["params"][p] for p in parameter_names]
                         for e in entries])             # [N, P]

    t1 = time.perf_counter()
    if init_model is not None:
        if tuple(init_model.filters) != tuple(filters):
            raise ValueError(
                f"continue-training filter mismatch: saved "
                f"{init_model.filters} vs requested {tuple(filters)}")
        host = init_model.host
        p_mins, p_maxs = host["param_mins"], host["param_maxs"]
        mins, maxs, va = host["mins"], host["maxs"], host["va"]
        x = normalize_params(params, p_mins, p_maxs)
        span = np.where(maxs > mins, maxs - mins, 1.0)
        norm = np.nan_to_num((data - mins) / span, nan=0.0)
        coeffs = np.einsum("nft,ftc->nfc", norm, va)    # saved basis
        net = {k: getattr(init_model, k).detach().to(device)
               for k in ("w1", "b1", "w2", "b2")}
    else:
        (p_mins, p_maxs, x, mins, maxs, va,
         coeffs) = _normalize_and_decompose(data, params, cfg.n_coeff)
        net = initial_mlp(len(filters), params.shape[1], cfg.hidden,
                          va.shape[2], cfg.seed, device)

    t2 = time.perf_counter()
    n = len(entries)
    # holdout_fraction 0 trains on the whole grid; else at least one point
    n_hold = 0
    if cfg.holdout_fraction > 0 and n > 4:
        n_hold = max(1, int(round(n * cfg.holdout_fraction)))
    perm = np.random.default_rng(cfg.seed).permutation(n)
    train_idx, hold_idx = perm[n_hold:], perm[:n_hold]

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    net, train_loss = fit_mlp(net, dev(x[train_idx]), dev(coeffs[train_idx]),
                              cfg.n_epochs, cfg.learning_rate, verbose)
    hold_loss = None
    if n_hold:
        with torch.no_grad():
            hold_loss = float(torch.mean(
                (stacked_mlp(dev(x[hold_idx]), net)
                 - dev(coeffs[hold_idx])) ** 2))
        if verbose:
            print(f"holdout mse {hold_loss:.5f} ({n_hold} grid points)")
    t3 = time.perf_counter()

    svd = SVDModelData({
        "filters": np.asarray(filters), "parameter_names":
        np.asarray(parameter_names), "tt": tt, "va": va, "mins": mins,
        "maxs": maxs, "param_mins": p_mins, "param_maxs": p_maxs,
        **{k: v.cpu().numpy() for k, v in net.items()}}, device)
    svd.fit_info = {"train_mse": train_loss, "holdout_mse": hold_loss,
                    "n_holdout": n_hold, "n_train": n - n_hold,
                    "interp_s": t1 - t0, "svd_s": t2 - t1, "fit_s": t3 - t2,
                    "epochs": cfg.n_epochs}
    return svd


def benchmark_svd_model(svd: SVDModelData, entries, parameter_names,
                        filters=None, batch=8192):
    """Reduced-chi^2 percentiles [0, 25, 50, 75, 100] of the surrogate
    against its training grid, per filter (reference ``create_benchmark``,
    nmma/em/training.py:611-739; 1 mag error scale). The surrogate runs
    batched on its device, through K1 there, ``batch`` grid points a call.
    """
    filters = filters or list(svd.filters)
    tt = np.asarray(svd.tt)
    device = svd.w1.device
    t_dev = torch.as_tensor(tt, dtype=torch.float32, device=device)
    theta = np.asarray([[e["params"][p] for p in parameter_names]
                        for e in entries], dtype=np.float32)
    preds = []
    with torch.no_grad():
        for i in range(0, len(entries), batch):
            chunk = torch.as_tensor(theta[i:i + batch], device=device)
            params = {p: chunk[:, k] for k, p in enumerate(parameter_names)}
            preds.append(svd(params, t_dev).cpu().numpy())
    pred = np.concatenate(preds)                            # [N, F, T]
    chi2 = {f: [] for f in filters}
    for n, e in enumerate(entries):
        for f in filters:
            j = list(svd.filters).index(f)
            truth = masked_interp_linear(tt, e["t"], e["mags"][f],
                                         fill_value=np.nan)
            sel = np.isfinite(truth) & np.isfinite(pred[n, j])
            if sel.sum() < 2:
                continue
            chi2[f].append(np.sum((pred[n, j][sel] - truth[sel]) ** 2)
                           / max(sel.sum() - 1, 1))
    return {f: np.percentile(v, [0, 25, 50, 75, 100]).tolist()
            for f, v in chi2.items() if v}


# bulla filenames of the families ``write_bulla_grid`` writes: the numbers
# GRID_PARSERS reads back (masses in Msun, angles in degrees)
_BULLA_NAMES = {
    "Bu2019lm": "nph1.0e+06_mejdyn{mej_dyn:.8f}_mejwind{mej_wind:.8f}"
                "_phi{KNphi:.6f}_theta{KNtheta:.6f}.dat",
    "Bu2019lm_sparse": "nph1.0e+06_mejdyn{mej_dyn:.8f}"
                       "_mejwind{mej_wind:.8f}_phi45_theta0.00.dat",
    "Bu2019nsbh": "nph1.0e+06_mejdyn{mej_dyn:.8f}_mejwind{mej_wind:.8f}"
                  "_theta{KNtheta:.6f}.dat",
}


def write_bulla_grid(directory, model, params, t, mags, filters):
    """Write a bulla-format grid: one ``.dat`` a point, ``# t[days] f1 ...``
    then one row a time, named as ``model``'s grid files are. params
    {name: [N]} (log10 masses as the parser returns them), t [T], mags
    [N, F, T]. Returns the paths."""
    os.makedirs(directory, exist_ok=True)
    pattern = _BULLA_NAMES[model]
    paths = []
    for n in range(len(mags)):
        values = {k: float(v[n]) for k, v in params.items()}
        for kind in ("dyn", "wind"):
            if f"log10_mej_{kind}" in values:
                values[f"mej_{kind}"] = 10.0 ** values[f"log10_mej_{kind}"]
        path = os.path.join(directory, pattern.format(**values))
        np.savetxt(path, np.column_stack([t, np.asarray(mags[n]).T]),
                   header="t[days] " + " ".join(filters), fmt="%.8e")
        paths.append(path)
    return paths
