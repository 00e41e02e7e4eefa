"""LEC chiral-EFT EOS emulators (LEC-7 / LEC-13).

Port of ``nmma_tpu/eos/lec.py`` (the reference's ``LECEoSGenerator``,
nmma/eos/eos_processing.py:189-233): three relu MLPs map the low-energy
constants to M_TOV, the radii and the log10 tidal deformabilities on a mass
grid decompressed from M_TOV (equal spacing, or the reference's split low and
high grid), with affine feature and output scalers. Batch-first; the
conversion step adds the same columns as ``TOVEmulator``. The reference's
sklearn/joblib emulators are read by ``ingest_reference_lec``, which imports
``joblib`` only when it is called.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.interp import interp_rows

LEC7_PARAMETERS = ("d11", "d22", "d3", "d4", "d6", "d7")
LEC13_PARAMETERS = LEC7_PARAMETERS + (
    "ksat", "qsat", "zsat", "cssq1", "cssq2", "cssq3", "cssq4")


def decompose_masses(mtov, n_mass_samples=30, split=None):
    """Mass grids [B, M] from M_TOV [B] (reference ``decompose_mass_data``):
    linspace(1, mtov, n) with ``split=None``; with ``split=(n_low, n_high[,
    m_split])`` a fixed grid 1..m_split and a variably spaced upper end
    m_split..mtov (``properly_disjoint_masses``, :137-167), the equal grid
    where mtov <= m_split."""
    col = mtov[..., None]
    device = mtov.device
    if split is None:
        frac = torch.arange(n_mass_samples, device=device) \
            / (n_mass_samples - 1)
        return 1.0 + (col - 1.0) * frac
    n_low, n_high, m_split = (tuple(split) + (2.0,))[:3]
    n_low, n_high = int(n_low), int(n_high)
    frac_lo = torch.arange(n_low, device=device) / (n_low - 1)
    low = (1.0 + (m_split - 1.0) * frac_lo).expand(*mtov.shape, n_low)
    # linspace(mtov, m_split, n_high, endpoint=False), reversed
    frac_hi = torch.arange(n_high, device=device) / n_high
    high = torch.flip(col + (m_split - col) * frac_hi, (-1,))
    disjoint = torch.cat([low, high], dim=-1)
    n = n_low + n_high
    equal = 1.0 + (col - 1.0) * (torch.arange(n, device=device) / (n - 1))
    return torch.where(col > m_split, disjoint, equal)


def _mlp(x, layers):
    h = x
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i != len(layers) - 1:
            h = torch.relu(h)
    return h


@dataclass
class LECEmulatorSet:
    """Three-headed LEC emulator: params -> (mass grid, R(m), Lambda(m)).

    ``*_layers`` are tuples of (kernel [in, out], bias) f32 tensors on one
    device; the scalers are affine, (x - loc) / scale on the features and
    y * scale + loc on the outputs (sklearn's StandardScaler/MinMaxScaler).
    """

    parameter_names: tuple
    feat_loc: torch.Tensor
    feat_scale: torch.Tensor
    mass_layers: tuple
    radius_layers: tuple
    lambda_layers: tuple
    radius_loc: torch.Tensor
    radius_scale: torch.Tensor
    lambda_loc: torch.Tensor
    lambda_scale: torch.Tensor
    n_mass_samples: int = 30
    split: tuple | None = None

    @classmethod
    def from_numpy(cls, device=None, **fields):
        """The set with its numpy arrays (and layer tuples) as f32 tensors
        on ``device``."""
        device = resolve_device(device)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)
        for k in ("feat_loc", "feat_scale", "radius_loc", "radius_scale",
                  "lambda_loc", "lambda_scale"):
            fields[k] = dev(fields[k])
        for k in ("mass_layers", "radius_layers", "lambda_layers"):
            fields[k] = tuple((dev(w), dev(b)) for w, b in fields[k])
        fields["parameter_names"] = tuple(fields["parameter_names"])
        return cls(**fields)

    def forward(self, theta):
        """theta [B, P] -> (masses [B, M], radii [B, M], lambdas [B, M])."""
        x = (theta - self.feat_loc) / self.feat_scale
        mtov = _mlp(x, self.mass_layers)[:, 0]
        radii = _mlp(x, self.radius_layers) * self.radius_scale \
            + self.radius_loc
        log_lam = _mlp(x, self.lambda_layers) * self.lambda_scale \
            + self.lambda_loc
        masses = decompose_masses(mtov, self.n_mass_samples, self.split)
        return masses, radii, torch.pow(10.0, log_lam)

    def __call__(self, parameters):
        """``parameters`` {name: [B]} with TOV_mass, TOV_radius, R_14,
        R_16 (NaN where M_TOV is below the mass) and, given mass_i_source,
        radius_i and lambda_i (0.0 beyond M_TOV) added."""
        p = dict(parameters)
        theta = torch.stack([p[k] for k in self.parameter_names], dim=-1)
        masses, radii, lams = self.forward(theta)
        mtov = masses[:, -1] if self.split is None else masses.max(-1).values

        def at(m, rows):
            return interp_rows(m[:, None], masses, rows)[:, 0]
        p["TOV_mass"] = mtov
        p["TOV_radius"] = at(mtov, radii)
        for name, m in (("R_14", 1.4), ("R_16", 1.6)):
            p[name] = torch.where(mtov >= m, at(torch.full_like(mtov, m),
                                                radii), math.nan)
        if "mass_1_source" in p:
            log_lam = torch.log(torch.clamp(lams, min=1e-10))
            for i in (1, 2):
                m = p[f"mass_{i}_source"]
                ns = m <= mtov
                m_c = torch.minimum(torch.maximum(m, masses[:, 0]), mtov)
                p.setdefault(f"radius_{i}", torch.where(ns, at(m_c, radii),
                                                        0.0))
                p.setdefault(f"lambda_{i}", torch.where(
                    ns, torch.exp(at(m_c, log_lam)), 0.0))
        return p

    def save(self, path):
        """The JAX package's npz layout."""
        def host(t):
            return t.cpu().numpy()
        arrays = {
            "parameter_names": np.asarray(self.parameter_names),
            **{k: host(getattr(self, k)) for k in
               ("feat_loc", "feat_scale", "radius_loc", "radius_scale",
                "lambda_loc", "lambda_scale")},
            "n_mass_samples": np.asarray(self.n_mass_samples),
            "split": np.asarray(self.split if self.split else ()),
        }
        for tag in ("mass", "radius", "lambda"):
            layers = getattr(self, f"{tag}_layers")
            arrays[f"n_{tag}"] = np.asarray(len(layers))
            for i, (w, b) in enumerate(layers):
                arrays[f"{tag}_w{i}"] = host(w)
                arrays[f"{tag}_b{i}"] = host(b)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path, device=None):
        with np.load(path, allow_pickle=False) as z:
            def layers(tag):
                return tuple((z[f"{tag}_w{i}"], z[f"{tag}_b{i}"])
                             for i in range(int(z[f"n_{tag}"])))
            # (n_low, n_high) are counts; a third element is the split mass
            raw = [float(v) for v in z["split"]]
            split = tuple(int(v) if i < 2 else v
                          for i, v in enumerate(raw)) or None
            return cls.from_numpy(
                device=device,
                parameter_names=[str(s) for s in z["parameter_names"]],
                feat_loc=z["feat_loc"], feat_scale=z["feat_scale"],
                mass_layers=layers("mass"), radius_layers=layers("radius"),
                lambda_layers=layers("lambda"),
                radius_loc=z["radius_loc"], radius_scale=z["radius_scale"],
                lambda_loc=z["lambda_loc"], lambda_scale=z["lambda_scale"],
                n_mass_samples=int(z["n_mass_samples"]), split=split)


def _scaler_affine(scaler):
    """(loc, scale) with transform(x) = (x - loc) / scale, for sklearn's
    StandardScaler and MinMaxScaler and for {'loc', 'scale'} dicts."""
    if hasattr(scaler, "mean_"):            # StandardScaler
        return (np.asarray(scaler.mean_, dtype=np.float64),
                np.asarray(scaler.scale_, dtype=np.float64))
    if hasattr(scaler, "data_min_"):        # MinMaxScaler
        if hasattr(scaler, "scale_") and hasattr(scaler, "min_"):
            sc = np.asarray(scaler.scale_, dtype=np.float64)
            mn = np.asarray(scaler.min_, dtype=np.float64)
            return -mn / sc, 1.0 / sc
        return (np.asarray(scaler.data_min_, dtype=np.float64),
                np.asarray(scaler.data_max_ - scaler.data_min_,
                           dtype=np.float64))
    if isinstance(scaler, dict):
        return (np.asarray(scaler["loc"], dtype=np.float64),
                np.asarray(scaler["scale"], dtype=np.float64))
    raise ValueError(f"unsupported scaler {type(scaler)!r}")


def _sklearn_mlp_layers(model):
    """(kernel, bias) stack from an MLPRegressor or a dict of w_i/b_i."""
    if hasattr(model, "coefs_"):
        return tuple((np.asarray(w), np.asarray(b))
                     for w, b in zip(model.coefs_, model.intercepts_))
    if isinstance(model, dict):
        n = len([k for k in model if k.startswith("w")])
        return tuple((model[f"w{i}"], model[f"b{i}"]) for i in range(n))
    raise ValueError(f"unsupported emulator {type(model)!r}")


def ingest_reference_lec(metadata, parameters=LEC13_PARAMETERS,
                         n_mass_samples=30, split=None, device=None):
    """The reference's metadata (joblib paths, or the loaded objects, of
    the feature/radius/lambda scalers and the mass/radius/lambda emulators;
    ``LECEoSGenerator.__init__``, eos_processing.py:190-199) -> an
    ``LECEmulatorSet`` on ``device``."""
    import joblib

    def load(key):
        obj = metadata[key]
        return joblib.load(obj) if isinstance(obj, (str, bytes)) else obj

    feat_loc, feat_scale = _scaler_affine(load("feature_scaler"))
    rad_loc, rad_scale = _scaler_affine(load("radius_scaler"))
    lam_loc, lam_scale = _scaler_affine(load("lambda_scaler"))
    return LECEmulatorSet.from_numpy(
        device=device, parameter_names=tuple(parameters),
        feat_loc=feat_loc, feat_scale=feat_scale,
        mass_layers=_sklearn_mlp_layers(load("mass_emulator")),
        radius_layers=_sklearn_mlp_layers(load("radius_emulator")),
        lambda_layers=_sklearn_mlp_layers(load("lambda_emulator")),
        radius_loc=rad_loc, radius_scale=rad_scale,
        lambda_loc=lam_loc, lambda_scale=lam_scale,
        n_mass_samples=n_mass_samples, split=split)
