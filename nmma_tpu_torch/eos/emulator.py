"""TOV emulator: NEP parameters -> macroscopic neutron-star curves by an MLP.

Port of ``nmma_tpu/eos/emulator.py`` (the reference's ``EoSGenerator``
emulators, nmma/eos/eos_processing.py:41-233): training EOS from the NEP
meta-model over a crust, their TOV families from the port's RK4 solver, and a
tanh MLP from the nuclear parameters to (M_TOV, R(x), log Lambda(x)) on the
relative mass grid x = m / M_TOV. The training EOS are integrated together,
every central pressure of every table one row of one RK4 loop
(``eos.tov.construct_families``), where the JAX package solves one table at a
time; the targets are the same.

At sampling time the emulator is two batch-first matmuls: the conversion step
adds TOV_mass, R_14, R_16, TOV_radius and, given source-frame masses, radius_i
and lambda_i, with 0.0 where no neutron star of that mass exists.
"""

from __future__ import annotations

import math
import time
from inspect import signature

import numpy as np
import torch

from .. import resolve_device
from ..ops.interp import interp_rows
from .generation import eos_from_nep, nep_eos_table
from .tov import construct_families

X_GRID = np.linspace(0.35, 1.0, 24)    # m / M_TOV grid
ARRAYS = ("p_mins", "p_maxs", "x_grid", "out_mean", "out_std", "w1", "b1",
          "w2", "b2")


class TOVEmulator:
    """MLP emulator and the conversion step that consumes it, its arrays
    f32 tensors on one device."""

    def __init__(self, param_names, p_mins, p_maxs, x_grid, out_mean,
                 out_std, w1, b1, w2, b2, device=None):
        device = resolve_device(device)
        self.param_names = tuple(param_names)
        values = (p_mins, p_maxs, x_grid, out_mean, out_std, w1, b1, w2, b2)
        for name, value in zip(ARRAYS, values):
            setattr(self, name, torch.as_tensor(
                np.asarray(value, dtype=np.float32), device=device))

    def forward(self, theta):
        """theta [B, P] -> (mtov [B], R(x) [B, X] km, log Lambda(x) [B, X])."""
        x = (theta - self.p_mins) / (self.p_maxs - self.p_mins)
        out = torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2
        out = out * self.out_std + self.out_mean
        n_x = self.x_grid.shape[0]
        return out[:, 0], out[:, 1:1 + n_x], out[:, 1 + n_x:]

    def __call__(self, parameters):
        """``parameters`` {name: [B]} with TOV_mass, R_14, R_16,
        TOV_radius and, given mass_i_source, radius_i and lambda_i added
        (reference ``EoSConverter('emulated')``); 0.0 where M_TOV is below
        the mass, the convention of ``TabulatedEOSSet``."""
        p = dict(parameters)
        theta = torch.stack([p[k] for k in self.param_names], dim=-1)
        mtov, radii, loglam = self.forward(theta)
        grid = self.x_grid
        p["TOV_mass"] = mtov

        def at_mass(m, rows):
            return interp_rows((m / mtov)[:, None], grid, rows)[:, 0]
        for name, m in (("R_14", 1.4), ("R_16", 1.6)):
            p[name] = torch.where(mtov >= m, at_mass(torch.full_like(
                mtov, m), radii), 0.0)
        p["TOV_radius"] = radii[:, -1]
        if "mass_1_source" in p:
            for i in (1, 2):
                m = p[f"mass_{i}_source"]
                x = torch.clamp(m / mtov, float(grid[0]), 1.0)
                ns = m / mtov <= 1.0
                r = interp_rows(x[:, None], grid, radii)[:, 0]
                lam = torch.exp(interp_rows(x[:, None], grid, loglam)[:, 0])
                # beyond M_TOV the object is a black hole
                p.setdefault(f"radius_{i}", torch.where(ns, r, 0.0))
                p.setdefault(f"lambda_{i}", torch.where(ns, lam, 0.0))
        return p

    def save(self, path):
        """The JAX package's npz layout."""
        np.savez_compressed(
            path, param_names=np.asarray(self.param_names),
            **{k: getattr(self, k).cpu().numpy() for k in ARRAYS})

    @classmethod
    def load(cls, path, device=None):
        with np.load(path) as z:
            return cls([str(s) for s in z["param_names"]],
                       *[z[k] for k in ARRAYS], device=device)


def macro_targets(r, m, lam, x_grid):
    """One TOV family (numpy) -> (mtov, R(x), log Lambda(x)) on the stable
    branch, as the JAX package's ``_macro_targets`` reads it."""
    good = (r > 6.0) & (r < 25.0) & (m > 0.1)
    r, m, lam = r[good], m[good], lam[good]
    imax = int(np.argmax(m))
    r, m, lam = r[:imax + 1], m[:imax + 1], lam[:imax + 1]
    order = np.argsort(m)
    r, m, lam = r[order], m[order], lam[order]
    mtov = m[-1]
    x = m / mtov
    return (mtov, np.interp(x_grid, x, r),
            np.interp(x_grid, x, np.log(np.maximum(lam, 1e-8))))


def emulator_targets(thetas, names, crust_table, x_grid=X_GRID,
                     device=None, **nep_kwargs):
    """(kept row indices, targets [n, 1 + 2X]) of the NEP parameter rows
    ``thetas``: every table's 48 central pressures in one RK4 loop on
    ``device``; rows whose EOS cannot be built, whose family has no
    stable branch, M_TOV outside (1.2, 3.5) or non-finite radii are
    dropped."""
    extra = [k for k in names if k not in ("S0", "L")]
    tables, rows = [], []
    for i, th in enumerate(thetas):
        sampled = dict(zip(names, th))
        kw = dict(nep_kwargs)
        kw.update({k: sampled[k] for k in extra})
        try:
            tables.append(nep_eos_table(sampled["S0"], sampled["L"],
                                        crust_table, **kw))
        except Exception:
            continue
        rows.append(i)
    keep, targets = [], []
    if not tables:
        return np.asarray(keep, dtype=int), np.zeros((0, 1 + 2 * len(x_grid)))
    families = construct_families(tables, n_points=48, device=device)
    for i, (r, m, lam, _) in zip(rows, families):
        try:
            mtov, radii, loglam = macro_targets(
                *(v.cpu().numpy().astype(np.float64) for v in (r, m, lam)),
                x_grid)
        except ValueError:
            continue
        if not (1.2 < mtov < 3.5) or not np.all(np.isfinite(radii)):
            continue
        keep.append(i)
        targets.append(np.concatenate([[mtov], radii, loglam]))
    return np.asarray(keep, dtype=int), np.asarray(targets, dtype=np.float64)


def train_tov_emulator(crust_table, param_ranges=None, n_train=128,
                       hidden=64, n_epochs=4000, learning_rate=2e-3,
                       seed=0, x_grid=X_GRID, verbose=False, device=None,
                       timings=None, **nep_kwargs):
    """Fit a ``TOVEmulator`` on ``device`` to NEP-generated EOS solved with
    the port's TOV solver. ``param_ranges`` {name: (lo, hi)} over the NEP
    parameters (default S0 in [28, 36] MeV, L in [30, 90] MeV; the others
    go to ``eos_from_nep`` by name). Exactly ``n_epochs`` epochs run, with
    the loss printed every 500 and after the last when ``verbose`` (the JAX
    package runs whole blocks of 500, so it rounds the count up, fault 3g).
    A dict ``timings`` receives the seconds spent on the targets and the
    fit."""
    device = resolve_device(device)
    if param_ranges is None:
        param_ranges = {"S0": (28.0, 36.0), "L": (30.0, 90.0)}
    names = list(param_ranges)
    lows = np.array([param_ranges[k][0] for k in names])
    highs = np.array([param_ranges[k][1] for k in names])
    if "S0" not in param_ranges or "L" not in param_ranges:
        raise ValueError(f"param_ranges must include 'S0' and 'L' (got "
                         f"{sorted(param_ranges)})")
    allowed = set(signature(eos_from_nep).parameters)
    unknown = [k for k in names if k not in ("S0", "L") and k not in allowed]
    if unknown:
        raise ValueError(f"unknown NEP parameter(s) {unknown}; eos_from_nep "
                         f"accepts {sorted(allowed)}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(lows, highs, (n_train, len(names)))
    keep, targets = emulator_targets(thetas, names, crust_table, x_grid,
                                     device=device, **nep_kwargs)
    thetas = thetas[keep]
    if len(targets) < 16:
        raise RuntimeError("too few physical training EOS")
    t1 = time.perf_counter()

    t_mean = targets.mean(axis=0)
    t_std = targets.std(axis=0) + 1e-8
    y = torch.as_tensor(((targets - t_mean) / t_std).astype(np.float32),
                        device=device)
    x_in = torch.as_tensor(((thetas - lows) / (highs - lows))
                           .astype(np.float32), device=device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dim_in, dim_out = x_in.shape[1], y.shape[1]
    params = {
        "w1": torch.randn((dim_in, hidden), generator=gen) / math.sqrt(dim_in),
        "b1": torch.zeros(hidden),
        "w2": torch.randn((hidden, dim_out), generator=gen)
        / math.sqrt(hidden),
        "b2": torch.zeros(dim_out)}
    params = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    done = 0
    while done < n_epochs:
        for _ in range(min(500, n_epochs - done)):
            opt.zero_grad(set_to_none=True)
            h = torch.tanh(x_in @ params["w1"] + params["b1"])
            loss = torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)
            loss.backward()
            opt.step()
        done = min(done + 500, n_epochs)
        if verbose:
            print(f"emulator epoch {done:5d} mse {float(loss.detach()):.5f}")
    if timings is not None:
        timings.update(targets_s=t1 - t0, fit_s=time.perf_counter() - t1,
                       n_eos=len(targets), epochs=done,
                       mse=float(loss.detach()))
    return TOVEmulator(names, lows, highs, x_grid, t_mean, t_std,
                       *(params[k].detach().cpu().numpy()
                         for k in ("w1", "b1", "w2", "b2")), device=device)
