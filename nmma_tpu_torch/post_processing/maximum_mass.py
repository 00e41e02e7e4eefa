"""Maximum-mass (post-merger remnant) inference, batch-first.

PyTorch counterpart of ``nmma_tpu/post_processing/maximum_mass.py``
(``maximum_mass_resampling``,
``nmma/post_processing/maximum_mass_constraint.py:76-216``): sample over the
joint GW+EM posterior KDE of (chirp_mass, eta_star, EOS, log10_mdisk,
log10_mej_dyn) under the constraint that the baryonic remnant mass exceeds
the collapse threshold (the baryonic TOV mass, or the Kepler-limit QUR when
ratio_R and delta are sampled). The per-EOS baryonic-mass curves are made
once on the host (``eos/baryonic.py``); the batched likelihood interpolates
them, with the port's ``NestedSampler``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .. import resolve_device
from ..eos.baryonic import baryonic_kepler_mass, stacked_baryonic_tables
from ..ops.interp import interp_rows
from ..priors import PriorDict, Uniform
from .kde import GaussianKDE
from .resampling import NEG_INF, run_resampler


def _numbered_files(directory):
    return sorted(glob.glob(os.path.join(directory, "*.dat")),
                  key=lambda f: int(os.path.splitext(os.path.basename(f))[0]))


class MaximumMassResampler:
    def __init__(self, posterior_samples, eos_path_macro, eos_path_micro,
                 n_eos=None, use_m_max=False, mass_grid=None, device=None):
        """posterior_samples: dict with chirp_mass, eta_star, EOS,
        log10_mdisk and log10_mej_dyn arrays (the joint GW+EM posterior);
        the macro (R, M, Lambda, P_c) and micro (n, eps, p, cs2) EOS files
        are ``{i}.dat`` in their directories. ``device``: where the
        likelihood and the sampler run (default the CUDA card)."""
        self.device = resolve_device(device)
        self.use_m_max = use_m_max
        keys = ("chirp_mass", "eta_star", "EOS", "log10_mdisk",
                "log10_mej_dyn")
        self.kde = GaussianKDE(np.column_stack(
            [np.asarray(posterior_samples[k]) for k in keys]))

        macro_files = _numbered_files(eos_path_macro)
        micro_files = _numbered_files(eos_path_micro)
        if n_eos:
            macro_files, micro_files = macro_files[:n_eos], micro_files[:n_eos]
        self.n_eos = len(macro_files)

        if mass_grid is None:
            mass_grid = np.linspace(0.8, 2.6, 64)
        self.mass_grid = mass_grid
        mb_tables, mb_tov = stacked_baryonic_tables(macro_files, micro_files,
                                                    mass_grid)
        mtov, r14 = [], []
        for f in macro_files:
            r, m = np.loadtxt(f, unpack=True, usecols=[0, 1])
            mtov.append(m.max())
            r14.append(np.interp(1.4, m, r))

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=self.device)

        self.mb_tables = f32(np.nan_to_num(mb_tables, nan=1e6))
        self.mb_tov = f32(mb_tov)
        self.mtov = f32(mtov)
        self.r14 = f32(r14)
        self._grid = f32(mass_grid)

        samples = {k: np.asarray(posterior_samples[k]) for k in keys}
        priors = {k: Uniform(minimum=float(samples[k].min()),
                             maximum=float(samples[k].max()))
                  for k in ("chirp_mass", "eta_star")}
        priors["EOS"] = Uniform(minimum=0.0, maximum=float(self.n_eos))
        for k in ("log10_mdisk", "log10_mej_dyn"):
            priors[k] = Uniform(minimum=float(samples[k].min()),
                                maximum=float(samples[k].max()))
        if use_m_max:
            priors["ratio_R"] = Uniform(minimum=1.0, maximum=1.4)
            priors["delta"] = Uniform(minimum=-0.05, maximum=0.05)
        self.priors = PriorDict(priors)

    def log_likelihood(self, p):
        """params {name: [B]} -> [B]: the posterior KDE where the remnant's
        baryonic mass lies above the collapse threshold, -1e30 elsewhere."""
        mc, eta_star, eos = p["chirp_mass"], p["eta_star"], p["EOS"]
        log10_mdisk, log10_mej = p["log10_mdisk"], p["log10_mej_dyn"]
        log_prior = self.kde(torch.stack(
            [mc, eta_star, eos, log10_mdisk, log10_mej], dim=1))

        # eta_star = log(0.25 - eta) (reference :137)
        eta = 0.25 - torch.exp(eta_star)
        q = (1 - torch.sqrt(torch.clamp(1 - 4 * eta, min=0.0)) - 2 * eta) \
            / (2 * eta)
        total = mc / torch.pow(eta, 3.0 / 5.0)
        m1 = total / (1 + q)
        m2 = total * q / (1 + q)

        idx = torch.clamp(torch.floor(eos).long(), 0, self.n_eos - 1)
        mb = interp_rows(torch.stack([m1, m2], dim=1), self._grid,
                         self.mb_tables[idx])                    # [B, 2]
        m_rem_b = mb[:, 0] + mb[:, 1] - 10.0**log10_mdisk - 10.0**log10_mej

        if self.use_m_max:
            m_threshold = baryonic_kepler_mass(
                self.mtov[idx], self.r14[idx], p["ratio_R"], p["delta"])
        else:
            m_threshold = self.mb_tov[idx]

        # a remnant that collapsed to a black hole: the threshold lies
        # below the remnant's mass
        logl = torch.where(m_threshold > m_rem_b, NEG_INF, 0.0)
        out = log_prior + logl
        return torch.where(torch.isnan(out), NEG_INF,
                           torch.clamp(out, min=NEG_INF))

    def run(self, nlive=256, verbose=False, **kwargs):
        """Nested sampling of the constrained posterior: (result, posterior
        {name: numpy})."""
        return run_resampler(self, nlive, verbose, kwargs)
