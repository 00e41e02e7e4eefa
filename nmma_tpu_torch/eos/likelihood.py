"""EOS constraint likelihoods on ``[B]`` batches.

PyTorch counterpart of ``nmma_tpu/eos/likelihood.py`` (the reference's
``nmma/eos/eos_likelihood.py:347-545``): each constraint is a callable
``(parameters, curves) -> logL [B]`` built from arrays prepared on the host
(histograms, grids):

* ``LowerMTOVConstraint``: log Phi((MTOV - m_obs) / sigma);
* ``UpperMTOVConstraint``: log Phi(-(MTOV - m_obs) / sigma);
* ``MassRadiusConstraint``: a smoothed 2-D histogram of an (R, M)
  posterior, summed along each sample's M-R curve up to its MTOV;
* ``JointEoSConstraint``: the sum of the above.

``tabulate_weighted_eos`` scores a whole tabulated family in one batched
call and writes the reference's sorted/ directory and weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

try:
    from scipy.ndimage import gaussian_filter
except ImportError:  # pragma: no cover
    gaussian_filter = None

from .. import resolve_device
from ..ops.interp import interp_rows


class LowerMTOVConstraint:
    """The EOS supports at least m_obs (Gaussian; reference :392-409)."""

    def __init__(self, measured_mass, measure_error, name=None):
        self.mass = float(measured_mass)
        self.error = float(measure_error)
        self.name = name or "Lower MTOV"

    def __call__(self, parameters, curves=None):
        return torch.special.log_ndtr(
            (parameters["TOV_mass"] - self.mass) / self.error)


class UpperMTOVConstraint:
    """The EOS supports at most m_obs (Gaussian; reference :411-427)."""

    def __init__(self, measured_mass, measure_error, name=None):
        self.mass = float(measured_mass)
        self.error = float(measure_error)
        self.name = name or "Upper MTOV"

    def __call__(self, parameters, curves=None):
        return torch.special.log_ndtr(
            -(parameters["TOV_mass"] - self.mass) / self.error)


class MassRadiusConstraint:
    """2-D histogram mass-radius posterior constraint (reference :429-545).

    The histogram (smoothed with a sigma = 3 Gaussian, the reference's
    binning) is built on the host; the likelihood walks each sample's
    radius curve on a fixed test-mass grid, masks masses above its MTOV and
    log-sums the histogram values.
    """

    def __init__(self, mass_array=None, radius_array=None, weights=None,
                 file_path=None, name=None, mass_step=0.01,
                 radius_step=0.03):
        if file_path:
            mass_array, radius_array, weights = self._read(file_path)
        masses = np.asarray(mass_array, dtype=np.float64)
        radii = np.asarray(radius_array, dtype=np.float64)
        self.name = name or "Mass-Radius"
        mass_bins = self._bins(masses, mass_step)
        rad_bins = self._bins(radii, radius_step)
        hist, self.rad_edges, self.mass_edges = np.histogram2d(
            radii, masses, bins=[rad_bins, mass_bins], weights=weights,
            density=True)
        drad = self.rad_edges[1] - self.rad_edges[0]
        dmass = self.mass_edges[1] - self.mass_edges[0]
        hist = hist * dmass * drad
        if gaussian_filter is not None:
            hist = gaussian_filter(hist, sigma=3)
        self.histogram = hist
        self.test_masses = np.linspace(1.2, 2.5, 151)
        self._tables = {}

    @staticmethod
    def _read(file_path):
        data = np.loadtxt(file_path, unpack=True)
        if data.shape[0] not in (2, 3):
            data = data.T
        weights = None
        if data.shape[0] == 3:
            a, b, weights = data
        else:
            a, b = data
        if (a <= 3.0).any():
            masses, radius = a, b
        else:
            radius, masses = a, b
        return masses, radius, weights

    @staticmethod
    def _bins(array, step, sensitivity=0.001):
        low, high = np.quantile(array, [sensitivity, 1.0 - sensitivity])
        return np.arange(0.95 * low, 1.05 * high, step, dtype=np.float64)

    def _on(self, device):
        key = str(device)
        if key not in self._tables:
            def f32(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                       device=device)
            tm = f32(self.test_masses)
            me = f32(self.mass_edges)
            self._tables[key] = dict(
                histogram=f32(self.histogram), test_masses=tm,
                rad_edges=f32(self.rad_edges),
                # the test masses' histogram columns and their support
                yi=torch.clamp((tm[:, None] > me[1:][None, :]).sum(1), 0,
                               self.histogram.shape[1] - 1),
                mass_ok=(tm >= me[0]) & (tm <= me[-1]))
        return self._tables[key]

    def __call__(self, parameters, curves):
        """``curves``: 'masses' [M] (ascending) and 'radii' [B, M]."""
        tov = parameters["TOV_mass"]
        radii = curves["radii"]
        t = self._on(radii.device)
        masses = torch.as_tensor(curves["masses"], dtype=torch.float32,
                                 device=radii.device)
        # beyond-MTOV rows carry 0 radii (TabulatedEOSSet): forward-fill
        # them with the last physical radius, so the bin just below MTOV
        # is not pulled toward 0 km (the reference interpolates the
        # truncated curve with a flat right end)
        idx = torch.arange(radii.shape[1], device=radii.device)
        last_good = torch.cummax(torch.where(radii > 0.0, idx, 0), 1).values
        radii_ff = torch.gather(radii, 1, last_good)
        test_radii = interp_rows(t["test_masses"], masses, radii_ff)
        below_tov = t["test_masses"] < tov[:, None]
        # outside the histogram's support: zero probability
        edges = t["rad_edges"]
        in_support = ((test_radii >= edges[0]) & (test_radii <= edges[-1])
                      & t["mass_ok"])
        xi = torch.clamp((test_radii[..., None] > edges[1:]).sum(-1), 0,
                         self.histogram.shape[0] - 1)
        vals = t["histogram"][xi, t["yi"].expand_as(xi)]
        total = torch.where(below_tov & in_support, vals, 0.0).sum(1)
        return torch.log(torch.clamp(total, min=1e-300))


class JointEoSConstraint:
    """Sum of constraint terms (reference ``JointEoSConstraint`` :57-65)."""

    def __init__(self, *constraints):
        self.constraints = list(constraints)

    def __call__(self, parameters, curves=None):
        total = 0.0
        for c in self.constraints:
            total = total + c(parameters, curves)
        return total


def tabulate_weighted_eos(eos_set, constraint, outdir, previous_weights=None,
                          normalise=True, device=None):
    """Re-weight and sort a macro EOS family under constraints.

    Counterpart of ``tabulate_weighted_eos`` (reference
    eos_likelihood.py:262-326): every EOS's curve is scored in one batched
    call on ``device`` (default the CUDA card). Writes ``outdir/sorted/<i>.dat`` (R, M, Lambda
    columns, ascending weight) and ``outdir/eos_weights.dat``. Returns
    (weight path, sorted dir, EOS kept, weights ascending).
    """
    from scipy.special import logsumexp

    device = resolve_device(device)
    idx = torch.arange(eos_set.n_eos, device=device)
    curves = {"masses": eos_set.mass_grid,
              "radii": eos_set.rows(idx, "radii")}
    with torch.no_grad():
        log_w = constraint({"TOV_mass": eos_set.rows(idx, "tov_mass")},
                           curves)
    log_w = torch.as_tensor(log_w).expand(eos_set.n_eos).cpu().numpy() \
        .astype(np.float64)
    good = np.isfinite(log_w)
    log_w = log_w[good]
    idx_good = np.flatnonzero(good)
    if previous_weights is not None:
        prev = np.asarray(previous_weights, dtype=np.float64)[good]
        log_w = log_w + np.log(np.maximum(prev, 1e-300))
    if normalise:
        log_w = log_w - logsumexp(log_w)
    weights = np.exp(log_w)

    sorted_dir = os.path.join(outdir, "sorted")
    os.makedirs(sorted_dir, exist_ok=True)
    order = np.argsort(weights)
    m = np.asarray(eos_set.mass_grid)
    for rank, j in enumerate(order):
        i = idx_good[j]
        r = eos_set.radii[i]
        lam = np.exp(eos_set.log_lambdas[i])
        keep = r > 0
        np.savetxt(os.path.join(sorted_dir, f"{rank + 1}.dat"),
                   np.column_stack([r[keep], m[keep], lam[keep]]))
    weight_path = os.path.join(outdir, "eos_weights.dat")
    np.savetxt(weight_path, weights[order])
    return weight_path, sorted_dir, int(good.sum()), weights[order]
