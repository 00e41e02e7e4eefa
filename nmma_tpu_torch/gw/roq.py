"""Reduced-order quadrature (ROQ) GW likelihood, with basis construction.

PyTorch counterpart of ``nmma_tpu/gw/roq.py`` (the reference's
``ROQGravitationalWaveTransient`` option, ``nmma/gw/gw_likelihood.py
:164-207`` with ``roq_likelihood_kwargs:57-95``, which reads externally
built LAL bases). The basis is built here from prior-drawn training
waveforms: a truncated SVD with empirical-interpolation (EIM) nodes, for the
linear <d|h> and the quadratic <h|h> terms, host-side in float64 (numpy,
as in the JAX package; ``ROQBasis.save``/``load`` share its ``.npz``
format). A call evaluates the ``[B]`` templates at the EIM nodes only:

    <d|h>  ~= sum_k w_k h(F_k)         w = (A^-1)^T b,  b_j = 4 df sum_f d* B_j / S
    <h|h>  ~= sum_k v_k |h(G_k)|^2     (the same construction on |h|^2)

The training draws come from a seeded ``torch.Generator``, so a basis built
here is not the JAX package's basis; a basis saved by either package loads
in both.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .likelihood import log_i0, project_signal
from .waveforms import taylorf2_tidal


def _empirical_interpolation(basis):
    """Greedy EIM node selection. basis [n, F] (rows orthonormal-ish).

    Returns (nodes [n], interpolant matrix A [n, n] with
    A[i, j] = basis_j(F_i))."""
    n, _ = basis.shape
    nodes = [int(np.argmax(np.abs(basis[0])))]
    for i in range(1, n):
        sub = basis[:i][:, nodes]                       # [i, i]
        coeff = np.linalg.solve(sub.T, basis[i][nodes])  # interpolate e_i
        resid = basis[i] - coeff @ basis[:i]
        nodes.append(int(np.argmax(np.abs(resid))))
    nodes = np.asarray(nodes)
    a_mat = basis[:, nodes].T                           # [n, n]
    return nodes, a_mat


class ROQBasis:
    """Linear + quadratic reduced bases with EIM nodes for one frequency
    grid (shared across interferometers with identical grids)."""

    def __init__(self, frequencies, lin_basis, lin_nodes, lin_a,
                 quad_basis, quad_nodes, quad_a):
        self.frequencies = np.asarray(frequencies)
        self.lin_basis = lin_basis          # [m, F] complex
        self.lin_nodes = lin_nodes          # [m]
        self.lin_a = lin_a                  # [m, m]
        self.quad_basis = quad_basis        # [q, F] real
        self.quad_nodes = quad_nodes        # [q]
        self.quad_a = quad_a                # [q, q]

    @property
    def n_lin(self):
        return len(self.lin_nodes)

    @property
    def n_quad(self):
        return len(self.quad_nodes)

    def save(self, path):
        np.savez_compressed(
            path, frequencies=self.frequencies,
            lin_basis_re=self.lin_basis.real,
            lin_basis_im=self.lin_basis.imag,
            lin_nodes=self.lin_nodes, lin_a_re=self.lin_a.real,
            lin_a_im=self.lin_a.imag, quad_basis=self.quad_basis,
            quad_nodes=self.quad_nodes, quad_a=self.quad_a)

    @classmethod
    def load(cls, path):
        z = np.load(path)
        return cls(z["frequencies"],
                   z["lin_basis_re"] + 1j * z["lin_basis_im"],
                   z["lin_nodes"], z["lin_a_re"] + 1j * z["lin_a_im"],
                   z["quad_basis"], z["quad_nodes"], z["quad_a"])


def build_roq_bases(interferometers, waveform, priors, trigger_time,
                    n_training=512, tol=1e-5, seed=0, transform=None,
                    device=None):
    """Per-interferometer bases ``{ifo_name: ROQBasis}``, each trained on
    the detector-projected strain at the analysis trigger time (the exact
    runtime quantity: the response and time-delay phase ramp differ per
    detector)."""
    return {ifo.name: build_roq_basis(
        ifo.frequencies, waveform, priors, n_training=n_training, tol=tol,
        seed=seed, transform=transform, detector=ifo.detector,
        trigger_time=trigger_time, device=device)
        for ifo in interferometers}


def build_roq_basis(frequencies, waveform, priors, n_training=512,
                    tol=1e-5, seed=0, transform=None, detector=None,
                    trigger_time=0.0, device=None):
    """An :class:`ROQBasis` from ``n_training`` prior-drawn waveforms
    (projected onto ``detector`` when given, h_plus otherwise), evaluated
    in f32 on ``device`` through the runtime path: the basis must span the
    f32 waveforms the likelihood will see."""
    device = resolve_device(device)
    freqs = np.asarray(frequencies, dtype=np.float64)
    f = torch.as_tensor(freqs, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = priors.sample_units(gen, n_training)

    rows = []
    with torch.no_grad():
        for chunk in u.split(128):
            params = priors.transform(chunk)
            if transform is not None:
                params = transform(params)
            if detector is not None:
                h = project_signal(detector, waveform, f, params,
                                   trigger_time)
            else:
                h = waveform(f, params)[0]
            rows.append(h.cpu().numpy().astype(np.complex128))
    training = np.concatenate(rows)                       # [N, F] complex

    # normalize rows so the basis resolves shape, not amplitude
    norms = np.linalg.norm(training, axis=1, keepdims=True)
    training = training / np.maximum(norms, 1e-300)

    # held-out rows choose the mode count: the EIM residual on fresh
    # waveforms is what the likelihood error depends on
    n_hold = max(n_training // 8, 8)
    holdout, train = training[:n_hold], training[n_hold:]

    lin_basis, lin_nodes, lin_a = _cross_validated_basis(
        train, holdout, tol)
    quad_basis, quad_nodes, quad_a = _cross_validated_basis(
        np.abs(train) ** 2, np.abs(holdout) ** 2, tol)

    return ROQBasis(freqs, lin_basis, lin_nodes, lin_a, quad_basis,
                    quad_nodes, quad_a)


def _cross_validated_basis(train, holdout, tol, target_resid=1e-3,
                           max_cond=100.0, n_cap=192):
    """Pick the smallest mode count whose worst held-out EIM residual
    beats ``target_resid``; fall back to the best-achieved count.

    The search is restricted to compact, well-conditioned interpolants:
    past the true manifold dimension the SVD modes are f32 evaluation
    noise, and although such bases can look fine on held-out *training*
    rows, they amplify the independent noise of fresh waveforms through
    the nodal solve. ``target_resid`` defaults to the f32 waveform
    noise floor (~1e-3 relative) — the best any basis can do when the
    runtime evaluates waveforms in f32.
    """
    _, s, vh = np.linalg.svd(train, full_matrices=False)
    n_max = int(np.sum(s >= max(tol, 1e-12) * s[0]))
    n_max = min(max(n_max, 2), len(s), len(train) // 2, n_cap)

    hold_norm = np.linalg.norm(holdout, axis=1)
    best = None
    n = 2
    while n <= n_max:
        nodes, a_mat = _empirical_interpolation(vh[:n])
        if np.linalg.cond(a_mat) <= max_cond:
            coeff = np.linalg.solve(a_mat, holdout[:, nodes].T)  # [n, H]
            resid = holdout - coeff.T @ vh[:n]
            worst = float(np.max(np.linalg.norm(resid, axis=1)
                                 / np.maximum(hold_norm, 1e-300)))
            if best is None or worst < best[0]:
                best = (worst, n, nodes, a_mat)
            if worst < target_resid:
                break
        n = n + max(n // 4, 1)
    if best is None:
        nodes, a_mat = _empirical_interpolation(vh[:2])
        return vh[:2], nodes, a_mat
    _, n, nodes, a_mat = best
    return vh[:n], nodes, a_mat


class ROQGWLikelihood:
    """Multi-detector ROQ likelihood on ``device`` (the CUDA card unless
    the caller passes one): waveforms at the EIM nodes only, inner products
    from weights built on the host in float64.

    ``basis``: one :class:`ROQBasis` shared by every ifo (valid only if it
    was built projected for that single ifo), or ``{ifo_name: ROQBasis}``
    from :func:`build_roq_bases`."""

    def __init__(self, interferometers, basis,
                 waveform=taylorf2_tidal, trigger_time=0.0,
                 phase_marginalization=False, device=None):
        self.device = device = resolve_device(device)
        self.ifos = list(interferometers)
        self.basis = basis
        self.waveform = waveform
        self.trigger_time = float(trigger_time)
        self.phase_marginalization = bool(phase_marginalization)

        # strain-amplitude rescaling: raw quadratic weights are ~1e43
        # (1/PSD) and overflow f32; weights carry amp_scale powers and
        # templates are divided by amp_scale at evaluation
        d0 = np.abs(np.asarray(self.ifos[0].strain))
        vals = d0[d0 > 0]
        self._amp_scale = float(np.median(vals)) if vals.size else 1e-22

        def put(array, dtype=torch.float32):
            return torch.as_tensor(np.asarray(array), dtype=dtype,
                                   device=device)

        self._lin_w, self._quad_w, self._f_lin, self._f_quad = [], [], [], []
        for ifo in self.ifos:
            b = basis[ifo.name] if isinstance(basis, dict) else basis
            if len(ifo.frequencies) != len(b.frequencies) or not \
                    np.allclose(ifo.frequencies, b.frequencies):
                raise ValueError(f"{ifo.name}: frequency grid does not "
                                 "match the ROQ basis")
            df = 1.0 / ifo.duration
            psd = np.asarray(ifo.psd, dtype=np.float64)
            good = np.isfinite(psd) & (psd > 0)
            inv_s = np.where(good, 1.0 / psd, 0.0)
            d = np.asarray(ifo.strain, dtype=np.complex128)

            # b_j = 4 df sum_f conj(d) B_j / S ;  w = A^{-1 T} b
            b_lin = 4.0 * df * (b.lin_basis * (np.conj(d) * inv_s)
                                [None, :]).sum(axis=1)
            w_lin = np.linalg.solve(b.lin_a.T, b_lin) * self._amp_scale
            b_quad = 4.0 * df * (b.quad_basis * inv_s[None, :]).sum(
                axis=1)
            w_quad = np.linalg.solve(b.quad_a.T, b_quad) * \
                self._amp_scale ** 2
            self._lin_w.append(put(w_lin, torch.complex64))
            self._quad_w.append(put(w_quad.real))
            self._f_lin.append(put(b.frequencies[b.lin_nodes]))
            self._f_quad.append(put(b.frequencies[b.quad_nodes]))

    def log_likelihood_ratio(self, parameters):
        """``[B]`` log-likelihood ratios of a ``[B]`` parameter batch."""
        d_inner_h = h_inner_h = 0.0
        inv_amp = 1.0 / self._amp_scale
        for i, ifo in enumerate(self.ifos):
            h_lin = project_signal(ifo.detector, self.waveform,
                                   self._f_lin[i], parameters,
                                   self.trigger_time) * inv_amp   # [B, m]
            h_quad = project_signal(ifo.detector, self.waveform,
                                    self._f_quad[i], parameters,
                                    self.trigger_time) * inv_amp  # [B, q]
            d_inner_h = d_inner_h + torch.sum(self._lin_w[i] * h_lin, dim=-1)
            h_inner_h = h_inner_h + torch.sum(
                self._quad_w[i] * (torch.conj(h_quad) * h_quad).real, dim=-1)
        if self.phase_marginalization:
            return log_i0(torch.abs(d_inner_h)) - 0.5 * h_inner_h
        return d_inner_h.real - 0.5 * h_inner_h

    def log_likelihood(self, parameters):
        return self.log_likelihood_ratio(parameters)

    def __call__(self, parameters):
        return self.log_likelihood_ratio(parameters)
