"""Photometric (EM) likelihood as one batched logL function.

PyTorch counterpart of ``nmma_tpu/likelihood/em.py`` (the reference's
``MultiFilterTransient``/``BasicEMTransient``,
nmma/em/em_likelihood.py:140-352). Observations are padded once into dense
``[F, N]`` masked tensors, and ``log_likelihood(params) -> [B]`` evaluates
model, interpolation onto the observation times, composite-filter averaging,
systematics, truncated-Gaussian chi^2 and upper-limit log-survival terms for
a whole live-point batch.

Statistical semantics matched to the reference:
  * detections: truncated-Gaussian logpdf with upper truncation at the
    detection limit (``truncated_gaussian``, reference :252-256);
  * non-detections (inf error): Gaussian log-survival-function with the
    *systematic* error as scale (reference :243-249);
  * total sigma^2 = data^2 + systematic^2 (reference :214-216);
  * any NaN / all-inf model => the -1e30 sentinel (reference sanity checks
    :206-209, :306-311).

On a CUDA device everything after the source's magnitudes (the rest of the
detector frame, the interpolation and the terms) is one launch of K6
(``ops/em_likelihood_kernel.py``); on the CPU the plain chain runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, tracing
from ..filters import resolve_filter
from ..models.base import DetectorLightCurveModel
from ..ops import em_likelihood_kernel
from .systematics import SystematicsModel

_NEG_INF = -1e30  # finite stand-in for nan_to_num(-inf); safe in f32
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass
class PhotometryData:
    """Dense masked photometry: [F, N] tensors padded over observations."""

    times: torch.Tensor      # [F, N] days since trigger
    mags: torch.Tensor       # [F, N]
    sigmas: torch.Tensor     # [F, N]; inf marks an upper limit
    valid: torch.Tensor      # [F, N] bool: real sample (not padding)

    @classmethod
    def from_dict(cls, data: dict, filters=None, device=None):
        """Pad the nmma-standard per-filter dict to dense f32 tensors on
        ``device`` (the CUDA card unless the caller passes one).

        Returns (PhotometryData, filters). Padding samples carry
        valid=False and are excluded from every statistic.
        """
        device = resolve_device(device)
        if filters is None:
            filters = list(data.keys())
        n_max = max(len(np.atleast_1d(data[f]["time"])) for f in filters)
        shape = (len(filters), n_max)
        times = np.zeros(shape)
        mags = np.zeros(shape)
        sigmas = np.full(shape, np.inf)
        valid = np.zeros(shape, dtype=bool)
        for i, f in enumerate(filters):
            t = np.atleast_1d(data[f]["time"])
            times[i, :len(t)] = t
            mags[i, :len(t)] = np.atleast_1d(data[f]["mag"])
            sigmas[i, :len(t)] = np.atleast_1d(data[f]["mag_error"])
            valid[i, :len(t)] = True

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(f32(times), f32(mags), f32(sigmas),
                   torch.as_tensor(valid, device=device)), list(filters)


def truncated_gaussian_logpdf(x, loc, scale, upper_lim):
    """ln truncnorm.pdf(x; a=-inf, b=(lim-loc)/scale, loc, scale): the
    standard normal logpdf minus log CDF of the truncation bound
    (``truncated_gaussian``, nmma/em/em_likelihood.py:252-256)."""
    u = (x - loc) / scale
    log_phi = -0.5 * u * u - _HALF_LOG_2PI - torch.log(scale)
    b = (upper_lim - loc) / scale
    # log Phi(b); 0 for lim = inf
    unbounded = torch.isposinf(b)
    log_cdf = torch.where(unbounded, 0.0, torch.special.log_ndtr(
        torch.where(unbounded, 0.0, b)))
    return log_phi - log_cdf


def gaussian_logsf(x, loc, scale):
    """ln(1 - Phi((x - loc)/scale)) — upper-limit penalty (reference :243-249)."""
    return torch.special.log_ndtr(-(x - loc) / scale)


class EMLikelihood:
    """Photometric likelihood bound to one detector model + dataset."""

    def __init__(self, light_curve_model: DetectorLightCurveModel,
                 data: PhotometryData, filters,
                 systematics: SystematicsModel | None = None,
                 detection_limit=None):
        self.model = light_curve_model
        self.data = data
        self.filters = list(filters)
        self.systematics = systematics or SystematicsModel(self.filters)
        device = data.times.device

        # static composite-filter resolution: observed filter -> model rows
        # + averaging weights (reference update_lightcurve_reference,
        # em_likelihood.py:313-335 and utils.get_filter_name_mapping)
        model_filters = list(self.model.filters)
        rows, weights = [], []
        for f in self.filters:
            kind, payload = resolve_filter(
                f, available=self.model.source.filter_names)
            helper = [payload] if kind == "direct" else list(payload)
            rows.append([model_filters.index(h) for h in helper])
            weights.append([1.0 / len(helper)] * len(helper))
        k_max = max(len(r) for r in rows)
        for r, w in zip(rows, weights):
            r.extend([0] * (k_max - len(r)))
            w.extend([0.0] * (k_max - len(w)))
        self._helper_rows = torch.tensor(rows, device=device)       # [F, K]
        self._helper_weights = torch.tensor(
            weights, dtype=torch.float32, device=device)[:, :, None]

        # detection limits per observed filter (reference :303-304)
        if detection_limit is None:
            detection_limit = np.inf
        if isinstance(detection_limit, dict):
            lim = [detection_limit.get(f, np.inf) for f in self.filters]
        elif np.isscalar(detection_limit):
            lim = [float(detection_limit)] * len(self.filters)
        else:
            lim = list(detection_limit)
        self.detection_limit = torch.tensor(
            lim, dtype=torch.float32, device=device)[:, None]      # [F, 1]
        # K6's forms of the helper rows, their weights and the limits
        self._k6_rows = self._helper_rows.to(torch.int32).contiguous()
        self._k6_weights = self._helper_weights[:, :, 0].contiguous()
        self._k6_limit = self.detection_limit[:, 0].contiguous()

    def expected_mags(self, obs_times_model, model_mags):
        """Model mags at the observation times, ``[B, F_obs, N]``.

        Per observed filter: interpolate each helper model row onto that
        filter's observation times (inf outside the modelled range), then
        average (composite filters are magnitude means). The JAX package
        contracts a dense hat basis [F, N, T] to avoid gathers on the TPU;
        here each query finds its cell by binary search and gathers the two
        hat weights that are non-zero, computed by the same formulas, so
        the values agree. Validity uses the contiguous-finite-block
        assumption of model light curves: queries outside
        [x[first_finite], x[last_finite]] get inf.
        """
        x = obs_times_model                                   # [B, T]
        b, n_grid = x.shape
        rows = model_mags[:, self._helper_rows]               # [B, F, K, T]
        clean = torch.where(torch.isfinite(rows), rows, 0.0)
        n_f, n_k = self._helper_rows.shape
        xq = self.data.times                                  # [F, N]
        n_obs = xq.shape[1]

        # cell j with x[j] <= xq < x[j+1], clamped to [0, T-2]
        xq_b = xq.reshape(1, -1).expand(b, -1).contiguous()   # [B, F*N]
        j = torch.searchsorted(x.contiguous(), xq_b, right=True) - 1
        j = torch.clamp(j, 0, n_grid - 2)
        x_l = torch.cat([x[:, :1], x[:, :-1]], dim=1)         # x[t-1]
        x_r = torch.cat([x[:, 1:], x[:, -1:]], dim=1)         # x[t+1]
        dl = torch.clamp(x - x_l, min=1e-30)
        dr = torch.clamp(x_r - x, min=1e-30)

        def hat(t):
            """Hat weight of grid node t at the queries, as the reference
            builds it: clip(min((xq-x_{t-1})/dl_t, (x_{t+1}-xq)/dr_t)),
            one-sided at the ends (rising side 1 at t = 0, falling side 1
            at t = T-1), so a query on x[0] or x[T-1] reads y there as
            ``np.interp`` does; the JAX package's padded widths give 0."""
            up = (xq_b - x_l.gather(1, t)) / dl.gather(1, t)
            dn = (x_r.gather(1, t) - xq_b) / dr.gather(1, t)
            up = torch.where(t == 0, 1.0, up)
            dn = torch.where(t == n_grid - 1, 1.0, dn)
            return torch.clamp(torch.minimum(up, dn), 0.0, 1.0)

        w_lo = hat(j).reshape(b, 1, n_f, n_obs)
        w_hi = hat(j + 1).reshape(b, 1, n_f, n_obs)
        # gather the two neighbouring model values per (filter, helper)
        idx = j.reshape(b, n_f, 1, n_obs).expand(b, n_f, n_k, n_obs)
        y_lo = clean.gather(3, idx)                           # [B, F, K, N]
        y_hi = clean.gather(3, idx + 1)
        est_k = w_lo.transpose(1, 2) * y_lo + w_hi.transpose(1, 2) * y_hi

        valid = torch.isfinite(rows)                          # [B, F, K, T]
        n_valid = valid.sum(dim=3)
        first = torch.argmax(valid.to(torch.uint8), dim=3)
        last = n_grid - 1 - torch.argmax(
            torch.flip(valid, (3,)).to(torch.uint8), dim=3)
        x_first = x.gather(1, first.reshape(b, -1)).reshape(b, n_f, n_k, 1)
        x_last = x.gather(1, last.reshape(b, -1)).reshape(b, n_f, n_k, 1)
        tq = xq[None, :, None, :]                             # [1, F, 1, N]
        ok = (tq >= x_first) & (tq <= x_last) & (n_valid[..., None] >= 2)
        est_k = torch.where(ok, est_k, math.inf)
        wrow = self._helper_weights                           # [F, K, 1]
        return torch.sum(torch.where(wrow > 0.0, est_k * wrow, 0.0), dim=2)

    def k6_operands(self, parameters):
        """The operands of K6 (``ops/em_likelihood_kernel.py``) for a
        parameter dict ``{name: [B]}``: the detector frame up to the source
        and sigma_sys run eagerly, the rest is the kernel's."""
        p, mags = self.model.frame(parameters)
        sigma_sys = self.systematics(parameters, self.data.times)
        d, model = self.data, self.model
        return dict(
            mags=mags.contiguous(), t_grid=model.sample_times,
            z=p["redshift"].contiguous(),
            timeshift=p["timeshift"].contiguous(),
            dm=(None if model.source.apparent_amplitude
                else p["distance_modulus"].contiguous()),
            ebv=p["Ebv"].contiguous(), nu_nodes=model.nu_nodes,
            nu_weights=model.nu_weights, helper_rows=self._k6_rows,
            helper_weights=self._k6_weights, times=d.times,
            data_mags=d.mags, sigmas=d.sigmas, valid=d.valid,
            detection_limit=self._k6_limit,
            sigma_sys=sigma_sys.contiguous(),
            extinction_law=model.extinction_law)

    def log_likelihood(self, parameters):
        """``[B]`` log-likelihoods for a parameter dict ``{name: [B]}``:
        on a CUDA device the detector frame up to the source, sigma_sys and
        K6; on the CPU :meth:`log_likelihood_plain`."""
        with tracing.span("likelihood.log_likelihood"):
            if self.data.times.device.type != "cpu" \
                    and not self.model.source.bolometric:
                return em_likelihood_kernel.em_log_likelihood(
                    **self.k6_operands(parameters))
            return self.log_likelihood_plain(parameters)

    def log_likelihood_plain(self, parameters):
        """``[B]`` log-likelihoods by the plain chain on any device: the
        detector model, the interpolation onto the epochs, sigma_sys and
        the terms, eagerly."""
        obs_times_model, model_mags = self.model(parameters)
        with tracing.span("likelihood.expected_mags"):
            est = self.expected_mags(obs_times_model,
                                     model_mags)              # [B, F, N]
        sigma_sys = self.systematics(parameters, self.data.times)

        d = self.data
        is_det = d.valid & torch.isfinite(d.sigmas)
        is_lim = d.valid & ~torch.isfinite(d.sigmas)

        total_sigma = torch.sqrt(d.sigmas ** 2 + sigma_sys ** 2)
        safe_sigma = torch.where(is_det, total_sigma, 1.0)
        safe_est = torch.where(torch.isfinite(est), est, 1e30)

        chi2_terms = truncated_gaussian_logpdf(
            d.mags, safe_est, safe_sigma, self.detection_limit)
        chi2 = torch.where(is_det, chi2_terms, 0.0).sum(dim=(1, 2))
        sf_terms = gaussian_logsf(d.mags, safe_est,
                                  torch.clamp(sigma_sys, min=1e-10))
        logsf = torch.where(is_lim, sf_terms, 0.0).sum(dim=(1, 2))

        logl = chi2 + logsf
        # model completely invalid (all-inf in any used band) => sentinel
        any_finite_per_band = torch.any(torch.isfinite(est) & d.valid,
                                        dim=2)
        used_band = torch.any(d.valid, dim=1)
        ok = torch.all(any_finite_per_band | ~used_band, dim=1)
        logl = torch.where(ok, logl, _NEG_INF)
        return torch.where(torch.isnan(logl), _NEG_INF,
                           torch.clamp(logl, min=_NEG_INF))

    def __call__(self, parameters):
        return self.log_likelihood(parameters)
