"""Best-fit reports, light-curve bands and figures.

Port of ``nmma_tpu/plotting.py`` (the reference's ``nmma/em/plotting_utils.py``
light-curve fit panels and ``nmma/em/lightcurve_handling.py:22-152`` best-fit
JSON with per-filter chi-square dicts, plus a self-contained corner plot).

Each function that evaluates a model is split in two:

* the compute half runs on the analysis's device and needs no matplotlib:
  ``compute_chisquare_dict`` evaluates the model once at the best-fit point,
  and ``lightcurve_bands`` evaluates the best-fit point and up to 60 posterior
  draws in one batched model call, so on the card each is one launch of the
  model's kernel;
* the draw half is host matplotlib, with the JAX package's figures and file
  names. Without matplotlib a drawing function raises an ImportError that
  names it; no figure is skipped quietly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .plotting_utils import pyplot, setup_multi_axes


def _as_batch(points, device):
    """{name: [B] f32 tensor} from {name: float or sequence}."""
    return {k: torch.as_tensor(np.atleast_1d(np.asarray(v, np.float32)),
                               device=device) for k, v in points.items()}


@torch.no_grad()
def compute_chisquare_dict(analysis, bestfit_params):
    """Per-filter chi^2/dof at the best-fit point, raw and with the
    systematic error budget (reference compute_chisquare_dict,
    lightcurve_handling.py:113-152): one model evaluation at B = 1 on the
    analysis's device."""
    lk = analysis.likelihood
    params = _as_batch(bestfit_params, lk.data.times.device)
    obs_t, mags = lk.model(params)
    est = lk.expected_mags(obs_t, mags)[0].cpu().numpy()        # [F, N]
    sigma_sys = lk.systematics(params, lk.data.times)[0].cpu().numpy()
    data = lk.data
    valid, sigmas, obs_mags = (data.valid.cpu().numpy(),
                               data.sigmas.cpu().numpy(),
                               data.mags.cpu().numpy())
    out = {}
    for i, filt in enumerate(lk.filters):
        det = valid[i] & np.isfinite(sigmas[i])
        if det.sum() == 0:
            continue
        resid = (obs_mags[i] - est[i])[det]
        sig = sigmas[i][det]
        sys_err = sigma_sys[i][det]
        dof = max(int(det.sum()), 1)
        out[filt] = {
            "chi2_per_dof": float(np.sum(resid**2 / sig**2) / dof),
            "chi2_per_dof_with_systematics": float(
                np.sum(resid**2 / (sig**2 + sys_err**2)) / dof),
            "n_points": int(det.sum()),
        }
    return out


def post_process_bestfit(analysis, result=None, save=True):
    """Best-fit JSON report ``{label}_bestfit.json`` (reference
    post_process_bestfit :22-111), with the JAX package's keys."""
    result = analysis.result if result is None else result
    bestfit = analysis.bestfit_parameters(result)
    chi2 = compute_chisquare_dict(analysis, bestfit)
    payload = {
        "Best fit index": int(np.argmax(result.logl)),
        # an MCMC result carries logz=nan (no evidence estimate); None
        # keeps the report strict-JSON parseable
        "log_evidence": None if np.isnan(result.logz) else result.logz,
        "log_evidence_err": (None if np.isnan(result.logz_err)
                             else result.logz_err),
        "log_likelihood": float(result.logl.max()),
        "posterior_parameters": bestfit,
        "chi2_per_dof": chi2,
    }
    if save:
        path = os.path.join(analysis.config.outdir,
                            f"{analysis.config.label}_bestfit.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
    return payload


def band_draws(result, n_band_samples=60):
    """Indices into ``result.samples_u`` of the band's posterior draws: at
    most ``n_band_samples`` evenly spaced equal-weight posterior samples,
    as the JAX package picks them."""
    idx = result.posterior_indices()
    return idx[np.linspace(0, len(idx) - 1,
                           min(n_band_samples, len(idx))).astype(int)]


@torch.no_grad()
def lightcurve_bands(analysis, result=None, n_band_samples=60):
    """The arrays of the light-curve fit figure, from one model call at
    B = 1 + S on the analysis's device: the best-fit point (the largest
    logL) and S <= ``n_band_samples`` posterior draws (``band_draws``).

    Returns numpy arrays: ``times`` [T] and ``best`` [F, T], the best fit's
    observer times and magnitudes; ``band_times`` [T], the first draw's
    times; ``draws`` [S, F, T]; ``lo`` and ``hi`` [F, T], the 5th and 95th
    percentiles over the draws, non-finite magnitudes left out."""
    result = analysis.result if result is None else result
    best = int(np.argmax(result.logl))
    take = band_draws(result, n_band_samples)
    u = torch.as_tensor(
        np.concatenate([result.samples_u[[best]], result.samples_u[take]]),
        dtype=torch.float32, device=analysis.likelihood.data.times.device)
    obs_t, mags = analysis.likelihood.model(analysis.priors.transform(u))
    obs_t, mags = obs_t.cpu().numpy(), mags.cpu().numpy()
    draws = mags[1:]
    masked = np.where(np.isfinite(draws), draws, np.nan)
    return {"times": obs_t[0], "best": mags[0], "band_times": obs_t[1],
            "draws": draws,
            "lo": np.nanpercentile(masked, 5, axis=0),
            "hi": np.nanpercentile(masked, 95, axis=0)}


def lightcurve_fit_plot(analysis, result=None, n_band_samples=60,
                        save_path=None):
    """Best-fit light-curve panels with posterior spread bands,
    ``{label}_lightcurves.png`` (counterpart of ``basic_em_analysis_plot``,
    em/plotting_utils.py)."""
    plt = pyplot()
    bands = lightcurve_bands(analysis, result, n_band_samples)
    lk = analysis.likelihood
    filters = lk.filters
    data = lk.data
    times, mags, sigmas, valid = (data.times.cpu().numpy(),
                                  data.mags.cpu().numpy(),
                                  data.sigmas.cpu().numpy(),
                                  data.valid.cpu().numpy())
    n = len(filters)
    ncols = min(3, n)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(4.2 * ncols, 3.2 * nrows),
                             squeeze=False, sharex=True)
    for i, filt in enumerate(filters):
        ax = axes[i // ncols][i % ncols]
        det = valid[i] & np.isfinite(sigmas[i])
        uplim = valid[i] & ~np.isfinite(sigmas[i])
        ax.errorbar(times[i][det], mags[i][det], yerr=sigmas[i][det],
                    fmt="o", ms=3, color="k", label="data")
        if uplim.any():
            ax.plot(times[i][uplim], mags[i][uplim], "v", color="gray", ms=5)
        sel = np.isfinite(bands["best"][i])
        ax.plot(bands["times"][sel], bands["best"][i][sel], color="C0",
                label="best fit")
        ax.fill_between(bands["band_times"], bands["lo"][i], bands["hi"][i],
                        alpha=0.25, color="C0")
        ax.invert_yaxis()
        ax.set_title(filt)
        ax.set_xlabel("time since trigger [days]")
        ax.set_ylabel("AB magnitude")
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    if save_path is None:
        save_path = os.path.join(analysis.config.outdir,
                                 f"{analysis.config.label}_lightcurves.png")
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def corner_plot(samples: dict, parameters=None, truths=None, save_path=None,
                bins=30):
    """Minimal corner plot (replaces the external ``corner`` dependency)."""
    plt = pyplot()
    if parameters is None:
        parameters = [k for k, v in samples.items()
                      if np.ndim(v) == 1 and np.std(v) > 0
                      and k != "log_likelihood"]
    n = len(parameters)
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n))
    if n == 1:
        axes = np.array([[axes]])
    for i, pi in enumerate(parameters):
        for j, pj in enumerate(parameters):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(samples[pi], bins=bins, histtype="step",
                        color="C0", density=True)
                med, lo, hi = np.percentile(samples[pi], [50, 16, 84])
                ax.set_title(f"{pi}\n${med:.3f}^{{+{hi-med:.3f}}}"
                             f"_{{-{med-lo:.3f}}}$", fontsize=8)
                if truths and pi in truths:
                    ax.axvline(truths[pi], color="C3", lw=1)
            else:
                ax.hist2d(samples[pj], samples[pi], bins=bins, cmap="Blues")
                if truths and pi in truths and pj in truths:
                    ax.plot(truths[pj], truths[pi], "s", color="C3", ms=4)
            if i == n - 1:
                ax.set_xlabel(pj, fontsize=8)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(pi, fontsize=8)
            else:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
    return save_path


def eos_mr_band_plot(eos_set, weights=None, credible=(0.68, 0.95),
                     constraints=None, save_path="eos_mr_band.png"):
    """Weighted M-R credible-band diagnostics plot.

    Counterpart of ``final_diagnostics`` (nmma/eos/eos_likelihood.py:67-130):
    per mass-grid point, the weighted radius quantiles over the EOS family,
    with optional constraint annotations.
    """
    plt = pyplot()
    radii = np.asarray(eos_set.radii)              # [N, M]
    m_grid = np.asarray(eos_set.mass_grid)
    n = radii.shape[0]
    w = np.ones(n) / n if weights is None else \
        np.asarray(weights, dtype=np.float64)
    w = w / w.sum()

    fig, ax = plt.subplots(figsize=(6, 4.5))
    colors = ["C0", "C1"]
    for ci, c in enumerate(sorted(credible, reverse=True)):
        lo_q, hi_q = 0.5 - c / 2, 0.5 + c / 2
        lo = np.full(len(m_grid), np.nan)
        hi = np.full(len(m_grid), np.nan)
        for k in range(len(m_grid)):
            r = radii[:, k]
            ok = r > 0                       # EOSs that reach this mass
            if ok.sum() < 2:
                continue
            order = np.argsort(r[ok])
            cdf = np.cumsum(w[ok][order])
            cdf /= cdf[-1]
            lo[k] = np.interp(lo_q, cdf, r[ok][order])
            hi[k] = np.interp(hi_q, cdf, r[ok][order])
        ax.fill_betweenx(m_grid, lo, hi, alpha=0.35,
                         color=colors[ci % len(colors)],
                         label=f"{int(c * 100)}% credible")
    for c in (constraints or []):
        label = getattr(c, "name", None) or type(c).__name__
        if hasattr(c, "measured_mass"):
            ax.axhline(float(c.measured_mass), ls="--", lw=1, color="gray")
            ax.text(ax.get_xlim()[1], float(c.measured_mass), f" {label}",
                    va="center", fontsize=7)
    ax.set_xlabel("radius [km]")
    ax.set_ylabel("mass [Msun]")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_marginalised_bands(times, bands, filters, save_path,
                            percentiles=(5, 50, 95)):
    """Per-filter percentile bands of a marginalised light-curve set
    (counterpart of the reference's ``lc_plot_with_histogram`` output,
    em/plotting_utils.py): shaded [lo, hi] region + median track, one
    panel per filter, magnitudes increasing downward."""
    plt = pyplot()
    bands = np.asarray(bands)
    times = np.asarray(times)
    fig, axes = setup_multi_axes(len(filters))
    for fi, (filt, ax) in enumerate(zip(filters, axes)):
        lo, med, hi = bands[0, fi], bands[1, fi], bands[-1, fi]
        ok = np.isfinite(lo) & np.isfinite(hi)
        ax.fill_between(times[ok], lo[ok], hi[ok], alpha=0.3,
                        label=f"{percentiles[0]}-{percentiles[-1]}%")
        okm = np.isfinite(med)
        ax.plot(times[okm], med[okm], lw=1.2, label="median")
        ax.set_xscale("log")
        ax.invert_yaxis()
        ax.set_title(filt, fontsize=9)
        ax.set_xlabel("time [days]")
        ax.set_ylabel("mag")
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
