"""Posterior comparison plots: multi-corner overlays, marginal-histogram
grids, R14 trend.

Counterpart of ``nmma/post_processing/plotting_routines.py`` (:17-350):
stacked corner plots over several result files with shared limits and the
LaTeX label mapping, per-parameter histogram panels, and the
R14-vs-event-count trend plot of ``combine-EOS``.

Port of ``nmma_tpu/post_processing/plotting_routines.py``: host numpy and
matplotlib, with matplotlib imported inside the drawing functions (an
ImportError naming it where it is not installed). A csv or whitespace
posterior table is read with numpy, its delimiter sniffed from the header
as pandas' ``sep=None`` does; ``shared_limits`` gives the JAX package's
limits bit for bit.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..plotting_utils import (fading_cmap, latex_label, pyplot,
                              setup_multi_axes, sig_lims)

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
           "#8c564b"]


def load_posterior_file(path):
    """Result file -> {param: samples}: our npz results ('posterior_*'
    arrays), plain npz/csv posterior tables."""
    if path.endswith(".npz"):
        z = np.load(path)
        post = {k[len("posterior_"):]: np.asarray(z[k])
                for k in z.files if k.startswith("posterior_")}
        if post:
            return post
        return {k: np.asarray(z[k]) for k in z.files
                if np.ndim(z[k]) == 1}
    with open(path) as fh:
        header = fh.readline()
    try:
        delimiter = csv.Sniffer().sniff(header, delimiters=",;\t ").delimiter
    except csv.Error:                     # one column: nothing to split
        delimiter = " "
    keys = (header.split() if delimiter == " "
            else [k.strip() for k in header.rstrip("\n").split(delimiter)])
    table = np.loadtxt(path, delimiter=None if delimiter == " "
                       else delimiter, skiprows=1, ndmin=2)
    return {k: table[:, i] for i, k in enumerate(keys)}


def shared_limits(posteriors, keys, quantiles=(0.001, 0.999)):
    """Common per-parameter plot ranges across posterior sets
    (reference setup_plot_quantities limit logic)."""
    lims = {}
    for k in keys:
        lo = min(np.quantile(p[k], quantiles[0]) for p in posteriors
                 if k in p)
        hi = max(np.quantile(p[k], quantiles[1]) for p in posteriors
                 if k in p)
        lims[k] = (lo, hi)
    return lims


def plot_histograms_only(posteriors, keys=None, labels=None, truths=None,
                         save_path=None, n_bins=40):
    """Per-parameter 1-D marginal grid for several posterior sets
    (reference plot_histograms_only)."""
    plt = pyplot()
    posteriors = list(posteriors)
    if keys is None:
        keys = [k for k in posteriors[0]
                if all(k in p for p in posteriors)
                and np.std(posteriors[0][k]) > 0]
    labels = labels or [f"run {i}" for i in range(len(posteriors))]
    lims = shared_limits(posteriors, keys)
    fig, axes = setup_multi_axes(len(keys))
    for ax, k in zip(axes, keys):
        bins = np.linspace(*lims[k], n_bins + 1)
        for i, post in enumerate(posteriors):
            if k not in post:
                continue
            ax.hist(post[k], bins=bins, density=True, histtype="step",
                    lw=1.6, color=_COLORS[i % len(_COLORS)],
                    label=labels[i])
        if truths and k in truths:
            ax.axvline(truths[k], color="k", ls="--", lw=1)
        ax.set_xlabel(latex_label(k))
        ax.set_yticks([])
    axes[0].legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def plot_multi_corner(posteriors, keys=None, labels=None, truths=None,
                      save_path=None, n_bins=30):
    """Overlaid corner plot across posterior sets with shared limits
    (reference plot_multi_corner / setup_corner_plot)."""
    plt = pyplot()
    posteriors = list(posteriors)
    if keys is None:
        keys = [k for k in posteriors[0]
                if all(k in p for p in posteriors)
                and np.std(posteriors[0][k]) > 0]
    labels = labels or [f"run {i}" for i in range(len(posteriors))]
    lims = shared_limits(posteriors, keys)
    n = len(keys)
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n))
    axes = np.atleast_2d(axes)
    for i, ki in enumerate(keys):
        for j, kj in enumerate(keys):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                bins = np.linspace(*lims[ki], n_bins + 1)
                for c, post in enumerate(posteriors):
                    ax.hist(post[ki], bins=bins, density=True,
                            histtype="step",
                            color=_COLORS[c % len(_COLORS)],
                            label=labels[c])
                if truths and ki in truths:
                    ax.axvline(truths[ki], color="k", ls="--", lw=1)
                if len(posteriors) == 1:
                    # significant-figure quantile title (reference
                    # sig_lims, core/utils.py:186-204)
                    ax.set_title(sig_lims(np.asarray(posteriors[0][ki])),
                                 fontsize=9)
                ax.set_yticks([])
            else:
                for c, post in enumerate(posteriors):
                    xb = np.linspace(*lims[kj], n_bins + 1)
                    yb = np.linspace(*lims[ki], n_bins + 1)
                    h, _, _ = np.histogram2d(post[kj], post[ki],
                                             bins=[xb, yb])
                    if h.max() <= 0:
                        continue
                    # 2-sigma-ish contour levels from the counts CDF
                    flat = np.sort(h.ravel())[::-1]
                    cdf = np.cumsum(flat) / flat.sum()
                    levels = sorted({flat[np.searchsorted(cdf, q)]
                                     for q in (0.68, 0.95)})
                    ax.contourf(
                        0.5 * (xb[1:] + xb[:-1]), 0.5 * (yb[1:] + yb[:-1]),
                        h.T, levels=levels + [h.max() + 1],
                        cmap=fading_cmap(_COLORS[c % len(_COLORS)]),
                        alpha=0.6)
                if truths:
                    if kj in truths:
                        ax.axvline(truths[kj], color="k", ls="--", lw=0.8)
                    if ki in truths:
                        ax.axhline(truths[ki], color="k", ls="--", lw=0.8)
                ax.set_ylim(*lims[ki])
            ax.set_xlim(*lims[kj])
            if i == n - 1:
                ax.set_xlabel(latex_label(kj), fontsize=9)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(latex_label(ki), fontsize=9)
            else:
                ax.set_yticklabels([])
    axes[0, 0].legend(fontsize=8, loc="upper left",
                      bbox_to_anchor=(1.05, 1.0))
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def plot_r14_trend(r14_medians, r14_lows, r14_highs, save_path=None,
                   true_value=None):
    """R_1.4 credible interval vs number of combined events (reference
    plot_R14_trend, the combine-EOS diagnostic)."""
    plt = pyplot()
    n = np.arange(1, len(r14_medians) + 1)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(n, r14_medians, "o-", color=_COLORS[0])
    ax.fill_between(n, r14_lows, r14_highs, alpha=0.3, color=_COLORS[0])
    if true_value is not None:
        ax.axhline(true_value, color="k", ls="--", lw=1)
    ax.set_xlabel("number of events")
    ax.set_ylabel(latex_label("R_14"))
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig


def main(cli_args=None):
    """``nmma-plot-multi-corner`` — overlay posterior result files."""
    import argparse
    p = argparse.ArgumentParser("nmma-plot-multi-corner")
    p.add_argument("results", nargs="+", help="result .npz/.csv files")
    p.add_argument("--labels", default=None,
                   help="comma-separated overlay labels")
    p.add_argument("--parameters", default=None,
                   help="comma-separated parameter subset")
    p.add_argument("--outfile", default="multi_corner.png")
    p.add_argument("--histograms-only", action="store_true")
    args = p.parse_args(cli_args)
    posts = [load_posterior_file(f) for f in args.results]
    labels = args.labels.split(",") if args.labels else \
        [os.path.basename(f) for f in args.results]
    keys = args.parameters.split(",") if args.parameters else None
    fn = plot_histograms_only if args.histograms_only else plot_multi_corner
    fn(posts, keys=keys, labels=labels, save_path=args.outfile)
    print(f"wrote {args.outfile}")
    return args.outfile
