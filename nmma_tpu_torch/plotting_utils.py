"""Shared figure plumbing: style setup, multi-axes grids, fading
colormaps, LaTeX label mapping, and the credible-interval helpers.

Port of ``nmma_tpu/plotting_utils.py`` (the reference's
``nmma/core/plotting_utils.py`` fig_setup / setup_multi_axes /
fading_cmap, :16-207, and the LaTeX ``label_mapping`` of
``nmma/core/conversion.py:831-888``). Host numpy and matplotlib only:
nothing here touches a device. matplotlib is imported inside the drawing
functions, so the module imports where matplotlib is not installed;
``sig_lims`` and ``nan_level`` are pure numpy and give the JAX package's
strings and levels exactly.
"""

from __future__ import annotations

import numpy as np

#: parameter name -> LaTeX axis label (reference label_mapping)
LATEX_LABELS = {
    "chirp_mass": r"$\mathcal{M}_c\,[M_\odot]$",
    "mass_ratio": r"$q$",
    "mass_1": r"$m_1\,[M_\odot]$",
    "mass_2": r"$m_2\,[M_\odot]$",
    "mass_1_source": r"$m_1^{\rm src}\,[M_\odot]$",
    "mass_2_source": r"$m_2^{\rm src}\,[M_\odot]$",
    "luminosity_distance": r"$d_L\,[{\rm Mpc}]$",
    "redshift": r"$z$",
    "theta_jn": r"$\theta_{JN}$",
    "cos_theta_jn": r"$\cos\theta_{JN}$",
    "inclination_EM": r"$\iota\,[{\rm rad}]$",
    "KNtheta": r"$\theta_{\rm obs}\,[\deg]$",
    "KNphi": r"$\Phi\,[\deg]$",
    "psi": r"$\psi$",
    "phase": r"$\phi$",
    "geocent_time": r"$t_c\,[{\rm s}]$",
    "lambda_1": r"$\Lambda_1$",
    "lambda_2": r"$\Lambda_2$",
    "lambda_tilde": r"$\tilde\Lambda$",
    "chi_1": r"$\chi_1$",
    "chi_2": r"$\chi_2$",
    "chi_eff": r"$\chi_{\rm eff}$",
    "EOS": r"${\rm EOS}$",
    "TOV_mass": r"$M_{\rm TOV}\,[M_\odot]$",
    "TOV_radius": r"$R_{\rm TOV}\,[{\rm km}]$",
    "R_14": r"$R_{1.4}\,[{\rm km}]$",
    "R_16": r"$R_{1.6}\,[{\rm km}]$",
    "log10_mej": r"$\log_{10}(M_{\rm ej}/M_\odot)$",
    "log10_vej": r"$\log_{10}(v_{\rm ej}/c)$",
    "log10_mej_dyn": r"$\log_{10}(M_{\rm ej}^{\rm dyn}/M_\odot)$",
    "log10_mej_wind": r"$\log_{10}(M_{\rm ej}^{\rm wind}/M_\odot)$",
    "log10_mdisk": r"$\log_{10}(M_{\rm disk}/M_\odot)$",
    "log10_kappa_r": r"$\log_{10}(\kappa/{\rm cm^2\,g^{-1}})$",
    "beta": r"$\beta$",
    "ratio_zeta": r"$\zeta$",
    "ratio_epsilon": r"$\epsilon$",
    "alpha": r"$\alpha$",
    "log10_E0": r"$\log_{10}(E_0/{\rm erg})$",
    "thetaCore": r"$\theta_c\,[{\rm rad}]$",
    "thetaWing": r"$\theta_w\,[{\rm rad}]$",
    "log10_n0": r"$\log_{10}(n_0/{\rm cm^{-3}})$",
    "p": r"$p$",
    "log10_epsilon_e": r"$\log_{10}\epsilon_e$",
    "log10_epsilon_B": r"$\log_{10}\epsilon_B$",
    "Ebv": r"$E(B-V)$",
    "timeshift": r"$\Delta t\,[{\rm d}]$",
    "Hubble_constant": r"$H_0\,[{\rm km\,s^{-1}\,Mpc^{-1}}]$",
    "eta_star": r"$\log(1/4-\eta)$",
}


def latex_label(name: str) -> str:
    return LATEX_LABELS.get(name, name.replace("_", r"\_"))


def pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend; an ImportError
    that names matplotlib where it is not installed (a figure is never
    skipped quietly)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "drawing this figure needs matplotlib, which is not installed "
            "here; the reports and arrays that need no figure run without "
            "it") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def fig_setup(figsize=(8, 6), style="default", usetex=False):
    """Create a styled (fig, ax) pair (reference fig_setup)."""
    plt = pyplot()
    plt.rcParams.update({
        "font.size": 12,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "text.usetex": usetex,
    })
    fig, ax = plt.subplots(figsize=figsize)
    return fig, ax


def setup_multi_axes(n_panels, n_cols=None, figsize_per_panel=(4.0, 3.0),
                     sharex=False, sharey=False):
    """Grid of axes sized to the panel count (reference setup_multi_axes);
    surplus axes are hidden. Returns (fig, flat axes list)."""
    plt = pyplot()
    if n_cols is None:
        n_cols = int(np.ceil(np.sqrt(n_panels)))
    n_rows = int(np.ceil(n_panels / n_cols))
    fig, axes = plt.subplots(
        n_rows, n_cols, sharex=sharex, sharey=sharey,
        figsize=(figsize_per_panel[0] * n_cols,
                 figsize_per_panel[1] * n_rows), squeeze=False)
    flat = axes.ravel().tolist()
    for ax in flat[n_panels:]:
        ax.set_visible(False)
    return fig, flat[:n_panels]


def fading_cmap(color, n=256, fade_to="white", reverse=False):
    """Colormap fading from ``fade_to`` into a base color (reference
    fading_cmap) — used for posterior overlays."""
    pyplot()
    from matplotlib.colors import LinearSegmentedColormap, to_rgb
    c0 = to_rgb(fade_to)
    c1 = to_rgb(color)
    colors = [c1, c0] if reverse else [c0, c1]
    return LinearSegmentedColormap.from_list(f"fade_{color}", colors, N=n)


def sig_lims(values, quantiles=(0.16, 0.5, 0.84), sig_unc=2):
    """LaTeX median +/- credible-interval string to significant figures.

    Counterpart of ``sig_lims`` (nmma/core/utils.py:186-204): the number
    of decimals is chosen so the SMALLER of the two one-sided errors
    carries ``sig_unc`` significant figures (one fewer when its leading
    digit is > 3, the Gelman rounding convention); used for corner-plot
    titles and bestfit summaries.
    """
    q_low, q_mean, q_high = np.quantile(np.asarray(values), quantiles)
    low_err = q_mean - q_low
    high_err = q_high - q_mean
    err = min(low_err, high_err)
    if not np.isfinite(err) or err <= 0:
        return f"${q_mean:.2f}$"
    log_err = np.log10(err)
    int_log = int(log_err) - 1 if log_err < 0 else int(log_err)
    ord_error = sig_unc - 1 - int_log
    if err / 10.0 ** int_log > 3:
        ord_error -= 1
    if ord_error >= 0:
        fmt = f".{ord_error}f"
        return (f"${{{q_mean:{fmt}}}}_{{-{low_err:{fmt}}}}"
                f"^{{+{high_err:{fmt}}}}$")
    q_mean, low_err, high_err = np.around(
        [q_mean, low_err, high_err], ord_error)
    return (f"${{{int(q_mean)}}}_{{-{int(low_err)}}}"
            f"^{{+{int(high_err)}}}$")


def nan_level(data, level, weights=None):
    """[low, high] weighted credible bounds, charging NaNs to the level.

    Counterpart of ``nan_level`` (nmma/core/utils.py:236-247): the NaN
    fraction eats into the credible level (an EOS/TOV failure counts as
    'outside the interval'); returns [nan, nan] once NaNs alone exceed
    the level. Weighted quantiles use the inverted-CDF convention.
    """
    data = np.asarray(data, dtype=float)
    nans = np.isnan(data)
    clean = data[~nans]
    nan_share = nans.sum() / len(data)
    if nan_share > level:
        return [np.nan, np.nan]
    rest = level - nan_share
    lo_q, hi_q = (1 - rest) / 2, 1 - (1 - rest) / 2
    if weights is None:
        return [np.quantile(clean, lo_q), np.quantile(clean, hi_q)]
    w = np.asarray(weights, dtype=float)[~nans]
    w = w / w.sum()
    order = np.argsort(clean)
    sorted_vals, cdf = clean[order], np.cumsum(w[order])
    # inverted CDF: the smallest value whose cumulative weight >= q
    lo = sorted_vals[np.searchsorted(cdf, lo_q, side="left")]
    hi = sorted_vals[np.searchsorted(cdf, hi_q, side="left")]
    return [lo, hi]
