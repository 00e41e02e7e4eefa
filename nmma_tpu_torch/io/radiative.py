"""Radiative-transfer output -> nmma-format light-curve files.

Port of ``nmma_tpu/io/radiative.py`` (a numpy copy on the port's
``constants`` and ``filters``): the counterpart of ``make_lcs`` and the
LightCurveHandler family (``nmma/em/lightcurve_handling.py:239-467``) and of
the cocteau-derived LANL spectra readers (``nmma/em/utils.py:840-1260``).
POSSIS ASCII, POSSIS HDF5, Kasen HDF5 and LANL (Wollaeger+18) spectra become
per-filter AB magnitude (or bolometric) light-curve files in the standard
model format. ``h5py`` is imported only inside the HDF5 readers.

Band synthesis: the reference integrates each spectrum through sncosmo
bandpass transmission curves. Transmission tables are not available
offline, so magnitudes here are monochromatic AB magnitudes at each
filter's effective wavelength,

    m_AB = -2.5 log10( f_lambda * lambda_eff^2 / c / 3631 Jy ),

the same approximation the JAX package makes. For the broadband filters
nmma uses this tracks full band integration to a few x 0.01 mag except
across strong spectral breaks. Everything here runs on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import D as _D10PC_CM, c_cgs as C_CGS
from ..filters import effective_wavelength

_AB_ZP_CGS = 3631e-23          # erg/s/cm^2/Hz
# numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def band_mags_from_spectra(wave_aa, flam, filters):
    """AB mags [F, T] from flam [T, W] (erg/s/cm^2/AA) on wave_aa [W]."""
    wave_aa = np.asarray(wave_aa, dtype=np.float64)
    flam = np.atleast_2d(np.asarray(flam, dtype=np.float64))
    mags = np.full((len(filters), flam.shape[0]), np.inf)
    for i, filt in enumerate(filters):
        lam_eff = effective_wavelength(filt) * 1e10    # m -> AA
        if not (wave_aa[0] <= lam_eff <= wave_aa[-1]):
            continue
        fl = np.array([np.interp(lam_eff, wave_aa, row) for row in flam])
        # f_nu = f_lambda * lambda^2 / c   (lambda in cm, c in cm/s)
        fnu = fl * (lam_eff ** 2 * 1e-8) / C_CGS
        with np.errstate(divide="ignore"):
            mags[i] = -2.5 * np.log10(np.maximum(fnu, 1e-300) / _AB_ZP_CGS)
        mags[i, fnu <= 0] = np.inf
    return mags


def read_possis_ascii(path):
    """POSSIS ASCII spectra (LightCurveHandler.open_source, :311-327).

    Header: Nobs / Nwave / 'Ntime ti tf'; body [Nobs*Nwave, 1+Ntime+...]
    with column 0 the wavelength (AA) and columns 1..Ntime the I Stokes
    flux at 10 pc (the reference's (1e-5/dMpc)^2 rescale is identity at
    its default dMpc=1e-5). Returns (time_days[T], thetas_deg[Nobs],
    wave[Nobs, W], flux[Nobs, T, W]).
    """
    with open(path) as fh:
        n_obs = int(fh.readline().strip())
        n_wave = int(fh.readline().strip())
        n_time, ti, tf = map(float, fh.readline().split())
    time, dt = np.linspace(ti, tf, int(n_time), retstep=True)
    time = time + 0.5 * dt
    cos = np.linspace(0, 1, n_obs)
    thetas = np.degrees(np.arccos(cos))
    data = np.loadtxt(path, skiprows=3)
    wave = np.stack([data[n_wave * i:n_wave * (i + 1), 0]
                     for i in range(n_obs)])
    flux = np.stack([data[n_wave * i:n_wave * (i + 1), 1:len(time) + 1].T
                     for i in range(n_obs)])
    return time, thetas, wave, flux


def read_possis_h5(path):
    """POSSIS HDF5 (H5LightCurveHandler.open_source, :389-403).

    observables/{stokes [Nobs,T,W,4], time [s], wave [AA], lbol}.
    Returns (time_days, thetas_deg, wave, I_stokes [Nobs,T,W], lbol).
    """
    import h5py
    with h5py.File(path, "r") as f:
        data = f["observables"]
        stokes = np.array(data["stokes"])
        time = np.array(data["time"]) / 86400.0
        wave = np.array(data["wave"])
        lbol = np.array(data["lbol"])
    i_stokes = stokes[:, :, :, 0]
    cos = np.linspace(0, 1, stokes.shape[0])
    thetas = np.degrees(np.arccos(cos))
    return time, thetas, wave, i_stokes, lbol


def read_kasen_h5(path, smooth_sigma=3.0):
    """Kasen et al. (2017) HDF5 (KasenLightCurveHandler, :420-443).

    nu [Hz] / time [s] / Lnu [T, Nu] (erg/s/Hz, isotropic). Zeros are
    data holes: filled with 1e20 then log-space gaussian-smoothed as the
    reference does. Returns (time_days, wave_aa ascending, flam [T, W]
    at 10 pc, lnu_smoothed, nu ascending-by-wave).
    """
    import h5py
    from scipy.ndimage import gaussian_filter
    with h5py.File(path, "r") as f:
        nu = np.array(f["nu"], dtype=np.float64)
        time = np.array(f["time"])
        lnu = np.array(f["Lnu"], dtype=np.float64)
    lnu[lnu == 0.0] = 1e20
    lnu = 10.0 ** gaussian_filter(np.log10(lnu), smooth_sigma)
    llam = lnu * nu[None, :] ** 2 / C_CGS / 1e8          # erg/s/AA
    flam = llam / (4.0 * np.pi * _D10PC_CM ** 2)
    wave = C_CGS / nu * 1e8
    order = np.argsort(wave)
    return time / 86400.0, wave[order], flam[:, order], lnu, nu[order]


def read_lanl_spectra(path, angles=(0,)):
    """Wollaeger+18 / Even+19 LANL spectra files (utils.py:934-1037).

    Blocks per timestep, each introduced by a line containing 'time'
    whose last token is the time in days, followed by rows of
    [wavelength_low, wavelength_high, spec_angle0, spec_angle1, ...]
    (wavelengths in cm; flux at 10 pc per angular bin). Returns
    (times[T], wave_aa[W], {angle: flam [T, W] erg/s/cm^2/AA}).
    The reference multiplies each bin by the number of angular bins
    (lightcurve_handling.py:374) to undo the solid-angle average.
    """
    times, blocks, current = [], [], None
    with open(path) as fh:
        for line in fh:
            if "time" in line:
                times.append(float(line.split()[-1]))
                current = []
                blocks.append(current)
            elif current is not None:
                toks = line.split()
                if toks:
                    current.append([float(t) for t in toks])
    if not times:
        raise IOError(f"no 'time' blocks found in {path}; not a LANL "
                      "spectra file")
    arr = np.asarray(blocks, dtype=np.float64)        # [T, W, 2+n_angles]
    wave_aa = 0.5 * (arr[0, :, 0] + arr[0, :, 1]) * 1e8   # cm -> AA
    n_angles = arr.shape[2] - 2
    out = {}
    for a in angles:
        if a >= n_angles:
            raise IndexError(f"angle {a} not in file ({n_angles} bins)")
        out[a] = arr[:, :, 2 + a] * n_angles
    return np.asarray(times), wave_aa, out


def lanl_thetas(n_angles):
    """Viewing angles for LANL angular bins (equal solid angle in cos)."""
    return np.degrees(np.arccos(np.linspace(-1, 1, n_angles)))


def spectra_to_lc_dict(time, wave_aa, flam, filters):
    """Model-format light-curve dict from one spectral series."""
    mags = band_mags_from_spectra(wave_aa, flam, filters)
    return {f: {"time": np.asarray(time), "mag": mags[i],
                "mag_error": np.full(len(time), np.nan)}
            for i, f in enumerate(filters)}


def bolometric_lc_dict(time, wave_aa, flam, dist_cm=_D10PC_CM):
    """{'time','lbol'} by trapezoid over wavelength (reference :355-357)."""
    lbol = _trapezoid(np.atleast_2d(flam) * 4.0 * np.pi * dist_cm ** 2,
                        x=wave_aa, axis=1)
    return {"time": np.asarray(time), "lbol": lbol}


def write_model_lc(path, data):
    """Write a model-format light curve: '# t[days] f1 f2 ...' columns."""
    if "lbol" in data:
        cols = np.column_stack([data["time"], data["lbol"]])
        header = "time lbol"
    else:
        filters = list(data.keys())
        t = np.asarray(data[filters[0]]["time"])
        cols = np.column_stack([t] + [np.asarray(data[f]["mag"])
                                      for f in filters])
        header = "time " + " ".join(filters)
    # plain whitespace-separated columns readable by the model-format
    # loader (io/photometry._read_model_csv)
    np.savetxt(path, cols, header=header, comments="")
    return path


def _savgol_smooth(mags, window=17, polyorder=3):
    from scipy.signal import savgol_filter
    finite = np.isfinite(mags)
    if finite.sum() < window:
        return mags
    filled = np.interp(np.arange(len(mags)), np.flatnonzero(finite),
                       mags[finite])
    return savgol_filter(filled, window_length=window, polyorder=polyorder)


def make_lcs(modeldir, lcdir, filters, file_type=None, d_mpc=1e-5,
             redshift=None, bolometric=False, smoothing=False,
             cosmology=None, verbose=True):
    """Convert every spectra file in ``modeldir`` (reference make_lcs).

    file_type None -> POSSIS ASCII; 'h5'/'hdf5' -> POSSIS HDF5;
    'kasen' -> Kasen HDF5; 'lanl' -> LANL ASCII spectra. Output naming
    follows the reference: <base>_theta<deg>_dMpc<D>.dat (or _z<z>,
    +'_Lbol' for bolometric).
    """
    from ..cosmology import get_cosmology
    cosmo = cosmology or get_cosmology()

    def f32(value):                          # the cosmology's f32 tables
        return torch.tensor(float(value), dtype=torch.float32)

    if redshift is not None:
        z = float(redshift)
        d_mpc = float(cosmo.luminosity_distance(f32(z)))
        dist_tag = f"z{z}"
    elif d_mpc <= 1e-5:
        z = 0.0                              # 10 pc: absolute magnitudes
        dist_tag = f"dMpc{int(d_mpc)}"
    else:
        z = float(cosmo.redshift_at_dl(f32(d_mpc)))
        dist_tag = f"dMpc{int(d_mpc)}"
    if bolometric:
        dist_tag += "_Lbol"
    dist_cm = max(d_mpc, 1e-5) * 3.0857e24     # 1e-5 Mpc == 10 pc

    os.makedirs(lcdir, exist_ok=True)
    ftype = (file_type or "").lower()
    if ftype and not any(k in ftype for k in ("h5", "hdf5", "kasen",
                                              "lanl", "possis")):
        raise ValueError(f"unknown file type {file_type!r} for lc "
                         "creation; use h5 | kasen | lanl | possis/None")
    exts = {".h5", ".hdf5"} if ("h5" in ftype or "kasen" in ftype) \
        else {".dat", ".csv", ".txt"}
    written = []
    for fname in sorted(os.listdir(modeldir)):
        base, ext = os.path.splitext(fname)
        if ext not in exts:
            continue
        path = os.path.join(modeldir, fname)

        if "kasen" in ftype:
            time, wave, flam, _, _ = read_kasen_h5(path)
            series = [(None, wave, flam)]
        elif "h5" in ftype:
            time, thetas, wave, stokes, _ = read_possis_h5(path)
            series = [(thetas[i], wave * (1 + z),
                       stokes[i] * (1e-5 / max(d_mpc, 1e-5)) ** 2 / (1 + z))
                      for i in range(len(thetas))]
        elif "lanl" in ftype:
            with open(path) as fh:
                head = fh.readline() + fh.read(4000)
            n_angles = max(len(head.splitlines()[1].split()) - 2, 1)
            time, wave, per_angle = read_lanl_spectra(
                path, angles=range(n_angles))
            thetas = lanl_thetas(n_angles)
            series = [(thetas[a], wave, per_angle[a])
                      for a in range(n_angles)]
        else:
            time, thetas, wave, flux = read_possis_ascii(path)
            series = [(thetas[i], wave[i] * (1 + z),
                       flux[i] * (1e-5 / max(d_mpc, 1e-5)) ** 2 / (1 + z))
                      for i in range(len(thetas))]

        for theta, w, fl in series:
            tag = f"_theta{theta:.2f}" if theta is not None else ""
            out = os.path.join(lcdir, f"{base}{tag}_{dist_tag}.dat")
            if os.path.isfile(out):
                continue
            if bolometric:
                data = bolometric_lc_dict(time, w, fl, dist_cm=dist_cm)
            else:
                data = spectra_to_lc_dict(time, w, fl, filters)
                if smoothing:
                    for f in filters:
                        data[f]["mag"] = _savgol_smooth(data[f]["mag"])
            write_model_lc(out, data)
            written.append(out)
        if verbose:
            print(f"{fname}: {len(series)} viewing angle(s) -> {lcdir}")
    return written
