"""SkyPortal AnalysisService -> nmma_tpu_torch bridge.

Port of ``nmma_tpu/skyportal.py`` (the reference's ``nmma/skyportal_osg.py
:1-232``): a SkyPortal analysis payload (photometry CSV, an optional
redshift CSV and free-form ``analysis_parameters``) becomes the
``lightcurve-analysis`` argv, which the port's CLI runs in-process; the
return value points at the posterior, result and figure files so plugins can
package them. The CSVs are read with numpy (per-column types inferred as
pandas infers them, so the data file is the JAX package's line for line),
and the redshift's distance comes from the built-in cosmology.
"""

from __future__ import annotations

import os
import tempfile
from datetime import datetime, timedelta
from pathlib import Path
from typing import Any

import numpy as np
import torch

DEFAULTS = {
    "source": "Me2017",
    "nlive": 32,
    "tmin": 0.01,
    "tmax": 7.0,
    "n_tsteps": 70,
    "Ebv_max": 0.5724,
    "error_budget": 1.0,
}


def _params(payload: dict) -> dict:
    return {**DEFAULTS, **(payload.get("analysis_parameters") or {})}


def _read_csv(path):
    """A CSV with a header row as a structured array, each column typed
    from its values (int, float or str), as pandas' read_csv types them."""
    return np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True,
                                       dtype=None, encoding="utf-8"))


def _resolve_redshift(payload: dict):
    src = payload.get("redshift")
    if src is None:
        return None
    table = _read_csv(src)
    if table.dtype.names is None or "redshift" not in table.dtype.names \
            or table.size == 0:
        return None
    z = float(table["redshift"][0])
    return None if np.isnan(z) else z


def _prepare_prior(prior_path, fix_z, redshift, outdir, source):
    """Copy the prior, pinning luminosity_distance when fix_z is set."""
    from .cosmology import get_cosmology
    text = Path(prior_path).read_text()
    if fix_z:
        if redshift is None:
            raise ValueError(
                "fix_z=True requires a redshift in the SkyPortal payload")
        # f32 table interpolation on the host, as the JAX package's
        d_l = float(get_cosmology().luminosity_distance(
            torch.tensor(redshift, dtype=torch.float32)))
        lines = [ln for ln in text.splitlines()
                 if not ln.strip().startswith("luminosity_distance")]
        lines.append(f"luminosity_distance = {d_l}")
        text = "\n".join(lines) + "\n"
    out = Path(outdir) / f"{source}.prior"
    out.write_text(text)
    return out


def _isot(mjd):
    """ISO time of an MJD to the millisecond (real SkyPortal payloads carry
    fractional seconds): strftime's microseconds less three digits."""
    base = datetime(1858, 11, 17) + timedelta(days=float(mjd))
    return base.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def _write_data_file(payload: dict, outdir) -> tuple[Path, float]:
    """SkyPortal photometry CSV -> 'isot filter mag magerr' rows."""
    table = _read_csv(payload["photometry"])
    data_path = Path(outdir) / "data.dat"
    with data_path.open("w") as fh:
        for row in table:
            filt = str(row["filter"])[-1]      # reference keeps last char
            fh.write(f"{_isot(row['mjd'])} {filt} {row['mag']} "
                     f"{row['magerr']}\n")
    return data_path, float(table["mjd"].min())


def run_from_skyportal_inputs(payload: dict[str, Any], *, outdir=None,
                              prior_dir=None, svdmodel_dir=None,
                              resource_id: str = "obj", invoke=None,
                              device=None) -> dict[str, Any]:
    """Run the EM analysis against a SkyPortal AnalysisService payload.

    ``invoke(argv)`` runs the analysis (default: the port's
    ``cli.lightcurve_analysis.main``). ``device`` adds ``--device`` to the
    argv; without it the CLI runs on the CUDA card. Returns a dict with
    ``status``/``message`` and, on success, the ``posterior_file`` /
    ``json_result_file`` / ``plot_file`` pointers plus ``log_bayes_factor``
    (reference return contract, skyportal_osg.py:160-232); it never raises.
    """
    params = _params(payload)
    source = str(params["source"])
    fix_z = params.get("fix_z") in (True, "True", "true", "t", 1)

    if outdir is None:
        outdir = Path(tempfile.mkdtemp(prefix="nmma_tpu_osg_"))
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    try:
        redshift = _resolve_redshift(payload)
        if prior_dir is None:
            prior_candidate = payload.get("prior")
        else:
            prior_candidate = Path(prior_dir) / f"{source}.prior"
        if prior_candidate is None or not os.path.exists(prior_candidate):
            raise FileNotFoundError(
                f"prior file for model {source!r} not found at "
                f"{prior_candidate}")
        prior_path = _prepare_prior(prior_candidate, fix_z, redshift,
                                    outdir, source)
        data_path, t0 = _write_data_file(payload, outdir)

        label = f"{source}_{resource_id}"
        argv = [
            "--model", source,
            "--outdir", str(outdir), "--label", label,
            "--trigger-time", str(t0),
            "--light-curve-data", str(data_path),
            "--prior", str(prior_path),
            "--tmin", str(params["tmin"]), "--tmax", str(params["tmax"]),
            "--n-tsteps", str(params["n_tsteps"]),
            "--em-error-budget", str(params["error_budget"]),
            "--nlive", str(params["nlive"]),
            "--plot",
        ]
        if svdmodel_dir is not None:
            argv += ["--svd-path", str(svdmodel_dir)]
        if device is not None:
            argv += ["--device", str(device)]

        if invoke is None:
            from .cli.lightcurve_analysis import main as invoke
        analysis = invoke(argv)

        posterior_file = outdir / f"{label}_posterior_samples.csv"
        plot_file = outdir / f"{label}_lightcurves.png"
        logz = getattr(getattr(analysis, "result", None), "logz", None)
        return {
            "status": "success",
            "message": f"analysis complete for {resource_id}",
            "posterior_file": str(posterior_file)
            if posterior_file.exists() else None,
            "json_result_file": str(outdir / f"{label}_result_meta.json"),
            "plot_file": str(plot_file) if plot_file.exists() else None,
            "log_bayes_factor": logz,
            "outdir": str(outdir),
        }
    except Exception as exc:  # noqa: BLE001 — service contract: never raise
        return {"status": "failure", "message": str(exc),
                "outdir": str(outdir)}
