"""Result/posterior I/O: writers + multi-format loaders.

Port of ``nmma_tpu/io/results.py``, the counterpart of
``nmma/core/utils.py:98-171`` (``get_posteriors``,
``get_bestfit_params``): posterior sets round-trip through csv / json /
npz so the post-processing CLIs interoperate with externally produced
posterior files (including reference-produced CSVs).
"""

from __future__ import annotations

import json

import numpy as np


def save_posterior_csv(path, posterior: dict):
    keys = [k for k in posterior if np.ndim(posterior[k]) == 1]
    n = len(np.asarray(posterior[keys[0]]))
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        cols = [np.asarray(posterior[k]) for k in keys]
        for i in range(n):
            f.write(",".join(f"{c[i]:.10g}" for c in cols) + "\n")
    return path


def load_posterior(path):
    """Posterior dict from .csv / .json / .npz / .dat files."""
    path = str(path)
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        out = {}
        for k in z.files:
            if k.startswith("posterior_"):
                out[k[len("posterior_"):]] = z[k]
            else:
                out[k] = z[k]
        return out
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if "posterior" in data:
            content = data["posterior"].get("content", data["posterior"])
            return {k: np.asarray(v) for k, v in content.items()}
        return {k: np.asarray(v) for k, v in data.items()
                if isinstance(v, list)}
    # csv / dat: header + numeric columns
    delimiter = "," if path.endswith(".csv") else None
    with open(path) as f:
        header = f.readline().strip()
    keys = header.split(",") if delimiter else header.split()
    table = np.loadtxt(path, delimiter=delimiter, skiprows=1, ndmin=2)
    return {k: table[:, i] for i, k in enumerate(keys)}


def load_bestfit(path):
    with open(path) as f:
        data = json.load(f)
    return data.get("posterior_parameters", data)
