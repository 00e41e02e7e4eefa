"""Surrogate-model registry: the local models home and a models.yaml client.

Port of ``nmma_tpu/registry.py`` (the reference's ``nmma/core/gitlab.py``):
surrogates resolve from ``$NMMA_TPU_MODELS`` (or ``~/nmma_tpu_models``),
the same home and environment variables as the JAX package's, so both
packages share one models home. Missing files come from a registry with
the reference's URL layout through the standard library's ``urllib``
(models.yaml, a joblib core, per-filter files, ``.lzma`` decompressed in
flight), with the base URL from ``$NMMA_TPU_REGISTRY_URL`` or an argument,
or from a download hook that replaces HTTP entirely. In a multi-process
job only rank 0 fetches and the others wait on the file system. The
loaders return the port's ``SVDModelData`` on ``device`` (the CUDA card
unless the caller passes one), registered as a source model.
"""

from __future__ import annotations

import lzma
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

MODELS_ENV = "NMMA_TPU_MODELS"
REGISTRY_URL_ENV = "NMMA_TPU_REGISTRY_URL"
# the reference's public registry (gitlab.py:19); raw/main mirrors its
# download URL layout
DEFAULT_REGISTRY_URL = "https://gitlab.com/Theodlz/nmma-models/raw/main"
# X-ray and radio "filters" are frequency points evaluated analytically,
# not registry artifacts (gitlab.py:25-32)
SKIP_FILTERS = (
    "X-ray-1keV", "X-ray-5keV", "radio-5.5GHz", "radio-1.25GHz",
    "radio-3GHz", "radio-6GHz",
)
_DOWNLOAD_HOOK = None


def get_models_home(models_home=None) -> str:
    """Model cache directory (reference get_models_home, gitlab.py:20-40)."""
    if models_home:
        return models_home
    return os.environ.get(
        MODELS_ENV, os.path.join(os.path.expanduser("~"), "nmma_tpu_models"))


def set_download_hook(fn):
    """fn(model_name, destination_dir) -> None; called for missing models."""
    global _DOWNLOAD_HOOK
    _DOWNLOAD_HOOK = fn


def get_model(model_name, models_home=None, filters=None,
              download_if_missing=True):
    """Path of ``{model_name}.npz`` in the models home (or its
    ``{model_name}/`` subdirectory), fetched through the download hook when
    missing and allowed."""
    home = get_models_home(models_home)
    path = os.path.join(home, f"{model_name}.npz")
    if os.path.exists(path):
        return path
    nested = os.path.join(home, model_name, f"{model_name}.npz")
    if os.path.exists(nested):
        return nested
    if download_if_missing and _DOWNLOAD_HOOK is not None:
        os.makedirs(home, exist_ok=True)
        if _is_process_zero():
            _DOWNLOAD_HOOK(model_name, home)
        else:
            _wait_for(path)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"Surrogate model {model_name!r} not found under {home!r}. "
        f"Set ${MODELS_ENV} to a directory containing {model_name}.npz "
        "(train one with create-svdmodel, or mount the model bundle).")


def registry_url(base_url=None) -> str:
    """Registry base URL: explicit argument > $NMMA_TPU_REGISTRY_URL > the
    public registry."""
    return (base_url or os.environ.get(REGISTRY_URL_ENV)
            or DEFAULT_REGISTRY_URL)


def _fetch(url, timeout=60.0):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        expect = resp.headers.get("content-length")
        data = resp.read()
    if expect is not None and len(data) != int(expect):
        raise OSError(f"incomplete download from {url}: "
                      f"{len(data)} of {expect} bytes")
    return data


def download_file(url, dest, timeout=60.0):
    """Fetch ``url`` into ``dest`` atomically (a temporary file, then a
    rename); ``.lzma`` payloads are decompressed in flight
    (download_and_decompress, gitlab.py:76-92)."""
    data = _fetch(url, timeout=timeout)
    if url.endswith(".lzma"):
        data = lzma.decompress(data)
        if dest.endswith(".lzma"):
            dest = dest[:-5]
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(dest.name + ".part")
    tmp.write_bytes(data)
    os.replace(tmp, dest)
    return str(dest)


def download_models_list(models_home=None, base_url=None, timeout=60.0):
    """Fetch ``models.yaml`` into the models home (gitlab.py:95-101)."""
    home = get_models_home(models_home)
    os.makedirs(home, exist_ok=True)
    return download_file(f"{registry_url(base_url)}/models.yaml",
                         os.path.join(home, "models.yaml"), timeout=timeout)


def load_models_list(models_home=None, base_url=None):
    """``(models, used_local)``: the models.yaml dict merged with the model
    directories present in the home; a models.yaml that is missing and
    cannot be fetched leaves the local scan, ``used_local=True``
    (gitlab.py:104-147)."""
    import yaml
    home = get_models_home(models_home)
    models_file = Path(home, "models.yaml")
    models, used_local = {}, False
    try:
        if not models_file.exists():
            download_models_list(home, base_url=base_url)
        with models_file.open("r") as f:
            models = yaml.safe_load(f) or {}
    except Exception:
        used_local = True

    for sub in Path(home).glob("*"):
        if not sub.is_dir():
            continue
        name = sub.name
        filters = []
        for ff in sub.glob("*"):
            if not ff.is_file():
                continue
            stem = ff.stem
            if name in stem:
                stem = stem.replace(name, "")
            stem = stem.strip("_")
            if stem:
                filters.append(stem)
        entry = models.setdefault(name, {})
        entry["filters"] = sorted(set(filters)
                                  | set(entry.get("filters", [])))
    return models, used_local


def refresh_models_list(models_home=None, base_url=None):
    """Re-fetch models.yaml (gitlab.py:150-161)."""
    home = get_models_home(models_home)
    stale = Path(home, "models.yaml")
    if stale.exists():
        stale.unlink()
    return load_models_list(home, base_url=base_url)[0]


def download_model(model_name, filters=None, models_home=None,
                   base_url=None, filters_only=False,
                   download_if_missing=True):
    """Resolve a reference-format model (joblib core and per-filter files)
    into the models home: ``(filepaths, filters)``.

    The reference's URL layout (gitlab.py:164-268):
    ``{base}/models/{core}.joblib`` and
    ``{base}/models/{name}/{filter}.{joblib|h5}`` ('_tf' models ship h5
    weights); SKIP_FILTERS pass through untouched; colon filter names
    (ps1::g) map to the registry's underscore ones (ps1__g); missing files
    are fetched by a thread pool on rank 0 only.
    """
    home = get_models_home(models_home)
    os.makedirs(home, exist_ok=True)
    models, used_local = load_models_list(home, base_url=base_url)
    if model_name not in models:
        raise ValueError(f"model_name {model_name} not found in models list"
                         + (" (local scan only — registry unreachable)"
                            if used_local else ""))
    info = models[model_name]
    os.makedirs(os.path.join(home, model_name), exist_ok=True)

    known = list(info.get("filters", []))
    to_registry = {f.replace("_", ":"): f for f in known}
    all_filters = set(known) | set(to_registry)
    if not filters:
        filters = known
    skipped = [f for f in filters if f in SKIP_FILTERS]
    filters = [to_registry.get(f, f) for f in filters
               if f not in SKIP_FILTERS]
    missing_filters = sorted(set(filters) - all_filters)
    if missing_filters:
        where = "local models list" if used_local else "registry models list"
        raise ValueError(f"{where} does not have filters "
                         f"{','.join(missing_filters)} for {model_name}")

    filter_format = "h5" if "_tf" in model_name else "joblib"
    core_name = _core_name(model_name)

    base = registry_url(base_url)
    filepaths = [] if filters_only else [Path(home, f"{core_name}.joblib")]
    urls = [] if filters_only else [f"{base}/models/{core_name}.joblib"]
    filepaths += [Path(home, model_name, f"{f}.{filter_format}")
                  for f in filters]
    urls += [f"{base}/models/{model_name}/{f}.{filter_format}"
             for f in filters]

    missing = [(u, str(f)) for u, f in zip(urls, filepaths)
               if not f.exists()]
    if missing:
        if not download_if_missing:
            raise OSError("Data not found and `download_if_missing` is "
                          "False")
        if _is_process_zero():
            with ThreadPoolExecutor(
                    max_workers=min(len(missing), 8)) as pool:
                list(pool.map(lambda uf: download_file(*uf), missing))
        else:
            for _, f in missing:
                _wait_for(f)
        still = [f for _, f in missing if not os.path.exists(f)]
        if still:
            raise OSError(f"failed to download {len(still)} model file(s) "
                          f"for {model_name}: " + ", ".join(still[:3]))
    return [str(f) for f in filepaths], filters + skipped


def _core_name(model_name):
    """The model's name without its '_tf' part (gitlab.py:219-223)."""
    return "_".join(c for c in model_name.split("_") if c != "tf")


def _is_process_zero() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, else of the
    ``RANK`` environment variable; a lone process is rank 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def _wait_for(path, timeout=600.0, poll=2.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            return
        time.sleep(poll)


def load_registered_model(model_name, models_home=None, mag_ncoeff=None,
                          device=None):
    """``get_model``, the ``.npz`` onto ``device``, and its registration as
    source model ``model_name``: returns the ``SVDModelData``."""
    from . import resolve_device
    from .models.svd import SVDModelData, make_svd_source_model
    device = resolve_device(device)
    svd = SVDModelData.load(get_model(model_name, models_home), device=device)
    make_svd_source_model(model_name, svd, mag_ncoeff=mag_ncoeff)
    return svd


def load_reference_registry_model(model_name, filters=None, models_home=None,
                                  base_url=None, mag_ncoeff=None,
                                  device=None):
    """``download_model`` and the joblib/h5 ingestion onto ``device``,
    registered under the core name ('_tf' stripped): returns the
    ``SVDModelData``."""
    from . import resolve_device
    from .models.svd import ingest_nmma_svd_model, make_svd_source_model
    device = resolve_device(device)
    _, filts = download_model(model_name, filters=filters,
                              models_home=models_home, base_url=base_url)
    home = get_models_home(models_home)
    core_name = _core_name(model_name)
    svd = ingest_nmma_svd_model(
        home, core_name, filters=[f for f in filts if f not in SKIP_FILTERS],
        filter_dir=os.path.join(home, model_name), device=device)
    make_svd_source_model(core_name, svd, mag_ncoeff=mag_ncoeff)
    return svd


def write_reference_layout(root, model_name, arrays, filters=None):
    """Write a surrogate's ``.npz`` arrays (``SVDModelData`` keys) as a
    registry tree in the reference's layout under ``root``: models.yaml,
    ``models/{core}.joblib`` (per filter VA, mins, maxs, tt, n_coeff, the
    parameter bounds and names) and keras-layout ``models/{model_name}/
    {filter}.h5`` weights, filters in the registry's spelling (ps1__z),
    which ``download_model`` fetches and ``ingest_nmma_svd_model`` reads
    back to the same arrays. For a mirror
    of native artifacts; ``model_name`` should carry '_tf' (h5 weights).
    Returns the tree's root."""
    import h5py
    import joblib
    import numpy as np
    import yaml

    names = [str(f) for f in arrays["filters"]]
    filters = names if filters is None else list(filters)
    # the registry spells ps1::z as ps1__z
    spelled = [f.replace(":", "_") for f in filters]
    weights_dir = Path(root, "models", model_name)
    weights_dir.mkdir(parents=True, exist_ok=True)
    Path(root, "models.yaml").write_text(
        yaml.safe_dump({model_name: {"filters": spelled}}))
    core = {}
    for f, name in zip(filters, spelled):
        i = names.index(f)
        core[name] = {"tt": np.asarray(arrays["tt"]),
                   "VA": np.asarray(arrays["va"][i]),
                   "mins": np.asarray(arrays["mins"][i]),
                   "maxs": np.asarray(arrays["maxs"][i]),
                   "n_coeff": int(np.shape(arrays["w2"])[-1]),
                   "param_mins": np.asarray(arrays["param_mins"]),
                   "param_maxs": np.asarray(arrays["param_maxs"]),
                   "model_parameters": [str(p) for p in
                                        arrays["parameter_names"]]}
        with h5py.File(weights_dir / f"{name}.h5", "w") as h5:
            for layer, (w, b) in enumerate(
                    ((arrays["w1"][i], arrays["b1"][i]),
                     (arrays["w2"][i], arrays["b2"][i])), start=1):
                g = h5.create_group(f"model_weights/dense_{layer}/"
                                    f"dense_{layer}")
                g["kernel:0"] = np.asarray(w)
                g["bias:0"] = np.asarray(b)
    joblib.dump(core, Path(root, "models", f"{_core_name(model_name)}.joblib"))
    return str(root)
