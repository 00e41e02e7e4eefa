"""The port's model registry (``nmma_tpu_torch/registry.py``), the
reference-format ingestion (``models/svd.py:ingest_nmma_svd_model``) and
``svdmodel-download`` against the JAX package's.

A localhost HTTP server serves a registry tree in the reference's layout
that ``registry.write_reference_layout`` writes from a surrogate in
``artifacts/`` (models.yaml, a joblib core, keras-layout h5 weights per
filter). No test reaches the network: an unreachable registry is a closed
localhost port. Both packages fetch the same files, ingest the same
weights, and the ingested surrogate's logL equals the surrogate loaded
from its ``.npz`` bit for bit.
"""

import lzma
import os
import shutil
import socket
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from nmma_tpu import registry as j_registry
from nmma_tpu_torch import registry as t_registry

pytest.importorskip("joblib")
pytest.importorskip("h5py")
torch.set_num_threads(1)

SPARSE = "artifacts/Bu2019lm_sparse_svd.npz"
PRODUCTION = "artifacts/Bu2019lm_production_svd.npz"
NAME = "Bu2019lm_sparse_tf"
CORE = "Bu2019lm_sparse"


def serve(root):
    """A ThreadingHTTPServer on 127.0.0.1 at a free port serving ``root``:
    (base URL, stop)."""
    handler = lambda *a, **kw: SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(root), **kw)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    return f"http://127.0.0.1:{server.server_address[1]}", stop


def closed_port_url():
    """The URL of a localhost port nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("registry_root")
    with np.load(SPARSE) as z:
        arrays = {k: z[k] for k in z.files}
    t_registry.write_reference_layout(root, NAME, arrays)
    url, stop = serve(root)
    try:
        yield url, root, arrays
    finally:
        stop()


def test_models_list_matches_jax(server, tmp_path):
    url = server[0]
    for module, home in ((j_registry, tmp_path / "jax"),
                         (t_registry, tmp_path / "port")):
        models, used_local = module.load_models_list(str(home), base_url=url)
        assert not used_local
        assert (home / "models.yaml").exists()
        (home / "LocalOnly").mkdir()
        (home / "LocalOnly" / "LocalOnly_ztfg.joblib").write_bytes(b"x")
    want = j_registry.load_models_list(str(tmp_path / "jax"), base_url=url)
    got = t_registry.load_models_list(str(tmp_path / "port"), base_url=url)
    assert got == want
    assert got[0]["LocalOnly"]["filters"] == ["ztfg"]
    assert got[0][NAME]["filters"] == [
        f.replace(":", "_") for f in server[2]["filters"]]


def test_unreachable_registry_leaves_the_local_scan(tmp_path):
    url = closed_port_url()
    for module in (j_registry, t_registry):
        home = tmp_path / module.__name__
        (home / "OnlyHere").mkdir(parents=True)
        (home / "OnlyHere" / "OnlyHere_sdssr.h5").write_bytes(b"x")
        models, used_local = module.load_models_list(str(home), base_url=url)
        assert used_local
        assert models == {"OnlyHere": {"filters": ["sdssr"]}}
        with pytest.raises(ValueError, match="registry unreachable"):
            module.download_model("Missing", models_home=str(home),
                                  base_url=url)


def test_download_model_matches_jax(server, tmp_path):
    url = server[0]
    results = {}
    for module in (j_registry, t_registry):
        home = tmp_path / module.__name__
        paths, filts = module.download_model(
            NAME, filters=["ps1::z", "ztfg", "X-ray-1keV"],
            models_home=str(home), base_url=url)
        results[module] = ([os.path.relpath(p, home) for p in paths], filts)
        for p in paths:
            assert os.path.exists(p)
        assert not (home / NAME / "ztfr.h5").exists()
        with pytest.raises(ValueError, match="does not have filters"):
            module.download_model(NAME, filters=["nosuchband"],
                                  models_home=str(home), base_url=url)
        with pytest.raises(ValueError, match="not found in models list"):
            module.download_model("NoSuchModel", models_home=str(home),
                                  base_url=url)
    got, want = results[t_registry], results[j_registry]
    assert got == want
    # the registry's spelling of ps1::z in the URL and the file name
    assert got[0] == [f"{CORE}.joblib", f"{NAME}/ps1__z.h5",
                      f"{NAME}/ztfg.h5"]
    assert got[1] == ["ps1__z", "ztfg", "X-ray-1keV"]


def test_lzma_payload_is_decompressed(server, tmp_path):
    url, root, _ = server
    payload = b"surrogate-bytes" * 100
    (root / "models" / "comp.joblib.lzma").write_bytes(lzma.compress(payload))
    dest = t_registry.download_file(f"{url}/models/comp.joblib.lzma",
                                    str(tmp_path / "comp.joblib.lzma"))
    assert dest.endswith("comp.joblib")
    assert open(dest, "rb").read() == payload
    assert not os.path.exists(dest + ".part")


def test_reference_model_ingests_to_the_same_surrogate(server, tmp_path):
    """load_reference_registry_model in both packages on the same tree: the
    same stacked weights; the port's surrogate evaluates bit for bit as the
    one loaded from the .npz."""
    from nmma_tpu_torch.models import SVDModelData
    url, _, arrays = server
    j_model = j_registry.load_reference_registry_model(
        NAME, models_home=str(tmp_path / "jax"), base_url=url)
    svd = t_registry.load_reference_registry_model(
        NAME, models_home=str(tmp_path / "port"), base_url=url,
        device="cpu")
    assert j_model.name == CORE
    assert svd.filters == tuple(f.replace(":", "_")
                                for f in arrays["filters"])
    assert svd.parameter_names == tuple(j_model.parameter_names)
    direct = SVDModelData.load(SPARSE, device="cpu")
    for k in ("w1", "b1", "w2", "b2", "param_mins", "p_span"):
        assert torch.equal(getattr(svd, k), getattr(direct, k)), k
    t = torch.tensor(np.geomspace(0.1, 14.0, 40), dtype=torch.float32)
    x = torch.rand(64, 2, generator=torch.Generator().manual_seed(0))
    params = dict(zip(svd.parameter_names,
                      (svd.param_mins + x * svd.p_span).unbind(1)))
    assert torch.equal(svd(params, t), direct(params, t))


def test_hook_and_load_registered_model(tmp_path):
    """get_model through a download hook that copies the .npz, then
    load_registered_model on the CPU: the surrogate's logL at 64 seeded
    points equals the directly loaded one's bit for bit, through
    EMAnalysis.batched_logl with the production surrogate."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.injections import create_light_curve_data
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.priors import parse_prior_dict

    calls = []

    def hook(name, home):
        calls.append(name)
        shutil.copy(PRODUCTION, os.path.join(home, f"{name}.npz"))

    t_registry.set_download_hook(hook)
    try:
        path = t_registry.get_model("Bu2019lm_hooked",
                                    models_home=str(tmp_path))
        assert path == str(tmp_path / "Bu2019lm_hooked.npz")
        registered = t_registry.load_registered_model(
            "Bu2019lm_hooked", models_home=str(tmp_path), device="cpu")
    finally:
        t_registry.set_download_hook(None)
    assert calls == ["Bu2019lm_hooked"]
    make_svd_source_model("Bu2019lm_direct",
                          SVDModelData.load(PRODUCTION, device="cpu"))
    filters = ["ztfg", "ztfr", "ztfi"]
    inj = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
           "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0}
    data = create_light_curve_data(inj, "Bu2019lm_direct", filters,
                                   tmin=0.5, tmax=11.0, n_tsteps=40,
                                   device="cpu")
    prior = "\n".join(f"{k} = Uniform(minimum={lo}, maximum={hi})"
                      for k, lo, hi in (
                          ("log10_mej_dyn", -3, -1),
                          ("log10_mej_wind", -2, -.5),
                          ("KNphi", 15, 75), ("KNtheta", 0, 90),
                          ("luminosity_distance", 20, 60),
                          ("timeshift", -0.1, 0.1)))
    u = torch.rand(64, 6, generator=torch.Generator().manual_seed(3))
    logl = []
    for name in ("Bu2019lm_hooked", "Bu2019lm_direct"):
        ana = EMAnalysis(EMAnalysisConfig(model=name, filters=filters,
                                          tmin=0.25, tmax=12.0),
                         data=data, priors=parse_prior_dict(prior),
                         device="cpu")
        logl.append(ana.batched_logl(u))
    assert len(registered.filters) == 9
    assert torch.equal(logl[0], logl[1])
    assert bool((logl[0] > -1e29).sum() >= 16)


def test_svdmodel_download_matches_jax(server, tmp_path, capsys):
    """svdmodel-download through both packages' tools: a reference-format
    fetch of every filter, then an .npz already in the home; a closed port
    with an empty home raises in both."""
    from nmma_tpu.cli import tools as j_tools
    from nmma_tpu_torch.cli import tools as t_tools
    url = server[0]
    got = {}
    for name, tools in (("jax", j_tools), ("port", t_tools)):
        home = tmp_path / name
        paths = tools.svdmodel_download(["--model", NAME, "--svd-path",
                                         str(home), "--registry-url", url,
                                         "--refresh-models-list"])
        got[name] = [os.path.relpath(p, home) for p in paths]
        shutil.copy(SPARSE, home / "native.npz")
        assert tools.svdmodel_download(
            ["--model", "native", "--svd-path", str(home)]) == \
            str(home / "native.npz")
        with pytest.raises(ValueError, match="not found in models list"):
            tools.svdmodel_download(["--model", "Absent", "--svd-path",
                                     str(tmp_path / f"{name}_empty"),
                                     "--registry-url", closed_port_url()])
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 1 + 9


def test_rank_zero_downloads(monkeypatch):
    """Rank 0 of torch.distributed when a group is initialised, else of
    RANK, else the lone process."""
    import torch.distributed as dist
    monkeypatch.delenv("RANK", raising=False)
    assert t_registry._is_process_zero()
    monkeypatch.setenv("RANK", "1")
    assert not t_registry._is_process_zero()
    monkeypatch.setenv("RANK", "0")
    assert t_registry._is_process_zero()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert not t_registry._is_process_zero()
