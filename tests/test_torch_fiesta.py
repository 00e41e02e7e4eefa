"""The port's fiesta surrogates (``nmma_tpu_torch/models/fiesta.py``) and
their CLI path against the JAX package's, on the CPU.

The surrogates are seeded here (no fiesta weights are in the repo): the
small per-filter lightcurve MLP of tests/test_fiesta.py and a flux-grid
MLP. Tolerances, with their reasons:

* magnitudes at B = 16 against ``jax.vmap``: 1e-4 mag (the models' f32
  gate), inf in the same places. The port takes log10 as ln x times
  1/ln 10, as XLA does, so the frequency cells are read alike (measured:
  0 mag apart on the lightcurve and point-frequency flux kinds, ~2e-6 with
  the banded integral);
* ingestion (flax msgpack through the port's own decoder, the pickle
  fallback, CVAE decoders, the native ``.npz`` of either package): the
  arrays equal, bit for bit;
* ``check_vs_priors``: the same messages;
* ``lightcurve-analysis --fiesta-surrogates-dir`` against the JAX CLI with
  ``--skip-sampling``: logL at 64 seeded unit points within rtol 1e-4 and
  atol 1e-2 with identical sentinels (tests/test_torch_em_slice.py's
  bounds), for both kinds from a fiesta-format directory and a native
  ``.npz``; then a small port run recovers the injection's medians within
  0.4 (tests/test_fiesta.py's criterion).
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.cli.lightcurve_analysis as j_cli
import nmma_tpu.models as j_models
import nmma_tpu.models.fiesta as j_fiesta
import nmma_tpu_torch.cli.lightcurve_analysis as t_cli
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.fiesta as t_fiesta
from nmma_tpu.filters import filters_to_quadrature
from nmma_tpu_torch.io.msgpack import msgpack_restore
from nmma_tpu_torch.priors import PriorDict
from nmma_tpu_torch.priors.core import Uniform

torch.set_num_threads(1)

B = 16
MAG_ATOL = 1e-4
RTOL, ATOL = 1e-4, 1e-2
TIMES = np.geomspace(0.1, 20.0, 60)
FILTERS = ("ztfg", "ztfr", "ztfi")
PARAMS = ("log10_mej_dyn", "log10_mej_wind")
SUPPORT = {"log10_mej_dyn": (-3.0, -1.0), "log10_mej_wind": (-2.0, -0.5)}
NUS = np.geomspace(1e14, 2e15, 16)


def lightcurve_data(name="SynthKN", seed=3, hidden=16):
    """tests/test_fiesta.py's per-filter 2-layer MLP surrogate (JAX)."""
    rng = np.random.default_rng(seed)
    p, f, t = len(PARAMS), len(FILTERS), len(TIMES)
    return j_fiesta.FiestaSurrogateData(
        name=name, kind="lightcurve", parameter_names=PARAMS,
        parameter_distributions=dict(SUPPORT), times=TIMES,
        x_min=np.array([-3.0, -2.0]), x_max=np.array([-1.0, -0.5]),
        kernels=(rng.normal(0.0, 0.5, (f, p, hidden)),
                 rng.normal(0.0, 0.2, (f, hidden, t))),
        biases=(rng.normal(0.0, 0.1, (f, hidden)),
                rng.normal(0.5, 0.05, (f, t))),
        y_min=np.full((f, t), -17.0), y_max=np.full((f, t), -9.0),
        filters=FILTERS)


def flux_data(name="SynthFlux", seed=5, hidden=12, layers=3):
    """A flux-grid MLP over NUS x TIMES whose log10 F_nu [mJy at 10 pc]
    gives absolute magnitudes around -16 (JAX)."""
    rng = np.random.default_rng(seed)
    n_out = len(NUS) * len(TIMES)
    dims = [len(PARAMS)] + [hidden] * (layers - 1) + [n_out]
    return j_fiesta.FiestaSurrogateData(
        name=name, kind="flux", parameter_names=PARAMS,
        parameter_distributions=dict(SUPPORT), times=TIMES,
        x_min=np.array([-3.0, -2.0]), x_max=np.array([-1.0, -0.5]),
        kernels=tuple(rng.normal(0.0, 0.4, (a, b))
                      for a, b in zip(dims[:-1], dims[1:])),
        biases=tuple(rng.normal(0.0, 0.1, b) for b in dims[1:]),
        y_min=np.full(n_out, 12.0), y_max=np.full(n_out, 14.0), nus=NUS)


def port(jdata):
    return t_fiesta.fiesta_from_numpy(dataclasses.asdict(jdata),
                                      device="cpu")


def draws(seed):
    """B seeded live points, with the GRB gate's keys: a quarter beyond
    the thetaWing window, a quarter with epsilon_e + epsilon_B > 1."""
    rng = np.random.default_rng(seed)
    p = {"log10_mej_dyn": rng.uniform(-3, -1, B),
         "log10_mej_wind": rng.uniform(-2, -0.5, B),
         "thetaCore": rng.uniform(0.01, 0.3, B),
         "alphaWing": rng.uniform(1.0, 4.0, B),
         "log10_epsilon_e": rng.uniform(-3.0, -1.0, B),
         "log10_epsilon_B": rng.uniform(-4.0, -1.0, B)}
    p["alphaWing"][:4] = 10.0 / p["thetaCore"][:4]
    p["log10_epsilon_e"][4:8] = 0.0
    return {k: v.astype(np.float32) for k, v in p.items()}


def assert_mags_match(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=MAG_ATOL)
    return fin


@pytest.mark.parametrize("case", ["lightcurve", "flux_point",
                                  "flux_banded"])
def test_magnitudes_match_jax_vmap(case):
    jdata = lightcurve_data() if case == "lightcurve" else flux_data()
    tdata = port(jdata)
    p = draws(11)
    t_q = np.geomspace(0.05, 30.0, 40).astype(np.float32)   # past both ends
    z = np.random.default_rng(12).uniform(0.0, 0.2, B).astype(np.float32)
    # the third filter's frequency lies outside the flux grid
    nu_eff = np.array([6.3e14, 4.7e14, 1e10], dtype=np.float32)
    nu_host = (nu_eff[None] * (1 + z[:, None])).astype(np.float32)
    nodes, weights = filters_to_quadrature(["ztfg", "ztfr", "radio-6GHz"])
    nu_nodes = (nodes[None] * (1 + z[:, None, None])).astype(np.float32)
    weights = weights.astype(np.float32)
    banded = case == "flux_banded"

    def one(params, nh, nn):
        return j_fiesta.fiesta_surrogate_mags(
            jdata, params, jnp.asarray(t_q), nh,
            nn if banded else None, jnp.asarray(weights) if banded else None)
    want = np.asarray(jax.vmap(one)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(nu_host),
        jnp.asarray(nu_nodes)))
    got = tdata.magnitudes(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(t_q),
        torch.from_numpy(nu_host),
        torch.from_numpy(nu_nodes) if banded else None,
        torch.from_numpy(weights) if banded else None).numpy()
    fin = assert_mags_match(got, want)
    gated = np.isinf(got).all(axis=(1, 2))
    assert gated[:8].all() and not gated[8:].any()
    inside = (t_q >= TIMES[0]) & (t_q <= TIMES[-1])
    assert np.isinf(got[:, :, ~inside]).all()
    assert fin[8:][:, :2][:, :, inside].all()
    if case != "lightcurve":
        # out of the trained frequency range: the log-flux floor
        assert (got[8:, 2] > 200).all()


@pytest.mark.parametrize("kind", ["lightcurve", "flux"])
def test_detector_magnitudes_match(kind):
    """Both kinds registered and through both packages' detector (the flux
    kind banded over the filters' quadrature)."""
    name = f"fiesta_{kind}_detector_test"
    jdata = lightcurve_data(name) if kind == "lightcurve" else \
        flux_data(name)
    j_fiesta.make_fiesta_source_model(name, jdata)
    model = t_fiesta.make_fiesta_source_model(name, port(jdata))
    assert model.banded == (kind == "flux")
    rng = np.random.default_rng(13)
    params = {"log10_mej_dyn": rng.uniform(-3, -1, B),
              "log10_mej_wind": rng.uniform(-2, -0.5, B),
              "luminosity_distance": rng.uniform(10, 200, B),
              "timeshift": rng.uniform(-0.2, 0.2, B)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    times = np.geomspace(0.2, 15.0, 30)
    t_det = t_models.DetectorLightCurveModel(name, list(FILTERS),
                                             sample_times=times,
                                             device="cpu")
    j_det = j_models.DetectorLightCurveModel(name, list(FILTERS),
                                             sample_times=times)
    _, got = t_det({k: torch.from_numpy(v) for k, v in params.items()})
    _, want = jax.jit(jax.vmap(j_det))(
        {k: jnp.asarray(v) for k, v in params.items()})
    fin = assert_mags_match(got.numpy(), np.asarray(want))
    assert fin.mean() > 0.9


def flax_tree(jdata, i, latent=0, rng=None):
    """The flax parameter tree of filter i's network; with ``latent``, a
    CVAE with an encoder and a latent-leading decoder."""
    dense = {f"Dense_{k}": {"kernel": np.asarray(w[i]),
                            "bias": np.asarray(b[i])}
             for k, (w, b) in enumerate(zip(jdata.kernels, jdata.biases))}
    if not latent:
        return {"params": dense}
    dense["Dense_0"]["kernel"] = np.concatenate(
        [rng.normal(0, 0.5, (latent, dense["Dense_0"]["kernel"].shape[1])),
         dense["Dense_0"]["kernel"]])
    return {"params": {
        "encoder": {"Dense_0": {"kernel": rng.normal(0, 1, (60, 8)),
                                "bias": rng.normal(0, 1, 8)},
                    "Dense_1": {"kernel": rng.normal(0, 1, (8, latent)),
                                "bias": rng.normal(0, 1, latent)}},
        "decoder": dense}}


def write_fiesta_dir(d, jdata, fmt="msgpack", latent=0):
    """A fiesta-format directory: the metadata pickle and one network file
    a filter (lightcurve kind) or ``{name}.pkl`` (flux kind), as flax
    msgpack or pickled parameter trees."""
    from flax import serialization

    os.makedirs(d, exist_ok=True)
    meta = {
        "times": jdata.times,
        "parameter_names": list(jdata.parameter_names),
        "parameter_distributions": {k: list(v) for k, v in
                                    jdata.parameter_distributions.items()},
        "X_scaler": {"min_val": jdata.x_min, "max_val": jdata.x_max},
    }
    rng = np.random.default_rng(21)
    if jdata.kind == "flux":
        meta.update(nus=jdata.nus, y_scaler={"min_val": jdata.y_min,
                                             "max_val": jdata.y_max})
        trees = {jdata.name: {"params": {
            f"Dense_{k}": {"kernel": w, "bias": b} for k, (w, b) in
            enumerate(zip(jdata.kernels, jdata.biases))}}}
    else:
        meta.update(filters=list(jdata.filters), y_scaler={
            f: {"min_val": jdata.y_min[i], "max_val": jdata.y_max[i]}
            for i, f in enumerate(jdata.filters)})
        trees = {f: flax_tree(jdata, i, latent, rng)
                 for i, f in enumerate(jdata.filters)}
    with open(os.path.join(d, f"{jdata.name}_metadata.pkl"), "wb") as fh:
        pickle.dump(meta, fh)
    for fname, tree in trees.items():
        with open(os.path.join(d, f"{fname}.pkl"), "wb") as fh:
            if fmt == "msgpack":
                fh.write(serialization.to_bytes(tree))
            else:
                pickle.dump(tree, fh)
    return trees


def assert_same_data(got, want):
    """Port and JAX FiestaSurrogateData: every field equal."""
    for f in dataclasses.fields(j_fiesta.FiestaSurrogateData):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, tuple) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, f.name


def test_msgpack_decoder_matches_flax(tmp_path):
    """Every network file of a fiesta-format directory, and a tree with
    every leaf type flax writes (ints of each width, floats, strings,
    bools, None, complex, numpy scalars, bfloat16, nested lists), decode to
    what flax's own msgpack_restore gives."""
    from flax import serialization

    jdata = lightcurve_data()
    trees = write_fiesta_dir(str(tmp_path), jdata)
    for fname in trees:
        blob = (tmp_path / f"{fname}.pkl").read_bytes()
        want = serialization.msgpack_restore(blob)
        got = msgpack_restore(blob)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    mixed = {"a": [1, -5, 200, -200, 70000, -70000, 2**40, -2**40, 1.5],
             "s": "latent", "t": True, "f": False, "n": None, "c": 1 - 2j,
             "i16": np.int16(-3), "u8": np.uint8(250),
             "f16": np.arange(6, dtype=np.float16).reshape(2, 3),
             "bf16": jnp.linspace(0, 1, 5, dtype=jnp.bfloat16),
             "wide": {str(i): np.float32(i) for i in range(40)}}
    blob = serialization.msgpack_serialize(mixed)
    want = serialization.msgpack_restore(blob)
    got = msgpack_restore(blob)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "bf16":     # widened exactly to f32 (no bfloat16 in numpy)
            np.testing.assert_array_equal(
                got[k], np.asarray(want[k], dtype=np.float32))
            assert got[k].dtype == np.float32
        elif isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    for bad in (blob[:-2], blob + b"\x00", pickle.dumps(mixed["a"])):
        with pytest.raises(ValueError):
            msgpack_restore(bad)


@pytest.mark.parametrize("case", ["lightcurve_msgpack", "lightcurve_pickle",
                                  "flux_msgpack", "flux_pickle"])
def test_ingest_fiesta_directory_matches(tmp_path, case):
    kind, fmt = case.split("_")
    jdata = lightcurve_data() if kind == "lightcurve" else flux_data()
    write_fiesta_dir(str(tmp_path), jdata, fmt=fmt)
    want = j_fiesta.ingest_fiesta_directory(str(tmp_path), jdata.name)
    got = t_fiesta.ingest_fiesta_directory(str(tmp_path), jdata.name,
                                           device="cpu")
    assert_same_data(got, want)
    assert_same_data(got, jdata)


def test_cvae_reduction_matches(tmp_path):
    """A CVAE tree ingests as the zero-latent decoder: the encoder dropped,
    the latent rows of the first decoder kernel deleted, in both."""
    jdata = lightcurve_data()
    write_fiesta_dir(str(tmp_path), jdata, latent=3)
    want = j_fiesta.ingest_fiesta_directory(str(tmp_path), jdata.name)
    got = t_fiesta.ingest_fiesta_directory(str(tmp_path), jdata.name,
                                           device="cpu")
    assert_same_data(got, want)
    for a, b in zip(got.kernels, jdata.kernels):
        np.testing.assert_array_equal(a, b)
    layers = [(np.ones((5, 4)), np.zeros(4)), (np.ones((4, 2)), np.zeros(2))]
    for mod in (t_fiesta, j_fiesta):
        assert mod._reduce_cvae_latent(layers, 2)[0][0].shape == (2, 4)
        with pytest.raises(ValueError, match="input dim"):
            mod._reduce_cvae_latent(layers, 6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_npz_read_by_the_other_package(tmp_path, writer):
    for jdata in (lightcurve_data(), flux_data()):
        path = str(tmp_path / f"{jdata.name}.npz")
        if writer == "jax":
            jdata.save(path)
            got = t_fiesta.FiestaSurrogateData.load(path, device="cpu")
            assert_same_data(got, jdata)
        else:
            port(jdata).save(path)
            assert_same_data(j_fiesta.FiestaSurrogateData.load(path), jdata)


def test_load_fiesta_surrogate_search(tmp_path, monkeypatch):
    """The nested KN/{model}/model layout past a malformed root candidate,
    the environment's surrogates root, and the same data in both."""
    jdata = lightcurve_data()
    with open(tmp_path / "metadata.pkl", "wb") as fh:
        pickle.dump({"times": [1.0], "parameter_names": ["x"],
                     "X_scaler": {}}, fh)
    write_fiesta_dir(str(tmp_path / "KN" / jdata.name / "model"), jdata)
    monkeypatch.setenv(t_fiesta.FIESTA_ENV, str(tmp_path))
    got = t_fiesta.load_fiesta_surrogate(jdata.name, device="cpu")
    assert_same_data(got, j_fiesta.load_fiesta_surrogate(jdata.name))
    with pytest.raises(FileNotFoundError, match="not found"):
        t_fiesta.load_fiesta_surrogate("NoSuchModel", device="cpu")


def test_check_vs_priors_messages_match():
    jdata = lightcurve_data()
    tdata = port(jdata)
    from nmma_tpu.priors import PriorDict as JPriorDict
    from nmma_tpu.priors.core import Uniform as JUniform
    ok = {"log10_mej_dyn": (-2.9, -1.1)}
    bad = {"log10_mej_dyn": (-5.0, -1.0), "log10_mej_wind": (-1.9, 0.0)}
    for ranges, raises in ((ok, False), (bad, True)):
        t_pd = PriorDict({k: Uniform(minimum=lo, maximum=hi)
                          for k, (lo, hi) in ranges.items()})
        j_pd = JPriorDict({k: JUniform(minimum=lo, maximum=hi)
                           for k, (lo, hi) in ranges.items()})
        if not raises:
            tdata.check_vs_priors(t_pd)
            jdata.check_vs_priors(j_pd)
            continue
        with pytest.raises(ValueError) as t_err:
            tdata.check_vs_priors(t_pd)
        with pytest.raises(ValueError) as j_err:
            jdata.check_vs_priors(j_pd)
        assert str(t_err.value) == str(j_err.value)
        assert "support" in str(t_err.value)


TRUTH = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.0}
PRIOR = ("log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)\n"
         "log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)\n"
         "luminosity_distance = 40.0\n"
         "timeshift = 0.0\n")


def cli_files(root, jdata, layout):
    """The surrogate root (fiesta-format directory or native .npz), the
    prior and photometry the JAX surrogate gives at TRUTH, 12 epochs a
    filter with 0.1 mag errors (tests/test_fiesta.py)."""
    surdir = root / "surrogates"
    surdir.mkdir()
    if layout == "npz":
        jdata.save(str(surdir / f"{jdata.name}.npz"))
    else:
        write_fiesta_dir(str(surdir), jdata)
    j_fiesta.make_fiesta_source_model(jdata.name + "_photometry", jdata)
    det = j_models.DetectorLightCurveModel(
        jdata.name + "_photometry", list(FILTERS),
        sample_times=np.geomspace(0.1, 20.0, 100))
    t_obs, mags = det({**{k: jnp.asarray(v) for k, v in TRUTH.items()},
                       "luminosity_distance": jnp.asarray(40.0),
                       "timeshift": jnp.asarray(0.0)})
    epochs = np.linspace(0.5, 10.0, 12)
    rows = []
    for i, f in enumerate(FILTERS):
        m = np.interp(epochs, np.asarray(t_obs), np.asarray(mags[i]))
        rows += [f"{59000 + t:.4f} {f} {v:.4f} 0.10"
                 for t, v in zip(epochs, m)]
    (root / "lc.dat").write_text("\n".join(rows) + "\n")
    (root / "p.prior").write_text(PRIOR)
    return ["--model", jdata.name, "--fiesta-surrogates-dir", str(surdir),
            "--prior", str(root / "p.prior"),
            "--light-curve-data", str(root / "lc.dat"),
            "--trigger-time", "59000", "--tmin", "0.1", "--tmax", "20.0",
            "--nlive", "64", "--walks", "8", "--dlogz", "2.0",
            "--error-budget", "0.2", "--outdir", str(root), "--label",
            "fiesta"]


@pytest.mark.parametrize("case", ["lightcurve_dir", "lightcurve_npz",
                                  "flux_dir", "flux_npz"])
def test_cli_logl_matches_jax(tmp_path, case):
    kind, layout = case.split("_")
    name = f"SynthCLI_{case}"
    jdata = lightcurve_data(name) if kind == "lightcurve" else \
        flux_data(name)
    args = cli_files(tmp_path, jdata, layout)
    j_ana = j_cli.main(args + ["--skip-sampling"])
    t_ana = t_cli.main(args + ["--skip-sampling"], device="cpu")
    assert t_fiesta.registered_fiesta_data(name) is not None
    assert t_ana.priors.sampled_names == j_ana.priors.sampled_names
    u = np.random.default_rng(64).uniform(
        size=(64, t_ana.priors.ndim)).astype(np.float32)
    want = np.asarray(j_ana.batched_logl(jnp.asarray(u)))
    got = t_ana.batched_logl(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    ok = want > -1e29
    assert ok.sum() >= 48
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def test_cli_run_recovers_the_injection(tmp_path):
    jdata = lightcurve_data("SynthCLI_run")
    args = cli_files(tmp_path, jdata, "dir")
    ana = t_cli.main(args, device="cpu")
    assert np.isfinite(ana.result.logz)
    post = ana.posterior_samples()
    for k, v in TRUTH.items():
        assert abs(float(np.median(np.asarray(post[k]))) - v) < 0.4, k
    # the trained-support guard also holds for the registered model
    bad = tmp_path / "bad.prior"
    bad.write_text(PRIOR.replace("minimum=-3.", "minimum=-5."))
    i = args.index("--prior")
    with pytest.raises(ValueError, match="support"):
        t_cli.main(args[:i + 1] + [str(bad)] + args[i + 2:]
                   + ["--skip-sampling"], device="cpu")
