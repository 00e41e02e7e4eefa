"""The port's nmma-generation / nmma-analysis (GW only) against the JAX
package's, on the CPU.

One injection (json, and the same as a LIGO-LW xml table) goes through both
packages' ``nmma_generation`` (H1 + L1, 8 s, 20-512 Hz,
IMRPhenomD_NRTidalv2, relative binning). Compared:

* the fiducial (the converted injection): relative 1e-6;
* the ifo data: frequencies and PSDs exactly; the strain within 1e-2 of its
  maximum, because the JAX package evaluates its zero-noise injection with
  the parameters folded into the compiled graph, where XLA rounds GMST
  without the fused multiply-add its likelihood's graph uses (one f32 ulp
  of the hour count, 4.1e-3 rad of detector phase), while the port's
  injection and likelihood share their arithmetic;
* the test logL: the port's likelihood on the JAX package's ifo data
  against the JAX package's test logL, by the GW logL gate of
  tests/test_torch_gw_likelihood.py; the port's own test logL against
  SNR^2/2 of its own data (rtol 2e-3, tests/test_gw.py:28).

Then the real-strain case without an injection of
tests/test_joint_cli_breadth.py:57-101 in the port (hdf5 strain, median
Welch PSD, ML fiducial, a short analysis), a tiny analysis of the dump, and
every flag of the joint path's EOS, EM, population and Hubble parts in both
packages (config 5's EOS run at H1 + L1, 8 s, TaylorF2): the dumps agree,
and the port's likelihood gives the JAX package's test logL within the GW +
EM gate of tests/test_torch_joint.py.
"""

import json
import pickle

import h5py
import numpy as np
import pytest
import torch

from nmma_tpu.cli import joint_main as j_cli
from nmma_tpu_torch.cli import joint_main as t_cli

INJ = dict(mass_1=1.48, mass_2=1.26, lambda_1=300.0, lambda_2=500.0,
           luminosity_distance=40.0, theta_jn=0.4, phase=1.3,
           ra=3.446, dec=-0.408, psi=1.5, geocent_time=0.0)
TRIGGER = 1187008882.4
PRIOR = """\
chirp_mass = Uniform(name='chirp_mass', minimum=1.18, maximum=1.21)
mass_ratio = Uniform(name='mass_ratio', minimum=0.6, maximum=1.0)
lambda_1 = Uniform(name='lambda_1', minimum=0, maximum=5000)
lambda_2 = Uniform(name='lambda_2', minimum=0, maximum=5000)
luminosity_distance = Uniform(name='luminosity_distance', minimum=10, maximum=100)
theta_jn = Sine(name='theta_jn')
phase = Uniform(name='phase', minimum=0, maximum=2 * np.pi, boundary='periodic')
psi = Uniform(name='psi', minimum=0, maximum=np.pi, boundary='periodic')
ra = Uniform(name='ra', minimum=0, maximum=2 * np.pi, boundary='periodic')
dec = Cosine(name='dec')
geocent_time = Uniform(name='geocent_time', minimum=-0.1, maximum=0.1)
"""
GEN = ["--gw-detectors", "H1,L1", "--duration", "8", "--minimum-frequency",
       "20", "--maximum-frequency", "512", "--waveform",
       "IMRPhenomD_NRTidalv2", "--trigger-time", repr(TRIGGER)]
PHASE_ULP = 2.0**-10


def write_inputs(root, kind):
    prior = root / "bns.prior"
    prior.write_text(PRIOR)
    if kind == "json":
        from nmma_tpu_torch.injections import write_injection_file
        injection = root / "inj.json"
        write_injection_file(injection, {k: [v] for k, v in INJ.items()})
        return prior, injection
    from test_torch_gw_data import write_ligolw
    injection = root / "inj.xml"
    # geocent_end_time is the offset from --trigger-time, which is how both
    # packages' CLIs read an injection's geocent_time
    write_ligolw(injection, [[0, INJ["mass_1"], INJ["mass_2"], 0, 0, 0, 0,
                              0, 0, INJ["theta_jn"], INJ["phase"],
                              INJ["luminosity_distance"], INJ["ra"],
                              INJ["dec"], INJ["psi"], 0, 0]])
    return prior, injection


@pytest.fixture(scope="module", params=["json", "xml"])
def generated(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"gen_{request.param}")
    prior, injection = write_inputs(root, request.param)
    args = GEN + ["--prior-file", str(prior), "--injection-file",
                  str(injection)]
    j_path = j_cli.nmma_generation(args + ["--outdir", str(root / "jax"),
                                           "--label", "bns"])
    t_path = t_cli.nmma_generation(args + ["--outdir", str(root / "port"),
                                           "--label", "bns"],
                                   device="cpu")
    with open(j_path, "rb") as f:
        j_dump = pickle.load(f)
    with open(t_path, "rb") as f:
        t_dump = pickle.load(f)
    metas = [json.loads((root / side / "bns_generation_meta.json")
                        .read_text()) for side in ("jax", "port")]
    return root, j_dump, t_dump, t_path, metas


def test_generation_matches_jax(generated):
    from nmma_tpu_torch.gw import GWTransientLikelihood, InterferometerData
    from nmma_tpu_torch.gw import get_waveform

    root, j_dump, t_dump, _, (j_meta, t_meta) = generated
    assert sorted(t_dump["fiducial"]) == sorted(j_dump["fiducial"])
    for k, v in j_dump["fiducial"].items():
        np.testing.assert_allclose(t_dump["fiducial"][k], v, rtol=1e-6)
    for a, b in zip(t_dump["ifos"], j_dump["ifos"]):
        assert type(a) is InterferometerData and a.name == b.name
        np.testing.assert_array_equal(a.frequencies, b.frequencies)
        np.testing.assert_array_equal(a.psd, b.psd)
        assert np.max(np.abs(a.strain - b.strain)) / \
            np.max(np.abs(b.strain)) < 1e-2
    # the port's likelihood on the JAX package's data, at the test point
    ifos = [InterferometerData(i.name, i.frequencies, i.strain, i.psd,
                               i.duration) for i in j_dump["ifos"]]
    lk, priors = t_cli.build_joint_likelihood({**t_dump, "ifos": ifos},
                                              device="cpu")
    point = t_cli._fill_from_priors(t_dump["fiducial"], priors, "cpu")
    batch = {k: torch.tensor([v]) for k, v in point.items()}
    got = float(lk(batch)[0])
    want = j_meta["test_logl"]
    dense = GWTransientLikelihood(ifos, waveform=get_waveform(
        "IMRPhenomD_NRTidalv2"), trigger_time=TRIGGER, device="cpu")
    d_power = float(dense.optimal_snr(batch)[0]) ** 2
    assert abs(got - want) <= 1e-2 + 1e-4 * abs(want) + PHASE_ULP * d_power
    # the port's own data: its test logL is SNR^2/2
    own = GWTransientLikelihood(t_dump["ifos"], waveform=get_waveform(
        "IMRPhenomD_NRTidalv2"), trigger_time=TRIGGER, device="cpu")
    snr2 = float(own.optimal_snr(batch)[0]) ** 2
    np.testing.assert_allclose(t_meta["test_logl"], snr2 / 2, rtol=2e-3)
    assert t_meta["device"] == "cpu"
    assert set(t_meta["timings_s"]) >= {"gw_data", "fiducial", "total"}


def test_analysis_writes_the_posterior(generated, tmp_path):
    _, _, _, t_path, _ = generated
    result = t_cli.nmma_analysis([
        "--data-dump", t_path, "--outdir", str(tmp_path), "--label", "bns",
        "--nlive", "64", "--walks", "8", "--dlogz", "2.0", "--max-iter",
        "30", "--device", "cpu"])
    assert np.isfinite(result.logz)
    z = np.load(tmp_path / "bns_result.npz")
    for col in ("posterior_chirp_mass", "posterior_mass_1",
                "posterior_mass_1_source", "posterior_redshift",
                "posterior_log_likelihood"):
        assert col in z.files and np.isfinite(z[col]).all(), col


FS = 1024.0
T0 = 1000000000.0
STRAIN_TRIGGER = T0 + 34.0
BBH = dict(mass_1=36.0, mass_2=29.0, chi_1=0.0, chi_2=0.0,
           luminosity_distance=600.0, theta_jn=0.4, phase=1.0,
           ra=1.3, dec=-0.5, psi=0.7, geocent_time=0.0)
BBH_PRIOR = ("mass_1 = Uniform(minimum=30., maximum=42.)\n"
             "mass_2 = Uniform(minimum=24., maximum=34.)\n"
             "luminosity_distance = Uniform(minimum=200., maximum=1200.)\n"
             "chi_1 = 0.0\nchi_2 = 0.0\ntheta_jn = 0.4\nphase = 1.0\n"
             "ra = 1.3\ndec = -0.5\npsi = 0.7\ngeocent_time = 0.0\n")


@pytest.fixture(scope="module")
def strain_files(tmp_path_factory):
    """tests/test_joint_cli_breadth.py's white noise with an IMRPhenomD BBH,
    GWOSC-style HDF5 files for H1 and L1, the signal from the port."""
    from nmma_tpu_torch.gw import get_detector, imrphenomd
    from nmma_tpu_torch.gw.likelihood import as_batch, project_signal

    tmp = tmp_path_factory.mktemp("strain")
    duration, sigma = 8.0, 4.0e-23
    paths = {}
    for k, name in enumerate(("H1", "L1")):
        data = np.random.default_rng(20 + k).normal(0.0, sigma,
                                                    int(38.0 * FS))
        n = int(duration * FS)
        freqs = np.fft.rfftfreq(n, d=1.0 / FS)
        h = project_signal(get_detector(name), imrphenomd,
                           torch.as_tensor(freqs[1:], dtype=torch.float32),
                           as_batch(BBH, "cpu"), STRAIN_TRIGGER)[0].numpy()
        h_full = np.zeros(len(freqs), dtype=np.complex128)
        h_full[1:] = h
        h_full *= np.exp(-2j * np.pi * freqs * (duration - 2.0))
        i0 = int(round((STRAIN_TRIGGER + 2.0 - duration - T0) * FS))
        data[i0:i0 + n] += np.fft.irfft(h_full * FS, n=n)
        path = tmp / f"{name}.hdf5"
        with h5py.File(path, "w") as f:
            ds = f.create_dataset("strain/Strain", data=data)
            ds.attrs["Xspacing"] = 1.0 / FS
            f.create_dataset("meta/GPSstart", data=T0)
        paths[name] = str(path)
    return paths


def strain_args(tmp_path, strain_files, label):
    prior = tmp_path / "bbh.prior"
    prior.write_text(BBH_PRIOR)
    return ["--outdir", str(tmp_path), "--label", label,
            "--prior-file", str(prior),
            "--strain-files", ",".join(f"{k}:{v}"
                                       for k, v in strain_files.items()),
            "--trigger-time", str(STRAIN_TRIGGER), "--duration", "8.0",
            "--post-trigger-duration", "2.0", "--minimum-frequency", "20.0",
            "--maximum-frequency", "500.0", "--waveform", "IMRPhenomD",
            "--device", "cpu"]


def mchirp(m1, m2):
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def test_real_strain_without_injection(strain_files, tmp_path):
    """Welch PSD + ML fiducial + relative binning, no --injection-file
    (tests/test_joint_cli_breadth.py:57-101 in the port)."""
    dump = t_cli.nmma_generation(
        strain_args(tmp_path, strain_files, "realdata")
        + ["--fiducial-rounds", "3", "--fiducial-batch", "128"])
    with open(dump, "rb") as f:
        fid = pickle.load(f)["fiducial"]
    mc_true = mchirp(36.0, 29.0)
    assert abs(mchirp(fid["mass_1"], fid["mass_2"]) - mc_true) < 2.0
    result = t_cli.nmma_analysis([
        "--data-dump", dump, "--outdir", str(tmp_path), "--label",
        "realdata", "--nlive", "64", "--walks", "8", "--dlogz", "1.0",
        "--max-iter", "150"], device="cpu")
    assert np.isfinite(result.logz)
    post = np.load(tmp_path / "realdata_result.npz")
    mc_post = mchirp(post["posterior_mass_1"], post["posterior_mass_2"])
    assert abs(np.median(mc_post) - mc_true) < 1.5, np.median(mc_post)


def test_time_marginalized_dump_builds_the_dense_likelihood(strain_files,
                                                            tmp_path):
    from nmma_tpu_torch.gw import GWTransientLikelihood
    dump = t_cli.nmma_generation(
        strain_args(tmp_path, strain_files, "tmarg")
        + ["--time-marginalization", "--phase-marginalization",
           "--fiducial-rounds", "2", "--fiducial-batch", "64"])
    with open(dump, "rb") as f:
        payload = pickle.load(f)
    lk, _ = t_cli.build_joint_likelihood(payload, device="cpu")
    assert isinstance(lk.likelihoods[0], GWTransientLikelihood)
    assert lk.likelihoods[0].time_marginalization
    meta = json.loads((tmp_path / "tmarg_generation_meta.json").read_text())
    assert np.isfinite(meta["test_logl"])


def joint_inputs(root):
    """The EOS set, weights, mass-radius samples, constraint json and light
    curve that the joint flags read, made once under ``root``."""
    from test_torch_eos import write_macro_set
    from test_torch_joint import config5_args

    from nmma_tpu_torch.injections import create_light_curve_data
    from nmma_tpu_torch.io import write_em_observations
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model

    write_macro_set(root / "eos")
    np.savetxt(root / "w.txt", np.linspace(1.0, 3.0, 10))
    rng = np.random.default_rng(8)
    np.savetxt(root / "mr.dat", np.column_stack([
        rng.normal(1.4, 0.1, 4000), rng.normal(11.5, 0.6, 4000)]))
    (root / "c.json").write_text(json.dumps({
        "psr": {"type": "lower_mtov", "mass": 2.0, "error": 0.04},
        "nicer": {"type": "mass_radius", "file": str(root / "mr.dat")}}))
    make_svd_source_model("Bu2019lm_sparse", SVDModelData.load(
        "artifacts/Bu2019lm_sparse_svd.npz", device="cpu"))
    data = create_light_curve_data(
        {"log10_mej_dyn": -2.3, "log10_mej_wind": -1.6,
         "luminosity_distance": 40.0}, "Bu2019lm_sparse", ["ztfg", "ztfr"],
        tmin=0.5, tmax=10.0, n_tsteps=12, seed=3,
        trigger_time=EM_TRIGGER, device="cpu")
    write_em_observations(root / "lc.dat", data, fmt="dat")
    return config5_args(root, root / "eos", waveform="TaylorF2")


EM_TRIGGER = 57982.5285236896
EM = ["--em-model", "Bu2019lm_sparse",
      "--svd-path", "artifacts/Bu2019lm_sparse_svd.npz"]
# the flags of the joint path, each added to config 5's EOS run (to its GW
# part alone for the population and Hubble priors); {root} is the inputs'
# directory
JOINT_FLAGS = {
    "eos_data": [],
    "eos_weights": ["--eos-weights", "{root}/w.txt"],
    "eos_reweight": ["--eos-reweight", "--lower-mtov", "2.1,0.05"],
    "lower_mtov": ["--lower-mtov", "2.1,0.05"],
    "upper_mtov": ["--upper-mtov", "2.15,0.1"],
    "mass_radius": ["--mass-radius-files", "{root}/mr.dat"],
    "constraint_json": ["--eos-constraint-json", "{root}/c.json"],
    "em_model": EM,
    "light_curve": EM + ["--light-curve-data", "{root}/lc.dat",
                         "--em-trigger-time", repr(EM_TRIGGER)],
    "population": ["--population-model", "peak", "--population-beta",
                   "1.5"],
    "hubble": ["--hubble-prior", "planck"],
}


@pytest.fixture(scope="module")
def joint_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("joint_flags")
    return root, joint_inputs(root)


def _generate_both(root, args):
    out = {}
    for side, cli, kw in (("jax", j_cli, {}), ("port", t_cli,
                                               {"device": "cpu"})):
        path = cli.nmma_generation(args + ["--outdir", str(root / side),
                                           "--label", "j"], **kw)
        with open(path, "rb") as f:
            dump = pickle.load(f)
        meta = json.loads((root / side / "j_generation_meta.json")
                          .read_text())
        out[side] = (dump, meta)
    return out


def _test_point_matches(j_dump, j_meta, t_dump):
    """The port's likelihood of its own dump, on the JAX package's GW data
    and photometry, at the JAX package's test point: the GW + EM gate of
    tests/test_torch_joint.py."""
    from test_torch_joint import data_power, joint_gate, port_dump_on_jax_data
    dump = port_dump_on_jax_data(t_dump, j_dump)
    lk, priors = t_cli.build_joint_likelihood(dump, device="cpu")
    point = t_cli._fill_from_priors(t_dump["fiducial"], priors, "cpu")
    batch = {k: torch.tensor([v]) for k, v in point.items()}
    got = lk(batch).numpy()
    assert np.isfinite(j_meta["test_logl"]) and got[0] > -1e29
    joint_gate(lk, batch, got, np.array([j_meta["test_logl"]]),
               data_power(dump["ifos"], point))
    return lk, priors


@pytest.mark.parametrize("case", list(JOINT_FLAGS))
def test_joint_flags_match_jax(joint_root, tmp_path, case):
    """nmma_generation with each joint flag in both packages: the dumps'
    EOS, constraint and EM parts agree, and the port's likelihood of its
    dump gives the JAX package's test logL."""
    root, config5 = joint_root
    flags = [f.replace("{root}", str(root)) for f in JOINT_FLAGS[case]]
    if case in ("population", "hubble"):
        prior, injection = write_inputs(tmp_path, "json")
        args = GEN + ["--prior-file", str(prior), "--injection-file",
                      str(injection)]
    else:
        args = config5
    sides = _generate_both(tmp_path, args + flags)
    (j_dump, j_meta), (t_dump, t_meta) = sides["jax"], sides["port"]
    assert sorted(t_dump) == sorted(j_dump)
    for k, v in j_dump["fiducial"].items():
        np.testing.assert_allclose(t_dump["fiducial"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert t_dump["eos_constraints"] == j_dump["eos_constraints"]
    assert (t_dump["em_data"] is None) == (j_dump["em_data"] is None)
    for f, obs in (j_dump["em_data"] or {}).items():
        np.testing.assert_allclose(t_dump["em_data"][f]["time"], obs["time"])
        np.testing.assert_allclose(t_dump["em_data"][f]["mag"], obs["mag"],
                                   rtol=0, atol=1e-4)
    if case == "eos_reweight":
        assert t_dump["eos_constraints"] == []
        np.testing.assert_allclose(np.loadtxt(t_dump["eos_weights"]),
                                   np.loadtxt(j_dump["eos_weights"]),
                                   rtol=1e-5)
        for i in range(1, 11):
            np.testing.assert_allclose(
                np.loadtxt(f"{t_dump['eos_data']}/{i}.dat"),
                np.loadtxt(f"{j_dump['eos_data']}/{i}.dat"), rtol=1e-6)
    else:
        assert t_dump["eos_data"] == j_dump["eos_data"]
        assert t_dump["eos_weights"] == j_dump["eos_weights"]
    lk, priors = _test_point_matches(j_dump, j_meta, t_dump)
    names = [type(term).__name__ for term in lk.likelihoods]
    if case in ("eos_weights", "eos_reweight"):
        assert type(priors["EOS"]).__name__ == "WeightedCategorical"
    if case == "hubble":
        assert "Hubble_constant" in priors.sampled_names
    if case == "population":
        assert names[-1] == "NeutronStarPopulation"
    if case in ("lower_mtov", "upper_mtov", "mass_radius",
                "constraint_json"):
        assert names[-1] == "_EOSConstraintTerm"
    if case in ("em_model", "light_curve"):
        assert names[-1] == "EMLikelihood"
        assert lk.sanity_keys == ("log10_mej_dyn",)


def test_eos_injection_matches_jax(tmp_path):
    """An injection carrying EOS, ratio_zeta and TOV_mass without EOS data:
    both packages' chains take the quasi-universal radii and the ejecta
    fits, and give the same converted injection and test logL."""
    from nmma_tpu_torch.injections import write_injection_file
    prior, _ = write_inputs(tmp_path, "json")
    injection = tmp_path / "eos.json"
    write_injection_file(injection, {**{k: [v] for k, v in INJ.items()},
                                     "EOS": [4.2], "ratio_zeta": [0.3],
                                     "TOV_mass": [2.2], "alpha": [5e-5]})
    sides = _generate_both(tmp_path, GEN + [
        "--prior-file", str(prior), "--injection-file", str(injection)])
    (j_dump, j_meta), (t_dump, _) = sides["jax"], sides["port"]
    fid = t_dump["fiducial"]
    for k in ("radius_1", "radius_2", "R_16", "log10_mej_dyn",
              "log10_mej_wind", "log10_mej", "log10_E0"):
        np.testing.assert_allclose(fid[k], j_dump["fiducial"][k], rtol=1e-5,
                                   err_msg=k)
    assert np.isfinite(fid["log10_mej"]) and fid["radius_1"] > 0
    _test_point_matches(j_dump, j_meta, t_dump)


CONVERSIONS = {
    "chirp_ratio": dict(chirp_mass=(1.18, 1.21), mass_ratio=(0.6, 1.0),
                        luminosity_distance=(10, 100)),
    "components": dict(mass_1=(1.3, 1.6), mass_2=(1.1, 1.3),
                       luminosity_distance=(10, 100)),
    "chirp_eta": dict(chirp_mass=(1.18, 1.21),
                      symmetric_mass_ratio=(0.2, 0.2499),
                      luminosity_distance=(10, 100)),
    "hubble": dict(chirp_mass=(1.18, 1.21), mass_ratio=(0.6, 1.0),
                   luminosity_distance=(10, 100),
                   Hubble_constant=(60.0, 80.0)),
    "omega_matter": dict(chirp_mass=(1.18, 1.21), mass_ratio=(0.6, 1.0),
                         luminosity_distance=(10, 400),
                         Hubble_constant=(60.0, 80.0),
                         Omega_matter=(0.2, 0.4)),
}


@pytest.mark.parametrize("case", list(CONVERSIONS))
def test_conversion_chain_matches_jax(case):
    """cosmology_to_distance -> bns_source_frame and the posterior columns,
    the port against jax.vmap of the JAX package's, relative 1e-5 plus 1e-6
    of the column's largest value (1e-4 for a sampled Omega_matter, whose
    d_L(z) grid is a cumulative f32 sum of 4,096 terms in both
    packages)."""
    import jax
    import jax.numpy as jnp

    import nmma_tpu.conversion as j_conv
    import nmma_tpu_torch.conversion as t_conv

    rng = np.random.default_rng(13)
    p = {k: rng.uniform(lo, hi, 32) for k, (lo, hi) in
         CONVERSIONS[case].items()}
    p.update(lambda_1=rng.uniform(0, 3000, 32),
             lambda_2=rng.uniform(0, 3000, 32),
             chi_1=rng.uniform(-0.05, 0.05, 32),
             chi_2=rng.uniform(-0.05, 0.05, 32))

    def j_chain(q):
        out = j_conv.generate_posterior_parameters(
            j_conv.MultimessengerConversion(j_conv.cosmology_to_distance,
                                            j_conv.bns_source_frame)(q))
        lt, dlt = j_conv.\
            tidal_deformabilities_and_mass_ratio_to_eff_tidal_deformabilities(
                out["lambda_1"], out["lambda_2"], out["mass_ratio"])
        return {**out, "lambda_T": lt, "delta_lambda_T": dlt}

    want = jax.jit(jax.vmap(j_chain))(
        {k: jnp.asarray(v, jnp.float32) for k, v in p.items()})
    got = t_conv.generate_posterior_parameters(
        t_conv.MultimessengerConversion(t_conv.cosmology_to_distance,
                                        t_conv.bns_source_frame)(
            {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in p.items()}))
    got["lambda_T"], got["delta_lambda_T"] = t_conv.\
        tidal_deformabilities_and_mass_ratio_to_eff_tidal_deformabilities(
            got["lambda_1"], got["lambda_2"], got["mass_ratio"])
    assert sorted(got) == sorted(want)
    rtol = 1e-4 if case == "omega_matter" else 1e-5
    for k in want:
        w = np.asarray(want[k])
        # delta_lambda_T cancels terms of size lambda: its error scales with
        # the column's largest value
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                   atol=1e-6 * np.max(np.abs(w)), err_msg=k)


def test_cosmology_clone_and_set_match_jax():
    import nmma_tpu.cosmology as j_cos
    import nmma_tpu_torch.cosmology as t_cos

    t_other = t_cos.get_cosmology().clone(H0=70.0, Om0=0.3)
    j_other = j_cos.get_cosmology().clone(H0=70.0, Om0=0.3)
    assert (t_other.H0, t_other.Om0) == (j_other.H0, j_other.Om0)
    try:
        assert t_cos.set_cosmology(t_other) is t_cos.get_cosmology()
        d = torch.tensor([40.0, 400.0])
        np.testing.assert_allclose(
            t_cos.redshift_from_parameters({"luminosity_distance": d})
            .numpy(),
            np.asarray(j_cos.redshift_from_parameters(
                {"luminosity_distance": jnp_array([40.0, 400.0])},
                j_other)), rtol=1e-5)
    finally:
        t_cos.set_cosmology(None)
    assert t_cos.get_cosmology() is t_cos.PLANCK18
    z = torch.tensor([0.1, 0.2])
    assert t_cos.redshift_from_parameters({"redshift": z}) is z
    assert torch.equal(t_cos.redshift_from_parameters({"m": z}),
                       torch.zeros(2))


def jnp_array(values):
    import jax.numpy as jnp
    return jnp.asarray(values, jnp.float32)
