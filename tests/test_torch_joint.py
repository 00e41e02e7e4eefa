"""The port's joint GW + EM + EOS path against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages:

* every conversion function of the joint path (EOS, pulsar timing, jet
  E_iso, ejecta fits), ``jax.vmap`` of the JAX function against the port's
  batch: rtol 1e-5 plus atol 1e-6 of the column's largest value (f32 libm
  ulps; ``cbrt`` is a power of 1/3 in the port);
* ``KilonovaEjectaFitting`` on BNS, NSBH and BBH rows and on rows with
  sampled ejecta: the same -inf rows, the finite log10 masses within atol
  1e-4 (dex), sampled values untouched;
* ``InjectionCreator`` with ``finite_ejecta_test``, both packages fed the
  same unit-cube draws: the same accepted draws (rtol 1e-5);
* the config-5 joint logL (``scripts/bench_joint_pe.py:21-52`` at a reduced
  GW width: H1 + L1, 8 s, 20-512 Hz) of one dump, built by both packages'
  ``build_joint_likelihood`` at B = 64: the GW gate (1e-2 + 1e-4 |logL_GW|
  + 2^-10 <d,d>, tests/test_torch_gw_likelihood.py) plus the EM gate (1e-2
  + 1e-4 |logL_EM|), with the -1e30 sentinels in the same places.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eos import write_macro_set

import nmma_tpu.conversion as j_conv
import nmma_tpu_torch.conversion as t_conv

torch.set_num_threads(1)

PHASE_ULP = 2.0**-10
N = 64


def _rng_inputs(seed, spec):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, N).astype(np.float32)
            for k, (lo, hi) in spec.items()}


def _check(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want[ok])))


MASSES = dict(m1=(1.2, 2.0), m2=(1.0, 1.4), comp1=(0.12, 0.2),
              comp2=(0.1, 0.18), lam1=(50.0, 1500.0), lam2=(100.0, 3000.0))
FUNCTIONS = {
    "lambda_to_compactness": (dict(lam=(1.0, 5000.0)), ("lam",)),
    "mass_and_compactness_to_radius": (dict(m=(1.0, 2.0), c=(0.1, 0.6)),
                                       ("m", "c")),
    "binary_mass_function": (dict(m=(1.2, 2.1), mc=(0.1, 1.0),
                                  s=(0.1, 1.0)), ("m", "mc", "s")),
    "shapiro_delay": (dict(mc=(0.1, 1.0), s=(0.1, 1.0)), ("mc", "s")),
    "einstein_delay_orbital_factor": (dict(pb=(1e3, 1e6), e=(0.0, 0.7)),
                                      ("pb", "e")),
    "simplified_einstein_delay": (dict(mp=(1.2, 2.1), mc=(0.1, 1.0),
                                       f=(1e-6, 1e-4)), ("mp", "mc", "f")),
    "einstein_delay": (dict(mp=(1.2, 2.1), mc=(0.1, 1.0), pb=(1e3, 1e6),
                            e=(0.0, 0.7)), ("mp", "mc", "pb", "e")),
    "mass_parameters_to_sini": (dict(mt=(1.5, 3.0), f=(1e-3, 0.2),
                                     mc=(0.2, 1.0)), ("mt", "f", "mc")),
    "chibh_to_risco": (dict(chi=(-0.99, 0.99)), ("chi",)),
    "baryon_mass_ns": (dict(m=(1.0, 2.0), c=(0.1, 0.2)), ("m", "c")),
    "nsbh_remnant_disk_mass": (dict(m1=(3.0, 10.0), m2=(1.1, 1.6),
                                    c=(0.12, 0.2), chi=(-0.5, 0.9)),
                               ("m1", "m2", "c", "chi")),
    "nsbh_dynamic_mass": (dict(m1=(3.0, 10.0), m2=(1.1, 1.6),
                               c=(0.12, 0.2), chi=(-0.5, 0.9)),
                          ("m1", "m2", "c", "chi")),
    "bns_log10_disk_mass": (dict(mt=(2.4, 3.4), q=(0.6, 1.0),
                                 mtov=(2.0, 2.4), r16=(7.0, 9.5)),
                            ("mt", "q", "mtov", "r16")),
    "bns_dynamic_mass_krfo": (MASSES, ("m1", "m2", "comp1", "comp2")),
    "bns_dynamic_vel_radice2018": (MASSES, ("m1", "m2", "comp1", "comp2")),
    "bns_prompt_collapse_dynamic_mass": (MASSES, ("m1", "m2", "lam1",
                                                  "lam2")),
    "bns_prompt_collapse_dynamic_vel": (MASSES, ("m1", "m2", "comp1",
                                                 "comp2")),
    "bns_prompt_collapse_log10_disk_mass": (MASSES, ("m1", "m2", "lam1",
                                                     "lam2")),
    "chibh_fitting": (MASSES, ("m1", "m2", "lam1", "lam2")),
    "gaussian_jet_log10_eiso": (dict(e=(48.0, 52.0), tc=(0.02, 0.3),
                                     aw=(1.5, 6.0)), ("e", "tc", "aw")),
    "powerlaw_jet_log10_eiso": (dict(e=(48.0, 52.0), tc=(0.02, 0.3),
                                     aw=(1.5, 6.0), b=(0.5, 6.0)),
                                ("e", "tc", "aw", "b")),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_conversion_function_matches_jax(name):
    spec, order = FUNCTIONS[name]
    x = _rng_inputs(len(name), spec)
    want = jax.vmap(getattr(j_conv, name))(*[jnp.asarray(x[k])
                                              for k in order])
    got = getattr(t_conv, name)(*[torch.from_numpy(x[k]) for k in order])
    _check(got.numpy(), want)


def test_eos_curve_conversions_match_jax(tmp_path):
    """radii_from_qur, and eos_to_ns_parameters / eos_to_system_parameters
    on the rows of a macro set (masses on both sides of MTOV)."""
    x = _rng_inputs(5, dict(mass_1_source=(1.2, 2.0),
                            mass_2_source=(1.0, 1.4),
                            lambda_1=(0.0, 1500.0), lambda_2=(1.0, 3000.0)))
    x["lambda_1"][::8] = 0.0
    want = jax.vmap(j_conv.radii_from_qur)(
        {k: jnp.asarray(v) for k, v in x.items()})
    got = t_conv.radii_from_qur({k: torch.from_numpy(v)
                                 for k, v in x.items()})
    for k in ("radius_1", "radius_2", "R_16"):
        _check(got[k].numpy(), want[k])
    assert (got["radius_1"] == 0).any()           # lambda 0: no radius

    curves = [np.loadtxt(p) for p in write_macro_set(tmp_path)]
    rows = []
    for c in curves:       # the stable branch, ascending in mass
        stable = c[:int(np.argmax(c[:, 1])) + 1]
        idx = np.linspace(0, len(stable) - 1, 24).round().astype(int)
        rows.append(stable[idx])
    rows = np.stack(rows).astype(np.float32)        # [10, 24, 3]
    r, m, lam = (rows[..., i] for i in range(3))
    m1 = np.linspace(1.0, 2.3, 10).astype(np.float32)
    m2 = np.full(10, 1.3, np.float32)
    want = [np.asarray(a) for a in jax.vmap(j_conv.eos_to_ns_parameters)(
        jnp.asarray(r), jnp.asarray(m))]
    got = t_conv.eos_to_ns_parameters(torch.from_numpy(r),
                                      torch.from_numpy(m))
    for g, w in zip(got, want):
        _check(g.numpy(), w)
    want = [np.asarray(a) for a in jax.vmap(j_conv.eos_to_system_parameters)(
        *map(jnp.asarray, (r, m, lam, m1, m2)))]
    got = t_conv.eos_to_system_parameters(*map(torch.from_numpy,
                                               (r, m, lam, m1, m2)))
    assert (want[0] == 0).any() and (want[2] == 0).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy() == 0, w == 0)
        _check(g.numpy(), w)


def _ejecta_rows():
    """BNS (radius_1 > 0), NSBH (radius_1 = 0 < radius_2) and BBH rows."""
    rng = np.random.default_rng(9)
    p = {"mass_1_source": rng.uniform(1.2, 6.0, N),
         "mass_2_source": rng.uniform(1.0, 1.5, N),
         "radius_1": rng.uniform(10.0, 13.0, N),
         "radius_2": rng.uniform(10.0, 13.5, N),
         "TOV_mass": rng.uniform(2.0, 2.4, N),
         "R_16": rng.uniform(10.5, 13.0, N),
         "ratio_zeta": rng.uniform(0.0, 0.5, N),
         "alpha": rng.uniform(0.0, 1e-3, N),
         "chi_1": rng.uniform(-0.3, 0.9, N)}
    kind = np.arange(N) % 3
    p["radius_1"][kind > 0] = 0.0
    p["radius_2"][kind == 2] = 0.0
    return {k: v.astype(np.float32) for k, v in p.items()}, kind


EJECTA = {
    "plain": {},
    "sampled": {"log10_mej_dyn": -2.5, "log10_E0": 50.0},
    "tophat_jet": {"thetaCore": 0.08, "ratio_epsilon": 0.01},
    "gaussian_jet": {"thetaWing": 0.3},
    "powerlaw_jet": {"alphaWing": 3.0, "b": 2.0},
    "spin_tilt": {"a_1": 0.6, "cos_tilt_1": 0.5},
}


@pytest.mark.parametrize("case", list(EJECTA))
def test_kilonova_ejecta_fitting_matches_jax(case):
    p, kind = _ejecta_rows()
    for k, v in EJECTA[case].items():
        p[k] = np.full(N, v, np.float32)
    if case == "spin_tilt":
        del p["chi_1"]
    want = jax.vmap(j_conv.KilonovaEjectaFitting())(
        {k: jnp.asarray(v) for k, v in p.items()})
    got = t_conv.KilonovaEjectaFitting()(
        {k: torch.from_numpy(v) for k, v in p.items()})
    for key in t_conv.KilonovaEjectaFitting.mass_fitting_keys:
        g, w = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=key)
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=1e-4,
                                   err_msg=key)
        if key in EJECTA[case]:
            assert (g == EJECTA[case][key]).all()
    # BBH rows carry no ejecta; BNS rows always do
    assert not np.isfinite(got["log10_mej"].numpy()[kind == 2]).any()
    assert np.isfinite(got["log10_mej"].numpy()[kind == 0]).all()


def test_supernova_and_resampling_conversions_match_jax():
    x = _rng_inputs(6, dict(log10_mni=(-2.0, -0.5), log10_mtot=(0.0, 1.0),
                            log10_mrp=(-2.0, -1.0), xmix=(0.1, 0.9)))
    want = jax.vmap(j_conv.convert_mtot_mni)(
        {k: jnp.asarray(v) for k, v in x.items()})
    got = t_conv.convert_mtot_mni({k: torch.from_numpy(v)
                                   for k, v in x.items()})
    for k in ("mni", "mtot", "mrp", "mni_c", "mrp_c"):
        _check(got[k].numpy(), want[k])
    samples = _rng_inputs(7, dict(chirp_mass=(1.18, 1.21),
                                  mass_ratio=(0.6, 1.0),
                                  luminosity_distance=(10.0, 100.0)))
    want = j_conv.reweight_to_flat_mass_prior(samples, frac=0.3, rng=4)
    got = t_conv.reweight_to_flat_mass_prior(samples, frac=0.3, rng=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- BASELINE config 5 at a reduced GW width ------------------------------
CONFIG5_INJECTION = {
    "chirp_mass": 1.1977, "mass_ratio": 0.9, "luminosity_distance": 40.0,
    "EOS": 4.2, "ratio_zeta": 0.3, "alpha": 5e-5, "theta_jn": 0.4,
    "phase": 1.3, "psi": 1.5, "ra": 3.446, "dec": -0.408,
    "geocent_time": 0.0, "timeshift": 0.0}
CONFIG5_PRIOR = (
    "chirp_mass = Uniform(minimum=1.18, maximum=1.21)\n"
    "mass_ratio = Uniform(minimum=0.6, maximum=1.0)\n"
    "luminosity_distance = Uniform(minimum=10., maximum=100.)\n"
    "EOS = Uniform(minimum=0., maximum=10.)\n"
    "ratio_zeta = Uniform(minimum=0., maximum=0.5)\n"
    "alpha = 5e-5\ntheta_jn = 0.4\nphase = 1.3\n"
    "psi = 1.5\nra = 3.446\ndec = -0.408\ngeocent_time = 0.0\n"
    "timeshift = 0.0\n")
TRIGGER = 1187008882.4


def config5_args(root, eos_dir, waveform="IMRPhenomD_NRTidalv2"):
    """nmma-generation flags of scripts/bench_joint_pe.py:47-52 with the
    GW width cut to H1 + L1, 8 s, 20-512 Hz."""
    from nmma_tpu_torch.injections import write_injection_file
    prior = root / "config5.prior"
    prior.write_text(CONFIG5_PRIOR)
    injection = root / "config5.json"
    write_injection_file(injection, {k: [v] for k, v in
                                     CONFIG5_INJECTION.items()})
    return ["--prior-file", str(prior), "--injection-file", str(injection),
            "--eos-data", str(eos_dir), "--duration", "8",
            "--minimum-frequency", "20", "--maximum-frequency", "512",
            "--gw-detectors", "H1,L1", "--trigger-time", repr(TRIGGER),
            "--waveform", waveform, "--em-model", "Bu2019lm_sparse",
            "--svd-path", "artifacts/Bu2019lm_sparse_svd.npz"]


def port_dump_on_jax_data(t_dump, j_dump):
    """The port's dump with the JAX package's GW strain and photometry:
    the JAX package's zero-noise injection rounds GMST one f32 ulp off its
    likelihood's (tests/test_torch_joint_cli.py), and its surrogate mags
    differ from K1's within 1e-4, so both likelihoods see the same data."""
    from nmma_tpu_torch.gw import InterferometerData
    ifos = [InterferometerData(i.name, i.frequencies, i.strain, i.psd,
                               i.duration) for i in j_dump["ifos"]]
    return {**t_dump, "ifos": ifos, "em_data": j_dump["em_data"]}


def joint_gate(likelihood, params, got, want, data_power):
    """Sentinels identical and |got - want| within the GW gate of the GW
    term plus the EM gate of the EM term (each the port's, on the converted
    parameters); returns the largest share of the gate used."""
    bad = want <= -1e29
    np.testing.assert_array_equal(got <= -1e29, bad)
    with torch.no_grad():
        conv = likelihood.conversion(params)
        gw = likelihood.likelihoods[0](conv).numpy()
        em = sum(lk(conv) for lk in likelihood.likelihoods[1:])
    em = np.broadcast_to(np.asarray(em), got.shape)
    allowed = (1e-2 + 1e-4 * np.abs(gw) + PHASE_ULP * data_power) \
        + (1e-2 + 1e-4 * np.abs(em))
    share = (np.abs(got - want) / allowed)[~bad]
    assert share.max() <= 1.0, (share.max(), np.abs(got - want)[~bad].max())
    return share.max()


def data_power(ifos, point):
    from nmma_tpu_torch.gw import GWTransientLikelihood, get_waveform
    dense = GWTransientLikelihood(
        ifos, waveform=get_waveform("IMRPhenomD_NRTidalv2"),
        trigger_time=TRIGGER, device="cpu")
    batch = {k: torch.tensor([v]) for k, v in point.items()}
    return float(dense.optimal_snr(batch)[0]) ** 2


@pytest.fixture(scope="module")
def config5(tmp_path_factory):
    from nmma_tpu.cli import joint_main as j_cli
    from nmma_tpu_torch.cli import joint_main as t_cli
    root = tmp_path_factory.mktemp("config5")
    write_macro_set(root / "eos")
    args = config5_args(root, root / "eos")
    j_path = j_cli.nmma_generation(args + ["--outdir", str(root / "jax"),
                                           "--label", "c5"])
    t_path = t_cli.nmma_generation(args + ["--outdir", str(root / "port"),
                                           "--label", "c5"], device="cpu")
    dumps = []
    for path in (j_path, t_path):
        with open(path, "rb") as f:
            dumps.append(pickle.load(f))
    metas = [json.loads((root / side / "c5_generation_meta.json")
                        .read_text()) for side in ("jax", "port")]
    return root, dumps, metas


def test_config5_generation_matches_jax(config5):
    _, (j_dump, t_dump), (j_meta, t_meta) = config5
    for k, v in j_dump["fiducial"].items():
        np.testing.assert_allclose(t_dump["fiducial"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert sorted(t_dump["em_data"]) == sorted(j_dump["em_data"]) == \
        ["ztfg", "ztfr"]
    for f, obs in j_dump["em_data"].items():
        np.testing.assert_array_equal(t_dump["em_data"][f]["time"],
                                      obs["time"])
        np.testing.assert_allclose(t_dump["em_data"][f]["mag"], obs["mag"],
                                   rtol=0, atol=1e-4)
    assert t_dump["eos_data"] == j_dump["eos_data"]
    assert np.isfinite(t_meta["test_logl"])
    assert set(t_meta["timings_s"]) >= {"eos", "em_data", "total"}


def test_config5_joint_logl_matches_jax(config5):
    """B = 64 prior draws through both packages' build_joint_likelihood on
    the same dump: the GW + EM gate, identical sentinels, one K1 call."""
    from nmma_tpu.cli import joint_main as j_cli
    from nmma_tpu_torch.cli import joint_main as t_cli
    from nmma_tpu_torch.ops import svd_kernel

    _, (j_dump, t_dump), _ = config5
    j_lk, j_priors = j_cli.build_joint_likelihood(j_dump)
    t_lk, t_priors = t_cli.build_joint_likelihood(
        port_dump_on_jax_data(t_dump, j_dump), device="cpu")
    assert t_priors.sampled_names == j_priors.sampled_names
    u = np.random.default_rng(21).uniform(0, 1, (N, t_priors.ndim)).astype(
        np.float32)
    # the parameters enter the JAX graph as arguments: with the prior's
    # fixed geocent_time folded into it, XLA rounds GMST one f32 ulp off
    # the graph the port follows (ROADMAP.md section 3), ~0.3% of <h,h>
    j_params = jax.vmap(j_priors.transform)(jnp.asarray(u))
    want = np.asarray(jax.jit(jax.vmap(j_lk.log_likelihood))(j_params))
    calls = []
    kernel = svd_kernel.svd_surrogate_mags

    def counted(*args):
        calls.append(args[0].shape)
        return kernel(*args)

    svd_kernel.svd_surrogate_mags = counted
    try:
        params = t_priors.transform(torch.from_numpy(u))
        got = t_lk(params).numpy()
    finally:
        svd_kernel.svd_surrogate_mags = kernel
    assert calls == [(N, 2)]               # K1 once, on the batch
    assert (want > -1e29).sum() > N // 2
    point = dict(t_dump["fiducial"])
    share = joint_gate(t_lk, params, got, want,
                       data_power(port_dump_on_jax_data(t_dump, j_dump)
                                  ["ifos"], point))
    print(f"config 5 joint logL: gate share {share:.4f}")


def test_injection_creator_matches_jax(tmp_path, monkeypatch):
    """Both packages' InjectionCreator with finite_ejecta_test on the same
    unit-cube draws: a chirp-mass range reaching past MTOV makes NSBH and
    BBH draws, which the test rejects and the creators redraw."""
    from nmma_tpu import injections as j_inj
    from nmma_tpu.eos import load_macro_eos_set as j_load
    from nmma_tpu.priors import parse_prior_dict as j_parse
    from nmma_tpu_torch import injections as t_inj
    from nmma_tpu_torch.eos import load_macro_eos_set as t_load
    from nmma_tpu_torch.priors import parse_prior_dict as t_parse

    write_macro_set(tmp_path / "eos")
    prior = CONFIG5_PRIOR.replace("minimum=1.18, maximum=1.21",
                                  "minimum=1.2, maximum=2.6")
    j_pri, t_pri = j_parse(prior), t_parse(prior)
    j_chain = j_conv.MultimessengerConversion(
        j_conv.cosmology_to_distance, j_conv.bns_source_frame,
        j_load(str(tmp_path / "eos")), j_conv.KilonovaEjectaFitting())
    t_chain = t_conv.MultimessengerConversion(
        t_conv.cosmology_to_distance, t_conv.bns_source_frame,
        t_load(str(tmp_path / "eos")), t_conv.KilonovaEjectaFitting())

    def stream():
        rng = np.random.default_rng(30)
        return lambda n: rng.uniform(0, 1, (n, t_pri.ndim)).astype(
            np.float32)

    j_next, t_next = stream(), stream()
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(j_next(shape[0])))
    # the JAX chain is written for one sample, and the JAX creator's
    # redraws write into its arrays, which must not be read-only views of
    # device arrays (ROADMAP.md section 3): it gets the vmap, as copies
    j_creator = j_inj.InjectionCreator(
        j_pri, lambda p: {k: np.array(v) for k, v in
                          jax.vmap(j_chain)(p).items()},
        tests=[j_inj.finite_ejecta_test])
    t_creator = t_inj.InjectionCreator(t_pri, t_chain,
                                       tests=[t_inj.finite_ejecta_test],
                                       device="cpu")
    t_creator._units = lambda n: torch.from_numpy(t_next(n))
    first = t_creator._draw(32)
    assert not t_inj.finite_ejecta_test(first).all()   # some redraws
    t_next = stream()
    t_creator._units = lambda n: torch.from_numpy(t_next(n))
    want = j_creator.generate(32)
    got = t_creator.generate(32)
    assert t_inj.finite_ejecta_test(got).all()
    for k in ("chirp_mass", "mass_ratio", "EOS", "log10_mej_dyn",
              "log10_mej_wind", "radius_1", "TOV_mass"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    seeded = t_inj.InjectionCreator(t_pri, t_chain, seed=3, device="cpu")
    again = t_inj.InjectionCreator(t_pri, t_chain, seed=3, device="cpu")
    np.testing.assert_array_equal(seeded.generate(4)["EOS"],
                                  again.generate(4)["EOS"])


def test_snr_test_matches_jax():
    """snr_test on the same draws: the port's batched optimal SNR against
    the JAX package's loop of single evaluations, thresholds between the
    draws' SNRs. The SNRs agree within rtol 3e-3: the JAX package runs each
    draw eagerly, and its eager GMST rounds one f32 ulp off the jitted
    graph's that the port follows (ROADMAP.md section 3), 0.15% of the
    antenna response here."""
    import nmma_tpu.gw as j_gw
    import nmma_tpu_torch.gw as t_gw
    from nmma_tpu import injections as j_inj
    from nmma_tpu_torch import injections as t_inj

    inj = dict(mass_1=1.48, mass_2=1.26, lambda_1=300.0, lambda_2=500.0,
               luminosity_distance=40.0, theta_jn=0.4, phase=1.3,
               ra=3.446, dec=-0.408, psi=1.5, geocent_time=0.0)
    j_ifos = [j_gw.InterferometerData.zero_noise_injection(
        n, inj, duration=8.0, f_min=20.0, f_max=256.0, trigger_time=TRIGGER,
        waveform=j_gw.get_waveform("TaylorF2")) for n in ("H1", "L1")]
    t_ifos = [t_gw.InterferometerData(i.name, i.frequencies, i.strain,
                                      i.psd, i.duration) for i in j_ifos]
    j_lk = j_gw.GWTransientLikelihood(
        j_ifos, waveform=j_gw.get_waveform("TaylorF2"), trigger_time=TRIGGER)
    t_lk = t_gw.GWTransientLikelihood(
        t_ifos, waveform=t_gw.get_waveform("TaylorF2"), trigger_time=TRIGGER,
        device="cpu")
    params = {k: np.full(5, v, np.float32) for k, v in inj.items()}
    params["luminosity_distance"] = np.array([20.0, 60.0, 120.0, 250.0,
                                              500.0], np.float32)
    snr = t_lk.optimal_snr({k: torch.from_numpy(v)
                            for k, v in params.items()}).numpy()
    want_snr = [float(j_lk.optimal_snr({k: float(v[i])
                                        for k, v in params.items()}))
                for i in range(5)]
    np.testing.assert_allclose(snr, want_snr, rtol=3e-3)
    for threshold in (0.5 * (snr[1] + snr[2]), 0.5 * (snr[3] + snr[4])):
        got = t_inj.snr_test(t_lk, threshold)(params)
        want = j_inj.snr_test(j_lk, threshold)(params)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < 5
