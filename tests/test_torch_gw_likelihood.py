"""The port's GW likelihoods against the JAX package on the CPU.

Both packages get the same interferometer data (the JAX package's
zero-noise injection, H1 + L1, 8 s, 20-512 Hz, SNR ~89, handed to the
port's ``InterferometerData`` as numpy arrays) and the same seeded numpy
parameters; the JAX side is ``jax.jit(jax.vmap(...))``.

The logL gate is |dlogL| <= 1e-2 + 1e-4 |logL| + 2^-10 <d,d>, with
identical -1e30 sentinels. logL = <d,h> - <h,h>/2 is a difference of inner
products of size <d,d> = SNR^2 (~8350 here), and the BNS phase at 20 Hz is
~1e4 rad, where one f32 ulp is 2^-10 rad: the two packages round their
phases differently there (different libm pow, no FMA contraction in
PyTorch's CPU kernels), and to first order off the peak logL moves by
<d,d> times the phase difference. Observed: up to 2.6 near the peak, where
the JAX package's own f32 logL reads up to 27 off its f64 evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.gw as j_gw
import nmma_tpu_torch.gw as t_gw
from nmma_tpu.gw.multibanding import MBGWLikelihood as JMB
from nmma_tpu.gw.roq import ROQBasis as JBasis
from nmma_tpu.gw.roq import ROQGWLikelihood as JROQ
from nmma_tpu.gw.strain import calibration_draws_from_envelope
from nmma_tpu.joint import MultiMessengerLikelihood as JMM
from nmma_tpu_torch.gw.multibanding import MBGWLikelihood as TMB
from nmma_tpu_torch.gw.roq import ROQBasis as TBasis
from nmma_tpu_torch.gw.roq import ROQGWLikelihood as TROQ
from nmma_tpu_torch.gw.roq import build_roq_bases
from nmma_tpu_torch.joint import MultiMessengerLikelihood as TMM

INJ = dict(mass_1=1.48, mass_2=1.26, lambda_1=300.0, lambda_2=500.0,
           luminosity_distance=40.0, theta_jn=0.4, phase=1.3,
           ra=3.446, dec=-0.408, psi=1.5, geocent_time=0.0)
TRIGGER = 1187008882.4
LOGL_RTOL, LOGL_ATOL = 1e-4, 1e-2
PHASE_ULP = 2.0**-10          # rad, an f32 ulp of a phase in [8192, 16384)


def port_ifos(jax_ifos):
    return [t_gw.InterferometerData(i.name, i.frequencies, i.strain, i.psd,
                                    i.duration) for i in jax_ifos]


@pytest.fixture(scope="module")
def data():
    j_ifos = [j_gw.InterferometerData.zero_noise_injection(
        n, INJ, duration=8.0, f_min=20.0, f_max=512.0, trigger_time=TRIGGER)
        for n in ("H1", "L1")]
    dense = j_gw.GWTransientLikelihood(j_ifos, trigger_time=TRIGGER)
    d_power = float(jax.jit(dense.optimal_snr)(INJ)) ** 2
    return j_ifos, port_ifos(j_ifos), d_power


def points(n_prior=16, n_near=16, seed=1):
    """Prior draws and draws near the injection, as numpy columns."""
    rng = np.random.default_rng(seed)
    prior = dict(
        mass_1=rng.uniform(1.44, 1.52, n_prior),
        mass_2=rng.uniform(1.2, 1.3, n_prior),
        lambda_1=rng.uniform(0, 2000, n_prior),
        lambda_2=rng.uniform(0, 2000, n_prior),
        luminosity_distance=rng.uniform(10, 100, n_prior),
        theta_jn=rng.uniform(0, np.pi, n_prior),
        phase=rng.uniform(0, 2 * np.pi, n_prior),
        ra=rng.uniform(0, 2 * np.pi, n_prior),
        dec=rng.uniform(-1.5, 1.5, n_prior),
        psi=rng.uniform(0, np.pi, n_prior),
        geocent_time=rng.uniform(-0.1, 0.1, n_prior))
    near = {k: np.full(n_near, v) for k, v in INJ.items()}
    near["mass_1"] = near["mass_1"] + rng.normal(0, 2e-4, n_near)
    near["mass_2"] = near["mass_2"] + rng.normal(0, 2e-4, n_near)
    near["luminosity_distance"] += rng.normal(0, 5, n_near)
    near["theta_jn"] += rng.normal(0, 0.2, n_near)
    near["phase"] += rng.normal(0, 0.3, n_near)
    near["ra"] += rng.normal(0, 0.05, n_near)
    near["dec"] += rng.normal(0, 0.05, n_near)
    near["psi"] += rng.normal(0, 0.2, n_near)
    near["geocent_time"] += rng.normal(0, 2e-4, n_near)
    near["lambda_1"] = rng.uniform(0, 2000, n_near)
    return {k: np.concatenate([[INJ[k]], prior[k], near[k]]) for k in INJ}


def compare(j_lk, t_lk, p, d_power):
    want = np.asarray(jax.jit(jax.vmap(j_lk.log_likelihood_ratio))(
        {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}))
    got = t_lk.log_likelihood_ratio(
        {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in p.items()}).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    allowed = LOGL_ATOL + LOGL_RTOL * np.abs(want) + PHASE_ULP * d_power
    print(f"max |dlogL| {d.max():.4e}, gate share {np.max(d / allowed):.3f}")
    assert np.all(d <= allowed), (d.max(), want[np.argmax(d / allowed)])
    return got, want


DENSE = {
    "plain": {},
    "phase": dict(phase_marginalization=True),
    "distance": dict(distance_marginalization=True),
    "distance_phase": dict(distance_marginalization=True,
                           phase_marginalization=True),
    "time_phase": dict(time_marginalization=True,
                       phase_marginalization=True),
    "time_distance_phase": dict(time_marginalization=True,
                                distance_marginalization=True,
                                phase_marginalization=True),
}


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_likelihood_matches_jax(data, case):
    j_ifos, t_ifos, d_power = data
    kw = DENSE[case]
    compare(j_gw.GWTransientLikelihood(j_ifos, trigger_time=TRIGGER, **kw),
            t_gw.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                       device="cpu", **kw),
            points(), d_power)


def test_dense_chunks_give_the_unchunked_values(data, monkeypatch):
    """A batch in chunks of 5 live points reads what one chunk does, to the
    rounding of the FFT's batched plans (2e-6 of <d,d>; reads 6e-7)."""
    import nmma_tpu_torch.gw.likelihood as t_lk
    _, t_ifos, d_power = data
    p = {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in points().items()}
    whole = t_lk.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                       time_marginalization=True,
                                       device="cpu")
    monkeypatch.setattr(t_lk, "DENSE_CHUNK_BYTES", 5 * 8 * 16384)
    chunked = t_lk.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                         time_marginalization=True,
                                         device="cpu")
    assert chunked.chunk_rows == 5 and chunked.n_chunks(33) == 7
    assert whole.n_chunks(33) == 1
    torch.testing.assert_close(chunked(p), whole(p), rtol=0,
                               atol=2e-6 * d_power)


@pytest.mark.parametrize("distance", [False, True])
def test_calibration_marginalization_matches_jax(data, distance):
    j_ifos, t_ifos, d_power = data
    freqs = j_ifos[0].frequencies
    env = np.column_stack([np.geomspace(10, 2048, 20), np.ones(20),
                           np.zeros(20), 0.95 * np.ones(20),
                           -0.05 * np.ones(20), 1.05 * np.ones(20),
                           0.05 * np.ones(20)])
    draws = {"H1": calibration_draws_from_envelope(env, freqs, n_draws=6,
                                                   seed=3)}
    kw = dict(calibration_draws=draws, phase_marginalization=True,
              distance_marginalization=distance)
    compare(j_gw.GWTransientLikelihood(j_ifos, trigger_time=TRIGGER, **kw),
            t_gw.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                       device="cpu", **kw),
            points(8, 8), d_power)


def test_optimal_snr_and_zero_noise_injection(data):
    j_ifos, t_ifos, d_power = data
    p = {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in points(4, 4).items()}
    dense = t_gw.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                       device="cpu")
    j_dense = j_gw.GWTransientLikelihood(j_ifos, trigger_time=TRIGGER)
    want = np.asarray(jax.jit(jax.vmap(j_dense.optimal_snr))(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}))
    np.testing.assert_allclose(dense.optimal_snr(p).numpy(), want,
                               rtol=1e-4)
    # the port's own injection: logL at the injection is SNR^2/2 (its
    # injection and its likelihood share their arithmetic); the strain
    # against the JAX package's within the f32 phase rounding and the GMST
    # the JAX package folds into its injection's graph (4.1e-3 rad)
    own = [t_gw.InterferometerData.zero_noise_injection(
        n, INJ, duration=8.0, f_min=20.0, f_max=512.0, trigger_time=TRIGGER,
        device="cpu") for n in ("H1", "L1")]
    for a, b in zip(own, j_ifos):
        np.testing.assert_array_equal(a.frequencies, b.frequencies)
        np.testing.assert_array_equal(a.psd, b.psd)
        assert np.max(np.abs(a.strain - b.strain)) / \
            np.max(np.abs(b.strain)) < 1e-2
    lk = t_gw.GWTransientLikelihood(own, trigger_time=TRIGGER, device="cpu")
    inj = {k: torch.tensor([v]) for k, v in INJ.items()}
    snr = float(lk.optimal_snr(inj)[0])
    np.testing.assert_allclose(float(lk(inj)[0]), snr**2 / 2, rtol=1e-5)


@pytest.mark.parametrize("waveform", ["TaylorF2", "IMRPhenomD_NRTidalv2"])
def test_relative_binning_matches_jax(data, waveform):
    j_ifos, t_ifos, d_power = data
    j_rb = j_gw.RelativeBinningGWLikelihood(
        j_ifos, INJ, waveform=j_gw.get_waveform(waveform),
        trigger_time=TRIGGER, eps=0.1)
    t_rb = t_gw.RelativeBinningGWLikelihood(
        t_ifos, INJ, waveform=t_gw.get_waveform(waveform),
        trigger_time=TRIGGER, eps=0.1, device="cpu")
    assert t_rb.n_bins == [len(np.asarray(s["edges"])) - 1
                           for s in j_rb._summary]
    compare(j_rb, t_rb, points(), d_power)


def test_relative_binning_phase_marginalized_matches_jax(data):
    j_ifos, t_ifos, d_power = data
    compare(j_gw.RelativeBinningGWLikelihood(
                j_ifos, INJ, trigger_time=TRIGGER,
                phase_marginalization=True),
            t_gw.RelativeBinningGWLikelihood(
                t_ifos, INJ, trigger_time=TRIGGER,
                phase_marginalization=True, device="cpu"),
            points(), d_power)


ROQ_INJ = {**INJ, "luminosity_distance": 400.0}
ROQ_PRIOR = (
    "mass_1 = Uniform(minimum=1.4795, maximum=1.4805)\n"
    "mass_2 = Uniform(minimum=1.2595, maximum=1.2605)\n"
    "lambda_1 = Uniform(minimum=0., maximum=1000.)\n"
    "lambda_2 = Uniform(minimum=0., maximum=1000.)\n"
    "luminosity_distance = Uniform(minimum=250., maximum=650.)\n"
    "theta_jn = 0.4\nphase = 1.3\nra = 3.446\ndec = -0.408\npsi = 1.5\n"
    "geocent_time = 0.0\n")


@pytest.fixture(scope="module")
def roq_data():
    """tests/test_roq.py's configuration (16 s, 30-256 Hz, SNR ~10)."""
    j_ifos = [j_gw.InterferometerData.zero_noise_injection(
        n, ROQ_INJ, duration=16.0, f_min=30.0, f_max=256.0,
        trigger_time=TRIGGER) for n in ("H1", "L1")]
    return j_ifos, port_ifos(j_ifos)


def roq_points():
    rng = np.random.default_rng(1)
    rows = [ROQ_INJ] + [
        {**ROQ_INJ, "mass_1": rng.uniform(1.4795, 1.4805),
         "mass_2": rng.uniform(1.2595, 1.2605),
         "lambda_1": rng.uniform(0, 900),
         "luminosity_distance": rng.uniform(280, 600)} for _ in range(6)]
    return {k: np.array([r[k] for r in rows]) for k in ROQ_INJ}


def test_roq_on_a_shared_basis_matches_jax(roq_data, tmp_path):
    """Both packages on one basis, built and saved by the JAX package."""
    from nmma_tpu.gw.roq import build_roq_bases as j_build
    from nmma_tpu.priors import parse_prior_dict
    j_ifos, t_ifos = roq_data
    bases = j_build(j_ifos, j_gw.taylorf2_tidal, parse_prior_dict(ROQ_PRIOR),
                    TRIGGER, n_training=256, tol=1e-5, seed=0)
    loaded = {}
    for name, basis in bases.items():
        path = str(tmp_path / f"{name}.npz")
        basis.save(path)
        loaded[name] = TBasis.load(path)
        np.testing.assert_array_equal(loaded[name].lin_nodes,
                                      basis.lin_nodes)
        np.testing.assert_array_equal(loaded[name].quad_basis,
                                      basis.quad_basis)
    d_power = float(jax.jit(j_gw.GWTransientLikelihood(
        j_ifos, trigger_time=TRIGGER).optimal_snr)(ROQ_INJ)) ** 2
    for phase in (False, True):
        compare(JROQ(j_ifos, bases, trigger_time=TRIGGER,
                     phase_marginalization=phase),
                TROQ(t_ifos, loaded, trigger_time=TRIGGER,
                     phase_marginalization=phase, device="cpu"),
                roq_points(), d_power)
    # and the JAX package reads the port's save
    path = str(tmp_path / "port.npz")
    loaded["H1"].save(path)
    again = JBasis.load(path)
    np.testing.assert_array_equal(again.lin_a, bases["H1"].lin_a)


def test_roq_basis_built_by_the_port(roq_data):
    """The port's own basis (its own draws) against the dense likelihood,
    by tests/test_roq.py:54-68's gate."""
    from nmma_tpu_torch.priors import parse_prior_dict
    _, t_ifos = roq_data
    bases = build_roq_bases(t_ifos, t_gw.taylorf2_tidal,
                            parse_prior_dict(ROQ_PRIOR), TRIGGER,
                            n_training=512, tol=1e-5, seed=0, device="cpu")
    n_freq = len(t_ifos[0].frequencies)
    assert all(b.n_lin < n_freq / 20 for b in bases.values())
    roq = TROQ(t_ifos, bases, trigger_time=TRIGGER, device="cpu")
    full = t_gw.GWTransientLikelihood(t_ifos, trigger_time=TRIGGER,
                                      device="cpu")
    p = {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in roq_points().items()}
    a, b = full(p).numpy(), roq(p).numpy()
    assert np.all(np.abs(a - b) < 1.5 + 1e-2 * np.abs(a)), (a, b)


MB_INJ = dict(mass_1=1.45, mass_2=1.35, lambda_1=300.0, lambda_2=450.0,
              luminosity_distance=120.0, theta_jn=0.6, phase=1.0,
              ra=1.2, dec=-0.3, psi=0.7, geocent_time=0.0)


def test_multibanding_matches_jax():
    """tests/test_multibanding.py's injection on 32 s, 25-512 Hz."""
    j_ifos = [j_gw.InterferometerData.zero_noise_injection(
        n, MB_INJ, duration=32.0, f_min=25.0, f_max=512.0,
        trigger_time=TRIGGER) for n in ("H1", "L1")]
    t_ifos = port_ifos(j_ifos)
    d_power = float(jax.jit(j_gw.GWTransientLikelihood(
        j_ifos, trigger_time=TRIGGER).optimal_snr)(MB_INJ)) ** 2
    rng = np.random.default_rng(0)
    rows = [MB_INJ] + [{**MB_INJ,
                        "mass_1": MB_INJ["mass_1"] + rng.uniform(-5e-3, 5e-3),
                        "mass_2": MB_INJ["mass_2"] + rng.uniform(-5e-3, 5e-3),
                        "luminosity_distance": 120 * rng.uniform(0.8, 1.3),
                        "lambda_1": rng.uniform(100, 600)}
                       for _ in range(10)]
    p = {k: np.array([r[k] for r in rows]) for k in MB_INJ}
    for phase in (False, True):
        j_mb = JMB(j_ifos, chirp_mass_min=1.15, trigger_time=TRIGGER,
                   phase_marginalization=phase)
        t_mb = TMB(t_ifos, chirp_mass_min=1.15, trigger_time=TRIGGER,
                   phase_marginalization=phase, device="cpu")
        assert t_mb.n_kept == j_mb.n_kept
        compare(j_mb, t_mb, p, d_power)


def test_multimessenger_sentinels_match_jax():
    """Non-finite totals become -1e30 and finite ones are floored there,
    in both packages; a non-finite sanity key gives the sentinel."""
    vals = np.array([np.nan, np.inf, -np.inf, 5.0, -2e30, 1e3],
                    dtype=np.float32)
    key = np.array([1.0, 1.0, 1.0, np.nan, 1.0, 1.0], dtype=np.float32)
    j_mm = JMM(None, [lambda p: p["v"]], sanity_keys=("k",))
    t_mm = TMM(None, [lambda p: p["v"]], sanity_keys=("k",))
    want = np.asarray(j_mm.log_likelihood({"v": jnp.asarray(vals),
                                           "k": jnp.asarray(key)}))
    got = t_mm.log_likelihood({"v": torch.as_tensor(vals),
                               "k": torch.as_tensor(key)}).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == -1e30 and got[5] == 1e3
