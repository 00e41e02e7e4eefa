"""The port's GW waveforms and detectors against the JAX package on the CPU.

The same seeded numpy parameters go through ``jax.vmap`` of the JAX
function and the port's batch-first counterpart. Tolerances:

* amplitudes: relative 1e-4 where the amplitude exceeds 1e-6 of its
  maximum: f32 libm ulps read ~1.4e-6, and PhenomD's intermediate
  amplitude, one f32 5x5 solve a sample with a condition number ~1e6,
  reads 1.1e-5 between the two packages' LAPACK solves;
* complex strain: max|h_port - h_jax| / max|h_jax| <= 2e-2. At 20 Hz a BNS
  phase is ~1e4 rad, where an f32 ulp is 1e-3 rad and one ulp of
  (pi M f)^(1/3) moves it by ~4e-3 rad (reads <= 7.2e-3);
* per-sample PhenomD quantities, the NRTidal pieces and the remnant fits:
  relative 1e-5; the hand-written derivatives against ``jax.grad``:
  1e-4 of the larger of the derivative and the function's value over the
  frequency (the amplitude's slope at its peak is ~0 by cancellation);
* antenna patterns 1e-5 absolute, time delays 1e-8 s (f32 ulps of ~0.02 s
  read 3.7e-9 s; 6e-5 rad at 1 kHz), GMST bit for bit
  with the JAX package's jitted graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.gw.detectors as j_det
import nmma_tpu.gw.phenomd as j_pd
import nmma_tpu.gw.waveforms as j_wf
import nmma_tpu_torch.gw.detectors as t_det
import nmma_tpu_torch.gw.phenomd as t_pd
import nmma_tpu_torch.gw.waveforms as t_wf

TRIGGER = 1187008882.4
AMP_RTOL = 1e-4
STRAIN_TOL = 2e-2
PIECE_RTOL = 1e-5
GRAD_RTOL = 1e-4
FREQS = np.arange(20.0 * 8, 512.0 * 8 + 1) / 8.0     # 8 s, 20-512 Hz


def draw(rng, n, bbh=False):
    if bbh:
        m1, m2 = rng.uniform(30.0, 42.0, n), rng.uniform(20.0, 30.0, n)
        lam = np.zeros(n)
    else:
        m1, m2 = rng.uniform(1.3, 1.7, n), rng.uniform(1.1, 1.3, n)
        lam = rng.uniform(0.0, 3000.0, n)
    return dict(mass_1=m1, mass_2=m2, lambda_1=lam,
                lambda_2=lam[::-1].copy(), chi_1=rng.uniform(-0.05, 0.05, n),
                chi_2=rng.uniform(-0.05, 0.05, n),
                luminosity_distance=rng.uniform(10.0, 100.0, n),
                theta_jn=rng.uniform(0.0, 3.0, n), phase=rng.uniform(0, 6, n))


def j_batch(p):
    return {k: jnp.asarray(v, dtype=jnp.float32) for k, v in p.items()}


def t_batch(p):
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}


def assert_strain_close(got, want):
    amp_w, amp_g = np.abs(want), np.abs(got)
    keep = amp_w > 1e-6 * amp_w.max()
    amp = np.max(np.abs(amp_g - amp_w)[keep] / amp_w[keep])
    strain = np.max(np.abs(got - want)) / np.max(amp_w)
    print(f"amplitude rel {amp:.3e}, strain rel {strain:.3e}")
    assert amp <= AMP_RTOL and strain <= STRAIN_TOL, (amp, strain)


CASES = {
    "TaylorF2": (j_wf.taylorf2_tidal, t_wf.taylorf2_tidal, False),
    "IMRPhenomD_bbh": (j_pd.imrphenomd, t_pd.imrphenomd, True),
    "IMRPhenomD_bns": (j_pd.imrphenomd, t_pd.imrphenomd, False),
    "IMRPhenomD_NRTidalv2": (j_pd.imrphenomd_nrtidalv2,
                             t_pd.imrphenomd_nrtidalv2, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_waveform_matches_jax(case):
    j_fn, t_fn, bbh = CASES[case]
    p = draw(np.random.default_rng(3), 12, bbh)
    want = jax.jit(jax.vmap(lambda q: j_fn(FREQS, q)))(j_batch(p))
    got = t_fn(torch.as_tensor(FREQS), t_batch(p))
    for w, g in zip(want, got):
        assert g.shape == (12, FREQS.size) and g.dtype == torch.complex64
        assert_strain_close(g.numpy(), np.asarray(w))


def _j_pieces(*cols):
    out = dict(j_pd._phenomd_pieces(*cols))
    out["phi_pn"] = {str(k): v for k, v in out["phi_pn"].items()}
    return out


def pieces_pair(p):
    """The per-sample PhenomD quantities of both packages; the JAX side's
    phi_pn keys as strings (vmap sorts them)."""
    cols = [p[k] for k in ("mass_1", "mass_2", "chi_1", "chi_2")]
    jp = jax.vmap(_j_pieces)(*[jnp.asarray(c, jnp.float32) for c in cols])
    tp = t_pd._phenomd_pieces(
        *[torch.as_tensor(c, dtype=torch.float32).reshape(-1, 1)
          for c in cols])
    return jp, tp


def close(got, want, rtol=PIECE_RTOL):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("bbh", [False, True])
def test_phenomd_pieces_match_jax(bbh):
    jp, tp = pieces_pair(draw(np.random.default_rng(5), 16, bbh))
    for key in ("eta", "seta", "f_rd", "f_damp", "v2c"):
        close(tp[key], jp[key])
    for key in ("sig", "bet", "alp", "rho", "gam", "pn_pref"):
        for a, b in zip(tp[key], jp[key]):
            close(a, b)
    for k, v in tp["phi_pn"].items():
        close(v * torch.ones(16, 1), jp["phi_pn"][str(k)] * jnp.ones(16))


def test_remnant_fits_match_jax():
    rng = np.random.default_rng(6)
    eta = rng.uniform(0.05, 0.25, 32).astype(np.float32)
    chi1 = rng.uniform(-0.9, 0.9, 32).astype(np.float32)
    chi2 = rng.uniform(-0.9, 0.9, 32).astype(np.float32)
    t = [torch.as_tensor(x) for x in (eta, chi1, chi2)]
    close(t_pd.final_spin(*t), j_pd.final_spin(eta, chi1, chi2))
    close(t_pd.radiated_energy(*t), j_pd.radiated_energy(eta, chi1, chi2))
    af = rng.uniform(-0.5, 0.99, 32).astype(np.float32)
    for a, b in zip(t_pd.qnm_ringdown(torch.as_tensor(af)),
                    j_pd.qnm_ringdown(af)):
        close(a, b)


def test_derivatives_match_jax_grad():
    """The C1 joins, the amplitude slopes and the alignment slope: the
    hand-written derivatives against jax.grad of the JAX closed forms."""
    p = draw(np.random.default_rng(7), 8, True)
    jp, tp = pieces_pair(p)
    for i in range(8):
        pick = {k: v for k, v in jax.tree_util.tree_map(
            lambda x: x[i], {k: v for k, v in jp.items()
                             if k != "phi_pn"}).items()}
        pick["phi_pn"] = {(int(k) if k.isdigit() else k): v[i]
                          for k, v in jp["phi_pn"].items()}
        row = {k: (v[i:i + 1] if isinstance(v, torch.Tensor)
                   else tuple(x[i:i + 1] for x in v))
               for k, v in tp.items() if k != "phi_pn"}
        row["phi_pn"] = {k: (v[i:i + 1] if isinstance(v, torch.Tensor)
                             else v) for k, v in tp["phi_pn"].items()}
        f_rd, f_damp = float(pick["f_rd"]), float(pick["f_damp"])
        f_peak = float(j_pd._amp_peak_frequency(pick["gam"], pick["f_rd"],
                                                pick["f_damp"]))
        cases = [
            (lambda f: j_pd._phi_inspiral(f, pick["eta"], pick["phi_pn"],
                                          pick["sig"]),
             lambda f: t_pd._dphi_inspiral(f, row["eta"], row["phi_pn"],
                                           row["sig"]), 0.018),
            (lambda f: j_pd._phi_intermediate(f, pick["eta"], pick["bet"]),
             lambda f: t_pd._dphi_intermediate(f, row["eta"], row["bet"]),
             0.018),
            (lambda f: j_pd._phi_intermediate(f, pick["eta"], pick["bet"]),
             lambda f: t_pd._dphi_intermediate(f, row["eta"], row["bet"]),
             0.5 * f_rd),
            (lambda f: j_pd._phi_mergerringdown(
                f, pick["eta"], pick["alp"], pick["f_rd"], pick["f_damp"]),
             lambda f: t_pd._dphi_mergerringdown(
                f, row["eta"], row["alp"], row["f_rd"], row["f_damp"]),
             0.5 * f_rd),
            (lambda f: j_pd._phi_mergerringdown(
                f, pick["eta"], pick["alp"], pick["f_rd"], pick["f_damp"]),
             lambda f: t_pd._dphi_mergerringdown(
                f, row["eta"], row["alp"], row["f_rd"], row["f_damp"]),
             f_peak),
            (lambda f: j_pd._amp_inspiral(f, pick["pn_pref"], pick["rho"]),
             lambda f: t_pd._damp_inspiral(f, row["pn_pref"], row["rho"]),
             0.014),
            (lambda f: j_pd._amp_mergerringdown(f, pick["gam"],
                                                pick["f_rd"],
                                                pick["f_damp"]),
             lambda f: t_pd._damp_mergerringdown(f, row["gam"], row["f_rd"],
                                                 row["f_damp"]), f_peak),
        ]
        for j_fn, t_dfn, f0 in cases:
            want = float(jax.grad(j_fn)(jnp.float32(f0)))
            got = float(t_dfn(torch.tensor([[f0]]))[0, 0])
            # the derivative's natural scale: its value, or the function's
            # value over the frequency where its terms cancel (at f_peak
            # the amplitude's slope is ~0)
            scale = max(abs(want), abs(float(j_fn(jnp.float32(f0)))) / f0)
            assert abs(got - want) <= GRAD_RTOL * scale, (f0, got, want)
        assert f_damp > 0


def test_intermediate_amplitude_and_solve_match_jax():
    """PhenomD's intermediate amplitude, whose quartic comes from one 5x5
    solve a sample (condition number ~1e6), on Mf in [0.014, f_peak)."""
    p = draw(np.random.default_rng(8), 16, True)
    jp, tp = pieces_pair(p)
    f3 = np.asarray(jax.vmap(j_pd._amp_peak_frequency)(
        jp["gam"], jp["f_rd"], jp["f_damp"]))
    mf = np.linspace(0.014, 1.0, 200)[None, :] * f3[:, None]
    mf = np.clip(mf, 0.014, None).astype(np.float32)
    want = jax.vmap(j_pd.phenomd_amplitude_ansatz)(jnp.asarray(mf), jp)
    got = t_pd.phenomd_amplitude_ansatz(torch.as_tensor(mf), tp)
    close(got, want)
    delta, _ = t_pd._amplitude_intermediate_coefficients(tp)
    assert torch.isfinite(delta).all()


def test_nrtidal_pieces_match_jax():
    rng = np.random.default_rng(9)
    p = draw(rng, 16)
    x = rng.uniform(1e-3, 0.2, (16, 50)).astype(np.float32)
    jm = [jnp.asarray(p[k], jnp.float32)[:, None]
          for k in ("mass_1", "mass_2", "lambda_1", "lambda_2")]
    tm = [torch.as_tensor(p[k], dtype=torch.float32)[:, None]
          for k in ("mass_1", "mass_2", "lambda_1", "lambda_2")]
    close(t_pd.nrtidalv2_phase(torch.as_tensor(x), *tm),
          j_pd.nrtidalv2_phase(jnp.asarray(x), *jm))
    close(t_pd.nrtidalv2_amplitude(torch.as_tensor(x), *tm),
          j_pd.nrtidalv2_amplitude(jnp.asarray(x), *jm))
    close(t_pd.nrtidal_merger_frequency(*tm),
          j_pd.nrtidal_merger_frequency(*jm))
    lam = np.concatenate([[0.0], rng.uniform(0, 5000, 31)]).astype(np.float32)
    close(t_pd.yagi_yunes_quadparam(torch.as_tensor(lam)),
          j_pd.yagi_yunes_quadparam(lam))
    f = np.linspace(0.0, 3.0, 301).astype(np.float32)
    close(t_pd.planck_taper(torch.as_tensor(f), 1.0, 2.0),
          j_pd.planck_taper(f, 1.0, 2.0))
    lt, dlt = t_wf.tidal_combinations(*[tm[i] for i in (2, 3, 0, 1)])
    jlt, jdlt = j_wf._tidal_combinations(*[jm[i] for i in (2, 3, 0, 1)])
    close(lt, jlt)
    close(dlt, jdlt)


def test_design_psd_is_the_jax_package():
    np.testing.assert_array_equal(t_wf.aligo_design_psd(FREQS),
                                  j_wf.aligo_design_psd(FREQS))


def test_gmst_is_the_jitted_jax_graph():
    """GMST from f32 GPS seconds equals the JAX package's jitted GMST bit
    for bit (XLA folds its constants and fuses a multiply-add there)."""
    rng = np.random.default_rng(10)
    gps = np.concatenate([
        rng.uniform(1.0e9, 1.4e9, 4000),
        TRIGGER + rng.uniform(-0.1, 0.1, 100)]).astype(np.float32)
    want = np.asarray(jax.jit(j_det.gmst_from_gps)(jnp.asarray(gps)))
    got = t_det.gmst_from_gps(torch.as_tensor(gps)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["H1", "L1", "V1", "K1", "ET2", "CE"])
def test_detectors_match_jax(name):
    """F+, Fx and the geocentre delay at TRIGGER and 200 seeded sky
    points, with the f32 GMST both packages take from the trigger."""
    j, t = j_det.get_detector(name), t_det.get_detector(name)
    np.testing.assert_array_equal(t.vertex, j.vertex)
    np.testing.assert_array_equal(t.response, j.response)
    rng = np.random.default_rng(11)
    ra = rng.uniform(0, 2 * np.pi, 200).astype(np.float32)
    dec = np.arcsin(rng.uniform(-1, 1, 200)).astype(np.float32)
    psi = rng.uniform(0, np.pi, 200).astype(np.float32)
    gt = rng.uniform(-0.1, 0.1, 200).astype(np.float32)

    def jax_side(ra, dec, psi, gt):
        gmst = j_det.gmst_from_gps(TRIGGER + gt)
        fp, fc = j.antenna_pattern(ra, dec, psi, gmst)
        return fp, fc, j.time_delay_from_geocenter(ra, dec, gmst)

    want = jax.jit(jax.vmap(jax_side))(ra, dec, psi, gt)
    tt = [torch.as_tensor(x) for x in (ra, dec, psi, gt)]
    gmst = t_det.gmst_from_gps(TRIGGER + tt[3])
    fp, fc = t.antenna_pattern(tt[0], tt[1], tt[2], gmst)
    delay = t.time_delay_from_geocenter(tt[0], tt[1], gmst)
    np.testing.assert_allclose(fp.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(fc.numpy(), want[1], atol=1e-5)
    np.testing.assert_allclose(delay.numpy(), want[2], atol=1e-8)
    assert np.all(fp.numpy()**2 + fc.numpy()**2 <= 1.0 + 1e-5)
