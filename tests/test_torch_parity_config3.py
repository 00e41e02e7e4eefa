"""BASELINE config 3 (TrPi2018 on an injection) through the port against the
JAX package: its data, its posterior and the JS harness.

- The port's ``create_light_curve_data`` rebuilds config 3's photometry
  (scripts/parity_cross_sampler.py:94-96, seed 10) within 1e-4 mag of the
  JAX package's, with the same non-finite pattern. Both draw the noise
  from ``np.random.default_rng(10)`` in the same order; the JAX side runs
  its fused f32 hat (NMMA_TPU_GRB_CONTRACT=fused), K3's semantics.
- The port's posterior, from scripts/torch_parity_config3.py run on the
  card and committed as tests/data/config3_port_posterior.npz, against
  the JAX package's two reference posteriors (artifacts/
  diag_config3_ns2048.npz and diag_config3_mcmc_long.npz): JS < 0.01 per
  sampled parameter (BASELINE.md:33), and logZ within 5 combined standard
  errors of the ns2048 run's -59.4958 +- 0.0843. The reference runs used
  the JAX default's bf16 hat (~0.003 mag from K3's f32 hat); against the
  0.5 mag error budget that moves no marginal.
- The port's ``posterior_js_divergences`` equals the JAX package's on the
  same samples (the same numpy arithmetic).
"""

import os
import sys

import numpy as np
import pytest

import nmma_tpu.post_processing.parity as j_parity
import nmma_tpu_torch.post_processing.parity as t_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_parity_config3 as config3  # noqa: E402

SAMPLED = ("log10_E0", "thetaCore", "inclination_EM", "log10_n0", "p",
           "log10_epsilon_e", "log10_epsilon_B", "timeshift")


def test_config3_injection_matches_jax(monkeypatch):
    """Both packages with keep_infinite_data: the same non-finite epochs
    and the finite magnitudes within 1e-4 mag; the script's data (which
    drops the non-finite epochs, as both packages do by default) is the
    port's finite subset."""
    import torch

    from nmma_tpu.injections import create_light_curve_data as j_create
    from nmma_tpu_torch.injections import create_light_curve_data as t_create
    torch.set_num_threads(1)
    monkeypatch.setenv("NMMA_TPU_GRB_CONTRACT", "fused")
    kw = dict(tmin=0.1, tmax=30.0, n_tsteps=24, seed=10,
              injection_error_budget=0.2, keep_infinite_data=True)
    want = j_create(config3.TRUTH, "TrPi2018", config3.FILTERS, **kw)
    got = t_create(config3.TRUTH, "TrPi2018", config3.FILTERS, **kw,
                   device="cpu")
    data = config3.config3_data(device="cpu")
    assert sorted(got) == sorted(want) == sorted(data)
    worst = 0.0
    for f in config3.FILTERS:
        g = got[f]
        w = {k: np.asarray(v) for k, v in want[f].items()}
        assert len(g["mag"]) == len(w["mag"]) == 24
        np.testing.assert_allclose(g["time"], w["time"], rtol=1e-6)
        fin = np.isfinite(w["mag"])
        np.testing.assert_array_equal(np.isfinite(g["mag"]), fin)
        np.testing.assert_array_equal(g["mag_error"], w["mag_error"])
        np.testing.assert_allclose(g["mag"][fin], w["mag"][fin], rtol=0,
                                   atol=1e-4)
        worst = max(worst, float(np.abs(g["mag"][fin] - w["mag"][fin]).max()))
        for k in ("time", "mag", "mag_error"):
            np.testing.assert_array_equal(data[f][k], g[k][fin])
    print(f"config 3 injection vs JAX: max |dmag| {worst:.3e}")


@pytest.fixture(scope="module")
def port_posterior():
    with np.load(config3.POSTERIOR_FILE) as f:
        return {k: f[k] for k in f.files}


def test_committed_posterior_passes_the_js_gate(port_posterior):
    post = {k: port_posterior[k] for k in SAMPLED}
    out = config3.compare(post, float(port_posterior["logz"]),
                          float(port_posterior["logz_err"]))
    print({k: v for k, v in out.items() if k != "parameters"})
    assert out["parameters"] == list(SAMPLED)
    for ref in ("js_ns2048", "js_mcmc_long"):
        assert set(out[ref]) == set(SAMPLED)
        assert max(out[ref].values()) < config3.JS_GATE, out[ref]
    assert abs(out["dlogz"]) <= out["dlogz_limit"]
    assert out["ok"]
    assert out["n_samples"] > 5000
    assert all(port_posterior[k].dtype == np.float32 for k in SAMPLED)
    assert "H100" in str(port_posterior["device"])


def test_posterior_js_divergences_match_jax(port_posterior):
    ref = config3.reference_posteriors()["ns2048"]
    post = {k: port_posterior[k] for k in SAMPLED}
    got = t_parity.posterior_js_divergences(post, ref, list(SAMPLED))
    want = j_parity.posterior_js_divergences(post, ref, list(SAMPLED))
    assert got == want
    # the default parameter choice: 1-D entries with spread in both
    assert t_parity.posterior_js_divergences(post, ref) == \
        j_parity.posterior_js_divergences(post, ref)
    assert t_parity.js_divergence_1d(np.ones(5), np.ones(7)) == \
        j_parity.js_divergence_1d(np.ones(5), np.ones(7)) == 0.0
