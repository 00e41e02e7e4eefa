"""K6, the EM likelihood from the source's magnitudes
(``ops/em_likelihood_kernel.py``, ``csrc/em_likelihood.cu``), on the CPU.

The kernel runs only on a CUDA card (chip_smoke.py's ``[k6]`` holds it to
the plain chain there). Here: CPU tensors take the plain chain and load no
library; the wrapper refuses bad operands before any launch; the detector
model's two steps, ``observe(frame(p))``, are its ``__call__`` bit for bit;
the plain chain on the CPU still matches the JAX package on the cases the
kernel has to get right (a source row with fewer than 2 finite samples,
composite filters, upper limits, a finite detection limit, a used band with
no finite model value, both extinction laws); the kernel's algorithm (the
search, the hat weights, the validity rules, the sentinels), emulated on
the CPU from the operands ``EMLikelihood.k6_operands`` hands it, matches
the plain chain on the same cases; and the kernel's symbol carries no other
kernel's name.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmma_tpu.likelihood as j_lik
import nmma_tpu.models as j_models
import nmma_tpu.models.base as j_base
import nmma_tpu_torch.models as t_models
import nmma_tpu_torch.models.base as t_base
import nmma_tpu_torch.models.svd as t_svd
from nmma_tpu_torch import _kernels as t_kernels
from nmma_tpu_torch.likelihood import (EMLikelihood, PhotometryData,
                                       SystematicsModel)
from nmma_tpu_torch.ops import em_likelihood_kernel as k6
from nmma_tpu_torch.ops.extinction import (band_extinction_mags_mw,
                                           band_extinction_mags_p92_smc)

torch.set_num_threads(1)

MODEL = "k6_test_source"
NAMES = ("m0", "t_on", "dead_i", "dead_z", "luminosity_distance",
         "timeshift", "Ebv")
# per parameter: the range of the draws
LO = np.array([-16.5, 0.01, 0.0, 0.0, 20.0, -0.2, 0.0])
HI = np.array([-14.5, 0.6, 1.0, 1.0, 200.0, 0.2, 0.3])
GRID = np.geomspace(0.05, 14.0, 80)
SENTINEL = -1e29
# the plain chain against the JAX package: both f32, the same formulas in
# another order; logL sums ~20 terms of a few units
RTOL, ATOL = 1e-4, 1e-3
CASES = ("few_finite", "composite", "upper_limits", "detection_limit",
         "all_inf_band", "p92_extinction", "mw_extinction")


def _rows_killed(filters, name, kill, n_t, idx, xp):
    """[B, F, T] mask of a filter's row when ``kill`` [B] is above 1/2:
    every sample but the last (one finite sample left)."""
    row = xp.asarray([f == name for f in filters])
    return (kill[:, None, None] > 0.5) & row[None, :, None] \
        & (idx[None, None, :] < n_t - 1)


def torch_source(params, t_days, nu_host, filters=None):
    """An analytic source: a power law in time whose slope runs with the
    frequency, +inf before ``t_on`` and on the ``i`` or ``z`` row (all but
    its last sample) where ``dead_i`` or ``dead_z`` is above 1/2."""
    lt = torch.log10(t_days)[None, None, :]
    lnu = torch.log10(nu_host / 1e14)[:, :, None]
    mags = params["m0"][:, None, None] + (1.2 + 0.3 * lnu) * lt
    mags = torch.where(t_days[None, None, :] < params["t_on"][:, None, None],
                       math.inf, mags)
    idx = torch.arange(t_days.shape[0])
    for name, key in (("i", "dead_i"), ("z", "dead_z")):
        mags = torch.where(_rows_killed(filters, name, params[key],
                                        t_days.shape[0], idx, torch),
                           math.inf, mags)
    return mags


def jax_source(params, t_days, nu_host, filters=None):
    """``torch_source`` for one sample."""
    lt = jnp.log10(t_days)[None, :]
    lnu = jnp.log10(nu_host / 1e14)[:, None]
    mags = params["m0"] + (1.2 + 0.3 * lnu) * lt
    mags = jnp.where(t_days[None, :] < params["t_on"], jnp.inf, mags)
    idx = jnp.arange(t_days.shape[0])
    for name, key in (("i", "dead_i"), ("z", "dead_z")):
        mask = _rows_killed(filters, name, jnp.atleast_1d(params[key]),
                            t_days.shape[0], idx, jnp)[0]
        mags = jnp.where(mask, jnp.inf, mags)
    return mags


t_base.register_source_model(t_base.SourceModel(
    name=MODEL, parameter_names=NAMES[:4], mags_fn=torch_source,
    needs_filters=True))
j_base.register_source_model(j_base.SourceModel(
    name=MODEL, parameter_names=NAMES[:4], mags_fn=jax_source,
    needs_filters=True))


def case_setup(case):
    """(observed filters, data dict, detection limit, extinction law, the
    draws [B, 7]) of one case. Each case plants its feature in some rows
    and leaves others finite."""
    observed = ["F606W", "i", "z"] if case == "composite" \
        else ["g", "i", "z"]
    rng = np.random.default_rng(CASES.index(case) + 11)
    data = {}
    for f in observed:
        t = np.sort(rng.uniform(0.3, 9.0, 6))
        mag = 18.0 + 1.2 * np.log10(t) + rng.normal(0.0, 0.1, t.size)
        err = np.full(t.size, 0.1)
        if case in ("upper_limits", "all_inf_band") and f == "z":
            err[:] = np.inf          # a band of upper limits alone
            mag -= 1.0
        elif case == "upper_limits" and f == "i":
            err[-2:] = np.inf
        data[f] = {"time": t, "mag": mag, "mag_error": err}
    # the i band's padding: one epoch fewer
    data["i"] = {k: v[:-1] for k, v in data["i"].items()}
    limit = {"i": 18.6, "g": 30.0} if case == "detection_limit" else None
    law = "G23_MW" if case == "mw_extinction" else "P92_SMC_host"
    theta = rng.uniform(LO, HI, (16, len(NAMES))).astype(np.float32)
    theta[:, 2:4] = 0.0
    if case == "few_finite":
        theta[::3, 2] = 1.0          # the i row keeps one finite sample
    if case == "all_inf_band":
        theta[::3, 3] = 1.0          # the z row, whose band has limits alone
    if case in ("p92_extinction", "mw_extinction"):
        theta[:, 6] = np.linspace(0.0, 1.5, 16)
    theta[:4, 1] = 0.01              # rows whose epochs all lie in range
    return observed, data, limit, law, theta


def port_likelihood(case):
    observed, data, limit, law, theta = case_setup(case)
    det = t_models.DetectorLightCurveModel(MODEL, observed, sample_times=GRID,
                                           extinction_law=law, device="cpu")
    photo, filters = PhotometryData.from_dict(data, observed, device="cpu")
    lk = EMLikelihood(det, photo, filters, SystematicsModel(filters, None,
                                                           0.4),
                      detection_limit=limit)
    params = {n: torch.from_numpy(theta[:, i].copy())
              for i, n in enumerate(NAMES)}
    return lk, params


def jax_logl(case):
    observed, data, limit, law, theta = case_setup(case)
    det = j_models.DetectorLightCurveModel(MODEL, observed, sample_times=GRID,
                                           extinction_law=law)
    photo, filters = j_lik.PhotometryData.from_dict(data, observed)
    lk = j_lik.EMLikelihood(det, photo, filters, j_lik.SystematicsModel(
        filters, None, 0.4), detection_limit=limit)
    return np.asarray(jax.vmap(lambda th: lk.log_likelihood(
        {n: th[i] for i, n in enumerate(NAMES)}))(jnp.asarray(theta)))


def refuse_loading(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("reached the kernel's library")

    monkeypatch.setattr(t_kernels, "load", refuse)


def assert_logl_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got < SENTINEL, want < SENTINEL)
    fin = want > SENTINEL
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)
    return fin


@pytest.mark.parametrize("case", CASES)
def test_plain_chain_matches_jax(monkeypatch, case):
    """The port's EMLikelihood on the CPU (the plain chain, no library)
    against the JAX package's, row by row: identical sentinels, finite
    logL within 1e-4 relative. Each case's feature shows in the rows."""
    refuse_loading(monkeypatch)
    lk, params = port_likelihood(case)
    got = lk.log_likelihood(params).numpy()
    fin = assert_logl_close(got, jax_logl(case))
    assert fin[1:3].all()
    if case in ("few_finite", "all_inf_band"):
        # the planted rows
        assert (got[::3] < SENTINEL).all()
    else:
        assert fin[:4].all()
    if case == "all_inf_band":
        # without the band rule the limits alone would read 0 there
        lk_det = lk.data
        assert not bool((lk_det.valid[2] & torch.isfinite(
            lk_det.sigmas[2])).any())


def emulate_k6(ops):
    """K6's algorithm on the CPU, row-parallel, from its operands: the
    observer times, the band extinction, the apparent rows and their finite
    counts and ends, a binary search of each epoch, the two hat weights,
    the helper rows' estimates, the terms and the sentinels."""
    mags, t_grid = ops["mags"], ops["t_grid"]
    n_b, n_f, n_t = mags.shape
    one_pz = 1.0 + ops["z"]
    x = t_grid[None] * one_pz[:, None] + ops["timeshift"][:, None]
    if ops["extinction_law"] == "G23_MW":
        ext = band_extinction_mags_mw(ops["nu_nodes"], ops["nu_weights"],
                                      ops["ebv"])
    else:
        ext = band_extinction_mags_p92_smc(ops["nu_nodes"],
                                           ops["nu_weights"], ops["ebv"],
                                           ops["z"])
    y = mags + ext[:, :, None]
    if ops["dm"] is not None:
        y = y + ops["dm"][:, None, None]
    y = y + (torch.log10(one_pz) * -2.5)[:, None, None]
    fin = torch.isfinite(y)
    count = fin.sum(-1)                                       # [B, F]
    idx = torch.arange(n_t)
    first = torch.where(fin, idx, n_t).amin(-1)
    last = torch.where(fin, idx, -1).amax(-1)
    x_first = x.gather(1, torch.where(count > 0, first, 0))
    x_last = x.gather(1, torch.where(count > 0, last, n_t - 1))

    times, valid = ops["times"], ops["valid"]
    n_fo, n_obs = times.shape
    xq = times.reshape(1, -1).expand(n_b, -1)                 # [B, Q]
    lo = torch.zeros_like(xq, dtype=torch.long)
    hi = torch.full_like(lo, n_t)
    for _ in range(n_t.bit_length() + 1):
        mid = (lo + hi) // 2
        active = lo < hi
        right = ~(x.gather(1, mid.clamp(max=n_t - 1)) > xq)
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    j = torch.clamp(lo - 1, 0, n_t - 2)

    def hat(t):
        xt = x.gather(1, t)
        xl = x.gather(1, (t - 1).clamp(min=0))
        xr = x.gather(1, (t + 1).clamp(max=n_t - 1))
        up = (xq - xl) / torch.clamp(xt - xl, min=1e-30)
        dn = (xr - xq) / torch.clamp(xr - xt, min=1e-30)
        up = torch.where(t == 0, 1.0, up)
        dn = torch.where(t == n_t - 1, 1.0, dn)
        return torch.clamp(torch.minimum(up, dn), 0.0, 1.0)

    w_lo, w_hi = hat(j), hat(j + 1)
    clean = torch.where(fin, y, 0.0)
    fo = torch.arange(n_fo).repeat_interleave(n_obs)          # [Q]
    est = None
    for k in range(ops["helper_rows"].shape[1]):
        r = ops["helper_rows"][fo, k].long()                  # [Q]
        w = ops["helper_weights"][fo, k]
        rows = clean[:, r]                                    # [B, Q, T]
        e = w_lo * rows.gather(2, j[..., None])[..., 0] \
            + w_hi * rows.gather(2, (j + 1)[..., None])[..., 0]
        inside = (count[:, r] >= 2) & (xq >= x_first[:, r]) \
            & (xq <= x_last[:, r])
        e = torch.where(inside, e, math.inf)
        term = torch.where(w > 0.0, e * w, 0.0)
        est = term if est is None else est + term
    est = est.reshape(n_b, n_fo, n_obs)

    sig, m = ops["sigmas"], ops["data_mags"]
    det = valid & torch.isfinite(sig)
    lim_mask = valid & ~torch.isfinite(sig)
    loc = torch.where(torch.isfinite(est), est, 1e30)
    s_sys = ops["sigma_sys"]
    scale = torch.sqrt(sig * sig + s_sys * s_sys)
    scale = torch.where(det, scale, 1.0)
    u = (m - loc) / scale
    log_phi = (-0.5 * u) * u - 0.5 * math.log(2 * math.pi) - torch.log(scale)
    bound = (ops["detection_limit"][:, None] - loc) / scale
    log_cdf = torch.where(torch.isposinf(bound), 0.0, torch.special.log_ndtr(
        torch.where(torch.isposinf(bound), 0.0, bound)))
    chi = torch.where(det, log_phi - log_cdf, 0.0).sum((1, 2))
    sf = torch.where(lim_mask, torch.special.log_ndtr(
        -(m - loc) / torch.clamp(s_sys, min=1e-10)), 0.0).sum((1, 2))
    logl = chi + sf
    used = valid.any(1)
    found = (torch.isfinite(est) & valid).any(2)
    logl = torch.where((found | ~used).all(1), logl, -1e30)
    return torch.where(torch.isnan(logl), -1e30,
                       torch.clamp(logl, min=-1e30))


@pytest.mark.parametrize("case", CASES)
def test_k6_algorithm_emulated_matches_plain_chain(monkeypatch, case):
    """K6's algorithm, emulated on the CPU from the operands the port
    hands the kernel, against the plain chain: the same sentinels, finite
    logL within f32 round-off of its sums."""
    refuse_loading(monkeypatch)
    lk, params = port_likelihood(case)
    ops = lk.k6_operands(params)
    assert ops["extinction_law"] == lk.model.extinction_law
    assert ops["helper_rows"].dtype == torch.int32
    got = emulate_k6(ops)
    want = lk.log_likelihood(params)
    assert_logl_close(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("case", ["composite", "upper_limits"])
def test_cpu_tensors_take_the_plain_chain_and_load_no_library(
        monkeypatch, case):
    """CPU tensors never reach the wrapper: EMLikelihood runs
    DetectorLightCurveModel.__call__ and the plain terms."""
    refuse_loading(monkeypatch)

    def refuse(**ops):
        raise AssertionError("CPU tensors reached K6")

    monkeypatch.setattr(k6, "em_log_likelihood", refuse)
    lk, params = port_likelihood(case)
    logl = lk(params)
    obs_t, mags = lk.model(params)
    est = lk.expected_mags(obs_t, mags)
    assert logl.shape == (16,) and (logl > SENTINEL).any()
    assert est.shape == (16,) + tuple(lk.data.times.shape)


def k6_operands(n_b=3, n_f=4, n_k=9, n_t=20, n_fo=3, n_kh=2, n_obs=5):
    f = torch.ones
    return dict(
        mags=f(n_b, n_f, n_t), t_grid=f(n_t), z=f(n_b), timeshift=f(n_b),
        dm=f(n_b), ebv=f(n_b), nu_nodes=f(n_f, n_k), nu_weights=f(n_f, n_k),
        helper_rows=torch.zeros((n_fo, n_kh), dtype=torch.int32),
        helper_weights=f(n_fo, n_kh), times=f(n_fo, n_obs),
        data_mags=f(n_fo, n_obs), sigmas=f(n_fo, n_obs),
        valid=torch.ones((n_fo, n_obs), dtype=torch.bool),
        detection_limit=f(n_fo), sigma_sys=f(n_b, n_fo, n_obs),
        extinction_law="P92_SMC_host")


@pytest.mark.parametrize("case", [
    "cpu", "cpu_no_dm", "float64", "int64_rows", "float_valid",
    "not_a_tensor", "strided", "mags_rank", "grid_shape", "row_vector",
    "node_shape", "weights_shape", "helper_shape", "data_shape",
    "limit_shape", "sigma_sys_shape", "short_grid", "long_grid",
    "too_many_helpers", "unknown_law"])
def test_k6_wrapper_refuses_before_any_launch(monkeypatch, case):
    """The wrapper checks dtypes, devices, shapes, contiguity and the
    kernel's limits before it loads the library; a CPU tensor reaches it
    only when called directly, and is refused."""
    refuse_loading(monkeypatch)
    ops = k6_operands()
    error = ValueError
    if case == "cpu_no_dm":
        ops["dm"] = None
    elif case == "float64":
        ops["sigma_sys"], error = ops["sigma_sys"].double(), TypeError
    elif case == "int64_rows":
        ops["helper_rows"], error = ops["helper_rows"].long(), TypeError
    elif case == "float_valid":
        ops["valid"], error = ops["valid"].float(), TypeError
    elif case == "not_a_tensor":
        ops["ebv"], error = np.ones(3, np.float32), TypeError
    elif case == "strided":
        ops["mags"] = torch.ones(3, 4, 40)[:, :, ::2]
    elif case == "mags_rank":
        ops["mags"] = torch.ones(3, 80)
    elif case == "grid_shape":
        ops["t_grid"] = torch.ones(21)
    elif case == "row_vector":
        ops["timeshift"] = torch.ones(4)
    elif case == "node_shape":
        ops["nu_nodes"] = torch.ones(5, 9)
    elif case == "weights_shape":
        ops["nu_weights"] = torch.ones(4, 8)
    elif case == "helper_shape":
        ops["helper_weights"] = torch.ones(3, 3)
    elif case == "data_shape":
        ops["sigmas"] = torch.ones(3, 6)
    elif case == "limit_shape":
        ops["detection_limit"] = torch.ones(3, 1)
    elif case == "sigma_sys_shape":
        ops["sigma_sys"] = torch.ones(3, 5, 3)
    elif case in ("short_grid", "long_grid"):
        n_t = 1 if case == "short_grid" else k6.MAX_T + 1
        ops.update(mags=torch.ones(3, 4, n_t), t_grid=torch.ones(n_t))
    elif case == "too_many_helpers":
        n_kh = k6.MAX_KH + 1
        ops.update(helper_rows=torch.zeros((3, n_kh), dtype=torch.int32),
                   helper_weights=torch.ones(3, n_kh))
    elif case == "unknown_law":
        ops["extinction_law"] = "F99"
    with pytest.raises(error, match="device" if case.startswith("cpu")
                       else None):
        k6.em_log_likelihood(**ops)


@pytest.fixture(scope="module")
def svd_model():
    svd = t_svd.SVDModelData.load("artifacts/Bu2019lm_production_svd.npz",
                                  device="cpu")
    t_svd.make_svd_source_model("Bu2019lm_k6_rows", svd)
    return svd


@pytest.mark.parametrize("model", ["Me2017", "TrPi2018", "svd"])
def test_observe_of_frame_is_call_bit_for_bit(svd_model, model):
    """``observe(frame(p))`` is ``__call__(p)`` bit for bit, and ``frame``
    hands on the completed parameters with the distance modulus and the
    source's rows in the detector's filter order: an SVD surrogate's
    untrained filter is an inf row, and its composite V adds its helper
    rows."""
    rng = np.random.default_rng(5)
    b = 4
    if model == "Me2017":
        name, filters, kw = "Me2017", ["ztfg", "ztfr", "2massks"], {}
        p = {"log10_mej": rng.uniform(-2.5, -1.0, b),
             "log10_vej": rng.uniform(-1.5, -0.7, b),
             "beta": rng.uniform(1.0, 5.0, b),
             "log10_kappa_r": rng.uniform(-1.0, 2.0, b)}
        grid = np.geomspace(0.01, 14.0, 40)
    elif model == "TrPi2018":
        name, filters = "TrPi2018", ["ztfg", "X-ray-1keV", "radio-6GHz"]
        kw = dict(n_theta=8, n_phi=4, n_r=128)
        p = {"log10_E0": rng.uniform(50.0, 52.0, b),
             "thetaCore": rng.uniform(0.05, 0.2, b),
             "thetaWing": np.full(b, 0.4), "inclination_EM": np.zeros(b),
             "log10_n0": rng.uniform(-3.0, 0.0, b),
             "p": rng.uniform(2.1, 2.8, b),
             "log10_epsilon_e": rng.uniform(-2.0, -0.5, b),
             "log10_epsilon_B": rng.uniform(-4.0, -1.0, b)}
        grid = np.geomspace(0.05, 40.0, 32)
    else:
        name, filters, kw = "Bu2019lm_k6_rows", \
            ["ztfg", "V", "X-ray-1keV"], {}
        p = {"log10_mej_dyn": rng.uniform(-3.0, -1.0, b),
             "log10_mej_wind": rng.uniform(-2.0, -0.5, b),
             "KNphi": rng.uniform(15.0, 75.0, b),
             "KNtheta": rng.uniform(0.0, 90.0, b)}
        grid = np.geomspace(0.01, 14.0, 150)
    p.update(luminosity_distance=rng.uniform(20.0, 200.0, b),
             timeshift=rng.uniform(-0.2, 0.2, b), Ebv=rng.uniform(0, 0.2, b))
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    det = t_models.DetectorLightCurveModel(name, filters, sample_times=grid,
                                           model_kwargs=kw, device="cpu")
    frame = det.frame(p)
    assert set(p) <= set(frame.parameters)
    assert {"redshift", "distance_modulus"} <= set(frame.parameters)
    assert frame.mags.shape == (b, len(det.filters), grid.shape[0])
    times, mags = det.observe(frame)
    want_times, want_mags = det(p)
    assert torch.equal(times, want_times)
    assert torch.equal(torch.isnan(mags), torch.isnan(want_mags))
    assert torch.equal(torch.nan_to_num(mags), torch.nan_to_num(want_mags))
    assert torch.isfinite(mags).any()
    if model == "svd":
        # V and X-ray-1keV are not trained; ztfr is V's helper
        assert det.filters == ["ztfg", "V", "X-ray-1keV", "ztfr"]
        assert torch.isposinf(frame.mags[:, 1:3]).all()
        assert torch.isfinite(frame.mags[:, [0, 3]]).any()


def test_k6_kernel_name_is_no_other_kernels():
    """The benchmark finds K6's launches by a substring of its symbol
    (portbench/metrics/k6_roofline.py): K6's one kernel carries its own,
    no other kernel carries it, and the library is built with -fmad=false
    and without fast math."""
    csrc = os.path.join(os.path.dirname(t_kernels.__file__), "csrc")
    pattern = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\("
                         r"[^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    names = {}
    for lib, (source, _) in t_kernels.KERNELS.items():
        with open(os.path.join(csrc, source)) as f:
            names[lib] = pattern.findall(f.read())
    assert names["em_likelihood"] == ["em_likelihood_kernel"]
    for lib, found in names.items():
        for other in t_kernels.KERNELS:
            if other != lib:
                assert not any(other in n for n in found), (lib, other)
    assert t_kernels.flags("em_likelihood")[-1] == "-fmad=false"
    assert "--use_fast_math" not in t_kernels.flags("em_likelihood")
