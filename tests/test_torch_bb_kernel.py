"""K5, the banded blackbody photometry (``ops/bb_photometry_kernel.py``,
``csrc/bb_photometry.cu``), on the CPU.

The kernel runs only on a CUDA card (chip_smoke.py's ``[k5]`` holds it to
the plain chain there). Here: CPU tensors take the plain chain and load no
library; tensors on any other device reach the kernel's two entries with
the operands they need; the wrapper refuses bad operands before any launch;
the kernel's symbol carries no other kernel's name; and Me2017's photometry
on the CPU matches the JAX package where the temperature fill has work to
do.
"""

import math
import os
import re

import jax
import numpy as np
import pytest
import torch

import nmma_tpu.models.kilonova as j_kn
from nmma_tpu_torch import _kernels as t_kernels
from nmma_tpu_torch.filters import filters_to_quadrature
from nmma_tpu_torch.models import kilonova as t_kn
from nmma_tpu_torch.models import shock_cooling as t_sc
from nmma_tpu_torch.ops import bb_photometry_kernel as k5
from nmma_tpu_torch.ops import photometry as t_phot

torch.set_num_threads(1)

FILTERS = ["sdssu", "ztfg", "ztfr", "2massks"]
T_DAYS = np.geomspace(0.01, 14.0, 60).astype(np.float32)
MAG_ATOL = 1e-5      # as tests/test_torch_photometry.py


def refuse_loading(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded the library {name}")

    monkeypatch.setattr(t_kernels, "load", refuse)


def photosphere(b, seed, case=None):
    """Me2017-like (ltot40 [B, T], r_photo [B, T]) in f32: a luminosity
    falling from ~1e2 to ~1e-2 (x 1e40 erg/s) and a radius growing to
    ~1e15 cm, the last time 0 as K2 leaves it; ``case`` plants undefined
    temperatures in row 0."""
    rng = np.random.default_rng(seed)
    t = T_DAYS[None]
    ltot = 10.0 ** rng.uniform(1.0, 2.0, (b, 1)) * t ** -1.3
    r_photo = 10.0 ** rng.uniform(14.0, 14.5, (b, 1)) * t ** 0.6
    ltot *= rng.uniform(0.9, 1.1, ltot.shape)
    ltot[:, -1] = r_photo[:, -1] = 0.0
    n = T_DAYS.shape[0]
    if case == "head":
        r_photo[0, :6] = 0.0
    elif case == "middle":
        ltot[0, 20:28] = 0.0
    elif case == "tail":
        ltot[0, n - 15:] = 0.0
    elif case == "head_by_luminosity":
        ltot[0, :4] = 0.0
    elif case == "one_valid":
        r_photo[0, :] = 0.0
        r_photo[0, 30] = 1e15
    elif case == "none_valid":
        ltot[0, :] = 0.0
    elif case == "negative_luminosity":
        ltot[0] = -ltot[0]
    return ltot.astype(np.float32), r_photo.astype(np.float32)


def band_nodes(b, seed):
    """Host-frame nodes [B, F, K] at redshifts up to 0.05, nu_host [B, F]
    and the weights [F, K], f32."""
    rng = np.random.default_rng(seed + 100)
    nodes, weights = filters_to_quadrature(FILTERS)
    z = rng.uniform(0.0, 0.05, b).astype(np.float32)
    nodes = (nodes[None].astype(np.float32)
             * (1.0 + z)[:, None, None]).astype(np.float32)
    return nodes, nodes[:, :, 0].copy(), weights.astype(np.float32)


@pytest.mark.parametrize("case", ["head", "middle", "tail",
                                  "head_by_luminosity", "one_valid",
                                  "none_valid", "negative_luminosity"])
def test_me2017_photometry_matches_jax_on_the_fill(case):
    """Undefined temperatures at the head (by R = 0, or by L = 0 where the
    fill extrapolates), in the middle and at the tail, a row with one valid
    sample and one with none, a negative L: the port's _me2017_photometry
    on the CPU (the plain chain) against the JAX package's, row by row."""
    ltot, r_photo = photosphere(3, 7, case)
    nodes, nu_host, weights = band_nodes(3, 7)
    want = jax.vmap(j_kn._me2017_photometry,
                    in_axes=(0, 0, None, 0, 0, None))(
        ltot, r_photo, T_DAYS, nu_host, nodes, weights)
    got = t_kn._me2017_photometry(*(torch.from_numpy(a) for a in (
        ltot, r_photo, T_DAYS, nu_host, nodes, weights)))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (3, len(FILTERS), T_DAYS.shape[0])
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    assert not np.isnan(got).any() and not np.isneginf(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=MAG_ATOL)
    if case in ("one_valid", "none_valid"):
        assert np.isposinf(got[0]).all()
        assert np.isfinite(got[1:, :, :-1]).all()
    if case in ("middle", "tail", "head_by_luminosity"):
        # a radius to fill over: the filled temperatures give magnitudes
        assert np.isfinite(got[0, :, :-1]).any()


@pytest.mark.parametrize("caller", ["me2017", "banded"])
def test_cpu_tensors_take_the_plain_chain_and_load_no_library(
        monkeypatch, caller):
    refuse_loading(monkeypatch)
    ltot, r_photo = photosphere(4, 3, "middle")
    nodes, nu_host, weights = band_nodes(4, 3)
    ltot, r_photo, t_days, nu_host, nodes, weights = (
        torch.from_numpy(a) for a in (ltot, r_photo, T_DAYS, nu_host, nodes,
                                      weights))
    if caller == "me2017":
        args = (ltot, r_photo, t_days, nu_host, nodes, weights)
        got = t_kn._me2017_photometry(*args)
        want = t_kn._me2017_photometry_plain(*args)
    else:
        inv_t = torch.where(r_photo > 0, 1.0 / (4e3 + ltot), math.inf)
        got = t_phot.blackbody_ab_mag_banded(nodes, weights, inv_t, r_photo)
        want = t_phot.blackbody_ab_mag_banded_plain(nodes, weights, inv_t,
                                                    r_photo)
    assert torch.equal(got, want)
    assert torch.isfinite(got).any()


META = torch.device("meta")


@pytest.mark.parametrize("caller", ["Me2017", "blackbody_fixedT",
                                    "Piro2021"])
def test_tensors_off_the_cpu_reach_k5(monkeypatch, caller):
    """On any other device (here meta tensors, which carry shapes only)
    Me2017 reaches K5's prologue entry and the 1/T callers its body entry,
    with f32, contiguous [B, T] operands and [B, F, K] nodes."""
    seen = {}

    def fake(name):
        def call(*args):
            seen[name] = args
            return torch.empty((b, n_f, n_t), device=META)
        return call

    monkeypatch.setattr(t_kn, "me2017_bb_mags", fake("prologue"))
    monkeypatch.setattr(k5, "bb_mags", fake("body"))
    b, n_f, n_k, n_t = 5, len(FILTERS), 9, 40
    col = torch.ones(b, device=META)
    t_days = torch.empty(n_t, device=META)
    nu_host = torch.empty((b, n_f), device=META)
    nodes = torch.empty((b, n_f, n_k), device=META)
    weights = torch.empty((n_f, n_k), device=META)
    if caller == "Me2017":
        t_kn._me2017_photometry(torch.empty((b, n_t), device=META),
                                torch.empty((b, n_t), device=META), t_days,
                                nu_host, nodes, weights)
        ltot40, r_photo, grid, got_nodes, got_w, log_dist2 = \
            seen["prologue"]
        assert grid.shape == (n_t,)
        assert log_dist2 == t_phot._LOG_DIST2
        pair = (ltot40, r_photo)
    else:
        if caller == "blackbody_fixedT":
            t_kn.blackbody_fixed_t_mags(
                {"log10_bb_luminosity": col, "temperature": col}, t_days,
                nu_host, nodes, weights)
        else:
            t_sc.piro2021_mags({"log10_Menv": col, "log10_Renv": col,
                                "log10_Ee": col}, t_days, nu_host, nodes,
                               weights)
        got_nodes, got_w, inv_t, radius, log_dist2 = seen["body"]
        pair = (inv_t, radius)
    assert list(seen) == ["prologue" if caller == "Me2017" else "body"]
    for t in pair:
        assert t.shape == (b, n_t) and t.is_contiguous()
        assert t.dtype == torch.float32
    assert got_nodes.shape == (b, n_f, n_k) and got_nodes.is_contiguous()
    assert got_w.shape == (n_f, n_k)


def k5_operands(b=3, n_f=2, n_k=9, n_t=20):
    f = torch.ones
    return dict(ltot40=f(b, n_t), r_photo=f(b, n_t), t_days=f(n_t),
                nu_nodes=f(b, n_f, n_k), weights=f(n_f, n_k), log_dist2=1.0)


@pytest.mark.parametrize("case", [
    "cpu", "float64", "not_a_tensor", "strided", "radius_shape",
    "grid_shape", "node_rows", "weights_shape", "too_many_nodes", "no_nodes",
    "long_grid", "tensor_log_dist2", "body_cpu", "body_inv_t_shape"])
def test_k5_wrapper_refuses_before_any_launch(monkeypatch, case):
    """The wrapper checks dtypes, devices, shapes, contiguity and the
    kernel's limits before it loads the library; a CPU tensor reaches it
    only when called directly, and is refused."""
    refuse_loading(monkeypatch)
    ops = k5_operands()
    error = ValueError
    if case == "float64":
        ops["r_photo"], error = ops["r_photo"].double(), TypeError
    elif case == "not_a_tensor":
        ops["weights"], error = np.ones((2, 9), np.float32), TypeError
    elif case == "strided":
        ops["ltot40"] = torch.ones(3, 40)[:, ::2]
    elif case == "radius_shape":
        ops["r_photo"] = torch.ones(3, 19)
    elif case == "grid_shape":
        ops["t_days"] = torch.ones(1, 20)
    elif case == "node_rows":
        ops["nu_nodes"] = torch.ones(1, 2, 9)
    elif case == "weights_shape":
        ops["weights"] = torch.ones(9, 2)
    elif case == "too_many_nodes":
        ops["nu_nodes"] = torch.ones(3, 2, k5.MAX_K + 1)
        ops["weights"] = torch.ones(2, k5.MAX_K + 1)
    elif case == "no_nodes":
        ops["nu_nodes"], ops["weights"] = torch.ones(3, 2, 0), torch.ones(2, 0)
    elif case == "long_grid":
        n_t = k5.MAX_T + 1
        ops.update(ltot40=torch.ones(3, n_t), r_photo=torch.ones(3, n_t),
                   t_days=torch.ones(n_t))
    elif case == "tensor_log_dist2":
        ops["log_dist2"], error = torch.tensor(1.0), TypeError
    if case.startswith("body"):
        inv_t = torch.ones(3, 20) if case == "body_cpu" else torch.ones(20)
        with pytest.raises(error, match="device" if case == "body_cpu"
                           else None):
            k5.bb_mags(ops["nu_nodes"], ops["weights"], inv_t,
                       ops["r_photo"], ops["log_dist2"])
        return
    with pytest.raises(error, match="device" if case == "cpu" else None):
        k5.me2017_bb_mags(**ops)


def test_k5_kernel_name_is_no_other_kernels():
    """The benchmark finds each kernel's launches by a substring of its
    symbol (portbench/counts/*.py KERNEL, metrics/k4_roofline.py,
    metrics/k5_roofline.py): K5's one kernel carries its own, and no
    other kernel carries it."""
    csrc = os.path.join(os.path.dirname(t_kernels.__file__), "csrc")
    pattern = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\("
                         r"[^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    names = {}
    for lib, (source, _) in t_kernels.KERNELS.items():
        with open(os.path.join(csrc, source)) as f:
            names[lib] = pattern.findall(f.read())
    assert names["bb_photometry"] == ["bb_photometry_kernel"]
    for lib, found in names.items():
        for other in t_kernels.KERNELS:
            if other != lib:
                assert not any(other in n for n in found), (lib, other)
    assert t_kernels.flags("bb_photometry")[-1] == "-fmad=false"
    assert "--use_fast_math" not in t_kernels.flags("bb_photometry")
