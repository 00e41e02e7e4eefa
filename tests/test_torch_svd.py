"""K1 and the SVD surrogate of the PyTorch port against the JAX package.

The port's plain K1 (``nmma_tpu_torch.ops.svd_kernel``, what a CPU tensor
runs) is held against the Pallas kernel in interpret mode and against the
JAX rank-C eval at production dims (P=4, H=2048, C=10, F=9) and Q=150, at
atol 1e-4 mag: the tolerance the JAX package holds its own kernel to
(tests/test_pallas_svd.py:55), f32 sums over H=2048 in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmma_tpu.models.svd import SVDModelData as JaxSVDModelData
from nmma_tpu.models.svd import _SVDFastEval, svd_surrogate_mags
from nmma_tpu.ops.pallas_svd import svd_surrogate_mags_pallas
from nmma_tpu_torch.models.svd import SVDModelData, svd_from_numpy
from nmma_tpu_torch.ops import svd_kernel

torch.set_num_threads(1)

ART = "artifacts/Bu2019lm_production_svd.npz"
ATOL = 1e-4
# the JAX package's own K1 test grid (tests/test_pallas_svd.py:28): Q=150
# inside the trained range; outside it the projection extrapolates to
# values the model replaces with inf
T_DAYS = np.geomspace(0.3, 12.0, 150)


@pytest.fixture(scope="module")
def arrays():
    with np.load(ART) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_eval():
    return _SVDFastEval(JaxSVDModelData.load(ART))


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("batch", [1, 128, 200])
def test_plain_k1_matches_pallas_and_rankc(jax_eval, batch):
    ev = jax_eval
    va_q, off_q, _ = ev.operator_rankc(T_DAYS)
    x = np.random.default_rng(batch).uniform(
        0.0, 1.0, (batch, ev._w1_stack.shape[1])).astype(np.float32)
    ops = (ev._w1_stack, ev._b1_stack, ev._w2c, ev._b2c, va_q, off_q)
    pallas = np.asarray(svd_surrogate_mags_pallas(
        jnp.asarray(x), *ops, interpret=True))
    core, _ = ev._rankc_fn(T_DAYS)
    rankc = np.asarray(jax.vmap(core)(jnp.asarray(x)))
    got = svd_kernel.svd_surrogate_mags(_t(x), *[_t(a) for a in ops]).numpy()
    assert got.shape == (batch, ev.F, len(T_DAYS))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, rankc, rtol=0, atol=ATOL)


def test_plain_k1_matches_pallas_on_main_path_grid(jax_eval):
    """K1 on the time grid of the main path (geomspace(0.01, 14, 150),
    as the analysis and the smoke run use it), with the JAX package's own
    operators. Only the columns inside the trained range are compared: the
    model replaces the others with inf, and there the JAX operators
    extrapolate, so their f32 sums reach ~1e-4 mag apart."""
    ev = jax_eval
    t_days = np.geomspace(0.01, 14.0, 150)
    va_q, off_q, inside = ev.operator_rankc(t_days)
    assert 0 < inside.sum() < len(t_days)
    x = np.random.default_rng(7).uniform(
        0.0, 1.0, (128, ev._w1_stack.shape[1])).astype(np.float32)
    ops = (ev._w1_stack, ev._b1_stack, ev._w2c, ev._b2c, va_q, off_q)
    pallas = np.asarray(svd_surrogate_mags_pallas(
        jnp.asarray(x), *ops, interpret=True))
    got = svd_kernel.svd_surrogate_mags(_t(x), *[_t(a) for a in ops]).numpy()
    assert got.shape == pallas.shape == (128, ev.F, len(t_days))
    np.testing.assert_allclose(got[:, :, inside], pallas[:, :, inside],
                               rtol=0, atol=ATOL)


def test_svd_from_numpy_matches_jax_model(arrays):
    """Same arrays, same parameters: rank-C operators equal inside the
    trained range [0.2, 14] d (both built in float64 on the host; the port
    zeroes the columns the JAX package extrapolates and then discards),
    equal inf fill outside it, and magnitudes within ATOL."""
    port = svd_from_numpy(arrays, device="cpu")
    ref = JaxSVDModelData.load(ART)
    # output times reaching below and beyond the trained range
    t_days = np.geomspace(0.01, 20.0, 150).astype(np.float32)
    va_j, off_j, inside_j = _SVDFastEval(ref).operator_rankc(t_days)
    va_p, off_p, inside_p = port.operator_rankc(torch.from_numpy(t_days))
    np.testing.assert_array_equal(inside_p.numpy(), inside_j)
    assert 0 < inside_j.sum() < len(t_days)
    np.testing.assert_array_equal(va_p.numpy()[:, :, inside_j],
                                  va_j[:, :, inside_j])
    np.testing.assert_array_equal(off_p.numpy()[:, inside_j],
                                  off_j[:, inside_j])
    assert not va_p.numpy()[:, :, ~inside_j].any()
    assert not off_p.numpy()[:, ~inside_j].any()

    rng = np.random.default_rng(5)
    lo, hi = arrays["param_mins"], arrays["param_maxs"]
    theta = rng.uniform(lo, hi, (16, len(lo))).astype(np.float32)
    names = port.parameter_names
    want = np.asarray(jax.vmap(lambda th: svd_surrogate_mags(
        ref, {n: th[i] for i, n in enumerate(names)}, jnp.asarray(t_days)))(
            jnp.asarray(theta)))
    got = port({n: torch.from_numpy(theta[:, i]) for i, n in
                enumerate(names)}, torch.from_numpy(t_days)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[:, :, ~inside_j]).all()
    assert np.isfinite(got[:, :, inside_j]).all()
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=0, atol=ATOL)


def test_load_reads_the_artifact(arrays):
    svd = SVDModelData.load(ART, device="cpu")
    assert svd.filters == tuple(str(f) for f in arrays["filters"])
    assert tuple(svd.w1.shape) == arrays["w1"].shape
    assert svd.n_coeff == arrays["w2"].shape[2]


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(jax_eval):
    ev = jax_eval
    va_q, off_q, _ = ev.operator_rankc(T_DAYS)
    ops = [_t(a) for a in (ev._w1_stack, ev._b1_stack, ev._w2c, ev._b2c,
                           va_q, off_q)]
    x = torch.rand(4, 4)
    with pytest.raises(TypeError):
        svd_kernel.svd_surrogate_mags(x.double(), *ops)
    with pytest.raises(ValueError):
        svd_kernel.svd_surrogate_mags(torch.rand(4, 3), *ops)
    with pytest.raises(ValueError):
        svd_kernel.svd_surrogate_mags(torch.rand(4, 8)[:, ::2], *ops)
    with pytest.raises(ValueError):
        svd_kernel.svd_surrogate_mags(x.to("meta"),
                                      *[o.to("meta") for o in ops])


# --- the kernel's summation order, emulated on the CPU --------------------
#
# csrc/svd_mlp.cu splits H into 32-unit chunks dealt to 8 warps (chunk ch to
# warp ch % 8); within a chunk the lanes' 32/LP sub-slices take KS = LP
# consecutive units each. A sub-slice sums a chunk's terms (FMAs from 0),
# then adds the chunk sums in order; the sub-slices meet in an xor-shuffle
# tree, the warps in order, then b2; the projection is an FMA chain over C
# from 0, then + off. LP = 32 (one sub-slice) at the large batches, LP = 16
# (two) at the samplers' B = 128.

WARPS, CHUNK = 8, 32


def _fma32(a, b, c):
    """f32 FMA: the product exact in float64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def emulate_k1_coeffs(x, w1, b1, w2c, b2, lp):
    """The coefficients c [B, F, C] in the kernel's order of f32
    operations."""
    n_b, n_p = x.shape
    n_f, _, n_h = w1.shape
    n_c = w2c.shape[2]
    sub = CHUNK // lp
    ks = CHUNK // sub
    hid = b1[None].expand(n_b, n_f, n_h)
    for p in range(n_p):
        hid = _fma32(x[:, None, p, None], w1[None, :, p, :], hid)
    hid = hid.clamp(min=0.0)                                     # [B, F, H]
    n_ch = -(-n_h // (CHUNK * WARPS)) * WARPS
    pad = n_ch * CHUNK - n_h
    hid = torch.nn.functional.pad(hid, (0, pad))
    w2p = torch.nn.functional.pad(w2c, (0, 0, 0, pad))
    # unit h = ((i * WARPS + w) * sub + s) * ks + k
    hid = hid.reshape(n_b, n_f, n_ch // WARPS, WARPS, sub, ks)
    w2p = w2p.reshape(n_f, n_ch // WARPS, WARPS, sub, ks, n_c)
    part = torch.zeros((n_b, n_f, n_ch // WARPS, WARPS, sub, n_c))
    for k in range(ks):
        part = _fma32(hid[..., k, None], w2p[None, ..., k, :], part)
    acc = torch.zeros_like(part[:, :, 0])                  # [B, F, W, S, C]
    for i in range(n_ch // WARPS):
        acc = acc + part[:, :, i]
    o = 1
    while o < sub:                         # the shuffle tree over sub-slices
        acc = acc + acc[:, :, :, torch.arange(sub) ^ o]
        o *= 2
    c = acc[:, :, 0, 0]
    for w in range(1, WARPS):
        c = c + acc[:, :, w, 0]
    return c + b2[None]


def emulate_k1(x, w1, b1, w2c, b2, va_q, off_q, lp):
    """Magnitudes [B, F, Q] in the kernel's order of f32 operations."""
    c = emulate_k1_coeffs(x, w1, b1, w2c, b2, lp)
    m = torch.zeros((x.shape[0], w1.shape[0], va_q.shape[2]))
    for j in range(c.shape[2]):
        m = _fma32(c[:, :, j, None], va_q[None, :, j, :], m)
    return m + off_q[None]


@pytest.mark.parametrize("lp", [32, 16])
def test_k1_summation_order_matches_plain_and_float64(lp):
    """On the production artifact and the main path's grid, inside the
    trained range, the kernel's order agrees with the plain K1 within ATOL.
    Against a float64 evaluation it is no less accurate than the plain
    version: in the coefficients c, which the split of H decides (max
    error), and in the magnitudes (RMS error). The magnitudes' max error is
    not compared: it is set by the f32 rounding of the 10-term projection,
    which both versions share and whose extreme over ~80,000 outputs moves
    by 2x from one draw of x to the next for either order."""
    svd = SVDModelData.load(ART, device="cpu")
    t_days = torch.tensor(np.geomspace(0.01, 14.0, 150), dtype=torch.float32)
    va_q, off_q, inside = svd.operator_rankc(t_days)
    assert 0 < int(inside.sum()) < len(t_days)
    x = torch.from_numpy(np.random.default_rng(31).uniform(
        0.0, 1.0, (64, svd.w1.shape[1])).astype(np.float32))
    mlp = (svd.w1, svd.b1, svd.w2, svd.b2)
    ops = (*mlp, va_q, off_q)
    plain = svd_kernel.svd_surrogate_mags_plain(x, *ops)[:, :, inside]
    emu = emulate_k1(x, *ops, lp=lp)[:, :, inside]
    exact = svd_kernel.svd_surrogate_mags_plain(
        x.double(), *(a.double() for a in ops))[:, :, inside]
    assert emu.shape == plain.shape == (64, svd.w1.shape[0],
                                        int(inside.sum()))
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), rtol=0, atol=ATOL)

    def coeffs(xx, w1, b1, w2c, b2):     # the plain version's first layers
        hid = torch.relu(torch.einsum("bp,fph->bfh", xx, w1) + b1[None])
        return torch.einsum("bfh,fhc->bfc", hid, w2c) + b2[None]

    c_exact = coeffs(x.double(), *(a.double() for a in mlp))
    c_err_plain = float((coeffs(x, *mlp).double() - c_exact).abs().max())
    c_err_emu = float((emulate_k1_coeffs(x, *mlp, lp=lp).double()
                       - c_exact).abs().max())

    def rms(a):
        return float((a.double() - exact).pow(2).mean().sqrt())

    print(f"LP={lp}: c max err kernel {c_err_emu:.3e} plain "
          f"{c_err_plain:.3e}; mags rms kernel {rms(emu):.3e} plain "
          f"{rms(plain):.3e}")
    assert c_err_emu <= c_err_plain
    assert rms(emu) <= rms(plain)


# --- the sparse Bu2019lm of the joint path: K1 at P = 2, H = 128 ----------
SPARSE = "artifacts/Bu2019lm_sparse_svd.npz"
# config 5's EM grid (geomspace(--em-tmin, --em-tmax, 100)), inside the
# trained range [0.2, 14] d
SPARSE_T_DAYS = np.geomspace(0.2, 14.0, 100)


@pytest.fixture(scope="module")
def sparse_eval():
    return _SVDFastEval(JaxSVDModelData.load(SPARSE))


@pytest.mark.parametrize("batch", [1, 128, 200])
def test_plain_k1_matches_pallas_on_the_sparse_surrogate(sparse_eval, batch):
    """P = 2, H = 128, C = 10, F = 9, Q = 100: the plain K1 against the
    Pallas kernel in interpret mode and the JAX rank-C eval, atol 1e-4
    mag."""
    ev = sparse_eval
    assert ev._w1_stack.shape[1:] == (2, 128)
    va_q, off_q, inside = ev.operator_rankc(SPARSE_T_DAYS)
    assert inside.all()
    x = np.random.default_rng(batch + 1).uniform(
        0.0, 1.0, (batch, 2)).astype(np.float32)
    ops = (ev._w1_stack, ev._b1_stack, ev._w2c, ev._b2c, va_q, off_q)
    pallas = np.asarray(svd_surrogate_mags_pallas(
        jnp.asarray(x), *ops, interpret=True))
    core, _ = ev._rankc_fn(SPARSE_T_DAYS)
    rankc = np.asarray(jax.vmap(core)(jnp.asarray(x)))
    got = svd_kernel.svd_surrogate_mags(_t(x), *[_t(a) for a in ops]).numpy()
    assert got.shape == (batch, 9, 100)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, rankc, rtol=0, atol=ATOL)


@pytest.mark.parametrize("lp", [32, 16])
def test_k1_summation_order_on_the_sparse_surrogate(lp):
    """At H = 128 the 8 warps have four 32-unit chunks: warps 4-7 keep zero
    partial sums, which the fixed reduction adds exactly (x + 0 = x). The
    kernel's order on the sparse surrogate agrees with the plain K1 within
    ATOL, is no less accurate than it against float64 in the coefficients,
    and equals the order with the four idle warps left out bit for bit."""
    svd = SVDModelData.load(SPARSE, device="cpu")
    va_q, off_q, inside = svd.operator_rankc(
        torch.tensor(SPARSE_T_DAYS, dtype=torch.float32))
    assert inside.all() and svd.w1.shape[1:] == (2, 128)
    x = torch.from_numpy(np.random.default_rng(32).uniform(
        0.0, 1.0, (64, 2)).astype(np.float32))
    mlp = (svd.w1, svd.b1, svd.w2, svd.b2)
    emu = emulate_k1(x, *mlp, va_q, off_q, lp=lp)
    plain = svd_kernel.svd_surrogate_mags_plain(x, *mlp, va_q, off_q)
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), rtol=0,
                               atol=ATOL)
    c_emu = emulate_k1_coeffs(x, *mlp, lp=lp)
    hid = torch.relu(torch.einsum("bp,fph->bfh", x.double(),
                                  svd.w1.double()) + svd.b1.double()[None])
    c_exact = torch.einsum("bfh,fhc->bfc", hid, svd.w2.double()) \
        + svd.b2.double()[None]
    hid32 = torch.relu(torch.einsum("bp,fph->bfh", x, svd.w1)
                       + svd.b1[None])
    c_plain = torch.einsum("bfh,fhc->bfc", hid32, svd.w2) + svd.b2[None]
    assert float((c_emu.double() - c_exact).abs().max()) <= \
        float((c_plain.double() - c_exact).abs().max())
    # the four busy warps alone, in order, then b2
    sub = CHUNK // lp
    hid = svd.b1[None].expand(64, -1, -1)
    for p in range(2):
        hid = _fma32(x[:, None, p, None], svd.w1[None, :, p, :], hid)
    hid = hid.clamp(min=0.0).reshape(64, 9, 4, sub, lp)
    w2 = svd.w2.reshape(9, 4, sub, lp, 10)
    part = torch.zeros((64, 9, 4, sub, 10))
    for k in range(lp):
        part = _fma32(hid[..., k, None], w2[None, ..., k, :], part)
    o = 1
    while o < sub:
        part = part + part[:, :, :, torch.arange(sub) ^ o]
        o *= 2
    c = part[:, :, 0, 0]
    for w in range(1, 4):
        c = c + part[:, :, w, 0]
    assert torch.equal(c + svd.b2[None], c_emu)
