"""The port's native table loader (``nmma_tpu_torch/native.py``) and the
readers that go through it, against ``np.loadtxt`` and the JAX package.

Both parsers round each decimal to the nearest double, so the native
loader equals ``np.loadtxt`` bit for bit. Where ``native/libnmma_native.so``
does not load, the port compiles ``native/fast_loader.cpp`` into its
``_build/`` directory and never writes into ``native/``; without a library
it falls back to ``np.loadtxt``, and ``loader()`` says which path ran. The
JAX package's readers run here through their ``np.loadtxt`` path.
"""

import os
import shutil

import numpy as np
import pytest

import nmma_tpu_torch.native as t_native


def write_tables(directory, n=12, seed=4):
    """Seeded whitespace tables: comment headers, blank lines, scientific
    notation, signs and integers, as bulla and EOS files carry."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        rows = int(rng.integers(1, 40))
        cols = int(rng.integers(1, 8))
        arr = rng.normal(size=(rows, cols)) * 10.0 ** rng.integers(
            -30, 30, size=(rows, cols))
        arr[0, 0] = float(rng.integers(-5, 5))
        path = os.path.join(directory, f"{i}.dat")
        with open(path, "w") as f:
            f.write("# t[days] a b c\n\n")
            for row in arr:
                f.write(" ".join(repr(float(v)) if k % 2 else f"{v:.17e}"
                                 for k, v in enumerate(row)) + "\n")
            f.write("\n")
        paths.append(path)
    return paths


@pytest.fixture()
def fresh(monkeypatch):
    """The loader with its resolution forgotten, restored afterwards."""
    for name in ("_lib", "_path"):
        monkeypatch.setattr(t_native, name, None)
    monkeypatch.setattr(t_native, "_tried", False)
    return t_native


def check_like_loadtxt(module, paths):
    many = module.parse_many(paths, n_threads=4)
    for path, arr in zip(paths, many):
        want = np.loadtxt(path, ndmin=2)
        one = module.parse_table(path)
        assert arr.dtype == one.dtype == np.float64
        np.testing.assert_array_equal(arr, want)
        np.testing.assert_array_equal(one, want)


def test_native_loader_equals_loadtxt(tmp_path):
    paths = write_tables(str(tmp_path))
    assert t_native.native_available()
    check_like_loadtxt(t_native, paths)


def test_builds_beside_the_port_when_the_native_library_is_absent(
        fresh, tmp_path, monkeypatch):
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler on this host")
    before = sorted(os.listdir(t_native.NATIVE_DIR))
    monkeypatch.setattr(fresh, "NATIVE_LIB", str(tmp_path / "absent.so"))
    monkeypatch.setattr(fresh, "BUILD_DIR", str(tmp_path / "_build"))
    assert fresh.native_available()
    assert fresh.loader().startswith(str(tmp_path / "_build"))
    check_like_loadtxt(fresh, write_tables(str(tmp_path / "tables")))
    assert sorted(os.listdir(t_native.NATIVE_DIR)) == before


def test_falls_back_to_loadtxt(fresh, tmp_path, monkeypatch):
    monkeypatch.setattr(fresh, "NATIVE_LIB", str(tmp_path / "absent.so"))
    monkeypatch.setattr(fresh, "_built_library", lambda: None)
    assert not fresh.native_available()
    assert fresh.loader() == "np.loadtxt"
    check_like_loadtxt(fresh, write_tables(str(tmp_path)))


@pytest.fixture()
def jax_loadtxt(monkeypatch):
    """The JAX package's readers on their np.loadtxt path."""
    import nmma_tpu.native as j_native
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_tried", True)


def test_readers_match_jax(tmp_path, jax_loadtxt):
    """read_bulla_grid, read_standard_grid_file and load_macro_eos_set on
    the same files through both packages."""
    from nmma_tpu.eos import load_macro_eos_set as j_macro
    from nmma_tpu.training.grids import read_standard_grid_file as j_std
    from nmma_tpu.training.svd import read_bulla_grid as j_bulla
    from nmma_tpu_torch.eos import load_macro_eos_set as t_macro
    from nmma_tpu_torch.training.grids import \
        read_standard_grid_file as t_std
    from nmma_tpu_torch.training.svd import read_bulla_grid as t_bulla
    from nmma_tpu_torch.training.svd import write_bulla_grid

    rng = np.random.default_rng(6)
    filters = ["ztfg", "ztfr", "ztfi"]
    params = {"log10_mej_dyn": rng.uniform(-3, -1, 8),
              "log10_mej_wind": rng.uniform(-2, -0.5, 8),
              "KNphi": rng.uniform(15, 75, 8),
              "KNtheta": rng.uniform(0, 90, 8)}
    t = np.geomspace(0.1, 14.0, 30)
    mags = rng.uniform(-17, -12, (8, 3, 30))
    files = write_bulla_grid(str(tmp_path / "bulla"), "Bu2019lm", params, t,
                             mags, filters)
    want, want_names, want_filters = j_bulla(files, model="Bu2019lm")
    got, names, got_filters = t_bulla(files, model="Bu2019lm")
    assert names == want_names and got_filters == want_filters
    for g, w in zip(got, want):
        assert g["params"] == w["params"]
        np.testing.assert_array_equal(g["t"], w["t"])
        for f in filters:
            np.testing.assert_array_equal(g["mags"][f], w["mags"][f])

    std = tmp_path / "standard.dat"
    np.savetxt(std, rng.normal(size=(20, 10)))
    j_cols, t_cols = j_std(str(std)), t_std(str(std))
    assert list(t_cols) == list(j_cols)
    for k in j_cols:
        np.testing.assert_array_equal(t_cols[k], j_cols[k])

    macro = tmp_path / "macro"
    macro.mkdir()
    for i in range(4):
        m = np.linspace(0.5, 2.0 + 0.1 * i, 60)
        r = 12.0 + 0.3 * i - 0.5 * (m - 1.4) ** 2
        lam = 400.0 * (1.4 / m) ** 6
        np.savetxt(macro / f"{i + 1}.dat", np.column_stack([r, m, lam]))
    j_set, t_set = j_macro(str(macro)), t_macro(str(macro))
    assert t_set.n_eos == j_set.n_eos == 4
    for name in ("radii", "tov_mass", "r14"):
        np.testing.assert_array_equal(getattr(t_set, name),
                                      np.asarray(getattr(j_set, name)),
                                      err_msg=name)
