"""ctypes bindings of the native ASCII-table loader, with a numpy fallback.

Port of ``nmma_tpu/native.py``: ``parse_table`` / ``parse_many`` read
whitespace numeric tables (training grids, EOS tables) through
``native/fast_loader.cpp`` (mmap, a branch-light float scanner, a thread
pool over files). The library is ``native/libnmma_native.so`` when one
loads there; otherwise the port compiles the same source with the host's
C++ compiler into ``_build/`` (ignored by git; nothing is written into
``native/``). Without a compiler or a library every call reads with
``np.loadtxt(ndmin=2)``, whose shapes are the native loader's also for a
one-column table; ``native_available()`` and ``loader()`` say which path
runs. This is host I/O, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
NATIVE_LIB = os.path.join(NATIVE_DIR, "libnmma_native.so")
SOURCE = os.path.join(NATIVE_DIR, "fast_loader.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_path = None
_tried = False


def _built_library():
    """Compile fast_loader.cpp into _build/ (hash of the source and flags in
    the name, reused while unchanged); None without a compiler or source."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f"libnmma_native-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, path)
    return path


def _open(path):
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.nmma_parse_table.restype = ctypes.POINTER(ctypes.c_double)
    lib.nmma_parse_table.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.nmma_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.nmma_parse_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    return lib


def _load_library():
    global _lib, _path, _tried
    if _tried:
        return _lib
    _tried = True
    for candidate in (NATIVE_LIB, None):
        path = candidate if candidate is not None else _built_library()
        if path is None or not os.path.exists(path):
            continue
        _lib = _open(path)
        if _lib is not None:
            _path = path
            break
    return _lib


def native_available() -> bool:
    """True when the native loader reads the tables."""
    return _load_library() is not None


def loader() -> str:
    """The library that reads the tables, or 'np.loadtxt' for the
    fallback."""
    return _path if native_available() else "np.loadtxt"


def parse_table(path) -> np.ndarray:
    """One whitespace numeric table -> [rows, cols] float64 array."""
    lib = _load_library()
    if lib is None:
        return np.loadtxt(path, ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.nmma_parse_table(str(path).encode(), ctypes.byref(rows),
                               ctypes.byref(cols))
    if not ptr or rows.value == 0:
        return np.loadtxt(path, ndmin=2)
    arr = np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    lib.nmma_free(ptr)
    return arr


def parse_many(paths, n_threads=0) -> list:
    """Many tables read concurrently -> list of float64 arrays."""
    lib = _load_library()
    paths = [str(p) for p in paths]
    if lib is None:
        return [np.loadtxt(p, ndmin=2) for p in paths]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_data = (ctypes.POINTER(ctypes.c_double) * n)()
    out_rows = (ctypes.c_int64 * n)()
    out_cols = (ctypes.c_int64 * n)()
    lib.nmma_parse_many(c_paths, n, out_data, out_rows, out_cols,
                        int(n_threads))
    results = []
    for i in range(n):
        if out_data[i] and out_rows[i] > 0:
            arr = np.ctypeslib.as_array(
                out_data[i], shape=(out_rows[i], out_cols[i])).copy()
            lib.nmma_free(out_data[i])
            results.append(arr)
        else:
            results.append(np.loadtxt(paths[i], ndmin=2))
    return results
