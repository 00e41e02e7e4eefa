"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``; nothing includes PyTorch's headers,
so a build takes seconds rather than the minutes of
``torch.utils.cpp_extension.load``. Libraries go to ``_build/`` (ignored by
git) under a name that carries the hash of the source and the flags, and
are reused while that hash is unchanged. A missing ``nvcc`` or a failed
build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source file, {C function: (restype, argtypes)})
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "svd_mlp": ("svd_mlp.cu", {
        "nmma_svd_mlp_mags": (_I, [_P] * 8 + [_I] * 7 + [_P]),
        "nmma_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
    "me2017_dynamics": ("me2017_dynamics.cu", {
        "nmma_me2017_dynamics": (_I, [_P] * 5 + [_I] * 4 + [_P]),
        "nmma_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
    "grb_eats": ("grb_eats.cu", {
        "nmma_grb_eats": (_I, [_P] * 9 + [_I] * 8 + [_P]),
        "nmma_grb_eats_supported": (_I, [ctypes.c_longlong] + [_I] * 6),
        "nmma_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
}

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc's output (with ptxas's registers, stack and spills per kernel) of
# each library built by this process
REPORTS: dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on PATH, else under ``$CUDA_HOME`` or
    the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> str:
    source = os.path.join(CSRC, KERNELS[name][0])
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that have no current
    library, one ``nvcc`` per source, all started together. Returns
    {name: library path}; raises with nvcc's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    try:
        for name, path in paths.items():
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, KERNELS[name][0])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            output = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} (exit "
                              f"{proc.returncode}):\n{output}")
            else:
                # atomic: a concurrent process never loads a half-written
                # library
                os.replace(tmp, paths[name])
                REPORTS[name] = output
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C functions' signatures set;
    builds it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        for fn, (restype, argtypes) in KERNELS[name][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.nmma_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
