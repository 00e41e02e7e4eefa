#!/usr/bin/env python3
"""Time K1 and K2 built from two source trees, in turns, on one card.

Run on a machine with one CUDA card and nvcc, from the repository root:

    python3 scripts/compare_kernels.py BASELINE_CSRC [--rounds 25]

BASELINE_CSRC is the csrc directory of another checkout (for instance the
parent commit unpacked with `git archive` into a git-ignored directory);
its kernels must have the C interface of nmma_tpu_torch/_kernels.py. Both
trees' K1 (svd_mlp.cu) and K2 (me2017_dynamics.cu) are built with the same
nvcc flags and fed the same operands: the production surrogate on the main
path's grid geomspace(0.01, 14, 150), and Me2017 operands of the smoke's
prior ranges. At B = 128 and 8192 each kernel is timed in the order
baseline, change, change, baseline: CUDA events around 10 back-to-back
launches, median of --rounds rounds, and torch.profiler's device time per
launch. One JSON line per (kernel, batch) gives every reading with the
card's name and power limit; before that, each tree's outputs are held
against the plain versions (K1 within 1e-4 mag, K2's r_photo bit for bit).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from nmma_tpu_torch import _kernels  # noqa: E402

KERNELS = {"svd_mlp": ("nmma_svd_mlp_mags", "svd_mlp_mags_kernel"),
           "me2017_dynamics": ("nmma_me2017_dynamics",
                               "me2017_dynamics_kernel")}


def build(csrc, tmp, tag):
    """{library: ctypes function} of the tree at ``csrc``."""
    procs, fns = {}, {}
    for lib in KERNELS:
        out = os.path.join(tmp, f"{tag}_{lib}.so")
        procs[lib] = (out, subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", out,
             os.path.join(csrc, _kernels.KERNELS[lib][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for lib, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {lib}:\n{log}")
        entry = KERNELS[lib][0]
        fn = getattr(ctypes.CDLL(out), entry)
        fn.restype, fn.argtypes = _kernels.KERNELS[lib][1][entry]
        fns[lib] = fn
    return fns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", help="csrc directory of the baseline")
    parser.add_argument("--rounds", type=int, default=25)
    args = parser.parse_args()
    import numpy as np
    import torch

    from nmma_tpu_torch.models import SVDModelData
    from nmma_tpu_torch.ops import me2017_kernel as k2
    from nmma_tpu_torch.ops import svd_kernel

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = "cuda"
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"baseline": build(os.path.abspath(args.baseline), tmp, "base"),
                 "change": build(_kernels.CSRC, tmp, "change")}
        svd = SVDModelData.load(chip_smoke.ARTIFACT, device=dev)
        t_days = torch.tensor(np.geomspace(0.01, 14.0, 150),
                              dtype=torch.float32, device=dev)
        va_q, off_q, _ = svd.operator_rankc(t_days)
        weights = (svd.w1, svd.b1, svd.w2, svd.b2, va_q, off_q)
        n_f, n_p, n_h = svd.w1.shape
        n_c, n_q = svd.w2.shape[2], va_q.shape[2]
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)

        def k1_call(fn, x, out):
            def call():
                code = fn(*[t.data_ptr() for t in (x, *weights)],
                          out.data_ptr(), x.shape[0], n_p, n_h, n_c, n_q,
                          n_f, 0, stream())
                if code:
                    raise RuntimeError(f"K1 launch failed: {code}")
            return call

        def k2_call(fn, ops, ltot, r_photo):
            def call():
                code = fn(*[t.data_ptr() for t in ops], ltot.data_ptr(),
                          r_photo.data_ptr(), ops[0].shape[1], k2.N_SHELLS,
                          ops[2].shape[1], 0, stream())
                if code:
                    raise RuntimeError(f"K2 launch failed: {code}")
            return call

        def k2_operands(n_b):
            u = torch.rand((4, n_b), generator=gen, device=dev)
            return k2.me2017_operands(
                -3.0 + 2.5 * u[0], -2.0 + 1.5 * u[1], 1.0 + 4.0 * u[2],
                10.0 ** (-1.0 + 3.0 * u[3]), t_days)

        for n_b in (128, 8192):
            x = torch.rand((n_b, n_p), generator=gen, device=dev)
            ops = k2_operands(n_b)
            mags_ref = svd_kernel.svd_surrogate_mags_plain(x, *weights)
            r_ref = k2.me2017_dynamics_plain(*ops)[1]
            calls = {}
            for tree, fns in trees.items():
                mags = torch.empty((n_b, n_f, n_q), device=dev)
                ltot = torch.empty((n_b, t_days.shape[0]), device=dev)
                r_photo = torch.empty_like(ltot)
                calls[("svd_mlp", tree)] = k1_call(fns["svd_mlp"], x, mags)
                calls[("me2017_dynamics", tree)] = k2_call(
                    fns["me2017_dynamics"], ops, ltot, r_photo)
                calls[("svd_mlp", tree)]()
                calls[("me2017_dynamics", tree)]()
                torch.cuda.synchronize()
                err = float((mags - mags_ref).abs().max())
                if not err <= 1e-4 or not torch.equal(r_photo, r_ref):
                    raise RuntimeError(f"{tree} disagrees with the plain "
                                       f"versions at B={n_b}: K1 {err}, K2 "
                                       f"r_photo "
                                       f"{int((r_photo != r_ref).sum())} off")
            for lib, (_, name) in KERNELS.items():
                row = {"kernel": lib, "batch": n_b, "card": card}
                for tree in ("baseline", "change", "change", "baseline"):
                    fn = calls[(lib, tree)]
                    row.setdefault(f"{tree}_event_ms", []).append(
                        chip_smoke.time_ms(torch, fn, rounds=args.rounds))
                    row.setdefault(f"{tree}_device_ms", []).append(
                        chip_smoke.kernel_device_ms(torch, fn, name))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
