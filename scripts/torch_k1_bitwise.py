#!/usr/bin/env python3
"""Check that K1 built from two source trees gives the same bits on one card.

Run on a machine with one CUDA card and nvcc, from the repository root:

    python3 scripts/torch_k1_bitwise.py BASELINE_CSRC

BASELINE_CSRC is the csrc directory of another checkout (for instance the
parent commit unpacked with `git archive` into a git-ignored directory);
its K1 must have the C interface of nmma_tpu_torch/_kernels.py. Both trees'
svd_mlp.cu are built with the same nvcc flags (scripts/compare_kernels.py's
`build`) and fed the same operands: the production surrogate (P = 4) on the
main path's grid geomspace(0.01, 14, 150), at B = 1, 128, 8192 and 8199. One
JSON line per batch says whether the two trees' magnitudes are equal bit for
bit, with the card's name and power limit; the script exits 1 if any batch
differs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

import chip_smoke  # noqa: E402
from nmma_tpu_torch import _kernels  # noqa: E402

BATCHES = (1, 128, 8192, 8199)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    from compare_kernels import build
    from nmma_tpu_torch.models import SVDModelData

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", help="csrc directory of the baseline")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_bitwise: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    svd = SVDModelData.load(chip_smoke.ARTIFACT, device=dev)
    t_days = torch.tensor(np.geomspace(0.01, 14.0, 150),
                          dtype=torch.float32, device=dev)
    va_q, off_q, _ = svd.operator_rankc(t_days)
    weights = (svd.w1, svd.b1, svd.w2, svd.b2, va_q, off_q)
    n_f, n_p, n_h = svd.w1.shape
    n_c, n_q = svd.w2.shape[2], va_q.shape[2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"baseline": build(os.path.abspath(args.baseline), tmp,
                                 "base")["svd_mlp"],
               "change": build(_kernels.CSRC, tmp, "change")["svd_mlp"]}
        for n_b in BATCHES:
            x = torch.rand((n_b, n_p), generator=gen, device=dev)
            mags = {}
            for tree, fn in fns.items():
                out = torch.empty((n_b, n_f, n_q), device=dev)
                code = fn(*[t.data_ptr() for t in (x, *weights)],
                          out.data_ptr(), n_b, n_p, n_h, n_c, n_q, n_f, 0,
                          stream)
                if code:
                    raise RuntimeError(f"{tree} K1 launch failed: {code}")
                mags[tree] = out
            torch.cuda.synchronize()
            equal = bool(torch.equal(mags["baseline"], mags["change"]))
            same = same and equal
            print(json.dumps({
                "kernel": "svd_mlp", "batch": n_b, "P": n_p, "card": card,
                "bitwise_equal": equal,
                "max_abs_diff": float((mags["baseline"]
                                       - mags["change"]).abs().max())}),
                flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
