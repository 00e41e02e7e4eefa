#!/usr/bin/env python3
"""SASS instruction counts of the port's CUDA kernels, loop by loop.

Run on a machine with the CUDA toolkit (nvcc and cuobjdump), from the
repository root:

    python3 scripts/sass_loop_counts.py [--min 40] [--csrc DIR]

Each source in nmma_tpu_torch/csrc (or in DIR, e.g. the csrc of another
checkout) is compiled for sm_90a with the flags of
nmma_tpu_torch/_kernels.py into a cubin, disassembled with cuobjdump, and
for every kernel entry (one per template instance) the script prints one
JSON line per loop, a loop being the address range that a backward branch
closes: its static instruction count and its opcodes by count. A loop's
instructions are counted once, whether or not every path through it runs
on each trip. Nested loops are listed separately and the outer count holds
the inner one's instructions once.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from nmma_tpu_torch import _kernels  # noqa: E402

INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
BRANCH = re.compile(r"BRA (?:!?U?P\d, )?0x([0-9a-f]+)")


def opcode(text):
    """The opcode of one SASS instruction, without its guard predicate and
    modifiers (`@!P0 FFMA.SAT R1, ...` -> FFMA)."""
    words = text.split()
    word = words[1] if words[0].startswith("@") else words[0]
    return word.split(".")[0]


def functions(sass):
    """{kernel entry name: [(address, instruction text)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = INSTR.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loops(body, min_len):
    """[(start, end, instructions)] of the backward branches' ranges."""
    found = []
    for addr, text in body:
        m = BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            seg = [t for a, t in body if lo <= a <= addr]
            if len(seg) >= min_len:
                found.append((lo, addr, seg))
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--min", type=int, default=40,
                        help="shortest loop to list, in instructions")
    parser.add_argument("--csrc", default=_kernels.CSRC,
                        help="directory of the kernel sources")
    args = parser.parse_args()
    nvcc = _kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for lib, (source, _) in _kernels.KERNELS.items():
            flags = [f for f in _kernels.flags(lib)
                     if f not in ("-shared", "-Xcompiler", "-fPIC")]
            cubin = os.path.join(tmp, lib + ".cubin")
            subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                            os.path.join(args.csrc, source)],
                           check=True, capture_output=True)
            sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                  capture_output=True, text=True).stdout
            for name, body in functions(sass).items():
                for lo, hi, seg in loops(body, args.min):
                    ops = collections.Counter(opcode(t) for t in seg)
                    print(json.dumps({
                        "library": lib, "kernel": name, "loop": f"{lo:#x}-{hi:#x}",
                        "instructions": len(seg),
                        "opcodes": dict(ops.most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
