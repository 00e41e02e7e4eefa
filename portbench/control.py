"""The readings that the limits of ``correct`` are set from.

    python portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (a window of
``--seconds``), with the numbers of ``check.py`` read twice on the same
rows: the program against the plain reference (the lower reading), and the
reference computed one precision lower, put in the program's place,
against the reference (the control: ``bf16`` and ``tf32``). One JSON line a
seed. The benchmark's own runs never run this.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.spec import Spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+", default=["bf16", "tf32"])
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"needs {spec.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.time()
        if spec.chips == 1:
            line = run.run_rank(spec, seed, args.seconds, False,
                                torch.device("cuda", 0), t,
                                controls=tuple(args.controls))
        else:
            line = run.run_ranks(spec, seed, args.seconds, False, t_start=t,
                                 controls=tuple(args.controls))
        print(json.dumps({"workload": spec.name, "seed": seed,
                          "program": {k: v["value"] for k, v in
                                      line["checks"].items()},
                          "controls": line["controls"],
                          "correct": line["correct"],
                          "metrics": line["metrics"],
                          "runs": line["runs"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
