"""One traced run of a benchmark cell, broken down by the port's spans.

    python scripts/portbench_spans.py --workload <cell> --seed <n> \
        [--seconds 20] [--out PATH]

Runs ``portbench/run.py``'s traced run of the cell on the CUDA card and
prints one JSON object: the result line's per-layer metrics; the traced
slice's whole iterations and counted window; per innermost span, the device
milliseconds and kernel launches it holds, the idle milliseconds whose gaps
fall under it and the host synchronisations, over the counted window and
over the whole slice (``null`` is what no span holds); the share of the
slice's kernel time held by a span; whether each launch of K1 to K6
lies inside its ``kernel.k*`` span, with the smallest margins; the least
lag from a launch to its kernel; spans a whole iteration; and the mean
time of the slice's likelihood calls (CUDA events).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

KERNELS = {"kernel.k1": "svd_mlp", "kernel.k2": "me2017_dynamics",
           "kernel.k3": "grb_eats", "kernel.k4": "grb_dynamics",
           "kernel.k5": "bb_photometry", "kernel.k6": "em_likelihood"}


def launches_inside(program, span_name, kernel):
    """(launches, inside their span, least margin before, after) in us."""
    n = inside = 0
    before = after = None
    for e, _ in program.device(everywhere=True):
        if e.get("cat") != "kernel" or kernel not in e["name"]:
            continue
        h = program.launch(e)
        if h is None:
            continue
        n += 1
        s = program.around(program.holder(h["ts"] + 0.5 * h["dur"]),
                           {span_name})
        if s is None or not (s.start <= h["ts"]
                             and h["ts"] + h["dur"] <= s.end):
            continue
        inside += 1
        b, a = h["ts"] - s.start, s.end - h["ts"] - h["dur"]
        before = b if before is None else min(before, b)
        after = a if after is None else min(after, a)
    return {"launches": n, "inside": inside, "least_us_before": before,
            "least_us_after": after}


def breakdown(reading, line):
    from portbench import program_spans

    program = program_spans.of(reading)
    out = {"metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "device": line["device"], "correct": line["correct"]}
    calls = reading.spans.durations_ms()
    out["slice_call_ms_mean"] = statistics.fmean(
        calls[i] for i in reading.slice_calls)
    if program is None:
        return out
    out["iterations"] = program.iterations
    out["window_ms"] = program.window_us / 1e3
    out["slice_ms"] = (reading.trace.t1 - reading.trace.t0) / 1e3
    for key, everywhere in (("window", False), ("slice", True)):
        out[key] = {str(k): [round(v[0], 4), v[1], round(v[2], 4), v[3]]
                    for k, v in sorted(program.table(everywhere).items(),
                                       key=lambda kv: -kv[1][0])}
    kern = [(e, s) for e, s in program.device(everywhere=True)
            if e.get("cat") == "kernel"]
    total = sum(e["dur"] for e, _ in kern)
    out["slice_kernel_ms"] = total / 1e3
    out["slice_kernel_held_share"] = sum(
        e["dur"] for e, s in kern if s is not None) / total
    out["launch_in_span"] = {k: launches_inside(program, k, v)
                             for k, v in KERNELS.items()}
    lags = [e["ts"] - program.launched_at(e) for e, _ in kern]
    out["least_launch_to_kernel_us"] = min(lags)
    spans = [s for s in program.spans if program.counted(s.start)]
    out["spans_per_iteration"] = len(spans) / program.iterations
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import run
    from portbench.spec import Spec

    readings = []

    class Kept(run.Reading):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            readings.append(self)

    run.Reading = Kept
    line = run.run_rank(Spec(args.workload), args.seed, args.seconds, True,
                        torch.device("cuda", 0), run.T_START)
    out = {"workload": args.workload, "seed": args.seed,
           **breakdown(readings[-1], line)}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
