"""Small cells for the CPU tests: the benchmark's configurations at few
rows (TrPi2018 at n_theta 8, n_phi 4, n_r 128, as the port's own CPU tests
run it), a tiny traffic mix, and a benchmark file that names them, all
written to a temporary folder that the harness searches after its own."""

import copy
import json
import os

from portbench.spec import HERE

TINY = {"name": "tiny", "nlive": 128, "n_delete": 16, "walks": 3,
        "dlogz": 0.1, "chunk_size": 2, "target_acceptance": 0.4,
        "trace_iterations": 2}
METRICS = ["sampler_share", "logl_call_ms_p95", "launches_per_call",
           "logl_mfu", "device_idle_share"]


def small_config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["name"] = name + "_small"
    cfg["reference"] = cfg["counts"] = name
    if "resolution" in cfg:
        cfg["resolution"] = {"n_theta": 8, "n_phi": 4, "n_r": 128}
    cfg["check"]["calls"] = 2
    cfg["check"]["dead_points"] = 32
    return cfg


def write_small(folder, names=("trpi2018", "me2017", "bu2019lm"),
                chips=1):
    """(benchmark dict, folder) with the cells ``<name>.tiny``."""
    os.makedirs(os.path.join(folder, "configs"), exist_ok=True)
    os.makedirs(os.path.join(folder, "traffic"), exist_ok=True)
    with open(os.path.join(folder, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    for name in names:
        with open(os.path.join(folder, "configs", name + "_small.json"),
                  "w") as f:
            json.dump(small_config(name), f)
    bench = {
        "workloads": [{"name": f"{n}.tiny", "config": f"{n}_small",
                       "traffic": "tiny", "chips": chips} for n in names],
        "end_to_end": [{"name": "dead_points_per_s", "unit": "points/s"},
                       {"name": "peak_mem_gib", "unit": "GiB"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": m, "unit": "%"} for m in METRICS],
    }
    return bench, folder
