"""A configuration, a traffic mix, a program and a per-layer metric added
from a temporary folder load and run without an edit of the harness."""

import json
import os

import torch

from portbench import run
from portbench.spec import Spec
from portbench.tests.small import TINY, small_config

READER = '''
def read(r):
    return float(len(r.spans.rows))
'''

# a program of a later cell: the EM analysis, with its calls counted
PROGRAM = '''
from portbench.programs import em

CALLS = []


def build(spec, *args):
    logl, ndim, scfg = em.build(spec, *args)

    def counted(u):
        CALLS.append(u.shape[0])
        return logl(u)
    spec.config["calls_seen"] = CALLS
    return counted, ndim, scfg
'''


def test_new_files_run_without_an_edit(tmp_path):
    folder = tmp_path / "later"
    for kind in ("configs", "traffic", "metrics", "programs"):
        (folder / kind).mkdir(parents=True)
    cfg = small_config("me2017")
    cfg["name"] = "me2017_ztf_gr"
    cfg["filters"] = ["ztfg", "ztfr"]
    cfg["program"] = "counted_em"
    (folder / "configs" / "me2017_ztf_gr.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "tiny_b8.json").write_text(json.dumps(
        {**TINY, "name": "tiny_b8", "n_delete": 8}))
    (folder / "metrics" / "calls_made.py").write_text(READER)
    (folder / "programs" / "counted_em.py").write_text(PROGRAM)
    bench = {"workloads": [{"name": "me2017_ztf_gr.tiny_b8",
                            "config": "me2017_ztf_gr", "traffic": "tiny_b8",
                            "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "calls_made", "unit": "calls"}]}
    spec = Spec("me2017_ztf_gr.tiny_b8", benchmark=bench,
                dirs=[str(folder)])
    assert spec.config["filters"] == ["ztfg", "ztfr"]
    assert spec.traffic["n_delete"] == 8
    line = run.run_rank(spec, 2 ** 35 + 9, 1.0, True, torch.device("cpu"),
                        0.0)
    assert line["correct"], line["checks"]
    assert line["metrics"]["calls_made"]["value"] >= 1 + TINY["walks"]
    # the warm-up's calls and the window's went through the added program
    assert len(spec.config["calls_seen"]) > \
        line["metrics"]["calls_made"]["value"]
    assert os.path.isdir(folder)
