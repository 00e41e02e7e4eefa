"""The count files against the smoke's bounds at B = 8192 (chip_smoke.py
``[k1]`` and ``[k2]`` print 0.0664 and 0.1689 ms), and K3's count of the
queries in range on real stage-1 rows."""

import json
import os

import pytest
import torch

from portbench import inputs, peaks
from portbench.counts import bu2019lm, me2017, trpi2018
from portbench.reference import trpi2018 as ref_trpi
from portbench.spec import HERE, ROOT


def test_k1_bound_at_8192():
    ops, n_bytes = bu2019lm.k1_work(8192, 9, 4, 2048, 10, 150)
    assert peaks.roofline_ms(ops, n_bytes) == pytest.approx(0.0664,
                                                            abs=5e-5)


def test_k2_bound_at_8192():
    ops, n_bytes = me2017.k2_work(8192, 150)
    assert peaks.roofline_ms(ops, n_bytes) == pytest.approx(0.1689,
                                                            abs=5e-5)


def test_k3_counts_the_rows_it_is_given(tmp_path):
    with open(os.path.join(HERE, "configs", "trpi2018.json")) as f:
        cfg = json.load(f)
    cfg["resolution"] = {"n_theta": 8, "n_phi": 4, "n_r": 128}
    ref = ref_trpi.Reference(cfg)
    data = str(tmp_path / "p.dat")
    inputs.photometry(cfg, ref_trpi, 7, data, "cpu", ROOT)
    ref.photometry.load(data)
    u = torch.rand((16, len(ref.photometry.sampled)),
                   generator=torch.Generator().manual_seed(3))
    ops = trpi2018.stage1_operands(ref, u)
    in_range = trpi2018.queries_in_range(ops)
    assert 0 < in_range <= 16 * 8 * 4 * 64
    (n_ops, n_bytes), = trpi2018.kernel_work(ref, u)
    # the map of every (row, ring, phi, r) is the least that is counted
    assert n_ops > 16 * 8 * 4 * 128 * trpi2018.K3_OPS_MAP
    assert n_bytes > 0
    assert trpi2018.step_ops(ref, u, n_ops) > n_ops
