"""The trpi2018_ramp configuration: a tiny cell of it runs to ``correct``
on the CPU; its K3 count at 4,096 folded rows meets chip_smoke.py
``[k3_rowq]``'s bound (0.1822 ms, by bytes); and ``k3_rowq_roofline``
reads the same on a synthetic trace whether a call's rows came in one K3
launch or in three."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from nmma_tpu_torch import tracing
from portbench import inputs, peaks, run
from portbench.counts import trpi2018_ramp as counts
from portbench.metrics import k3_rowq_roofline, ramp_glue_share
from portbench.reference import trpi2018_ramp as ref_ramp
from portbench.spec import HERE, ROOT, Spec
from portbench.tests.small import write_small
from portbench.trace import Trace

SEED = 2 ** 36 + 17
K3 = "(anonymous namespace)::grb_eats_kernel(float const*)"


def test_tiny_ramp_cell_is_correct(tmp_path):
    bench, folder = write_small(str(tmp_path / "bench"),
                                names=("trpi2018_ramp",))
    spec = Spec("trpi2018_ramp.tiny", benchmark=bench, dirs=[folder])
    line = run.run_rank(spec, SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert line["attempted"] > 0


def test_k3_count_at_4096_rows_meets_the_smoke_bound(tmp_path):
    with open(os.path.join(HERE, "configs", "trpi2018_ramp.json")) as f:
        cfg = json.load(f)
    ref = ref_ramp.Reference(cfg)
    inputs.photometry(cfg, ref_ramp, 7, str(tmp_path / "p.dat"), "cpu",
                      ROOT)
    ref.photometry.load(str(tmp_path / "p.dat"))
    u = torch.rand((64, len(ref.photometry.sampled)),
                   generator=torch.Generator().manual_seed(5))
    (n_ops, n_bytes), = counts.kernel_work(ref, u)
    # 64 live points x 64 nodes = 4,096 rows, bound by their bytes
    assert n_bytes / peaks.PEAK_BYTES > n_ops / peaks.PEAK_F32_FLOPS
    assert peaks.roofline_ms(n_ops, n_bytes) == pytest.approx(0.1822,
                                                              abs=5e-5)
    assert counts.step_ops(ref, u, n_ops) > n_ops


def _x(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _reading(launches_a_call, monkeypatch):
    """Three calls of 2, 5 and 3 rows in a synthetic slice, each call's K3
    time (300, 500, 200 us) split over ``launches_a_call`` launches, with
    a stage-1 kernel beside them; the counted inputs are the first two."""
    m = 200_000.0
    events, spans = [], []
    corr = 0
    for k, (start, k3_us) in enumerate(((1000, 300), (3000, 500),
                                        (5000, 200))):
        call_id = 10 * (k + 1)
        spans.append(("analysis.batched_logl", call_id, -1, start,
                      start + 1800))
        corr += 1
        events += [_x("cuda_runtime", "cudaLaunchKernel", m + start + 10, 4,
                      corr),
                   _x("kernel", "grb_dynamics_kernel", m + start + 20, 100,
                      corr)]
        for j in range(launches_a_call):
            corr += 1
            at = m + start + 200 + 400 * j
            events += [_x("cuda_runtime", "cudaLaunchKernel", at, 4, corr),
                       _x("kernel", K3, at + 10, k3_us / launches_a_call,
                          corr)]
            spans.append(("kernel.k3", call_id + 1 + j, call_id, at - 2,
                          at + 8))
    events = [_x("kernel", "margin", 0, 10, 0)] + events
    base = tracing.trace_base_ns(1_790_857_026 * 10**9 + 5 * 10**15)
    records = [tracing.SpanRecord(n, i, p, -1, -1, -1,
                                  base + int((m + s) * 1e3),
                                  base + int((m + e) * 1e3))
               for n, i, p, s, e in spans]
    monkeypatch.setattr(tracing, "records", lambda: list(records))
    work = SimpleNamespace(
        KERNEL="grb_eats",
        kernel_work=lambda ref, u: [(0.0, 1e9 * u.shape[0])])
    return SimpleNamespace(trace=Trace(events), counts=work, reference=None,
                           counted_inputs=lambda: [torch.zeros((2, 4)),
                                                   torch.zeros((5, 4))])


@pytest.mark.parametrize("launches", [1, 3])
def test_k3_rowq_roofline_does_not_depend_on_the_chunks(launches,
                                                        monkeypatch):
    r = _reading(launches, monkeypatch)
    # 7e9 bytes at 3.35 TB/s over the first two calls' 800 us of K3
    want = 100.0 * peaks.roofline_ms(0.0, 7e9) / 0.8
    assert k3_rowq_roofline.read(r) == pytest.approx(want, rel=1e-9)


def test_ramp_readers_read_nothing_without_their_spans(monkeypatch):
    r = _reading(1, monkeypatch)
    # no ns.iteration and no grb.ramp span: nothing to read
    assert ramp_glue_share.read(r) is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert k3_rowq_roofline.read(r) is None
    assert k3_rowq_roofline.read(SimpleNamespace(trace=None,
                                                 counts=None)) is None


def test_ramp_glue_share_on_a_synthetic_slice(monkeypatch):
    """One whole iteration holding a call: the fold's kernel, a chunk's
    ring sum and the concatenation (200 us) under the ramp's own spans;
    stage 1, K3 and a likelihood kernel (600 us) under theirs."""
    m = 200_000.0
    launches = [("opening", 900, 10), ("fold", 1150, 50),
                ("stage1", 1400, 200), ("k3", 1650, 300),
                ("ring_sum", 2400, 100), ("cat", 3000, 50),
                ("likelihood", 4500, 100), ("next", 5500, 10)]
    events = [_x("kernel", "margin", 0, 10, 0)]
    for corr, (name, at, dur) in enumerate(launches, start=1):
        events += [_x("cuda_runtime", "cudaLaunchKernel", m + at, 4, corr),
                   _x("kernel", name, m + at + 6, dur, corr)]
    spans = [("ns.iteration", 1, -1, 1000, 5000),
             ("analysis.batched_logl", 2, 1, 1050, 4900),
             ("grb.ramp", 3, 2, 1100, 4000),
             ("grb.ramp.fold", 4, 3, 1100, 1300),
             ("grb.ramp.chunk", 5, 3, 1300, 2600),
             ("grb.stage1", 6, 5, 1350, 1500),
             ("kernel.k3", 7, 5, 1600, 1700),
             ("ns.iteration", 8, -1, 5000, 6000)]
    base = tracing.trace_base_ns(1_790_857_026 * 10**9 + 5 * 10**15)
    records = [tracing.SpanRecord(n, i, p, -1, -1, -1,
                                  base + int((m + s) * 1e3),
                                  base + int((m + e) * 1e3))
               for n, i, p, s, e in spans]
    monkeypatch.setattr(tracing, "records", lambda: list(records))
    r = SimpleNamespace(trace=Trace(events))
    assert ramp_glue_share.read(r) == pytest.approx(100.0 * 200 / 800)
