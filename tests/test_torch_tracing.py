"""The port's spans and counters (``nmma_tpu_torch/tracing.py``) and the
benchmark's readers of them (``portbench/program_spans.py``), on the CPU.

The likelihood is the tiny Me2017 analysis of
``__graft_entry__._tiny_analysis`` (its data and prior, on the CPU).
Held: without a profiler a call records no span, allocates nothing, and
the counters still count; under torch.profiler a call records the
span tree with parents and one call id, each span enclosing the ``cpu_op``
records of its own operators once mapped through the exported file's
``baseTimeNanoseconds``; logL and a short sampler run bit for bit with and
without tracing; ``profile_dir``'s file carries the spans; and the readers'
arithmetic on a synthetic trace.
"""

import dataclasses
import importlib
import json
import tracemalloc

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from nmma_tpu_torch import tracing
from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
from nmma_tpu_torch.inference import NestedSampler, NestedSamplerConfig
from nmma_tpu_torch.parallel import mesh as M
from nmma_tpu_torch.priors import parse_prior_dict
from portbench import program_spans
from portbench.trace import Trace

# __graft_entry__.py:16-36
TINY_PRIOR = (
    "log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
    "log10_vej = Uniform(minimum=-2., maximum=-0.5)\n"
    "beta = Uniform(minimum=1., maximum=5.)\n"
    "log10_kappa_r = Uniform(minimum=-1., maximum=2.)\n"
    "luminosity_distance = Uniform(minimum=1., maximum=200.)\n"
    "timeshift = Uniform(minimum=-0.4, maximum=0.4)\n"
)

CALL_SPANS = {"analysis.batched_logl", "priors.transform",
              "priors.constraint", "likelihood.log_likelihood",
              "likelihood.expected_mags", "model.detector", "model.source",
              "me2017.photometry"}


@pytest.fixture(scope="module")
def analysis():
    rng = np.random.default_rng(0)
    t = np.linspace(0.5, 8.0, 8)
    data = {f: {"time": t, "mag": 18.0 + rng.normal(0, 0.1, 8),
                "mag_error": np.full(8, 0.1)} for f in ("ztfg", "ztfr")}
    cfg = EMAnalysisConfig(
        model="Me2017", trigger_time=0.0, n_tsteps=32, tmax=12.0,
        error_budget=1.0,
        sampler=NestedSamplerConfig(nlive=64, n_delete=8, walks=4,
                                    chunk_size=1))
    return EMAnalysis(cfg, data=data, priors=parse_prior_dict(TINY_PRIOR),
                      device="cpu")


@pytest.fixture
def rows(analysis):
    u = np.random.default_rng(1).uniform(0.2, 0.8,
                                         (64, analysis.priors.ndim))
    return torch.from_numpy(u.astype(np.float32))


def test_off_records_nothing_allocates_nothing_and_counts(
        analysis, rows, tmp_path, monkeypatch):
    tracing.clear()
    assert not tracing.recording()
    analysis.batched_logl(rows)
    assert tracing.records() == []
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with tracing.span("ns.walk_step"):
                pass
        grown = sum(s.size_diff for s in tracemalloc.take_snapshot()
                    .compare_to(before, "filename")
                    if s.traceback[0].filename == tracing.__file__)
    finally:
        tracemalloc.stop()
    assert grown == 0
    assert tracing.span("a") is tracing.span("b")

    # a one-rank gloo group: shard_logl counts its collective
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        sharded = M.shard_logl(analysis.batched_logl,
                               M.make_mesh(device="cpu"))
        tracing.reset()
        for _ in range(3):
            sharded(rows)
    finally:
        dist.destroy_process_group()
    assert tracing.counter(tracing.MESH_COLLECTIVES) == 3
    assert tracing.records() == []
    tracing.reset(tracing.MESH_COLLECTIVES)
    assert tracing.counter(tracing.MESH_COLLECTIVES) == 0


def test_profiler_records_the_span_tree_on_its_clock(analysis, rows,
                                                     tmp_path):
    want = analysis.batched_logl(rows)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        got = [analysis.batched_logl(rows) for _ in range(2)]
    assert not tracing.recording()
    for g in got:
        assert torch.equal(g, want)
    spans = tracing.records()
    assert tracing.dropped() == 0
    calls = [s for s in spans if s.name == tracing.LOGL_CALL]
    assert [s.rows for s in calls] == [64, 64]
    assert calls[1].call == calls[0].call + 1
    by_id = {s.id: s for s in spans}
    for call in calls:
        mine = [s for s in spans if s.call == call.call]
        assert {s.name for s in mine} == CALL_SPANS
        for s in mine:
            if s is not call:
                parent = by_id[s.parent]
                assert parent.call == call.call
                assert parent.start_ns <= s.start_ns <= s.end_ns \
                    <= parent.end_ns
    assert by_id[next(s for s in spans if s.name == "model.source").parent
                 ].name == "model.detector"

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    assert base == tracing.trace_base_ns(spans[0].start_ns)
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    for s in spans:
        lo = tracing.trace_us(s.start_ns, base)
        hi = tracing.trace_us(s.end_ns, base)
        inside = [(a, b) for a, b in ops if lo <= a < hi]
        assert inside, s.name
        # no operator begun in the span outlives it, none begun before
        # ends inside it
        assert all(b <= hi for a, b in inside), s.name
        assert not [(a, b) for a, b in ops if a < lo < b < hi], s.name


def test_profile_dir_is_bit_for_bit_and_carries_the_spans(analysis,
                                                          tmp_path):
    cfg = dataclasses.replace(analysis.config.sampler, max_iter=3, seed=7)

    def run(config):
        return NestedSampler(analysis.batched_logl, analysis.priors.ndim,
                             config, device="cpu").run(verbose=False)

    plain = run(cfg)
    tracing.clear()
    traced = run(dataclasses.replace(cfg, profile_dir=str(tmp_path)))
    for f in ("samples_u", "logl", "logw", "log_x"):
        np.testing.assert_array_equal(getattr(traced, f), getattr(plain, f))
    assert (traced.logz, traced.ncall) == (plain.logz, plain.ncall)

    with open(tmp_path / "nested_sampler_it1.json") as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    names = {e["name"] for e in spans}
    # the chunk read follows the traced chunk
    assert {"ns.iteration", "ns.select", "ns.cholesky",
            "ns.walk_step"} | CALL_SPANS == names
    its = [e for e in spans if e["name"] == "ns.iteration"]
    assert [e["args"]["iteration"] for e in its] == [1]
    ops = [e["ts"] for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert its[0]["ts"] <= min(ops)
    walks = [e for e in spans if e["name"] == "ns.walk_step"]
    assert len(walks) == cfg.walks
    assert all(e["args"]["iteration"] == 1 for e in walks)


# -- the readers, on a synthetic trace (microseconds) --------------------------

def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(name, at, ran, dur, corr):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 4, corr),
            _x("kernel", name, ran, dur, corr)]


class _Reading:
    def __init__(self, trace):
        self.trace = trace


def synthetic():
    """A slice that opens (after a 0.1 s margin) inside iteration 0, holds
    iteration 1 whole, the chunk read after it, and iteration 2's start."""
    m = 200_000.0
    ev = _launch("margin", 0, 10, 10, 1)
    # iteration 0's tail: its own span began before the profiler
    ev += _launch("elementwise", m + 1100, m + 1110, 300, 2)
    # iteration 1: grb.stage1's kernel runs after the span has closed,
    # K3 after it; a 20 us gap inside the call, 50 us in the walk step
    ev += _launch("stage1", m + 2200, m + 2210, 300, 3)
    ev += _launch("grb_eats_kernel", m + 2400, m + 2510, 90, 4)
    ev += _launch("tail", m + 2590, m + 2620, 30, 5)
    ev += _launch("where", m + 2650, m + 2700, 100, 6)
    # the chunk read: a sync, then a 400 us gap put down to it
    ev += [_x("cuda_runtime", "cudaStreamSynchronize", m + 3050, 100)]
    ev += _launch("topk", m + 3180, m + 3200, 50, 7)
    # iteration 2, after the counted window
    ev += _launch("select", m + 3310, m + 3350, 20, 8)
    ev += [_x("cuda_runtime", "cudaStreamSynchronize", m + 3320, 5)]
    spans = [("analysis.batched_logl", 1, -1, 1050, 1400),
             ("ns.walk_step", 2, -1, 1450, 1900),
             ("ns.iteration", 10, -1, 2000, 3000),
             ("ns.walk_step", 11, 10, 2050, 2900),
             ("analysis.batched_logl", 12, 11, 2100, 2640),
             ("grb.stage1", 13, 12, 2150, 2300),
             ("kernel.k3", 14, 12, 2390, 2410),
             ("ns.chunk_read", 20, -1, 3000, 3300),
             ("ns.iteration", 30, -1, 3300, 4000)]
    base = tracing.trace_base_ns(1_790_857_026 * 10**9 + 5 * 10**15)
    records = [tracing.SpanRecord(n, i, p, -1, -1, -1,
                                  base + int((m + s) * 1e3),
                                  base + int((m + e) * 1e3))
               for n, i, p, s, e in spans]
    return Trace(ev), records


def test_readers_on_a_synthetic_trace(monkeypatch):
    trace, records = synthetic()
    monkeypatch.setattr(tracing, "records", lambda: list(records))
    p = program_spans.of(_Reading(trace))
    assert p.iterations == 1
    assert p.window_us == pytest.approx(1300.0)
    # by correlation: the stage-1 kernel ran after its span had closed
    busy = 390 + 30 + 100 + 50
    assert p.busy_share({"grb.stage1"}) == pytest.approx(300 / busy)
    assert p.busy_share({"kernel.k3"}) == pytest.approx(90 / busy)
    # the gap inside the call, and the walk step's and chunk read's
    assert p.idle_share({program_spans.LOGL_CALL}) == \
        pytest.approx(20 / 1300)
    assert p.idle_share(program_spans.SAMPLER,
                        {program_spans.LOGL_CALL}) == \
        pytest.approx(450 / 1300)
    # iteration 0's tail and iteration 2's sync are outside the window
    assert p.syncs_per_iteration() == 1.0
    call = program_spans.LOGL_CALL
    assert p.table()[call][:2] == [pytest.approx(0.03), 1]
    assert p.table(everywhere=True)[call][:2] == [pytest.approx(0.33), 2]
    # a run that ends after the chunk: the window runs to the slice's end
    monkeypatch.setattr(tracing, "records", lambda: list(records[:-1]))
    p = program_spans.of(_Reading(trace))
    assert (p.lo, p.hi) == (trace.t0 + 890, trace.t1)
    assert p.syncs_per_iteration() == 1.0
    monkeypatch.setattr(tracing, "records", lambda: list(records))
    values = {}
    for name in ("stage1_share", "logl_idle_share", "sampler_idle_share",
                 "host_syncs_per_iter"):
        values[name] = importlib.import_module(
            f"portbench.metrics.{name}").read(_Reading(trace))
    assert values == pytest.approx({
        "stage1_share": 100 * 300 / busy,
        "logl_idle_share": 100 * 20 / 1300,
        "sampler_idle_share": 100 * 450 / 1300, "host_syncs_per_iter": 1.0})


def test_readers_read_nothing_without_spans(monkeypatch):
    trace, _ = synthetic()
    monkeypatch.setattr(tracing, "records", lambda: [])
    from portbench.metrics import blackbody_share
    assert blackbody_share.read(_Reading(trace)) is None
    assert blackbody_share.read(_Reading(None)) is None
