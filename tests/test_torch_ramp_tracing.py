"""The energy ramp's spans and counter (``models/grb.py:_e0_ramp_flux``,
``nmma_tpu_torch/tracing.py``) on the CPU, at n_theta 8, n_phi 4, n_r 128
with chunks of 50 folded rows.

Under torch.profiler a ramp call records one ``grb.ramp`` span (its live
points, rows and chunks), one ``grb.ramp.fold`` and one ``grb.ramp.chunk``
a chunk, with ``grb.stage1`` and the kernel's span inside each chunk (the
CPU's plain K3 stands in for the card's launch through a wrapper that
opens ``kernel.k3`` as ``ops/grb_kernel.py`` does). ``grb.ramp.chunks``
counts every chunk whether or not a profiler records; without one nothing
is recorded; TrPi2018 without the ramp records no ramp span."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nmma_tpu_torch.models.grb as TG
from nmma_tpu_torch import tracing
from nmma_tpu_torch.ops import grb_kernel

SMALL = dict(n_theta=8, n_phi=4, n_r=128)
CHUNK = 50
POINTS = 3
NAMES = ("thetaCore", "thetaWing", "inclination_EM", "log10_n0", "p",
         "log10_epsilon_e", "log10_epsilon_B", "xi_N", "d_L",
         "energy_exponential", "log10_Eend", "t_start",
         "injection_duration")
LO = (0.05, 0.3, 0.0, -3.0, 2.2, -1.5, -3.5, 1.0, 3.086e19, 0.8, 52.0, 1e4,
      1e6)
HI = (0.12, 0.4, 0.1, -1.0, 2.6, -0.8, -3.5, 1.0, 3.086e19, 1.4, 53.0, 5e4,
      3e6)
T_DAYS = torch.from_numpy(np.geomspace(0.05, 200.0, 20).astype(np.float32))
NU = torch.tensor([[5e14, 2.4e17, 6e9]]).expand(POINTS, -1)
RAMP = {"grb.ramp", "grb.ramp.fold", "grb.ramp.chunk"}


def params(ramp=True):
    theta = np.random.default_rng(7).uniform(LO, HI, (POINTS, len(NAMES)))
    p = {n: torch.from_numpy(theta[:, i].astype(np.float32))
         for i, n in enumerate(NAMES)}
    if not ramp:
        for k in TG._E0_RAMP_KEYS:
            del p[k]
        p["log10_E0"] = torch.full((POINTS,), 52.0)
    return p


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 50 rows, and K3's span and counter around the plain K3."""
    row_bytes = TG._STAGE1_ROW_TENSORS * 4 * SMALL["n_theta"] * SMALL["n_r"]
    monkeypatch.setattr(TG, "RAMP_CHUNK_BYTES", CHUNK * row_bytes)
    assert TG.ramp_chunk_rows(SMALL["n_theta"], SMALL["n_r"]) == CHUNK

    def launch(*ops):
        with tracing.span("kernel.k3", batch=ops[0]):
            out = grb_kernel.eats_flux_plain(*ops)
        tracing.count(tracing.K3_LAUNCHES)
        return out

    monkeypatch.setattr(grb_kernel, "eats_flux", launch)


def test_ramp_spans_nest_and_the_chunks_are_counted(small_chunks):
    rows = POINTS * 64
    chunks = math.ceil(rows / CHUNK)
    tracing.clear()
    tracing.reset()
    want = TG.trpi2018_mags(params(), T_DAYS, NU, **SMALL)
    assert tracing.records() == []
    assert tracing.counter(tracing.RAMP_CHUNKS) == chunks
    assert tracing.counter(tracing.K3_LAUNCHES) == chunks

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = TG.trpi2018_mags(params(), T_DAYS, NU, **SMALL)
    assert torch.equal(got, want)
    assert tracing.counter(tracing.RAMP_CHUNKS) == chunks
    spans = tracing.records()
    by_id = {s.id: s for s in spans}
    named = {n: [s for s in spans if s.name == n] for n in RAMP}
    ramp, = named["grb.ramp"]
    assert (ramp.points, ramp.rows, ramp.chunks) == (POINTS, rows, chunks)
    fold, = named["grb.ramp.fold"]
    assert fold.parent == ramp.id
    parts = sorted(named["grb.ramp.chunk"], key=lambda s: s.start_ns)
    assert [s.rows for s in parts] == [CHUNK] * (chunks - 1) + [
        rows - CHUNK * (chunks - 1)]
    assert all(s.parent == ramp.id for s in parts)
    assert fold.end_ns <= parts[0].start_ns
    inner = [s for s in spans if s.name == "grb.stage1"
             or s.name.startswith("kernel.")]
    assert sorted(s.name for s in inner) == \
        ["grb.stage1"] * chunks + ["kernel.k3"] * chunks
    for s in inner:
        part = by_id[s.parent]
        assert part.name == "grb.ramp.chunk"
        assert part.start_ns <= s.start_ns <= s.end_ns <= part.end_ns
    for s in parts + [fold]:
        assert ramp.start_ns <= s.start_ns <= s.end_ns <= ramp.end_ns
    tracing.clear()


def test_the_path_without_the_ramp_records_no_ramp_span(small_chunks):
    tracing.clear()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        TG.trpi2018_mags(params(ramp=False), T_DAYS, NU, **SMALL)
    names = {s.name for s in tracing.records()}
    assert "grb.stage1" in names
    assert not names & RAMP
    assert tracing.counter(tracing.RAMP_CHUNKS) == 0
    tracing.clear()
