"""The k4_roofline reader on a synthetic trace and its counted inputs."""

from types import SimpleNamespace

import pytest
import torch

from portbench.metrics import k4_roofline
from portbench.trace import Trace

K4 = ("void (anonymous namespace)::grb_dynamics_kernel<false, true, true>"
      "((anonymous namespace)::Slots, float const*)")
K3 = "(anonymous namespace)::grb_eats_kernel(float const*)"


def reading(events, inputs, n_theta=48, n_r=256):
    """What k4_roofline reads: a trace of ``events`` (Chrome trace ``X``
    records, microseconds) and the counted calls' unit points."""
    return SimpleNamespace(
        trace=Trace(events), counted_inputs=lambda: inputs,
        reference=SimpleNamespace(n_theta=n_theta, n_r=n_r))


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_none_without_k4_launches():
    u = torch.zeros((8192, 8))
    events = [kernel(K3, 10.0 + 100.0 * i, 50.0) for i in range(4)]
    assert k4_roofline.read(reading(events, [u])) is None
    assert k4_roofline.read(SimpleNamespace(trace=None,
                                            reference=None)) is None


def test_matches_a_hand_count():
    """Calls of 8,192, 16,384 (two parts) and 8,192 rows: four K4 launches
    of 2 ms; the K3 launch between them is not read. At 48 x 256 (128
    subgrid radii) a part of 8,192 rows is bound by its bytes:
    4 x 8,192 x (6 x 48 x 128 + 128 + 48 + 9 + 15) = 1,214,513,152 bytes,
    0.36254 ms at 3.35 TB/s, against 8,192 x 48 x (256 x 74 + 128 x 61)
    = 10,519,314,432 operations, 0.15700 ms at 67 TFLOP/s: 4 x 0.36254 ms
    over 8 ms is 18.127%."""
    events = [kernel(K4, 1000.0 * i, 2000.0) for i in (0, 3, 6, 9)]
    events.append(kernel(K3, 2500.0, 400.0))
    inputs = [torch.zeros((8192, 8)), torch.zeros((16384, 8)),
              torch.zeros((8192, 8))]
    assert k4_roofline.work(8192, 48, 256) == (10_519_314_432,
                                               1_214_513_152)
    share = k4_roofline.read(reading(events, inputs))
    assert share == pytest.approx(18.12706, abs=1e-5)
    # fewer launches than counted parts: the first launches, paired in order
    assert k4_roofline.read(reading(events[:2], inputs)) == \
        pytest.approx(18.12706, abs=1e-5)


def test_counts_the_stride_one_grid_below_256_radii():
    ops, n_bytes = k4_roofline.work(10, 8, 128)
    assert ops == 10 * 8 * 128 * (74 + 61)
    assert n_bytes == 4 * 10 * (6 * 8 * 128 + 128 + 8 + 9 + 15)
