"""The k5_roofline reader on a synthetic trace and its counted inputs."""

from types import SimpleNamespace

import pytest
import torch

from portbench.metrics import k5_roofline
from portbench.trace import Trace

K5 = ("void (anonymous namespace)::bb_photometry_kernel<true>(float const*, "
      "float const*, float const*, float const*, float const*, float*, int, "
      "int, int, float)")
K2 = ("(anonymous namespace)::me2017_dynamics_kernel(float const*, float "
      "const*, float const*, float*, float*, int, int)")


def reading(events, inputs, n_f=9, n_k=9, n_t=150):
    """What k5_roofline reads: a trace of ``events`` (Chrome trace ``X``
    records, microseconds), the counted calls' unit points and the
    reference's photometry shapes."""
    ph = SimpleNamespace(nu_nodes=torch.zeros((n_f, n_k)),
                         sample_times=torch.zeros(n_t))
    return SimpleNamespace(
        trace=Trace(events), counted_inputs=lambda: inputs,
        reference=SimpleNamespace(photometry=ph))


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_none_without_k5_launches():
    """The parent's trace: K2 and eager kernels, no K5."""
    u = torch.zeros((8192, 6))
    events = [kernel(K2, 10.0 + 100.0 * i, 50.0) for i in range(4)]
    events.append(kernel("void at::native::elementwise_kernel<128, 4>",
                         500.0, 80.0))
    assert k5_roofline.read(reading(events, [u])) is None
    assert k5_roofline.read(SimpleNamespace(trace=None,
                                            reference=None)) is None


def test_matches_a_hand_count():
    """Calls of 8,192, 16,384 (two parts) and 8,192 rows: four K5 launches
    of 0.3 ms; the K2 launch between them is not read. At F = K = 9 and
    T = 150 a part of 8,192 rows is bound by its operations:
    8,192 x 150 x (21 + 81 x 18) = 1,817,395,200, 0.0271253 ms at 67
    TFLOP/s, against 4 x (2 x 8,192 x 150 + 150 + 8,192 x 81 + 81 + 8,192
    x 9 x 150) = 56,722,332 bytes, 0.0169320 ms at 3.35 TB/s: 4 x
    0.0271253 ms over 1.2 ms is 9.04177%."""
    events = [kernel(K5, 1000.0 * i, 300.0) for i in (0, 3, 6, 9)]
    events.append(kernel(K2, 2500.0, 400.0))
    inputs = [torch.zeros((8192, 6)), torch.zeros((16384, 6)),
              torch.zeros((8192, 6))]
    assert k5_roofline.work(8192, 9, 9, 150) == (1_817_395_200,
                                                 56_722_332)
    share = k5_roofline.read(reading(events, inputs))
    assert share == pytest.approx(100.0 * 1_817_395_200 / 67e12 * 1e3
                                  / 0.3, rel=1e-12)
    assert share == pytest.approx(9.04177, abs=1e-5)
    # fewer launches than counted parts: the first launches, paired in order
    assert k5_roofline.read(reading(events[:2], inputs)) == \
        pytest.approx(9.04177, abs=1e-5)


def test_bound_by_bytes_with_few_nodes():
    """One node a filter: the bytes bound the part."""
    ops, n_bytes = k5_roofline.work(100, 2, 1, 10)
    assert ops == 100 * 10 * (21 + 2 * 18)
    assert n_bytes == 4 * (2 * 100 * 10 + 10 + 100 * 2 + 2 + 100 * 2 * 10)
