"""The k6_roofline reader on a synthetic trace and its counted inputs."""

from types import SimpleNamespace

import pytest
import torch

from portbench.metrics import k6_roofline
from portbench.trace import Trace

K6 = ("void (anonymous namespace)::em_likelihood_kernel<0>(float const*, "
      "float const*, float const*, float const*, float const*, float const*, "
      "float const*, float const*, int const*, float const*, float const*, "
      "float const*, float const*, unsigned char const*, float const*, "
      "float const*, float*, long long, int, int, int, int, int, int)")
K5 = ("void (anonymous namespace)::bb_photometry_kernel<true>(float const*, "
      "float const*, float const*, float const*, float const*, float*, int, "
      "int, int, float)")


def reading(events, inputs, n_f=9, n_pad=10, n_obs=90, n_t=150):
    """What k6_roofline reads: a trace of ``events`` (Chrome trace ``X``
    records, microseconds), the counted calls' unit points and the
    reference's photometry shapes: ``n_obs`` valid entries of an
    ``n_f`` x ``n_pad`` data array."""
    valid = torch.zeros((n_f, n_pad), dtype=torch.bool)
    valid.view(-1)[:n_obs] = True
    ph = SimpleNamespace(valid=valid, sample_times=torch.zeros(n_t))
    return SimpleNamespace(
        trace=Trace(events), counted_inputs=lambda: inputs,
        reference=SimpleNamespace(photometry=ph))


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_none_without_k6_launches():
    """The parent's trace: K5 and eager kernels, no K6."""
    u = torch.zeros((8192, 6))
    events = [kernel(K5, 10.0 + 100.0 * i, 50.0) for i in range(4)]
    events.append(kernel("void at::native::elementwise_kernel<128, 4>",
                         500.0, 80.0))
    assert k6_roofline.read(reading(events, [u])) is None
    assert k6_roofline.read(SimpleNamespace(trace=None,
                                            reference=None)) is None


def test_bound_at_8192_rows_matches_a_hand_count():
    """me2017's shapes: 8,192 rows, 9 filters, 150 grid times, 10 entries
    a filter, all 90 valid. Operations: 8,192 x (9 x 150 x 5 + 150 x 2 +
    90 x (18 + 2 x 8)) = 82,821,120, 0.00123614 ms at 67 TFLOP/s; bytes:
    4 x 8,192 x (1,350 + 90 + 4 + 1) + 13 x 90 = 47,350,930, 0.0141346 ms
    at 3.35 TB/s, which bounds the part. Calls of 8,192, 16,384 (two parts)
    and 8,192 rows: four K6 launches of 0.05 ms; the K5 launch between
    them is not read."""
    assert k6_roofline.work(8192, 9, 150, 10, 90) == (82_821_120,
                                                      47_350_930)
    events = [kernel(K6, 1000.0 * i, 50.0) for i in (0, 3, 6, 9)]
    events.append(kernel(K5, 2500.0, 400.0))
    inputs = [torch.zeros((8192, 6)), torch.zeros((16384, 6)),
              torch.zeros((8192, 6))]
    share = k6_roofline.read(reading(events, inputs))
    assert share == pytest.approx(100.0 * 47_350_930 / 3.35e12 * 1e3
                                  / 0.05, rel=1e-12)
    assert share == pytest.approx(28.26921, abs=1e-5)
    # fewer launches than counted parts: the first launches, paired in order
    assert k6_roofline.read(reading(events[:2], inputs)) == \
        pytest.approx(28.26921, abs=1e-5)


def test_a_short_last_part_and_padding():
    """A call of 8,200 rows is two parts, of 8,192 and 8 rows; padding
    entries of the data cost bytes but no operations."""
    events = [kernel(K6, 0.0, 40.0), kernel(K6, 100.0, 10.0)]
    ops8, bytes8 = k6_roofline.work(8, 5, 64, 10, 47)
    assert ops8 == 8 * (5 * 64 * 5 + 64 * 2 + 47 * (18 + 2 * 6))
    assert bytes8 == 4 * 8 * (5 * 64 + 5 * 10 + 5) + 13 * 50
    share = k6_roofline.read(reading(events, [torch.zeros((8200, 8))],
                                     n_f=5, n_pad=10, n_obs=47, n_t=64))
    from portbench import peaks
    want = (peaks.roofline_ms(*k6_roofline.work(8192, 5, 64, 10, 47))
            + peaks.roofline_ms(ops8, bytes8)) / 0.05
    assert share == pytest.approx(100.0 * want, rel=1e-12)
