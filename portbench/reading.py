"""What a per-layer metric reads from, once the window has closed.

A reader (``metrics/<name>.py``) has one function, ``read(r)``, that takes
a :class:`Reading` and returns the metric's value, or None when it finds
nothing to read (the harness then leaves the metric out of the line). The
shared reductions live here, so a reader is a few lines.
"""

from __future__ import annotations

import statistics

from . import peaks

# calls of the traced slice whose rows are counted for a kernel's work
COUNTED_CALLS = 8


class Reading:
    def __init__(self, spec, spans, trace, slice_calls, counts, reference,
                 chips):
        self.spec = spec
        self.spans = spans
        self.trace = trace                  # trace.Trace or None
        self.slice_calls = slice_calls      # range of traced call indices
        self.counts = counts
        self.reference = reference
        self.chips = chips
        self._dur = spans.durations_ms()
        self._gaps = spans.gaps_ms()

    # -- the spans, outside the traced slice --------------------------------
    def outside(self):
        """Indices of the calls outside the traced slice (the profiler
        slows the calls inside it)."""
        return [i for i in range(len(self._dur)) if i not in self.slice_calls]

    def call_ms(self):
        return [self._dur[i] for i in self.outside()]

    def sampler_share(self):
        """The window's device time outside the likelihood calls, as a share
        of the window, leaving out the slice and the two gaps around it."""
        sl = self.slice_calls
        gaps = [g for k, g in enumerate(self._gaps)
                if not (sl and sl.start <= k <= sl.stop)]
        calls = self.call_ms()
        total = sum(gaps) + sum(calls)
        return sum(gaps) / total if total > 0 else None

    def p95_call_ms(self):
        """Over the walk calls (the initial live set's calls are larger)."""
        walk = self.spec.traffic["n_delete"] // self.chips
        ms = [self._dur[i] for i in self.outside()
              if self.spans.rows[i] == walk]
        if len(ms) < 20:
            return None
        return statistics.quantiles(ms, n=20)[-1]

    def ms_per_row(self):
        rows = self.spans.rows
        keep = self.outside()
        n = sum(rows[i] for i in keep)
        return sum(self._dur[i] for i in keep) / n if n else None

    # -- the traced slice ---------------------------------------------------
    def counted_inputs(self):
        return [self.spans.inputs[i] for i in sorted(self.spans.inputs)]

    def kernel_roofline(self):
        """Counted bound over the device time of the configuration's kernel,
        launch by launch over the counted calls; None without a trace or
        without a launch of it."""
        if self.trace is None or self.counts is None:
            return None
        launches = self.trace.kernels(self.counts.KERNEL)
        inputs = self.counted_inputs()
        work = [w for u in inputs for w in self.counts.kernel_work(
            self.reference, u)]
        n = min(len(launches), len(work))
        if n == 0:
            return None
        bound = sum(peaks.roofline_ms(*w) for w in work[:n])
        device = sum(e["dur"] for e in launches[:n]) / 1e3
        return bound / device

    def step_mfu(self):
        """Operations counted for one call at the cell's per-call rows over
        the mean time of a call (rows-weighted, outside the slice), against
        the f32 peak."""
        inputs = self.counted_inputs()
        per_row = self.ms_per_row()
        if not inputs or per_row is None or self.counts is None:
            return None
        ops = []
        for u in inputs:
            k_ops = sum(w[0] for w in self.counts.kernel_work(
                self.reference, u))
            ops.append(self.counts.step_ops(self.reference, u, k_ops))
        rows = inputs[0].shape[0]
        return (sum(ops) / len(ops)) / (per_row * rows / 1e3) \
            / peaks.PEAK_F32_FLOPS

    def launches_per_call(self):
        if self.trace is None or not self.slice_calls:
            return None
        kernels = self.trace.kernels()
        return len(kernels) / len(self.slice_calls) if kernels else None

    def idle_share(self):
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 1.0 - self.trace.busy_s / self.trace.window_s

    def collective_share(self):
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        nccl = self.trace.kernels("nccl")
        if not nccl:
            return None
        return sum(e["dur"] for e in nccl) / 1e6 / self.trace.busy_s
