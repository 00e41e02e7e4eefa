"""The port's own spans over the traced slice, for the per-layer readers.

The port records a span at each layer boundary of its hot path while a
torch.profiler session records (``nmma_tpu_torch/tracing.py``), stamped on
the host clock that the profiler's host records use. :func:`of` maps them
onto the slice's trace (``trace.Trace``) and puts the trace's records down
to them:

* a device record (kernel, copy, set) belongs to the innermost span that
  holds the middle of its launch, the host record with the same
  ``args.correlation``;
* an idle gap of the device belongs to the innermost span that holds its
  middle (host and device clocks may differ by milliseconds);
* a host synchronisation (``SYNCS``) belongs to the innermost span that
  holds its middle.

Only the slice's whole sampler iterations are counted: the slice opens
inside a walk step of a sampler iteration, whose own span and first walk
step began before the profiler and are not recorded. The counted window
runs from the start of the first whole ``ns.iteration`` to the start of the
iteration after the last whole one (or the slice's end), so each counted
iteration carries the chunk boundary that follows it, if any.

A program without the recorder (``nmma_tpu_torch.tracing``), or a slice
holding no whole iteration, reads None.
"""

from __future__ import annotations

import bisect

ITERATION = "ns.iteration"
LOGL_CALL = "analysis.batched_logl"
SAMPLER = frozenset({ITERATION, "ns.select", "ns.cholesky", "ns.walk_step",
                     "ns.chunk_read"})
# runtime calls after which the host waits for the device
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                   "cudaMemcpy3D", "cudaMemcpyPeer", "cudaMemcpyFromSymbol",
                   "cudaMemcpyToSymbol"})
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Span:
    __slots__ = ("name", "id", "parent", "start", "end")

    def __init__(self, name, id, parent, start, end):
        self.name, self.id, self.parent = name, id, parent
        self.start, self.end = start, end


def recorded():
    """The port's recorded spans and the function that maps a stamp onto
    the trace's axis, or None when the port has no recorder."""
    try:
        from nmma_tpu_torch import tracing
    except ImportError:
        return None
    records = tracing.records()
    if not records:
        return None
    base = tracing.trace_base_ns(records[0].start_ns)
    return records, lambda ns: tracing.trace_us(ns, base)


def of(r):
    """The :class:`Program` of a reading's traced slice, or None."""
    if r.trace is None:
        return None
    got = recorded()
    if got is None:
        return None
    records, to_us = got
    spans = [Span(s.name, s.id, s.parent, to_us(s.start_ns),
                  to_us(s.end_ns)) for s in records]
    program = Program(r.trace, spans)
    return program if program.iterations else None


class Program:
    """Spans (on the trace's axis, microseconds) over a ``trace.Trace``."""

    def __init__(self, trace, spans):
        self.trace = trace
        self.spans = sorted(spans, key=lambda s: s.start)
        self._starts = [s.start for s in self.spans]
        self._by_id = {s.id: s for s in self.spans}
        its = [s for s in self.spans if s.name == ITERATION]
        whole = [s for s in its if trace.t0 <= s.start and s.end <= trace.t1]
        self.iterations = len(whole)
        self.lo = self.hi = 0.0
        if whole:
            after = [s.start for s in its if s.start > whole[-1].start]
            self.lo = whole[0].start
            self.hi = min(after[0], trace.t1) if after else trace.t1
        self._launch = {}
        for h in trace.host:
            corr = h.get("args", {}).get("correlation")
            if corr is not None and h.get("cat") in LAUNCH_CATS:
                self._launch[corr] = h

    @property
    def window_us(self):
        return self.hi - self.lo

    def counted(self, t):
        return self.lo <= t < self.hi

    def holder(self, t):
        """The innermost span that holds ``t``, or None: the latest to
        start at or before ``t`` is that span or one of its descendants."""
        k = bisect.bisect_right(self._starts, t) - 1
        s = self.spans[k] if k >= 0 else None
        while s is not None and s.end < t:
            s = self._by_id.get(s.parent)
        return s

    def around(self, span, names):
        """The innermost span named in ``names`` that is ``span`` or holds
        it, or None."""
        while span is not None and span.name not in names:
            span = self._by_id.get(span.parent)
        return span

    def under(self, span, names):
        return self.around(span, names) is not None

    def launch(self, e):
        """The host record that launched a device record, or None."""
        return self._launch.get(e.get("args", {}).get("correlation"))

    def launched_at(self, e):
        """The middle of a device record's launch (its own start when the
        trace has no launch record for it)."""
        h = self.launch(e)
        return e["ts"] if h is None else h["ts"] + 0.5 * h["dur"]

    def device(self, everywhere=False):
        """[(record, holding span or None)] of the device records launched
        in the counted window (``everywhere``: in the whole slice)."""
        out = []
        for e in self.trace.device:
            t = self.launched_at(e)
            if everywhere or self.counted(t):
                out.append((e, self.holder(t)))
        return out

    def gaps(self, everywhere=False):
        """[(microseconds, holding span or None)] of the device's idle gaps
        whose middle lies in the counted window (or the whole slice)."""
        merged = self.trace.merged
        out = []
        for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
            mid = 0.5 * (e0 + s1)
            if everywhere or self.counted(mid):
                out.append((s1 - e0, self.holder(mid)))
        return out

    def syncs(self, everywhere=False):
        """[(record, holding span)] of the host synchronisations in the
        counted window (or the whole slice) that a span holds."""
        out = []
        for h in self.trace.host:
            if h.get("name") in SYNCS and h.get("cat") in LAUNCH_CATS:
                t = h["ts"] + 0.5 * h["dur"]
                inside = everywhere and self.trace.t0 <= t < self.trace.t1
                s = self.holder(t) if inside or self.counted(t) else None
                if s is not None:
                    out.append((h, s))
        return out

    # -- the metrics' quantities ---------------------------------------------
    def busy_share(self, names):
        """Device time of the records launched under a span in ``names``
        over the busy time of every record launched in the window."""
        recs = self.device()
        busy = _busy([e for e, _ in recs])
        if busy <= 0:
            return None
        mine = _busy([e for e, s in recs if self.under(s, names)])
        return mine / busy

    def idle_share(self, inside, outside=frozenset()):
        """Idle time whose gaps lie under a span in ``inside`` and under
        none in ``outside``, over the window."""
        if self.window_us <= 0:
            return None
        idle = sum(us for us, s in self.gaps()
                   if self.under(s, inside) and not self.under(s, outside))
        return idle / self.window_us

    def syncs_per_iteration(self):
        return len(self.syncs()) / self.iterations

    def table(self, everywhere=False):
        """{innermost span name: [device ms, launches, idle ms, syncs]} over
        the window (or the whole slice), None for what no span holds."""
        rows = {}

        def row(s):
            return rows.setdefault(None if s is None else s.name,
                                   [0.0, 0, 0.0, 0])

        for e, s in self.device(everywhere):
            r = row(s)
            r[0] += e["dur"] / 1e3
            r[1] += e.get("cat") == "kernel"
        for us, s in self.gaps(everywhere):
            row(s)[2] += us / 1e3
        for _, s in self.syncs(everywhere):
            row(s)[3] += 1
        return rows


def _busy(records):
    """Microseconds of the union of the records' intervals."""
    total, end = 0.0, None
    for s, e in sorted((r["ts"], r["ts"] + r["dur"]) for r in records):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def percent(share):
    return None if share is None else 100.0 * share
