"""Spans and counters of the port, on torch.profiler's clock.

A span marks a layer boundary of the hot path: the sampler's iteration and
its parts (``inference/nested.py``), one call into ``EMAnalysis.batched_logl``
and its parts (``analysis.py``, ``likelihood/em.py``, ``models/``), each
launch of a hand-written kernel (``ops/*_kernel.py``) and each collective of
the split likelihood (``parallel/mesh.py``)::

    with tracing.span("ns.walk_step"):
        ...

Spans record only while a torch.profiler session is recording in this
process; nothing else turns them on. Without one, :func:`span` is one flag
check that returns a shared no-op context: it allocates nothing and calls no
torch operator. With one, each span appends a :class:`SpanRecord` to an
in-memory list of at most ``CAP`` records (:func:`dropped` counts the rest);
it launches nothing on the device and reads nothing from it. The list is
read with :func:`records` and emptied with :func:`clear`.

A span is stamped with ``time.time_ns()``. torch.profiler writes a Chrome
trace's ``ts`` as Unix-time microseconds less the file's
``baseTimeNanoseconds``, which is the Unix time rounded down to a multiple
of ``TRIMONTH_S`` seconds; :func:`trace_us` maps a stamp onto that axis, so
a span lies beside the profiler's own records of the same moment.

Counters are host integers, counted whether or not a profiler records:
kernel launches (``K1_LAUNCHES`` to ``K6_LAUNCHES``), the energy ramp's
chunks (``RAMP_CHUNKS``) and the split likelihood's collectives
(``MESH_COLLECTIVES``; the sampler's stop agreement is not counted).
:func:`counter` reads one, :func:`reset` sets them to 0.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

K1_LAUNCHES = "kernel.k1.launches"
K2_LAUNCHES = "kernel.k2.launches"
K3_LAUNCHES = "kernel.k3.launches"
K4_LAUNCHES = "kernel.k4.launches"
K5_LAUNCHES = "kernel.k5.launches"
K6_LAUNCHES = "kernel.k6.launches"
RAMP_CHUNKS = "grb.ramp.chunks"
MESH_COLLECTIVES = "mesh.collectives"

# the span of one call into the likelihood layer: it takes a new call id,
# which the spans inside it inherit
LOGL_CALL = "analysis.batched_logl"

# records kept in memory; a traced sampler iteration makes a few hundred
CAP = 1 << 18
# torch.profiler's trace base: Unix time rounded down to this many seconds
TRIMONTH_S = 7889238
# the thread id under which exported spans appear beside the process's own
SPAN_TID = 0

_recording = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int          # the enclosing recorded span's id, or -1
    call: int            # the batched_logl call's id, or -1 outside calls
    iteration: int       # the sampler iteration's number, or -1 outside
    rows: int            # rows of the batch the span was given, or -1
    start_ns: int        # time.time_ns() on entry
    end_ns: int          # time.time_ns() on exit
    points: int = -1     # live points behind the rows, or -1
    chunks: int = -1     # chunks the rows run in, or -1


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _Noop()
_counts = {K1_LAUNCHES: 0, K2_LAUNCHES: 0, K3_LAUNCHES: 0, K4_LAUNCHES: 0,
           K5_LAUNCHES: 0, K6_LAUNCHES: 0, RAMP_CHUNKS: 0,
           MESH_COLLECTIVES: 0}
_records = []
_dropped = 0
_ids = itertools.count()
_calls = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "id", "parent", "call", "iteration", "rows",
                 "points", "chunks", "start_ns")

    def __init__(self, name, iteration, batch, rows, points, chunks):
        self.name = name
        self.iteration = -1 if iteration is None else iteration
        if rows is None:
            rows = -1 if batch is None else len(batch)
        self.rows = rows
        self.points = -1 if points is None else points
        self.chunks = -1 if chunks is None else chunks

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top else -1
        if self.name == LOGL_CALL:
            self.call = next(_calls)
        else:
            self.call = top.call if top else -1
        if self.iteration < 0 and top:
            self.iteration = top.iteration
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.time_ns()
        _local.stack.pop()
        _keep(SpanRecord(self.name, self.id, self.parent, self.call,
                         self.iteration, self.rows, self.start_ns, end_ns,
                         self.points, self.chunks))
        return False


def _keep(record):
    global _dropped
    if len(_records) < CAP:
        _records.append(record)
    else:
        _dropped += 1


def recording():
    """Whether a torch.profiler session records in this process."""
    return _recording()


def span(name, iteration=None, batch=None, rows=None, points=None,
         chunks=None):
    """A context that records ``name`` while a profiler records, else the
    shared no-op. ``iteration`` is the sampler's iteration number (spans
    inside inherit it); ``batch`` is the tensor whose rows the span
    handles, read only while recording, or ``rows`` their number;
    ``points`` the live points behind them and ``chunks`` the chunks
    they run in, where the span has such."""
    if not _recording():
        return _NOOP
    return _Span(name, iteration, batch, rows, points, chunks)


def records():
    """The recorded spans, oldest first, as a new list."""
    return list(_records)


def dropped():
    """Spans not kept because the list was full."""
    return _dropped


def clear():
    """Empty the list of recorded spans and the count of dropped ones."""
    global _dropped
    _records.clear()
    _dropped = 0


def count(name):
    _counts[name] = _counts.get(name, 0) + 1


def counter(name):
    return _counts.get(name, 0)


def reset(*names):
    """Set the named counters (every counter without a name) to 0."""
    for name in names or list(_counts):
        _counts[name] = 0


# -- the profiler's clock -----------------------------------------------------

def trace_base_ns(stamp_ns):
    """The ``baseTimeNanoseconds`` torch.profiler gives a trace taken at
    ``stamp_ns`` (Unix nanoseconds)."""
    return stamp_ns // 10**9 // TRIMONTH_S * TRIMONTH_S * 10**9


def trace_us(stamp_ns, base_ns):
    """A ``time.time_ns()`` stamp on a Chrome trace's ``ts`` axis
    (microseconds after ``base_ns``)."""
    return (stamp_ns - base_ns) / 1e3


def add_to_chrome_trace(path, spans):
    """Append ``spans`` to the Chrome trace that torch.profiler wrote at
    ``path``, as ``X`` events of category ``program_span`` on the trace's
    own base, under this process and thread ``SPAN_TID``."""
    with open(path) as f:
        trace = json.load(f)
    base, pid = trace["baseTimeNanoseconds"], os.getpid()
    events = trace["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID, "args": {"name": "nmma_tpu_torch spans"}})
    for s in spans:
        args = {"id": s.id, "parent": s.parent}
        for key in ("call", "iteration", "rows", "points", "chunks"):
            if getattr(s, key) >= 0:
                args[key] = getattr(s, key)
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": SPAN_TID,
                       "ts": trace_us(s.start_ns, base),
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
