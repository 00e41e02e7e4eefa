"""The profiler's slice of the traced run, and its reduction.

The slice covers whole sampler iterations in the middle of the window.
torch.profiler keeps only the device records inside the window it opened
on the host's clock, and the card's records sit up to ~3 ms off the host's
launches (``chip_smoke.py:800-806``), so the card is synchronised and the
host idles ``MARGIN_S`` at both ends. Records of work enqueued before the
slice may still be kept: they end before the first device gap longer than
``MARGIN_CUT_S`` (the opening margin), and are cut off here. Nothing runs
after the closing margin. The Chrome
trace is read back from ``TMPDIR``: device records are the kernels,
copies and sets; host records are the operators and runtime calls.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

MARGIN_S = 0.1
MARGIN_CUT_S = 0.06
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
# host records looked back through for the one around a gap
SCAN = 4096


class Slice:
    """Starts and stops torch.profiler around a span of calls."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.prof = None
        self.events = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        # device activity and the runtime calls that launch it; tracing
        # every host operator as well made a TrPi2018 iteration take ~10 s
        # in place of ~1.4
        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                            else [ProfilerActivity.CPU])
        self.prof.start()
        self._margin()

    def stop(self):
        if self.prof is None or self.events is not None:
            return
        self._margin()
        self.prof.stop()
        self.events = []

    def _margin(self):
        if self.cuda:
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)

    def read(self):
        """The trace's events, exported to and read back from TMPDIR."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(self.events)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device and host records of the slice, times in microseconds."""

    def __init__(self, events):
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in HOST_CATS]
        dev.sort(key=lambda e: e["ts"])
        merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
        # the opening margin: the first long device gap
        lo = 0
        for k in range(1, len(merged)):
            if merged[k][0] - merged[k - 1][1] > MARGIN_CUT_S * 1e6:
                lo = k
                break
        self.merged = merged[lo:]
        if self.merged:
            t0, t1 = self.merged[0][0], self.merged[-1][1]
        else:
            t0 = t1 = 0.0
        self.t0, self.t1 = t0, t1
        self.device = [e for e in dev if t0 <= e["ts"] < t1]
        self.host = host

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.merged) / 1e6

    def kernels(self, name=None):
        return [e for e in self.device if e.get("cat") == "kernel"
                and (name is None or name in e["name"])]

    def device_ops(self):
        """[[name, seconds]] of the device records that took most time."""
        total = {}
        for e in self.device:
            total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] / 1e6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k[:160], v] for k, v in top]

    def idle_gaps(self):
        """[[what the host was doing, seconds]]: the device's idle gaps
        inside the slice, each named by the innermost host record around
        its middle (host and device clocks may differ by milliseconds),
        summed by name."""
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [h["ts"] for h in host]
        total = {}
        for (_, e0), (s1, _) in zip(self.merged[:-1], self.merged[1:]):
            mid = 0.5 * (e0 + s1)
            name = "no host record"
            # nested records: the latest one to start that still runs
            for k in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid)
                               - 1 - SCAN), -1):
                if host[k]["ts"] + host[k]["dur"] >= mid:
                    name = host[k]["name"]
                    break
            total[name] = total.get(name, 0.0) + (s1 - e0) / 1e6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k[:160], v] for k, v in top]
