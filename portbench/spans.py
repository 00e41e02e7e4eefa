"""The benchmark's spans around the calls into the likelihood layer.

:class:`Spans` wraps ``EMAnalysis.batched_logl`` before the sampler gets
it. Around each call it records one CUDA event before and one after on the
current stream, and it counts the call's rows and the values that are NaN
or +-inf (neither finite nor the -1e30 sentinel). It keeps a uniform
sample, drawn from the seed, of whole calls (rows and logL) for the
correctness check, by reservoir sampling over every call of the window.
Hooks registered by call index run before that call's start event: the
traced run starts and stops the profiler there. On the CPU (tests) the
events are host clock readings.
"""

from __future__ import annotations

import random
import time

import torch


class _HostEvent:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


class Spans:
    def __init__(self, fn, device, seed, keep_calls):
        self.fn = fn
        self.cuda = torch.device(device).type == "cuda"
        self.rng = random.Random(seed)
        self.keep_calls = keep_calls
        self.kept = []          # [(call index, u, logl)], the reservoir
        self.starts, self.ends, self.rows = [], [], []
        self.nonfinite = None   # device count of NaN / inf values
        self.hooks = {}         # call index -> callable
        self.inputs = {}        # call index -> u, for calls asked for
        self.keep_inputs = set()
        self.window_start = self.window_end = None
        self.opened_at = None   # host clock (time.time) at the window's start
        self.run_s = []         # seconds of each sampler run of the window

    def event(self):
        if not self.cuda:
            return _HostEvent()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def open(self):
        self.opened_at = time.time()
        self.window_start = self.event()

    def close(self):
        self.window_end = self.event()
        if self.cuda:
            torch.cuda.synchronize()

    @property
    def calls(self):
        return len(self.starts)

    def __call__(self, u):
        i = self.calls
        hook = self.hooks.get(i)
        if hook is not None:
            hook()
        self.starts.append(self.event())
        out = self.fn(u)
        self.ends.append(self.event())
        self.rows.append(u.shape[0])
        bad = (~torch.isfinite(out)).sum()
        self.nonfinite = bad if self.nonfinite is None \
            else self.nonfinite + bad
        if i in self.keep_inputs:
            self.inputs[i] = u.clone()
        if len(self.kept) < self.keep_calls:
            self.kept.append((i, u.clone(), out.clone()))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep_calls:
                self.kept[j] = (i, u.clone(), out.clone())
        return out

    # -- readings, once the window has closed ------------------------------
    def durations_ms(self):
        return [s.elapsed_time(e) for s, e in zip(self.starts, self.ends)]

    def gaps_ms(self):
        """Time outside the calls before each call and after the last:
        len(calls) + 1 values on the device's timeline."""
        marks = [self.window_start] + [x for pair in zip(self.starts,
                                                         self.ends)
                                       for x in pair] + [self.window_end]
        return [marks[2 * k].elapsed_time(marks[2 * k + 1])
                for k in range(self.calls + 1)]

    def failed(self):
        return 0 if self.nonfinite is None else int(self.nonfinite)
