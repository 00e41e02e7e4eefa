#!/usr/bin/env python3
"""Trace where torch.profiler puts the card's kernels against the host's
launches, over the whole of chip_smoke.py.

Run on a machine with one CUDA card and nvcc, from the repository root:

    python3 scripts/torch_profiler_window.py > profiler_windows.log

It runs `chip_smoke.main()` with the smoke's `device_profile` replaced by
one that also prints what the tracer kept, and `kernel_device_windows`
by one that first traces a window without the smoke's idle margins
(chip_smoke.PROFILE_MARGIN_S at both ends) and then one with them. For
every window it prints a `[window]` JSON line: seconds since the start,
the kernels the tracer kept, and the lag of the device's first kernel start
behind the host's first launch call and of its last kernel end behind the
host's last launch call (microseconds, on the profiler's one timeline;
negative where the device's clock reads ahead of the host's). For the
`kernel_device_windows` windows it adds the count of the named kernel without
the margins. The smoke's own output and checks are unchanged otherwise;
the readings it prints come from the windows with the margins.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

_T0 = time.time()


def _lags(torch, prof):
    """(device kernels kept, us from the first launch call to the first
    kernel start, us from the last launch call's end to the last kernel
    end)."""
    dev, launch = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e.time_range)
        elif "LaunchKernel" in e.name:
            launch.append(e.time_range)
    if not dev or not launch:
        return len(dev), None, None
    first = min(r.start for r in dev) - min(r.start for r in launch)
    last = max(r.end for r in dev) - max(r.end for r in launch)
    return len(dev), round(first, 3), round(last, 3)


def traced(torch, fn, kernel=None, margin_s=None, note=None):
    """chip_smoke.device_profile with ``margin_s`` seconds of host idle at
    both ends of the window (the smoke's own margin when None); prints the
    window's `[window]` line."""
    from torch.profiler import ProfilerActivity, profile

    if margin_s is None:
        margin_s = chip_smoke.PROFILE_MARGIN_S
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    named = [e for e in dev if kernel and kernel in e.key]
    kept, first, last = _lags(torch, prof)
    print("[window] " + json.dumps({
        "s": round(time.time() - _T0, 1), "kernel": kernel,
        "margin_s": margin_s, "kernels_kept": kept, "first_lag_us": first,
        "last_lag_us": last, **(note or {})}), flush=True)
    return busy_ms, sum(e.count for e in dev), ";".join(
        f"{e.key[:40]}:{e.self_device_time_total / 1e3:.4f}" for e in top), \
        sum(e.self_device_time_total for e in named) / 1e3, \
        sum(e.count for e in named)


def probe_kernel_device_windows(torch, fn, kernel, calls=20, warmup=3):
    """chip_smoke.kernel_device_windows over a window without margins, then
    over one with them, whose reading it returns."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    window = lambda: [fn() for _ in range(calls)]  # noqa: E731
    bare = traced(torch, window, kernel, margin_s=0.0)[4]
    named_ms, count = traced(
        torch, window, kernel,
        note={"calls": calls, "named_without_margins": bare})[3:]
    if not 0 < count <= calls:
        raise RuntimeError(f"the window with margins saw {count} launches "
                           f"of {kernel} in {calls} calls")
    return named_ms / count, 1


def main() -> int:
    chip_smoke.device_profile = traced
    chip_smoke.kernel_device_windows = probe_kernel_device_windows
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
