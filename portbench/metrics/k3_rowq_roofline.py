"""k3_rowq_roofline [%]: K3 in its per-row query mode (csrc/grb_eats.cu),
the energy ramp's: the counted bound of the counted calls' folded rows
(``kernel_work`` of the configuration's counts file, one entry a call)
over the summed device time of every launch of its kernel inside those
calls.

The traced slice opens on the first counted call, so the i-th
``analysis.batched_logl`` span of the slice is the i-th counted call; a
launch belongs to the call whose span holds its launch
(``program_spans.py``). Work and time are summed per call, not paired
launch by launch, so the number of launches a call takes (the ramp's
chunks) does not change what is divided. A counted call without a launch
in the slice is left out on both sides. Reads None without a trace, without
the program's spans or without a launch inside a counted call."""

from portbench import peaks, program_spans


def read(r):
    if r.trace is None or r.counts is None:
        return None
    got = program_spans.recorded()
    if got is None:
        return None
    records, to_us = got
    p = program_spans.Program(r.trace, [
        program_spans.Span(s.name, s.id, s.parent, to_us(s.start_ns),
                           to_us(s.end_ns)) for s in records])
    inputs = r.counted_inputs()
    calls = [s for s in p.spans if s.name == program_spans.LOGL_CALL]
    index = {s.id: i for i, s in enumerate(calls[:len(inputs)])}
    device_us = [0.0] * len(index)
    for e, s in p.device(everywhere=True):
        if e.get("cat") != "kernel" or r.counts.KERNEL not in e["name"]:
            continue
        call = p.around(s, {program_spans.LOGL_CALL})
        if call is not None and call.id in index:
            device_us[index[call.id]] += e["dur"]
    bound_ms = sum(peaks.roofline_ms(*w)
                   for u, us in zip(inputs, device_us) if us > 0
                   for w in r.counts.kernel_work(r.reference, u))
    total_us = sum(device_us)
    if total_us <= 0:
        return None
    return 100.0 * bound_ms / (total_us / 1e3)
