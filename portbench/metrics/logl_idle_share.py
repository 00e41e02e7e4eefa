"""logl_idle_share [%]: the device's idle time in gaps that fall under an
``analysis.batched_logl`` span (a call into the likelihood layer, its
launches and host work), over the window of the traced slice's whole
iterations (program_spans.py)."""

from portbench import program_spans


def read(r):
    p = program_spans.of(r)
    return None if p is None else program_spans.percent(
        p.idle_share({program_spans.LOGL_CALL}))
