"""logl_call_ms_p95 [ms]: the 95th percentile, over the calls of the
window outside the traced slice, of the time between a call's two events
(analysis.py, likelihood/em.py)."""


def read(r):
    return r.p95_call_ms()
