"""sampler_idle_share [%]: the device's idle time in gaps that fall under
the sampler's spans (inference/nested.py: ``ns.iteration``, ``ns.select``,
``ns.cholesky``, ``ns.walk_step``, ``ns.chunk_read``) and outside every
``analysis.batched_logl``, over the window of the traced slice's whole
iterations (program_spans.py)."""

from portbench import program_spans


def read(r):
    p = program_spans.of(r)
    return None if p is None else program_spans.percent(
        p.idle_share(program_spans.SAMPLER, {program_spans.LOGL_CALL}))
