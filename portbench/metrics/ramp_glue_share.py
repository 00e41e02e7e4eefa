"""ramp_glue_share [%]: device time of the records whose innermost span is
the energy ramp's own (``grb.ramp``, ``grb.ramp.fold``,
``grb.ramp.chunk`` in models/grb.py: the fold of the nodes into the
batch, each chunk's ring sum, the concatenation) over the busy time of
every record launched in the traced slice's whole iterations
(program_spans.py). Stage 1 and the kernels are not in it: their innermost
spans are their own. A program without the ramp's spans reads None."""

from portbench import program_spans

RAMP = frozenset({"grb.ramp", "grb.ramp.fold", "grb.ramp.chunk"})


def read(r):
    p = program_spans.of(r)
    if p is None or not any(s.name in RAMP for s in p.spans):
        return None
    recs = p.device()
    busy = program_spans._busy([e for e, _ in recs])
    if busy <= 0:
        return None
    mine = program_spans._busy([e for e, s in recs
                                if s is not None and s.name in RAMP])
    return program_spans.percent(mine / busy)
