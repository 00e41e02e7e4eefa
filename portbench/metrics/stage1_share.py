"""stage1_share [%]: device time of the records launched under the port's
``grb.stage1`` span (models/grb.py: the jet's dynamics and tracks before
K3) over the busy time of every record launched in the traced slice's
whole iterations (program_spans.py)."""

from portbench import program_spans


def read(r):
    p = program_spans.of(r)
    return None if p is None else program_spans.percent(
        p.busy_share({"grb.stage1"}))
