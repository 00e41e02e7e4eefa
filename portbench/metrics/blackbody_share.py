"""blackbody_share [%]: device time of the records launched under the
port's ``me2017.photometry`` span (models/kilonova.py: the photosphere's
temperature and the banded blackbody of ops/photometry.py) over the busy
time of every record launched in the traced slice's whole iterations
(program_spans.py)."""

from portbench import program_spans


def read(r):
    p = program_spans.of(r)
    return None if p is None else program_spans.percent(
        p.busy_share({"me2017.photometry"}))
