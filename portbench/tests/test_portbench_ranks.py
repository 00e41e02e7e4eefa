"""The several-card path rehearsed on the CPU: two gloo ranks, each
building ``NestedSampler(..., mesh=make_mesh())`` as a four-card cell
does. The sound run is correct with the ranks in agreement; with the
exchange between ranks left out, ``correct`` reads false."""

from portbench import run
from portbench.spec import Spec
from portbench.tests import faults
from portbench.tests.small import write_small


def two_ranks(tmp_path, prepare=None):
    bench, folder = write_small(str(tmp_path / "bench"), names=("me2017",),
                                chips=2)
    spec = Spec("me2017.tiny", benchmark=bench, dirs=[folder])
    return run.run_ranks(spec, 2 ** 38 + 1, 1.0, False, device_type="cpu",
                         t_start=0.0, prepare=prepare)


def test_two_ranks_agree(tmp_path):
    line = two_ranks(tmp_path)
    assert line["correct"], line["checks"]
    assert line["checks"]["rank_disagreement"]["value"] == 0.0
    assert line["device"]["count"] == 2


def test_exchange_left_out_is_not_correct(tmp_path):
    line = two_ranks(tmp_path, faults.exchange_left_out)
    assert not line["correct"], line["checks"]
