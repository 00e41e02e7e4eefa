"""A run with its timed path broken underneath comes out not correct:
for each fault a cell of this benchmark can have, the harness is driven
past its look for a card, at a small size on the CPU, and ``correct``
reads false. The sound run on the same seed reads true."""

import pytest
import torch

from portbench import run
from portbench.spec import Spec
from portbench.tests import faults
from portbench.tests.small import write_small

SEED = 2 ** 36 + 17


def small_run(tmp_path, name):
    bench, folder = write_small(str(tmp_path / "bench"), names=(name,))
    spec = Spec(f"{name}.tiny", benchmark=bench, dirs=[folder])
    return run.run_rank(spec, SEED, 1.0, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", ["me2017", "trpi2018"])
def test_sound_run_is_correct(name, tmp_path):
    line = small_run(tmp_path, name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert line["attempted"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["me2017", "trpi2018"])
def test_fault_is_not_correct(name, fault, tmp_path):
    with faults.FAULTS[fault]():
        line = small_run(tmp_path, name)
    assert not line["correct"], line["checks"]
