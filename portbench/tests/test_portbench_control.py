"""The control: the plain reference computed one precision lower, put in
the program's place, fails a configuration's limits where the program
passes them. Here at a small size (bfloat16 on the CPU); on a card the
TF32 control of the surrogate too. The full-size readings, a dozen seeds
of the program and three or more of the control a cell, come from
``portbench/control.py`` on the card."""

import pytest
import torch

from portbench import check, run
from portbench.spec import Spec
from portbench.tests.small import write_small


def readings(tmp_path, name, controls, device):
    bench, folder = write_small(str(tmp_path / "bench"), names=(name,))
    spec = Spec(f"{name}.tiny", benchmark=bench, dirs=[folder])
    line = run.run_rank(spec, 2 ** 37 + 5, 1.0, False, torch.device(device),
                        0.0, controls=controls)
    return spec, line


@pytest.mark.parametrize("name", ["trpi2018", "me2017"])
def test_bf16_control_fails_where_the_program_passes(name, tmp_path):
    spec, line = readings(tmp_path, name, ("bf16",), "cpu")
    limits = spec.config["check"]["limits"]
    assert line["correct"], line["checks"]
    ok, checks = check.verdict(line["controls"]["bf16"], limits)
    assert not ok, checks


@pytest.mark.card
def test_tf32_control_fails_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    spec, line = readings(tmp_path, "bu2019lm", ("tf32",), "cuda")
    ok, checks = check.verdict(line["controls"]["tf32"],
                               spec.config["check"]["limits"])
    assert line["correct"], line["checks"]
    assert not ok, checks
