"""Each configuration's plain reference against the program's likelihood
on the CPU, at a small batch: the same unit-cube rows, the same photometry
file, the logL within float32 rounding of the same arithmetic in another
order (both read ~3e-7 of each other here)."""

import os

import numpy as np
import pytest
import torch

from portbench import check, inputs, run
from portbench.spec import Spec
from portbench.tests.small import write_small

TOL = 1e-5


@pytest.mark.parametrize("name", ["trpi2018", "me2017", "bu2019lm"])
def test_reference_matches_the_program(name, tmp_path):
    bench, folder = write_small(str(tmp_path / "bench"), names=(name,))
    spec = Spec(f"{name}.tiny", benchmark=bench, dirs=[folder])
    data, prior = str(tmp_path / "p.dat"), str(tmp_path / "p.prior")
    inputs.photometry(spec.config, spec.reference(), 2 ** 40 + 3, data,
                      "cpu", run.ROOT)
    inputs.prior_file(spec.config, prior)
    logl, ndim, _ = spec.program().build(spec, data, prior,
                                         str(tmp_path / "o"), 5, "cpu",
                                         run.ROOT)
    gen = torch.Generator().manual_seed(11)
    u = torch.rand((48, ndim), generator=gen)
    prog = logl(u)
    ref = run.reference_model(spec, "cpu")
    ref.photometry.load(data)
    want = ref.log_likelihood(u)
    gap, flips = check.logl_numbers(prog, want)
    assert flips == 0
    assert gap < TOL
    # the rows reach the likelihood's terms, not only its sentinel
    assert bool((want > -1e29).any())


def test_photometry_is_made_from_the_seed(tmp_path):
    bench, folder = write_small(str(tmp_path / "bench"), names=("me2017",))
    spec = Spec("me2017.tiny", benchmark=bench, dirs=[folder])
    paths = [str(tmp_path / f"{k}.dat") for k in range(3)]
    for path, seed in zip(paths, (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2)):
        rows = inputs.photometry(spec.config, spec.reference(), seed, path,
                                 "cpu", run.ROOT)
        assert rows == 90
    text = [open(p).read() for p in paths]
    assert text[0] == text[1] != text[2]
    assert os.path.getsize(paths[0]) > 0
    assert np.isfinite(float(text[0].split()[2]))
