"""TrPi2018 on the quasi-static energy ramp against the benchmark's plain
reference (``portbench/reference/trpi2018_ramp.py``), on the CPU at
n_theta 8, n_phi 4, n_r 128.

The port's ``EMAnalysis.batched_logl`` on the ramp configuration's prior
and data meets the reference's logL within 1e-5 relative with no sentinel
on one side only (the gate of portbench/tests/test_portbench_reference.py).
With energy_exponential = 0 the ramp's energy is log10_Eend at every node,
and the reference then meets the frozen ``reference/trpi2018.py`` at
log10_E0 = log10_Eend: the same infinities, and magnitudes that differ only
by where each node's log-R grid ends (one node's time here, the last
node's there), a discretisation difference of ~7e-4 mag at the median."""

import json
import os

import torch

from portbench import check, inputs, run
from portbench.reference import trpi2018 as ref_trpi
from portbench.reference import trpi2018_ramp as ref_ramp
from portbench.spec import HERE, Spec
from portbench.tests.small import small_config, write_small

TOL = 1e-5
SEED = 2 ** 40 + 3
# with energy_exponential = 0: the median and the largest |dmag| between
# the node-by-node grids and the shared one (read 7e-4 and 0.17 on these
# rows, mostly radio at late nodes)
E0_MEDIAN_MAG = 2e-3
E0_MAX_MAG = 0.25


def test_program_matches_the_ramp_reference(tmp_path):
    bench, folder = write_small(str(tmp_path / "bench"),
                                names=("trpi2018_ramp",))
    spec = Spec("trpi2018_ramp.tiny", benchmark=bench, dirs=[folder])
    assert spec.reference() is ref_ramp
    data, prior = str(tmp_path / "p.dat"), str(tmp_path / "p.prior")
    inputs.photometry(spec.config, spec.reference(), SEED, data, "cpu",
                      run.ROOT)
    inputs.prior_file(spec.config, prior)
    logl, ndim, _ = spec.program().build(spec, data, prior,
                                         str(tmp_path / "o"), 5, "cpu",
                                         run.ROOT)
    # the prior's four ramp keys select the ramp inside trpi2018_mags
    assert ndim == 11
    u = torch.rand((24, ndim), generator=torch.Generator().manual_seed(11))
    prog = logl(u)
    ref = run.reference_model(spec, "cpu")
    ref.photometry.load(data)
    want = ref.log_likelihood(u)
    gap, flips = check.logl_numbers(prog, want)
    assert flips == 0
    assert gap < TOL
    assert bool((want > -1e29).sum() >= 12)


def test_flat_ramp_meets_the_frozen_reference():
    cfg = small_config("trpi2018_ramp")
    ramp = ref_ramp.Reference(cfg)
    with open(os.path.join(HERE, "configs", "trpi2018.json")) as f:
        flat_cfg = json.load(f)
    flat_cfg["resolution"] = cfg["resolution"]
    flat = ref_trpi.Reference(flat_cfg)
    ph = ramp.photometry
    u = torch.rand((32, len(ph.sampled)),
                   generator=torch.Generator().manual_seed(3))
    p = ph.parameters(u)
    p["energy_exponential"] = torch.zeros_like(p["energy_exponential"])
    q = dict(p, log10_E0=p["log10_Eend"])
    t = ph.sample_times
    nu = ph.nu_0[None] * (1.0 + p["redshift"])[:, None]
    got = ramp.mags(p, t, nu)
    want = flat.mags(q, t, nu)
    assert got.shape == want.shape == (32, len(ph.filters), t.shape[0])
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float(fin.float().mean()) > 0.8
    dmag = (got - want)[fin].abs()
    assert float(dmag.median()) < E0_MEDIAN_MAG
    assert float(dmag.max()) < E0_MAX_MAG
    # a nonzero exponent moves the curve: the ramp is read
    p["energy_exponential"] = torch.ones_like(p["energy_exponential"])
    moved = (ramp.mags(p, t, nu) - want)[fin].abs()
    assert float(moved.median()) > 10 * E0_MEDIAN_MAG
