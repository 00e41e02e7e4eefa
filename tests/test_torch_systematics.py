"""The port's yaml systematics against the JAX package's.

Each yaml format the JAX package reads (legacy with time nodes, legacy
without time, legacy filter groups, and the modern per-filter / group /
'each' / shared format) is written to ``tmp_path`` and read by both
``SystematicsModel``s. They must request the same priors (names, kinds,
ranges) and resolve the same per-filter plans, and ``sigma_sys`` for a
seeded batch of node values (B=32) on padded observation times must agree.

Tolerance: sigma_sys within 1e-6 absolute (values of order 1; both
packages interpolate in f32 by the same formula), inf in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nmma_tpu.likelihood.systematics import SystematicsModel as JSys
from nmma_tpu_torch.likelihood.systematics import SystematicsModel as TSys

torch.set_num_threads(1)

B = 32
FILTERS = ["sdssu", "ztfg", "ztfr", "2massj", "2massh", "2massks"]
TIME_RANGE = (0.1, 10.0)

FORMATS = {
    "legacy_with_time": {"config": {
        "withTime": {"value": True, "filters": [None], "time_nodes": 4,
                     "type": "Uniform", "minimum": 0.0, "maximum": 2.0},
        "withoutTime": {"value": False}}},
    "legacy_without_time": {"config": {
        "withTime": {"value": False},
        "withoutTime": {"value": True, "type": "Uniform", "minimum": 0.0,
                        "maximum": 2.0}}},
    "legacy_filter_groups": {"config": {
        "withTime": {"value": True,
                     "filters": ["ztfr", None, ["sdssu", "2massks"]],
                     "time_nodes": 3, "type": "Uniform", "minimum": 0.0,
                     "maximum": 1.5}}},
    "modern": {
        "ztfg": {"time_nodes": 3, "time_range": "log 0.5 8.0",
                 "prior": "Uniform(minimum=0.0, maximum=1.0)"},
        "nir": {"filters": ["2massj", "2massh"], "time_nodes": 2,
                "prior": "Uniform(minimum=0.1, maximum=0.9)"},
        "per": {"each": ["sdssu", "ztfr"], "time_range": "1.0 6.0 4",
                "prior": "Uniform(minimum=0.0, maximum=2.0)"},
        "rest": {"prior": "Uniform(minimum=0.0, maximum=0.5)"}},
    "modern_single_node": {
        "time_nodes": 1, "prior": "Uniform(minimum=0.0, maximum=1.0)"},
}


@pytest.fixture(params=list(FORMATS))
def models(request, tmp_path):
    path = tmp_path / f"{request.param}.yaml"
    path.write_text(yaml.safe_dump(FORMATS[request.param]))
    j_sys = JSys(FILTERS, str(path), model_time_range=TIME_RANGE)
    t_sys = TSys(FILTERS, str(path), model_time_range=TIME_RANGE)
    return j_sys, t_sys


def test_priors_and_plans_match(models):
    j_sys, t_sys = models
    j_pri, t_pri = j_sys.create_priors(), t_sys.create_priors()
    assert list(t_pri) == list(j_pri) and t_pri
    for name, prior in j_pri.items():
        assert type(t_pri[name]).__name__ == type(prior).__name__
        assert (t_pri[name].minimum, t_pri[name].maximum) == \
            (prior.minimum, prior.maximum)
    j_sys.finalize(list(j_pri))
    t_sys.finalize(list(t_pri))
    assert set(t_sys.plans) == set(j_sys.plans)
    for f, plan in j_sys.plans.items():
        got = t_sys.plans[f]
        assert got[:2] == plan[:2], f
        if plan[0] == "interp":
            np.testing.assert_allclose(got[2], plan[2], rtol=1e-12)
    assert t_sys.prior_parameter_names() == j_sys.prior_parameter_names()


def test_sigma_sys_matches(models):
    j_sys, t_sys = models
    names = list(j_sys.create_priors())
    j_sys.finalize(names)
    t_sys.finalize(names)
    rng = np.random.default_rng(7)
    params = {n: rng.uniform(0.05, 1.0, B).astype(np.float32) for n in names}
    # padded [F, N] rows: times inside, before and after the nodes, zeros
    times = np.zeros((len(FILTERS), 12), dtype=np.float32)
    for i in range(len(FILTERS)):
        times[i, :10 - i] = np.sort(rng.uniform(0.0, 12.0, 10 - i))
    want = np.asarray(jax.vmap(lambda p: j_sys(p, jnp.asarray(times)))(
        {k: jnp.asarray(v) for k, v in params.items()}))
    got = t_sys({k: torch.from_numpy(v) for k, v in params.items()},
                torch.from_numpy(times)).numpy()
    assert got.shape == want.shape == (B, len(FILTERS), 12)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_budget_without_yaml_matches():
    """No yaml: the error budget, or em_syserr where the prior samples it."""
    times = np.linspace(0.5, 5.0, 5, dtype=np.float32)[None].repeat(2, 0)
    t_sys = TSys(["ztfg", "ztfr"], None, error_budget=0.3)
    assert t_sys.create_priors() == {}
    t_sys.finalize(["log10_mej"])
    got = t_sys({"log10_mej": torch.zeros(B)}, torch.from_numpy(times))
    assert got.shape == (B, 2, 5) and bool((got == 0.3).all())
    t_sys.finalize(["em_syserr"])
    got = t_sys({"em_syserr": torch.full((B,), 0.7)},
                torch.from_numpy(times))
    assert bool((got == torch.tensor(0.7)).all())


def test_missing_filter_definition_raises(tmp_path):
    path = tmp_path / "partial.yaml"
    path.write_text(yaml.safe_dump(
        {"ztfg": {"prior": "Uniform(minimum=0.0, maximum=1.0)"}}))
    with pytest.raises(ValueError, match="missing systematics"):
        TSys(["ztfg", "ztfr"], str(path))
    with pytest.raises(ValueError, match="missing systematics"):
        JSys(["ztfg", "ztfr"], str(path))
