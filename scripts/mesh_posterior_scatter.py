"""Seed-to-seed scatter of the tiny Me2017 posterior in both packages, on
the CPU: the reason tests/test_torch_parallel.py holds the port's sharded
run against the JAX package's within two pooled deviations, not one.

For seeds 100-115 of the port's nested sampler and keys 100-115 of the JAX
package's, on ``__graft_entry__._tiny_analysis``'s data and prior (nlive
64, n_delete 8, walks 4), it prints logZ and the posterior weight of the
low-distance mode (unit-cube distance below 0.05); then the same for the
two runs the test compares (the port's seed 42, the JAX package's
8-device run from key 0) with each dimension's median gap in pooled
posterior deviations. Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/mesh_posterior_scatter.py

It prints one JSON line at the end; about two minutes on one CPU core.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(100, 116)


def mode_weight(result):
    import numpy as np

    w = np.exp(result.logw - np.logaddexp.reduce(result.logw))
    return float(w[np.asarray(result.samples_u)[:, 4] < 0.05].sum())


def main():
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import dataclasses

    import jax
    import numpy as np
    import torch

    import __graft_entry__ as graft
    from nmma_tpu.inference import NestedSampler as JaxNestedSampler
    from nmma_tpu.parallel import make_mesh, shard_state
    from nmma_tpu_torch.inference import NestedSampler
    from test_torch_parallel import tiny_data, tiny_port_analysis

    torch.set_num_threads(1)
    ana = tiny_port_analysis(tiny_data())
    j_ana = graft._tiny_analysis()
    out = {"port": {}, "jax": {}}

    def port_run(seed):
        cfg = dataclasses.replace(ana.config.sampler, seed=seed)
        return NestedSampler(ana.batched_logl, ana.priors.ndim, cfg,
                             device="cpu").run(verbose=False)

    j_plain = JaxNestedSampler(j_ana.batched_logl, j_ana.priors.ndim,
                               j_ana.config.sampler)
    for seed in SEEDS:
        for name, res in (("port", port_run(seed)), ("jax", j_plain.run(
                key=jax.random.PRNGKey(seed), verbose=False))):
            out[name][seed] = (mode_weight(res), float(res.logz))
            print(name, seed, *out[name][seed], flush=True)

    mesh = make_mesh(8)
    j_mesh = JaxNestedSampler(j_ana.batched_logl, j_ana.priors.ndim,
                              j_ana.config.sampler, mesh=mesh)
    pair = {"port": port_run(42), "jax": j_mesh.run(state=shard_state(
        j_mesh.init_state(jax.random.PRNGKey(0)), mesh), verbose=False)}
    draws = {k: np.asarray(r.samples_u)[r.posterior_indices()]
             for k, r in pair.items()}
    pooled = np.concatenate(list(draws.values())).std(axis=0)
    gaps = np.abs(np.median(draws["port"], 0)
                  - np.median(draws["jax"], 0)) / pooled
    summary = {
        name: {"mode_weight_min": min(v[0] for v in out[name].values()),
               "mode_weight_max": max(v[0] for v in out[name].values()),
               "mode_weight_mean": float(np.mean(
                   [v[0] for v in out[name].values()])),
               "logz_mean": float(np.mean([v[1] for v in
                                           out[name].values()]))}
        for name in out}
    summary["tested_pair"] = {
        "mode_weight": {k: mode_weight(r) for k, r in pair.items()},
        "median_gap_in_pooled_deviations": gaps.tolist()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
