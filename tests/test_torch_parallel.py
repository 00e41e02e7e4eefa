"""Live-point sharding of the port's nested sampler over torch.distributed.

Worlds of 2 and 4 CPU processes (this file run as a script, one rank
each: gloo, a file store in the test's temp directory, every process
killed WORLD_TIMEOUT_S after the worlds start) run the tiny Me2017
analysis of ``__graft_entry__._tiny_analysis`` (nlive 64, n_delete 8,
walks 4, 2 filters x 8 epochs from numpy seed 0) through
``NestedSampler(..., mesh=make_mesh())``, on the same data and prior text
as the JAX package's.

Held bit for bit: ``shard_logl`` on 64 seeded rows against the port's
one-process ``batched_logl`` (on the CPU it is batch-invariant: 64 rows in
one call equal 2 x 32 and 4 x 16), and every rank's sharded run
(samples, logL, logZ, iterations, calls) against the one-process port run,
also after an interrupt and a resume. Held within ``tests/test_parallel.py``'s
gates: ``shard_logl`` against the JAX package's ``batched_logl`` (rtol 1e-5,
atol 1e-4), and the sharded run against the JAX package's run on its 8
virtual devices (|dlogZ| < 3 max(hypot(errors), 0.1); each dimension's
median within two deviations of the pooled posterior, see
test_sharded_run_agrees_with_jax_mesh). The two packages draw different
random numbers, so that gate is statistical.

The ranks import the port alone; JAX and the JAX package are imported
where the references are made.

    python tests/test_torch_parallel.py WORLD_SIZE RANK DIRECTORY
"""

import dataclasses
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from nmma_tpu_torch import tracing  # noqa: E402
from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig  # noqa: E402
from nmma_tpu_torch.inference import (NestedSampler,  # noqa: E402
                                      NestedSamplerConfig,
                                      NestedSamplerResult)
from nmma_tpu_torch.parallel import mesh as M  # noqa: E402
from nmma_tpu_torch.priors import parse_prior_dict  # noqa: E402

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 120
RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(
    NestedSamplerResult))

# _tiny_analysis's prior and data (__graft_entry__.py:16-36)
TINY_PRIOR = (
    "log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
    "log10_vej = Uniform(minimum=-2., maximum=-0.5)\n"
    "beta = Uniform(minimum=1., maximum=5.)\n"
    "log10_kappa_r = Uniform(minimum=-1., maximum=2.)\n"
    "luminosity_distance = Uniform(minimum=1., maximum=200.)\n"
    "timeshift = Uniform(minimum=-0.4, maximum=0.4)\n"
)


def tiny_data(n_obs=8):
    rng = np.random.default_rng(0)
    t = np.linspace(0.5, 8.0, n_obs)
    return {f: {"time": t, "mag": 18.0 + rng.normal(0, 0.1, n_obs),
                "mag_error": np.full(n_obs, 0.1)} for f in ("ztfg", "ztfr")}


def tiny_port_analysis(data):
    cfg = EMAnalysisConfig(
        model="Me2017", trigger_time=0.0, n_tsteps=32, tmax=12.0,
        error_budget=1.0,
        sampler=NestedSamplerConfig(nlive=64, n_delete=8, walks=4,
                                    chunk_size=1))
    return EMAnalysis(cfg, data=data, priors=parse_prior_dict(TINY_PRIOR),
                      device="cpu")


def seeded_rows(ndim):
    u = np.random.default_rng(0).uniform(0.2, 0.8, (64, ndim))
    return u.astype(np.float32)


def worker(world, rank, root):
    """One rank of a world: forms the group from a file store in ``root``,
    runs every case and writes ``root/rank{rank}.npz``."""
    M.initialize_distributed(init_method=f"file://{root}/store",
                             world_size=world, rank=rank, device="cpu")
    ana = tiny_port_analysis(tiny_data())
    cfg, ndim = ana.config.sampler, ana.priors.ndim
    mesh = M.make_mesh(device="cpu")
    out = {}

    def run(config, **kw):
        return NestedSampler(ana.batched_logl, ndim, config, mesh=mesh).run(
            verbose=False, **kw)

    def keep(prefix, res):
        for f in RESULT_FIELDS:
            out[prefix + f] = getattr(res, f)

    # sizes that do not divide into the ranks raise before any collective
    errors = []
    for bad in (dict(nlive=64 + world // 2), dict(n_delete=8 + world // 2)):
        try:
            NestedSampler(ana.batched_logl, ndim,
                          dataclasses.replace(cfg, **bad), mesh=mesh)
        except ValueError as err:
            errors.append(str(err))
    out["errors"] = np.array(errors)

    out["shard_logl"] = M.shard_logl(ana.batched_logl, mesh)(
        torch.from_numpy(seeded_rows(ndim))).numpy()
    tracing.reset(tracing.MESH_COLLECTIVES)
    keep("", run(cfg))
    out["collectives"] = tracing.counter(tracing.MESH_COLLECTIVES)

    if world == 2:
        # a wall-clock cap that only rank 1 crosses
        keep("capped_", run(dataclasses.replace(
            cfg, max_seconds=0.0 if rank == 1 else math.inf)))
        # rank 1 alone is signalled during the first walk; the resumed run
        # must end where the uninterrupted one did
        calls = [0]

        def signalled(u):
            calls[0] += 1
            if rank == 1 and calls[0] == 2:
                signal.raise_signal(signal.SIGUSR1)
            return ana.batched_logl(u)

        ckpt = f"{root}/checkpoint.npz"
        sampler = NestedSampler(signalled, ndim, cfg, mesh=mesh)
        saves = [0]
        save = sampler.save_checkpoint

        def counted_save(*args):
            saves[0] += 1
            save(*args)

        sampler.save_checkpoint = counted_save
        keep("interrupted_", sampler.run(verbose=False, checkpoint_path=ckpt,
                                         resume=True))
        out["saves"] = saves[0]
        dist.barrier()     # rank 0's checkpoint is on disk
        keep("resumed_", run(cfg, checkpoint_path=ckpt, resume=True))

    if world == 4:
        # the first two ranks only; the others are not in the mesh
        sub = M.make_mesh(2, device="cpu")
        out["sub_member"] = sub is not None
        if sub is not None:
            out["sub_logl"] = M.shard_logl(ana.batched_logl, sub)(
                torch.from_numpy(seeded_rows(ndim))).numpy()
        try:
            M.make_mesh(8, device="cpu")
        except ValueError as err:
            out["too_many"] = str(err)
    dist.barrier()
    np.savez(f"{root}/rank{rank}.npz", **out)
    dist.destroy_process_group()


def start_world(world, root):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world), str(rank),
         str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]


def finish_world(procs, root, deadline):
    """Each rank's results, after every process ended by ``deadline`` (on
    the monotonic clock; all are killed when one has not)."""
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"rank {rank} of {len(procs)} timed out")
        outs.append((proc.returncode, out, err))
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\n{out}\n{err[-3000:]}"
    ranks = []
    for rank in range(len(procs)):
        with np.load(root / f"rank{rank}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started together; the one-process port run and the JAX
    package's runs are made while they work."""
    roots = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    procs = {w: start_world(w, root) for w, root in roots.items()}
    try:
        import jax

        import __graft_entry__ as graft
        from nmma_tpu.inference import NestedSampler as JaxNestedSampler
        from nmma_tpu.parallel import make_mesh as jax_make_mesh
        from nmma_tpu.parallel import shard_state as jax_shard_state

        ana = tiny_port_analysis(tiny_data())
        u = seeded_rows(ana.priors.ndim)
        port_logl = ana.batched_logl(torch.from_numpy(u)).numpy()
        port = NestedSampler(ana.batched_logl, ana.priors.ndim,
                             ana.config.sampler, device="cpu").run(
            verbose=False)
        mesh_one = NestedSampler(ana.batched_logl, ana.priors.ndim,
                                 ana.config.sampler,
                                 mesh=M.make_mesh(device="cpu")).run(
            verbose=False)

        j_ana = graft._tiny_analysis()
        j_logl = np.asarray(jax.jit(j_ana.batched_logl)(u))
        j_mesh = jax_make_mesh(8)
        j_sampler = JaxNestedSampler(j_ana.batched_logl, j_ana.priors.ndim,
                                     j_ana.config.sampler, mesh=j_mesh)
        j_run = j_sampler.run(state=jax_shard_state(
            j_sampler.init_state(jax.random.PRNGKey(0)), j_mesh),
            verbose=False)
    except BaseException:
        for p in sum(procs.values(), []):
            p.kill()
            p.communicate()
        raise
    worlds = {w: finish_world(procs[w], roots[w], deadline) for w in procs}
    return dict(worlds=worlds, port=port, port_logl=port_logl,
                mesh_one=mesh_one, jax_logl=j_logl, jax_run=j_run,
                ndim=ana.priors.ndim)


def result_of(rank, prefix=""):
    """The NestedSamplerResult a rank saved under ``prefix``."""
    return NestedSamplerResult(**{
        f: rank[prefix + f] if rank[prefix + f].ndim else rank[prefix + f][()]
        for f in RESULT_FIELDS})


def assert_same_result(got, want):
    """Every field equal bit for bit: samples, logL, weights, volumes,
    logZ and its error, information, calls and iterations."""
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_logl_matches_one_process_and_jax(runs, world):
    for rank in runs["worlds"][world]:
        np.testing.assert_array_equal(rank["shard_logl"], runs["port_logl"])
        np.testing.assert_allclose(rank["shard_logl"], runs["jax_logl"],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_run_equals_one_process_run(runs, world):
    """Every rank's run equals the one-process port run bit for bit, with
    one collective per likelihood call (the initial live set and each walk
    step)."""
    port = runs["port"]
    assert port.niter > 10 and np.isfinite(port.logz)
    for rank in runs["worlds"][world]:
        assert_same_result(result_of(rank), port)
        assert int(rank["collectives"]) == 1 + port.niter * 4


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_run_agrees_with_jax_mesh(runs, world):
    """Against the JAX package's run sharded over its 8 virtual devices:
    |dlogZ| < 3 max(hypot(errors), 0.1) (tests/test_parallel.py:85-87),
    and each dimension's posterior median within two standard deviations
    of the two runs' pooled posterior.

    tests/test_parallel.py holds the medians within one deviation of the
    reference run, between two runs that draw the same random numbers.
    These two draw their own, and at nlive 64 one run's medians scatter by
    about a deviation from seed to seed; the posterior is also bimodal:
    over 16 seeds of each package the low-distance mode held 0.014-0.289
    (port) and 0.003-0.267 (JAX package) of the weight, means 0.142 and
    0.127. Here the JAX run holds 0.446 of it and the port's 0.010, so
    log10_vej's and the distance's medians lie 1.0 and 1.6 pooled
    deviations apart (scripts/mesh_posterior_scatter.py)."""
    res = result_of(runs["worlds"][world][0])
    want = runs["jax_run"]
    dz = abs(res.logz - want.logz)
    tol = 3.0 * max(np.hypot(res.logz_err, want.logz_err), 0.1)
    assert dz < tol, (res.logz, want.logz, tol)
    a = res.samples_u[res.posterior_indices()]
    b = np.asarray(want.samples_u)[want.posterior_indices()]
    pooled = np.concatenate([a, b]).std(axis=0)
    for d in range(runs["ndim"]):
        assert abs(np.median(a[:, d]) - np.median(b[:, d])) \
            < 2.0 * pooled[d], d


@pytest.mark.parametrize("world", [2, 4])
def test_sizes_that_do_not_divide_raise_on_every_rank(runs, world):
    for rank in runs["worlds"][world]:
        errors = list(rank["errors"])
        assert len(errors) == 2, errors
        assert f"nlive axis ({64 + world // 2})" in errors[0]
        assert f"n_delete axis ({8 + world // 2})" in errors[1]
        assert all(f"mesh size ({world})" in e for e in errors)


def test_max_seconds_on_one_rank_stops_every_rank(runs):
    ranks = runs["worlds"][2]
    for rank in ranks:
        assert int(rank["capped_niter"]) == 1      # chunk_size 1
    assert_same_result(result_of(ranks[0], "capped_"),
                       result_of(ranks[1], "capped_"))


def test_resume_after_one_rank_is_signalled(runs):
    """Rank 1's signal stops both ranks after the first chunk, rank 0 alone
    writes the checkpoint, and the resumed run equals the uninterrupted
    one."""
    ranks = runs["worlds"][2]
    for i, rank in enumerate(ranks):
        assert int(rank["interrupted_niter"]) == 1
        assert int(rank["saves"]) == (1 if i == 0 else 0)
        assert_same_result(result_of(rank, "resumed_"), runs["port"])


def test_mesh_over_the_first_ranks(runs):
    ranks = runs["worlds"][4]
    assert [bool(r["sub_member"]) for r in ranks] == [True, True, False,
                                                     False]
    for rank in ranks[:2]:
        np.testing.assert_array_equal(rank["sub_logl"], runs["port_logl"])
    for rank in ranks:
        assert "requested 8 devices, have 4" in str(rank["too_many"])


def test_one_process_mesh_is_the_plain_sampler(runs, monkeypatch):
    """Without torchrun's environment or arguments, initialize_distributed
    forms no group; the one-process mesh has no group, and a sampler with
    it is the plain sampler bit for bit."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    M.initialize_distributed()
    assert not dist.is_initialized()
    mesh = M.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (
        None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        M.make_mesh(2, device="cpu")
    assert_same_result(runs["mesh_one"], runs["port"])


def test_profile_dir_writes_one_trace(tmp_path):
    """profile_dir traces the second chunk into one Chrome trace and leaves
    the run's result as it is without it."""
    def logl(u):
        return -0.5 * (((u - 0.5) / 0.1) ** 2).sum(dim=1)

    cfg = NestedSamplerConfig(nlive=32, n_delete=4, walks=2, max_iter=3,
                              chunk_size=1)
    plain = NestedSampler(logl, 2, cfg, device="cpu").run(verbose=False)
    traced = NestedSampler(logl, 2, NestedSamplerConfig(
        **{**cfg.__dict__, "profile_dir": str(tmp_path / "trace")}),
        device="cpu").run(verbose=False)
    assert os.listdir(tmp_path / "trace") == ["nested_sampler_it1.json"]
    assert (tmp_path / "trace" / "nested_sampler_it1.json").stat().st_size
    assert_same_result(traced, plain)
    assert math.isfinite(traced.logz)


def test_shard_state_checks_the_live_axis():
    """shard_state places every tensor of the state on the mesh's device
    and refuses live arrays that do not divide into the ranks, as the JAX
    package's does (nmma_tpu/parallel/mesh.py:88-101)."""
    sampler = NestedSampler(lambda u: u[:, 0], 2,
                            NestedSamplerConfig(nlive=64, n_delete=8),
                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = sampler.init_state(gen)
    two = M.BatchMesh(group=None, rank=0, size=2,
                           device=torch.device("cpu"))
    placed = M.shard_state(state, two)
    assert placed.u_live.device == torch.device("cpu")
    assert torch.equal(placed.u_live, state.u_live)
    with pytest.raises(ValueError, match=r"u_live axis \(64\) must divide "
                                         r"the mesh size \(3\)"):
        M.shard_state(state, M.BatchMesh(
            group=None, rank=0, size=3, device=torch.device("cpu")))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
