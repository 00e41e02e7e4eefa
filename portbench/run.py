"""One run of one cell of the port's benchmark.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run reads the cell's entry in ``BENCHMARK.json`` and the configuration
and traffic files it names, makes its photometry from the seed through the
benchmark's reference model, builds the program under test through the
configuration's ``programs/<name>.py`` (``em``: the port's ``EMAnalysis``),
warms it up with a one-iteration sampler run at the cell's shapes, and
then runs the nested sampler, the public path that the command line drives
minus the result files, for ``--seconds``: each run converged inside the
window is followed by another from a seed drawn from ``--seed``. On several
cards the run starts one process a card, each rank building
``NestedSampler(..., mesh=make_mesh())`` over a process group. Once the
window has closed it checks what the window produced against the plain
reference (``check.py``) and prints one JSON line as the last line of its
standard output; with ``--trace 1`` a slice of the window is profiled and
the line carries the per-layer metrics instead of the end-to-end ones.

It exits with code 2, printing no result, without enough CUDA cards, with
code 3 when JAX, flax or the JAX package is loaded once the window has
closed, and with another code than 0 when the program is missing.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import replace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_TORCH = time.time()

from portbench import check, inputs  # noqa: E402
from portbench.reading import COUNTED_CALLS, Reading  # noqa: E402
from portbench.spans import Spans  # noqa: E402
from portbench.spec import Spec  # noqa: E402
from portbench.trace import Slice  # noqa: E402

# what may not be loaded in a process that prints a result, compared by
# the whole top-level name (the program's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "nmma_tpu")
GIB = 2.0 ** 30
# seconds the ranks of a several-card run may take beyond the window
RANK_TIMEOUT_S = 330


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(*parts):
    print("[portbench]", *parts, file=sys.stderr, flush=True)


# -- the window -------------------------------------------------------------

def _agree_stop(stop, mesh):
    """Whether some rank wants to stop, on every rank."""
    if mesh is None or mesh.group is None:
        return stop
    import torch.distributed as dist
    t = torch.tensor([1.0 if stop else 0.0], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item() > 0)


def converged(res, scfg):
    """Whether a sampler run ended on its evidence criterion (and not on
    its time cap): the sampler's own test, dlogz = ln(Z + L_max X) - ln Z
    over the dead points, redone from the result."""
    n_dead = res.niter * scfg.n_delete
    if n_dead == 0:
        return False
    logz = float(np.logaddexp.reduce(res.logw[:n_dead].astype(np.float64)))
    remain = float(res.logl[n_dead:].max()) + float(res.log_x[n_dead - 1])
    return float(np.logaddexp(logz, remain) - logz) < scfg.dlogz


def window(spans, ndim, scfg, seed, seconds, device, mesh):
    """The timed sampler runs: [NestedSamplerResult], window seconds."""
    from nmma_tpu_torch.inference import NestedSampler

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    results = []
    spans.open()
    t0 = time.perf_counter()
    k = 0
    while True:
        left = seconds - (time.perf_counter() - t0)
        t_run = time.perf_counter()
        sampler = NestedSampler(spans, ndim, replace(
            scfg, seed=inputs.derived_seed(seed, k),
            max_seconds=max(left, 0.0)),
            device=device, mesh=mesh)
        res = sampler.run(verbose=False)
        results.append(res)
        spans.run_s.append(time.perf_counter() - t_run)
        k += 1
        again = converged(res, scfg) and \
            time.perf_counter() - t0 < seconds
        if _agree_stop(not again, mesh):
            break
    spans.close()
    return results, time.perf_counter() - t0


def warm_up(logl, ndim, scfg, device, mesh, seed):
    """One iteration at the cell's shapes through the same wrapper."""
    from nmma_tpu_torch.inference import NestedSampler

    warm = Spans(logl, device, seed, 0)
    warm.open()
    NestedSampler(warm, ndim, replace(scfg, max_iter=1, chunk_size=1),
                  device=device, mesh=mesh).run(verbose=False)
    warm.close()


# -- the check --------------------------------------------------------------

def reference_model(spec, device, dtype=torch.float32):
    return spec.reference().Reference(spec.config, dtype=dtype,
                                      device=device, root=ROOT)


def compared_rows(spec, spans, results, seed):
    """(u [M, ndim], program logL [M]) of the rows compared: the kept whole
    calls (a block of ``n_delete`` rows drawn from the seed where a call
    is larger) and ``dead_points`` dead points drawn from the seed."""
    n_rows = spec.traffic["n_delete"] // spec.chips
    us, ls = [], []
    for i, u, logl in sorted(spans.kept, key=lambda k: k[0]):
        if u.shape[0] > n_rows:
            lo = int(np.random.default_rng([seed % inputs.SEED_SPACE, i])
                     .integers(u.shape[0] - n_rows + 1))
            u, logl = u[lo:lo + n_rows], logl[lo:lo + n_rows]
        us.append(u.float().cpu())
        ls.append(logl.double().cpu())
    n_del = spec.traffic["n_delete"]
    dead_u = np.concatenate([r.samples_u[:r.niter * n_del] for r in results])
    dead_l = np.concatenate([r.logl[:r.niter * n_del] for r in results])
    m = min(int(spec.config["check"]["dead_points"]), dead_u.shape[0])
    if m:
        pick = np.random.default_rng([seed % inputs.SEED_SPACE, 1 << 20]) \
            .choice(dead_u.shape[0], m, replace=False)
        us.append(torch.as_tensor(dead_u[pick], dtype=torch.float32))
        ls.append(torch.as_tensor(dead_l[pick], dtype=torch.float64))
    return torch.cat(us), torch.cat(ls)


def numbers(spec, ref, u, prog_logl, results, device):
    """The numbers ``correct`` compares (check.py), for one run; the
    reference's logL of the compared rows comes back too."""
    ref_logl = ref.log_likelihood(u.to(device)).double().cpu()
    gap, flips = check.logl_numbers(prog_logl, ref_logl)
    tr = spec.traffic
    book = [check.bookkeeping_numbers(r, tr["nlive"], tr["n_delete"])
            for r in results]
    return {"logl_gap": gap, "sentinel_flips": flips,
            "logw_gap": max(b[0] for b in book),
            "logz_gap": max(b[1] for b in book),
            "order_breaks": sum(b[2] for b in book)}, ref_logl


def control_numbers(spec, data_path, u, ref_logl, results, device, control):
    """The same numbers with the reference computed one precision lower put
    in the program's place: ``bf16`` (bfloat16 throughout) or ``tf32``
    (float32 with TF32 matrix products). The sampler's bookkeeping is
    worked out in bfloat16 either way: TF32 touches no operation of it."""
    dtype = torch.bfloat16 if control == "bf16" else torch.float32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        low = reference_model(spec, device, dtype)
        low.photometry.load(data_path)
        low_logl = low.log_likelihood(u.to(device)).double().cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
    gap, flips = check.logl_numbers(low_logl, ref_logl)
    tr = spec.traffic
    book = [check.bookkeeping_numbers(r, tr["nlive"], tr["n_delete"],
                                      against=torch.bfloat16)
            for r in results]
    return {"logl_gap": gap, "sentinel_flips": flips,
            "logw_gap": max(b[0] for b in book),
            "logz_gap": max(b[1] for b in book),
            "order_breaks": sum(b[2] for b in book)}


def rank_digest(results):
    return torch.tensor([[float(r.logz), float(r.niter),
                          float(np.sum(r.logl.astype(np.float64)))]
                         for r in results], dtype=torch.float64)


# -- one rank ---------------------------------------------------------------

def run_rank(spec, seed, seconds, trace, device, t_start, mesh=None,
             controls=()):
    """The run on one process (one card, or one rank of several): returns
    the result line on the rank that reports, else None. ``controls``
    (``bf16``, ``tf32``) adds the control's readings of the same rows under
    ``controls``; the benchmark's own runs ask for none."""
    cuda = torch.device(device).type == "cuda"
    lead = mesh is None or mesh.rank == 0
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        _log(f"torch imported at {T_TORCH - t_start:.2f} s")
        torch.zeros(1, device=device).sum().item()
        _log(f"device ready at {time.time() - t_start:.2f} s")
        data_path = os.path.join(tmp, "photometry.dat")
        prior_path = os.path.join(tmp, "prior.prior")
        inputs.photometry(spec.config, spec.reference(), seed, data_path,
                          device, ROOT)
        inputs.prior_file(spec.config, prior_path)
        _log(f"inputs made at {time.time() - t_start:.2f} s")
        logl, ndim, scfg = spec.program().build(
            spec, data_path, prior_path, os.path.join(tmp, "out"), seed,
            device, ROOT)
        _log(f"program built at {time.time() - t_start:.2f} s")
        tr = spec.traffic
        warm_up(logl, ndim, scfg, device, mesh, seed)
        _log(f"warmed up at {time.time() - t_start:.2f} s")

        spans = Spans(logl, device, seed,
                      int(spec.config["check"]["calls"]))
        slice_calls = range(0)
        prof = None
        if trace and lead:
            slice_calls = range(1, 1 + tr["trace_iterations"] * tr["walks"])
            prof = Slice(cuda)
            spans.hooks = {slice_calls.start: prof.start,
                           slice_calls.stop: prof.stop}
            spans.keep_inputs = set(range(
                slice_calls.start, slice_calls.start + COUNTED_CALLS))
        results, window_s = window(spans, ndim, scfg, seed, seconds,
                                   device, mesh)
        if prof is not None:
            prof.stop()
            slice_calls = range(slice_calls.start,
                                min(slice_calls.stop, spans.calls))
        setup_s = spans.opened_at - t_start
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        dead = sum(r.niter for r in results) * tr["n_delete"]
        counted = torch.tensor([float(sum(spans.rows)),
                                float(spans.failed())], dtype=torch.float64)

        digests = rank_digest(results)
        peaks = [peak]
        agree_gap = 0.0
        if mesh is not None and mesh.group is not None:
            import torch.distributed as dist
            d = digests.to(mesh.device)
            got = [torch.zeros_like(d) for _ in range(mesh.size)]
            dist.all_gather(got, d, group=mesh.group)
            agree_gap = max(float((g.cpu() - digests).abs().max())
                            for g in got)
            pk = torch.tensor([float(peak)], device=mesh.device)
            allp = [torch.zeros_like(pk) for _ in range(mesh.size)]
            dist.all_gather(allp, pk, group=mesh.group)
            peaks = [float(p.item()) for p in allp]
            c = counted.to(mesh.device)
            dist.all_reduce(c, group=mesh.group)
            counted = c.cpu()
        attempted, failed = int(counted[0]), int(counted[1])
        if not lead:
            return None

        # the program's state goes before the reference runs
        u_cmp, l_cmp = compared_rows(spec, spans, results, seed)
        traced = prof.read() if prof is not None else None
        del logl, spans.fn
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ref = reference_model(spec, device)
        ref.photometry.load(data_path)
        nums, ref_logl = numbers(spec, ref, u_cmp, l_cmp, results, device)
        if spec.chips > 1:
            nums["rank_disagreement"] = agree_gap
        correct, checks = check.verdict(
            nums, spec.config["check"]["limits"])

        if trace:
            reading = Reading(spec, spans, traced, slice_calls,
                              spec.counts(), ref, spec.chips)
            metrics = {}
            for m in spec.per_layer:
                value = spec.module("metrics", spec.base(m["name"])) \
                    .read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"dead_points_per_s": dead / window_s,
                      "peak_mem_gib": max(peaks) / GIB, "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[spec.base(m["name"])],
                                   "unit": m["unit"]}
                       for m in spec.end_to_end}
        line = {"correct": bool(correct), "attempted": int(attempted),
                "failed": int(failed), "metrics": metrics,
                "device": {"platform": "gpu" if cuda else "cpu",
                           "kind": (torch.cuda.get_device_name(device)
                                    if cuda else "cpu"),
                           "count": spec.chips,
                           "memory_peak_bytes": int(max(peaks))}}
        if traced is not None:
            line["device"]["busy_s"] = traced.busy_s
            line["device"]["window_s"] = traced.window_s
            line["breakdown"] = {"device_ops": traced.device_ops(),
                                 "idle_gaps": traced.idle_gaps()}
        line["runs"] = {"window_s": window_s, "dead_points": dead,
                        "sampler_runs": len(results),
                        "iterations": [r.niter for r in results],
                        "run_s": spans.run_s,
                        "logz": [r.logz for r in results]}
        if controls:
            line["controls"] = {}
            for control in controls:
                line["controls"][control] = control_numbers(
                    spec, data_path, u_cmp, ref_logl, results, device,
                    control)
        line["checks"] = checks
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- several cards ----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, spec_args, seed, seconds, trace, t_start,
               device_type, controls, prepare, queue):
    """One rank of a several-card run (a spawned process); on the CPU the
    ranks form a gloo group (a rehearsal of the path, no measurement).
    ``prepare``, when given, is a picklable callable whose context the
    rank runs in (the tests plant faults with it)."""
    line, error = None, None
    try:
        import torch.distributed as dist
        from nmma_tpu_torch.parallel import mesh as pmesh
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        pmesh.initialize_distributed(
            init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, device=device)
        mesh = pmesh.make_mesh(device=device)
        with prepare() if prepare else contextlib.nullcontext():
            line = run_rank(Spec(*spec_args), seed, seconds, trace, device,
                            t_start, mesh=mesh, controls=controls)
        if line is not None:
            line["forbidden"] = forbidden_modules()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        error = traceback.format_exc()
    queue.put((rank, line, error))


def run_ranks(spec, seed, seconds, trace, device_type="cuda", t_start=None,
              controls=(), prepare=None):
    """The run over ``spec.chips`` processes, one a card: rank 0's line."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    spec_args = (spec.name, spec.benchmark, spec.dirs[1:])
    procs = [ctx.Process(target=_rank_main, args=(
        r, spec.chips, port, spec_args, seed, seconds, trace,
        T_START if t_start is None else t_start, device_type, controls,
        prepare, queue))
        for r in range(spec.chips)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.time() + seconds + RANK_TIMEOUT_S
    try:
        while len(got) < len(procs) and time.time() < deadline:
            try:
                rank, line, error = queue.get(timeout=5.0)
            except Exception:
                if not any(p.is_alive() for p in procs) and queue.empty():
                    break
                continue
            got[rank] = (line, error)
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errors = [e for _, e in got.values() if e]
    if errors or 0 not in got or got[0][0] is None:
        raise RuntimeError("a rank failed:\n" + "\n".join(
            errors or [f"ranks reported: {sorted(got)}"]))
    line = got[0][0]
    if line.pop("forbidden"):
        raise ImportError("rank 0 loaded a forbidden module")
    return line


# -- the command ------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < spec.chips:
        _log(f"needs {spec.chips} CUDA card(s); found {found}")
        return 2
    if spec.chips == 1:
        line = run_rank(spec, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    else:
        line = run_ranks(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        _log("forbidden modules loaded:", ", ".join(found))
        return 3
    for name, c in line["checks"].items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
