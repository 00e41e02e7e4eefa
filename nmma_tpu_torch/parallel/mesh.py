"""Process groups for the nested sampler: likelihood batches split over ranks.

Counterpart of ``nmma_tpu/parallel/mesh.py``. The reference farmed
likelihood calls over MPI workers (``nmma/core/mpi_setup.py:604-683``,
SURVEY.md §2.7); the JAX package shards the live-point batch over a device
mesh and lets GSPMD insert the collectives. Here the ranks of a
``torch.distributed`` group (one process per card, started by ``torchrun``)
share the work differently:

* every rank keeps the whole sampler state and draws from a generator
  seeded with the same seed, so all its random numbers equal every other
  rank's;
* only the likelihood calls are split (:func:`shard_logl`): rank r
  evaluates its ``B / W`` rows of the ``[B, ndim]`` batch, and one
  collective gives every rank all ``B`` values;
* every accept decision, and so every state, is then the same on every
  rank.

The live set is tiny (64 KiB at nlive 1,024 and 16 dimensions) and its
top-k, Cholesky and bookkeeping take microseconds, so replicating it costs
nothing beside the likelihood, and the threshold needs no gather of the
live set. The JAX package's ``live_point_sharding``, ``replicated`` and
``state_shardings`` name XLA layouts of the state; a replicated state has
none, and :func:`shard_logl` takes the place of the batch-sharded layout of
the proposal batch.

Lockstep holds while the ranks run the same operations on equal inputs,
which Cholesky, ``topk`` and ``index_copy`` do on one model of card.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device, tracing

# a lost rank raises at the next collective after this long instead of
# hanging
TIMEOUT = timedelta(minutes=3)

# torchrun's environment: with all three set, the group forms from it
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


@dataclass(frozen=True)
class BatchMesh:
    """The ranks that split each likelihood batch: ``group`` (None for the
    one-process mesh), this process's ``rank`` in it, its ``size`` and the
    ``device`` this rank's tensors live on."""
    group: object
    rank: int
    size: int
    device: torch.device


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           backend=None, device=None):
    """Form the default process group (reference counterpart: the rank
    discipline of ``core/mpi_setup.py``).

    Does nothing when a group exists, or when it gets none of
    ``init_method``, ``world_size`` and ``rank`` and the environment is not
    torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``). Otherwise calls
    ``torch.distributed.init_process_group``: the backend is ``nccl`` when
    ``device`` is a CUDA device (None means the card, and raises without
    one) and ``gloo`` when it is the CPU, unless ``backend`` names one.
    A collective that waits longer than ``TIMEOUT`` raises.
    """
    if dist.is_initialized():
        return
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if not explicit and not all(v in os.environ for v in _TORCHRUN_ENV):
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=TIMEOUT)


def make_mesh(n_devices=None, device=None):
    """The batch mesh over every rank of the default group, or its first
    ``n_devices`` ranks; without a group, the one-process mesh (size 1, no
    group, no collective).

    ``device`` None means this rank's card: ``cuda:LOCAL_RANK`` (0 without
    torchrun), made the current device before anything is built on it, so
    that ``device=None`` elsewhere in the port lands on the same card.
    Every rank of the group calls this; ranks from ``n_devices`` on are not
    in the mesh and get None.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(
            f"requested {n} devices, have {have} "
            f"(multi-process: call initialize_distributed() first)")
    if not dist.is_initialized():
        return BatchMesh(group=None, rank=0, size=1, device=device)
    group = dist.group.WORLD if n == have else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return BatchMesh(group=group, rank=rank, size=n, device=device)


def check_divides(name, n, mesh):
    """Raise a ValueError unless ``n`` (the length of the batch axis
    ``name``) divides into the mesh's ranks."""
    if n % mesh.size != 0:
        raise ValueError(f"{name} axis ({n}) must divide the mesh size "
                         f"({mesh.size})")


def shard_logl(logl_fn, mesh):
    """``logl_fn`` split over the mesh: a batched ``u [B, ndim] -> [B]`` in
    which rank r evaluates rows ``[r B/W, (r+1) B/W)`` and one
    ``all_reduce`` gives every rank all ``B`` values.

    Each rank writes its rows into a zero-filled ``[B]`` buffer, so every
    slot of the sum is one value plus zeros and is exact: the ``-1e30``
    sentinel, ``-inf`` and NaN come through unchanged. NCCL and gloo both
    take this collective on CUDA and CPU tensors (gloo's all-gather does
    not take CUDA ones). Without a group it returns ``logl_fn`` itself.
    """
    if mesh.group is None:
        return logl_fn

    def sharded(u):
        check_divides("batch", u.shape[0], mesh)
        rows = u.shape[0] // mesh.size
        lo = mesh.rank * rows
        part = logl_fn(u[lo:lo + rows])
        out = part.new_zeros((u.shape[0],))
        out[lo:lo + rows] = part
        with tracing.span("mesh.all_reduce", batch=out):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        tracing.count(tracing.MESH_COLLECTIVES)
        return out

    return sharded


def agree(mesh, *flags):
    """Each flag true on some rank of the mesh, by one ``all_reduce(MAX)``
    (the flags of one rank alone without a group): rank-local stop
    conditions, such as a signal or a wall-clock cap, must end every rank
    after the same chunk, or the next collective waits forever."""
    if mesh is None or mesh.group is None:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([float(bool(f)) for f in flags], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return tuple(bool(v) for v in t.tolist())


def shard_state(state, mesh):
    """The sampler state on the mesh's device, after checking that its live
    arrays (``u_live``, ``logl_live``) divide the mesh size. Every rank
    keeps the whole state (module docstring)."""
    for name in ("u_live", "logl_live"):
        check_divides(name, getattr(state, name).shape[0], mesh)
    return dataclasses.replace(state, **{
        name: value.to(mesh.device) for name, value in vars(state).items()
        if isinstance(value, torch.Tensor) and name != "rng_state"})
