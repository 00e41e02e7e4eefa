"""collective_share [%]: NCCL kernels' device time over rank 0's busy time
in the traced slice (parallel/mesh.py)."""


def read(r):
    share = r.collective_share()
    return None if share is None else 100.0 * share
