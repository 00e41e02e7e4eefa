"""logl_mfu [%]: the operations counted for one likelihood call at the
cell's per-call rows (the kernel and every other pass the configuration's
counts file lists) over the mean time of a call, against the f32 peak."""


def read(r):
    share = r.step_mfu()
    return None if share is None else 100.0 * share
