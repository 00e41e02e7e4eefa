"""The body that every ``<kernel>_roofline`` reader shares [%]: the counted
bound of the configuration's kernel (the larger of its operations at the
f32 peak and its bytes at the memory rate, from the configuration's counts
file, which also names the kernel) over its device time from the profiler,
launch by launch over the first counted calls of the traced slice. It is
not a metric of its own: ``k1_roofline.py`` and the others import it."""


def read(r):
    share = r.kernel_roofline()
    return None if share is None else 100.0 * share
