"""launches_per_call [launches]: the profiler's CUDA kernel records in the
traced slice over the likelihood calls in it (models/, ops/)."""


def read(r):
    return r.launches_per_call()
