"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Each is a context manager that patches the program in this
process."""

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def state_unchanged():
    """Each sampler iteration leaves the live set as it found it."""
    from nmma_tpu_torch.inference.nested import NestedSampler
    original = NestedSampler._iteration

    def iteration(self, st, gen):
        u, logl = st.u_live, st.logl_live
        out = original(self, st, gen)
        st.u_live, st.logl_live = u, logl
        return out
    return patched(NestedSampler, "_iteration", iteration)


def half_batch():
    """Only the first half of each batch is evaluated; the rest get that
    half's mean."""
    from nmma_tpu_torch.analysis import EMAnalysis
    original = EMAnalysis.batched_logl

    def batched_logl(self, u):
        half = max(1, u.shape[0] // 2)
        part = original(self, u[:half])
        fill = part[part > -1e29].mean() if bool((part > -1e29).any()) \
            else part[0]
        return torch.cat([part, fill.expand(u.shape[0] - half)])
    return patched(EMAnalysis, "batched_logl", batched_logl)


def answer_altered():
    """The first row of each batch gets the last row's answer (an answer
    sent to the wrong row)."""
    from nmma_tpu_torch.analysis import EMAnalysis
    original = EMAnalysis.batched_logl

    def batched_logl(self, u):
        out = original(self, u).clone()
        out[0] = out[-1]
        return out
    return patched(EMAnalysis, "batched_logl", batched_logl)


def exchange_left_out():
    """Each rank keeps only its own rows of a sharded call (the
    all_reduce is skipped)."""
    import torch.distributed as dist
    return patched(dist, "all_reduce", lambda t, *a, **k: None)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "exchange_left_out": exchange_left_out}
