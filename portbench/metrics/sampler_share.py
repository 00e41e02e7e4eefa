"""sampler_share [%]: the window's device time outside the calls into the
likelihood layer (between one call's end event and the next call's start
event, and before the first and after the last), over the window
(inference/nested.py). The traced slice is left out."""


def read(r):
    share = r.sampler_share()
    return None if share is None else 100.0 * share
