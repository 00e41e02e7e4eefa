"""device_idle_share [%]: 1 minus the union of the device records over the
traced slice (rank 0 on several cards)."""


def read(r):
    share = r.idle_share()
    return None if share is None else 100.0 * share
