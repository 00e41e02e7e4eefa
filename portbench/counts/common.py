"""Operations of the likelihood passes that every configuration shares,
counted from shapes: an FMA counts two, a transcendental one, a compare or
select one. These are the work the passes need, whatever implements them:
a later change that fuses or removes a pass changes the time, not the
count."""

import math

# the detector frame per (row, filter, grid time): extinction, distance
# modulus and redshift correction added (3), the finite test and count (2)
DETECTOR_OPS = 5
# per (row, grid time): the observer time t (1 + z) + timeshift
DETECTOR_TIME_OPS = 2
# per (row, observation): a binary search of the row's grid (a compare and
# a select a step), the two-node interpolation (4), the validity tests (4)
# and the Gaussian or survival term with its mask (10)
EPOCH_OPS = 18


def search_ops(n):
    return 2 * math.ceil(math.log2(n))


def likelihood_ops(rows, n_filters, n_times, n_obs):
    """Operations of the detector frame, the interpolation onto the epochs
    and the likelihood terms for ``rows`` rows, ``n_filters`` filters,
    ``n_times`` grid times and ``n_obs`` observations in all."""
    return rows * (n_filters * n_times * DETECTOR_OPS
                   + n_times * DETECTOR_TIME_OPS
                   + n_obs * (EPOCH_OPS + search_ops(n_times)))
