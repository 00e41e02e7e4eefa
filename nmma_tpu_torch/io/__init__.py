from .photometry import (cut_data_to_time_range, load_em_observations,
                         remove_nondetections, shift_to_trigger_time,
                         write_em_observations)
from .results import load_bestfit, load_posterior, save_posterior_csv

__all__ = [
    "load_em_observations", "write_em_observations", "cut_data_to_time_range",
    "shift_to_trigger_time", "remove_nondetections", "save_posterior_csv",
    "load_posterior", "load_bestfit",
]
