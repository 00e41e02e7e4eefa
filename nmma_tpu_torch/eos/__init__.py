"""EOS tables, the TOV solver, NEP and CSE table generation, and EOS
constraints: the PyTorch counterparts of ``nmma_tpu.eos``'s modules on the
joint GW + EM + EOS path, and the baryonic-mass tables of the
maximum-mass resampler (``baryonic``). (``emulator`` and ``lec`` are not
ported yet.)"""

from .cse import cse_eos_family, cse_extend, mixed_low_density_eos
from .eos import EOSTable, TabulatedEOSSet, load_macro_eos_set
from .generation import (crust_from_micro_table, eos_from_nep,
                         nep_eos_table)
from .likelihood import tabulate_weighted_eos
from .tov import construct_families, construct_family, tov_solve

__all__ = ["EOSTable", "TabulatedEOSSet", "load_macro_eos_set",
           "tov_solve", "construct_family", "construct_families",
           "eos_from_nep", "crust_from_micro_table", "nep_eos_table",
           "cse_eos_family", "cse_extend", "mixed_low_density_eos",
           "tabulate_weighted_eos"]
