"""Surrogate training: the SVD + MLP trainer and the two GP backends.

Port of ``nmma_tpu/training/``. Grids are read and decomposed on the host
with numpy; the fits run on the device (the card unless ``device`` says
otherwise).
"""

from .gp import (GPSurrogate, fit_gp_coefficients, load_gp_surrogate,
                 save_gp_surrogate, svd_gp_surrogate_mags, train_svd_gp_model)
from .gp_compact import (CompactGPSurrogate, compact_kernel, fit_compact_gp,
                         train_svd_compact_gp_model)
from .svd import (GRID_PARSERS, SVDTrainingConfig, axial_symmetry,
                  benchmark_svd_model, read_bulla_grid, train_svd_model)

__all__ = ["SVDTrainingConfig", "train_svd_model", "read_bulla_grid",
           "benchmark_svd_model", "axial_symmetry", "GRID_PARSERS",
           "GPSurrogate", "fit_gp_coefficients", "train_svd_gp_model",
           "svd_gp_surrogate_mags", "save_gp_surrogate", "load_gp_surrogate",
           "CompactGPSurrogate", "compact_kernel", "fit_compact_gp",
           "train_svd_compact_gp_model"]
