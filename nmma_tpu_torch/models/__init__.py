from .base import (DetectorLightCurveModel, SourceModel, get_source_model,
                   register_source_model)
from . import grb  # noqa: F401  (registers TrPi2018)
from . import kilonova  # noqa: F401  (registers Me2017, HoNa2020, ...)
from . import shock_cooling  # noqa: F401  (registers Piro2021)
from . import supernova  # noqa: F401  (registers Arnett, Sr2023, ...)
from .combined import make_combined_source_model, stack_magnitudes
from .fiesta import (FiestaSurrogateData, fiesta_from_numpy,
                     load_fiesta_surrogate, make_fiesta_source_model)
from .spectral import (make_salt2_source_model, make_spectral_source_model,
                       spectral_model_from_file)
from .svd import SVDModelData, make_svd_source_model, svd_from_numpy

__all__ = [
    "DetectorLightCurveModel", "SourceModel",
    "get_source_model", "register_source_model", "SVDModelData",
    "make_combined_source_model", "make_svd_source_model",
    "stack_magnitudes", "svd_from_numpy", "make_spectral_source_model",
    "make_salt2_source_model", "spectral_model_from_file",
    "FiestaSurrogateData", "fiesta_from_numpy", "load_fiesta_surrogate",
    "make_fiesta_source_model",
]
