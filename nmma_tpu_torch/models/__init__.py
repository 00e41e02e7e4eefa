from .base import (DetectorLightCurveModel, SourceModel, get_source_model,
                   register_source_model)
from . import grb  # noqa: F401  (registers TrPi2018)
from . import kilonova  # noqa: F401  (registers Me2017, HoNa2020, ...)
from .combined import make_combined_source_model, stack_magnitudes
from .svd import SVDModelData, make_svd_source_model, svd_from_numpy

__all__ = [
    "DetectorLightCurveModel", "SourceModel",
    "get_source_model", "register_source_model", "SVDModelData",
    "make_combined_source_model", "make_svd_source_model",
    "stack_magnitudes", "svd_from_numpy",
]
