from .base import (DetectorLightCurveModel, SourceModel, get_source_model,
                   register_source_model)
from . import kilonova  # noqa: F401  (registers Me2017)
from .svd import SVDModelData, make_svd_source_model, svd_from_numpy

__all__ = [
    "DetectorLightCurveModel", "SourceModel",
    "get_source_model", "register_source_model", "SVDModelData",
    "make_svd_source_model", "svd_from_numpy",
]
