from .em import EMLikelihood, PhotometryData
from .systematics import SystematicsModel

__all__ = ["EMLikelihood", "PhotometryData", "SystematicsModel"]
