from .bolometric import BolometricLikelihood
from .em import EMLikelihood, PhotometryData
from .systematics import SystematicsModel

__all__ = ["BolometricLikelihood", "EMLikelihood", "PhotometryData",
           "SystematicsModel"]
