"""The analysis web service (port of ``nmma_tpu/api``)."""

from .app import AnalysisService, run_nmma_model

__all__ = ["AnalysisService", "run_nmma_model"]
