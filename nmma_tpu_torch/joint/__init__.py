from .likelihood import MultiMessengerLikelihood

__all__ = ["MultiMessengerLikelihood"]
