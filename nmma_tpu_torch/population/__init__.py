from .likelihood import NeutronStarPopulation

__all__ = ["NeutronStarPopulation"]
