from . import poisson
from .domain import Box

__all__ = ["Box", "poisson"]
