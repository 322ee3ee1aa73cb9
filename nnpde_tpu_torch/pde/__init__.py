from . import ipw, poisson
from .domain import Box

__all__ = ["Box", "ipw", "poisson"]
