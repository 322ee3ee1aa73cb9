from . import ipw, poisson, qho
from .domain import Box

__all__ = ["Box", "ipw", "poisson", "qho"]
