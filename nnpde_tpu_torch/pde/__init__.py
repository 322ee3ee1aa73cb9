from . import ipw, kh, poisson, qho
from .domain import Box

__all__ = ["Box", "ipw", "kh", "poisson", "qho"]
