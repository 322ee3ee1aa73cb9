from .optim import ScheduledAdam, make_optimizer
from .trainer import FitResult, fit

__all__ = ["FitResult", "ScheduledAdam", "fit", "make_optimizer"]
