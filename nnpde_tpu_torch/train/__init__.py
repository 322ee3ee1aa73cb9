from .optim import ScheduledAdam, make_optimizer, make_wan_optimizers
from .trainer import FitResult, fit, fit_wan

__all__ = ["FitResult", "ScheduledAdam", "fit", "fit_wan", "make_optimizer",
           "make_wan_optimizers"]
