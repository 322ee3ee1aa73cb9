from .lbfgs import lbfgs_fit, lbfgs_polish
from .optim import ScheduledAdam, make_optimizer, make_wan_optimizers
from .trainer import FitResult, fit, fit_wan

__all__ = ["FitResult", "ScheduledAdam", "fit", "fit_wan", "lbfgs_fit", "lbfgs_polish",
           "make_optimizer", "make_wan_optimizers"]
