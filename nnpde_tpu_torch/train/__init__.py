from .lbfgs import lbfgs_fit, lbfgs_polish
from .optim import MultiTransformAdam, ScheduledAdam, make_optimizer, make_wan_optimizers
from .trainer import FitResult, fit, fit_wan, leaf_labels

__all__ = ["FitResult", "MultiTransformAdam", "ScheduledAdam", "fit", "fit_wan", "lbfgs_fit",
           "lbfgs_polish", "leaf_labels", "make_optimizer", "make_wan_optimizers"]
