from .checkpoint import load_params, load_train_state, save_params, save_train_state
from .ledger import append_result, load_results, save_curves

__all__ = ["append_result", "load_params", "load_results", "load_train_state", "save_curves",
           "save_params", "save_train_state"]
