from .poisson import PoissonConfig, train_poisson_nd

__all__ = ["PoissonConfig", "train_poisson_nd"]
