from .samplers import (
    face_points,
    first_fraction_every_kth,
    first_fraction_indices,
    linspace_grid,
    meshgrid_2d,
    mid_fraction_every_kth,
    shifted_qmc,
    sobol_box,
    sobol_unit,
    uniform_box,
)

__all__ = ["face_points", "first_fraction_every_kth", "first_fraction_indices",
           "linspace_grid", "meshgrid_2d", "mid_fraction_every_kth", "shifted_qmc",
           "sobol_box", "sobol_unit", "uniform_box"]
