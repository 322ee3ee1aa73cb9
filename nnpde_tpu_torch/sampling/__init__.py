from .samplers import (
    face_points,
    linspace_grid,
    meshgrid_2d,
    shifted_qmc,
    sobol_unit,
    uniform_box,
)

__all__ = ["face_points", "linspace_grid", "meshgrid_2d", "shifted_qmc", "sobol_unit",
           "uniform_box"]
