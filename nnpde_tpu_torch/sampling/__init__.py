from .samplers import face_points, shifted_qmc, sobol_unit, uniform_box

__all__ = ["face_points", "shifted_qmc", "sobol_unit", "uniform_box"]
