"""Model registry: rebuild a SolutionModel from checkpoint metadata.

Counterpart of ``nnpde_tpu/models/registry.py``.  A parameter checkpoint
(:mod:`nnpde_tpu_torch.exp.checkpoint`) carries a small meta dict (problem,
layers, activation, technique, quantum numbers, box) and this module
rebuilds the exact model from it, trial factor included, so a checkpoint
written by either package loads in either.
"""

from __future__ import annotations

from typing import Dict

from ..pde import ipw as ipw_phys
from ..pde import qho as qho_phys
from .inputmap import CosineInputMap
from .mlp import NetSpec
from .solution import SolutionModel
from .trial import factor_for_technique


def _critic(problem: str, spec: NetSpec, technique: str, meta: Dict) -> SolutionModel:
    """The WAN critic's factor rules, which differ from the primal's: the
    Poisson, 1D well and KH critics are raw nets; the 1D oscillator's
    critic takes the primal's exp window unless the technique is BC; the
    2D well and 2D oscillator critics always take the FBC factor."""
    if problem in ("poisson_nd", "ipw_1d", "ipw_1d_wan", "kh_1d"):
        return SolutionModel(spec)
    if problem in ("qho_1d", "qho_1d_wan"):
        factor = (factor_for_technique("OG", dim=1, kind="window", L=meta["x_max"])
                  if technique != "BC" else None)
        return SolutionModel(spec, factor)
    if problem == "ipw_2d":
        return SolutionModel(spec, factor_for_technique("FBC", dim=2, kind="box", L=meta["L"]))
    if problem == "qho_2d":
        return SolutionModel(spec, factor_for_technique("FBC", dim=2, kind="window",
                                                        L=meta["L"]))
    raise ValueError(f"Unknown critic problem {problem!r}")


def build_solution_model(meta: Dict) -> SolutionModel:
    """meta schema: {problem, layers, activation, technique, n|nx/ny,
    L|x_max, role?}.  ``role='critic'`` rebuilds the WAN critic with the
    critic's factor rules."""
    problem = meta["problem"]
    layers = tuple(meta["layers"])
    technique = meta.get("technique", "RAW")
    spec = NetSpec(layers, activation=meta.get("activation", "tanh"))

    if meta.get("role") == "critic":
        return _critic(problem, spec, technique, meta)

    if problem == "poisson_nd":
        dim = layers[0]
        bc_mode = meta.get("bc_mode", "FBC")
        if meta.get("bc_type", "dirichlet") == "neumann" and bc_mode == "FBC":
            # hard Neumann: the raw net on the cosine input features, no factor
            return SolutionModel(spec, input_map=CosineInputMap(dim, 0.0, meta["L"]))
        return SolutionModel(spec, factor_for_technique(
            "FBC" if bc_mode == "FBC" else "RB", dim=dim, kind="box", L=meta["L"]))
    if problem in ("ipw_1d", "ipw_1d_wan"):
        n, L = meta["n"], meta["L"]
        return SolutionModel(spec, factor_for_technique(
            technique, dim=1, kind="box", L=L,
            nodes_per_dim=[ipw_phys.nodes(n, L)] if technique == "FN" else None))
    if problem == "ipw_2d":
        nx, ny, L = meta["nx"], meta["ny"], meta["L"]
        return SolutionModel(spec, factor_for_technique(
            technique, dim=2, kind="box", L=L,
            nodes_per_dim=([ipw_phys.nodes(nx, L), ipw_phys.nodes(ny, L)]
                           if technique == "FN" else None)))
    if problem in ("qho_1d", "qho_1d_wan"):
        n = meta["n"]
        return SolutionModel(spec, factor_for_technique(
            "OG" if technique in ("OG", "FBC") else technique, dim=1, kind="window",
            L=meta["x_max"], nodes_per_dim=[qho_phys.nodes(n)] if technique == "FN" else None))
    if problem == "qho_2d":
        nx, ny = meta["nx"], meta["ny"]
        return SolutionModel(spec, factor_for_technique(
            technique, dim=2, kind="window", L=meta["L"],
            nodes_per_dim=([qho_phys.nodes(nx), qho_phys.nodes(ny)]
                           if technique == "FN" else None)))
    if problem == "kh_1d":
        return SolutionModel(spec, factor_for_technique(technique, dim=1, kind="window",
                                                        L=meta["L"]))
    raise ValueError(f"Unknown problem {problem!r}")
