"""Model and cost constructors (plain callables over torch tensors)."""

from mpc_code_tpu_torch.models.model import (
    ModelFns, PlantFns, build_mhe_model, build_model, build_plant,
)
from mpc_code_tpu_torch.models.costs import (
    build_mhe_cost,
    build_ss_cost,
    build_stage_cost,
    build_terminal_cost,
)

__all__ = ["ModelFns", "PlantFns", "build_model", "build_plant", "build_mhe_model",
           "build_stage_cost", "build_ss_cost", "build_terminal_cost", "build_mhe_cost"]
