"""Model and cost constructors (plain callables over torch tensors)."""

from mpc_code_tpu_torch.models.model import ModelFns, build_model
from mpc_code_tpu_torch.models.costs import (
    build_ss_cost,
    build_stage_cost,
    build_terminal_cost,
)

__all__ = ["ModelFns", "build_model", "build_stage_cost", "build_ss_cost",
           "build_terminal_cost"]
