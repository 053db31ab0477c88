"""Estimator family: Luenberger, KF, steady-state KF, EKF and the traced MHE."""

from mpc_code_tpu_torch.estimators.linear import build_augmented, kalman, kalss, kalss_gain
from mpc_code_tpu_torch.estimators.ekf import ekf
from mpc_code_tpu_torch.estimators.mhe import (
    MHECarry, MHESmoothState, make_mhe_cold_carry, make_mhe_traced,
)

__all__ = ["kalman", "kalss", "kalss_gain", "build_augmented", "ekf",
           "MHECarry", "MHESmoothState", "make_mhe_traced", "make_mhe_cold_carry"]
