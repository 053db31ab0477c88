"""Estimator family: Luenberger, KF, steady-state KF, EKF (MHE: ROADMAP Queue 1 items 16-17)."""

from mpc_code_tpu_torch.estimators.linear import build_augmented, kalman, kalss, kalss_gain
from mpc_code_tpu_torch.estimators.ekf import ekf

__all__ = ["kalman", "kalss", "kalss_gain", "build_augmented", "ekf"]
