"""Numerical building blocks: integrators, small linear algebra, kernels."""

from mpc_code_tpu_torch.ops.integrators import rk4, rk4_quad
from mpc_code_tpu_torch.ops.dare import dare_gain, solve_dare
from mpc_code_tpu_torch.ops.linalg import solve_sym, sqrtm_psd

__all__ = ["rk4", "rk4_quad", "solve_dare", "dare_gain", "sqrtm_psd", "solve_sym"]
