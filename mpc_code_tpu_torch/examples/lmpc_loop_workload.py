"""The warm batched LMPC closed loop on the nonlinear CSTR plant.

``examples/lmpc_nlplant.py`` (Ex_LMPC_nlplant) at its full width: nx=3,
nu=2, ny=nd=2, N=50, h=0.2; the affine linear model around ``(xlin,
ulin)`` with ``Bd = B`` (``offree='lin'``), the time-varying Kalman filter
(``kal``), DUForm (the stage cost's ``S``, so the structured OCP carries
u_prev and nxa=5), the state and input boxes, the Riccati terminal weight,
the nonlinear CSTR plant by RK4 with Mx=10 and the ``defSP`` setpoint
steps.  The solver options are those of ``tools/closed_loop_bench.py:48-51``:
the OCP by the structured IPM under Gauss-Newton with the dual warm start,
the target by the dense IPM, both ``SolverOptions.for_f32(max_iter=10)``.
A linear model has no derivative kernel: each OCP iteration takes its stage
derivatives from ``torch.func`` and runs the Riccati KKT kernel once.  The
OCP runs in the lanes' dtype; the target is solved in TARGET_DTYPE =
float64 whatever the lanes' dtype, as in ``closed_loop_workload.py``.
B scenarios step together and share the step inputs; each lane's plant
starts from its own state, drawn uniformly from the box XLO..XHI (inside
the state bounds) with ``seed``, and its estimate from the example's
``x0_m``.

    cfg = make_config()
    hist, times = run_loop(cfg, draw_x0(16384, device), Nsim=6,
                           step=make_step(cfg, device))
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_code_tpu_torch.config import SolverOptions
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.closed_loop_workload import PHASES, run_loop  # noqa: F401
from mpc_code_tpu_torch.examples.lmpc_nlplant import make_config as make_lmpc
from mpc_code_tpu_torch.loop.batched import make_mpc_step

N, NSIM, MAX_ITER = 50, 6, 10
TARGET_DTYPE = torch.float64
XLO = np.array([0.45, 345.0, 0.62])       # the lanes' initial plant states
XHI = np.array([0.55, 355.0, 0.70])
U_BOX = np.array([305.0 - 295.0, 0.25])   # width of the input bounds


def make_config(N=N, max_iter=MAX_ITER):
    """The LMPC closed loop's configuration at horizon ``N``."""
    return make_lmpc().replace(
        N=N,
        sol_opts_dyn=SolverOptions.for_f32(max_iter=max_iter, hessian="gauss_newton"),
        sol_opts_ss=SolverOptions.for_f32(max_iter=max_iter))


def draw_x0(batch, device=None, seed=0, dtype=torch.float32):
    """``batch`` initial plant states, uniform on XLO..XHI with ``seed``,
    rounded to f32."""
    x0 = np.random.default_rng(seed).uniform(XLO, XHI, size=(batch, 3))
    return torch.as_tensor(x0.astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def make_step(cfg, device=None):
    """The loop's ``make_mpc_step``: structured OCP, targets in
    TARGET_DTYPE, on ``device`` (default the card)."""
    return make_mpc_step(cfg, device=device, target_dtype=TARGET_DTYPE)
