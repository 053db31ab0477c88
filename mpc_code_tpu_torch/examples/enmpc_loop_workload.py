"""The ENMPC flagship closed loop: economic NMPC with the moving-horizon estimator.

A port of ``tools/enmpc_onchip_bench.py`` in its default mode, resident on
the card from step 0 with the growing-horizon MHE warmup in the step.
``examples/enmpc.py`` (Ex_ENMPC) at its full width: nx=2, nu=1, ny=nd=2,
N=25, h=2.0, RK4 with Mx=10, the output-disturbance model, the ContForm
economic OCP by the structured IPM under Gauss-Newton (kernel 4 and the
Riccati KKT kernel once a pass), the economic target by the dense IPM, the
MHE with N_mhe=10 and the 'smooth' arrival-cost update, its window solved
by the structured IPM (the Riccati KKT kernel once a pass at (N, nxa, nu)
= (11, 4, 4), every stage derivative by ``torch.func`` through the MHE
model's RK4 at Mx_mhe=10), and the RK4 plant.  The solver options are the
tool's on a chip (``tools/enmpc_onchip_bench.py:50-59``):
``SolverOptions.for_f32()`` for the target and the MHE,
``for_f32(hessian="gauss_newton")`` for the OCP; every solve runs in the
lanes' dtype.  B lanes start from the example's initial carry with their
plant states perturbed by ``1e-3 * normal`` (seed 0, ``:82-90``).

    cfg = make_config()
    hist, times = run_loop(cfg, draw_x0(16384, device), Nsim=16,
                           step=make_step(cfg, device))

The tool's ``ENMPC_WARM_HANDOFF=1`` mode (a host warmup through
``ClosedLoop``, then the traced continuation) needs the host loop, ROADMAP
Queue 1 item 22: ``warm_handoff`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_code_tpu_torch.config import SolverOptions
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.closed_loop_workload import PHASES, run_loop  # noqa: F401
from mpc_code_tpu_torch.examples.enmpc import make_config as make_enmpc
from mpc_code_tpu_torch.loop.batched import make_mpc_step

N, N_MHE, NSIM = 25, 10, 16
U_BOX = np.array([2.0])           # width of the input bounds [0, 2]


def make_config(N=N, N_mhe=N_MHE, Nsim=NSIM, warm_handoff=False):
    """The flagship loop's configuration at horizon ``N`` and MHE window
    ``N_mhe``."""
    if warm_handoff:
        raise NotImplementedError(
            "the warm hand-off mode needs the host loop ClosedLoop and "
            "MHERuntime, which are not ported yet (ROADMAP Queue 1 item 22)")
    cfg = make_enmpc(Nsim=Nsim).replace(
        N=N, sol_opts_ss=SolverOptions.for_f32(),
        sol_opts_dyn=SolverOptions.for_f32(hessian="gauss_newton"),
        sol_opts_mhe=SolverOptions.for_f32())
    cfg.estimator.N_mhe = N_mhe
    return cfg


def draw_x0(batch, device=None, seed=0, dtype=torch.float32):
    """``batch`` initial plant states: the example's ``x0_p`` plus
    ``1e-3 * normal`` with ``seed``, rounded to f32."""
    cfg = make_enmpc()
    dx = 1e-3 * np.random.default_rng(seed).standard_normal((batch, cfg.nxp))
    x0 = np.asarray(cfg.x0_p, float)[None] + dx
    return torch.as_tensor(x0.astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def make_step(cfg, device=None):
    """The loop's ``make_mpc_step`` (MHE, target, structured OCP) on
    ``device`` (default the card)."""
    return make_mpc_step(cfg, device=device)


def mhe_ocp(cfg, device=None):
    """The structured MHE problem of the loop's estimator (its shapes: N
    = N_mhe + 1, nxa = nu = nx + nd), as ``make_mhe_traced`` builds it."""
    from mpc_code_tpu_torch.estimators.linear import build_augmented
    from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    model = build_model(cfg)
    N = cfg.estimator.N_mhe
    socp, _ = build_structured_mhe(cfg, build_mhe_model(cfg, model),
                                   build_augmented(cfg, model).fy,
                                   build_mhe_cost(cfg.estimator.mhe_cost), N, N,
                                   maskable=True, device=device)
    return socp
