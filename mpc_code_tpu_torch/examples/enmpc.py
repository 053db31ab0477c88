"""Economic NMPC of a 2-state reactor with MHE (port of
``mpc_code_tpu/examples/enmpc.py``; reference: Ex_ENMPC.py).

StateFeedback outputs, output-disturbance model (Bd=0, Cd=I), economic
steady-state and continuous-time stage costs u*(alfa*cA0 - beta*y2)
(ContForm -> quadrature of the stage cost over each interval), user terminal
weight 2000*||x-xs||^2, MHE with N_mhe=10 and the 'smooth' prior update
(``estimators/mhe.py``).  The maps are written in torch ops on indexed
components, so each argument may be one point or lanes-minor (dim, L), and
``torch.fx`` traces them for the CUDA sweep.
"""

import numpy as np
import torch

from mpc_code_tpu_torch.config import (
    Bounds, ContinuousModel, ContinuousPlant, DisturbanceModel,
    EstimatorConfig, MHECost, MPCConfig, SolverOptions, SSCost, StageCost,
    TerminalCost,
)

CA0 = 1.0
V = 1.0
K1 = 1.0
K2 = 0.05
ALFA = 1.0
BETA = 4.0


def plant_fxp(xp, t, u, pxp, pxmp):
    """Reactor ODE (Ex_ENMPC.py:45-62)."""
    return torch.stack([
        u[0] * (CA0 - xp[0]) / V - K1 * xp[0],
        -u[0] * xp[1] / V + K1 * xp[0] - K2 * xp[1],
    ])


def model_fxm(x, u, d, t, px):
    """Model ODE (Ex_ENMPC.py:74-91) — same structure as the plant."""
    return torch.stack([
        u[0] * (CA0 - x[0]) / V - K1 * x[0],
        -u[0] * x[1] / V + K1 * x[0] - K2 * x[1],
    ])


def mhe_fx(x, u, d, t, px, w):
    """MHE state map (Ex_ENMPC.py:136-155) — noise enters via G."""
    return model_fxm(x, u, d, t, px)


def user_fssobj(x, u, y, xsp, usp, ysp):
    """Economic steady-state cost (Ex_ENMPC.py:196-214)."""
    return u[0] * (ALFA * CA0 - BETA * y[1])


def user_fobj_cont(x, u, y, xs, us, ys):
    """Economic continuous stage cost (Ex_ENMPC.py:217-233)."""
    return u[0] * (ALFA * CA0 - BETA * y[1])


def user_vfin(x, xs):
    """Terminal weight (Ex_ENMPC.py:236-252)."""
    diffx = x - xs
    return 2000.0 * (diffx @ diffx)


def user_fobj_mhe(w, v, t):
    """MHE cost with identity covariances (Ex_ENMPC.py:158-177)."""
    return 0.5 * (w @ w + v @ v)


def make_config(Nsim: int = 21) -> MPCConfig:
    nx, nu, ny, nd = 2, 1, 2, 2

    return MPCConfig(
        nx=nx, nxp=2, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=25, h=2.0,
        StateFeedback=True,
        model=ContinuousModel(fx=model_fxm, Mx=10),
        plant=ContinuousPlant(fx=plant_fxp, Mx=10),
        dist=DisturbanceModel(offree="lin", Bd=np.zeros((nd, nd)), Cd=np.eye(nd)),
        x0_p=np.array([0.9, 0.1]),
        x0_m=np.array([1.2, 0.5]),
        u0=np.array([0.0]),
        ss_cost=SSCost(f_obj=user_fssobj),
        stage_cost=StageCost(f_cont=user_fobj_cont),
        terminal=TerminalCost(vfin=user_vfin),
        estimator=EstimatorConfig(
            kind="mhe",
            N_mhe=10,
            mhe_up="smooth",
            fx_mhe_cont=mhe_fx,
            Mx_mhe=10,
            mhe_cost=MHECost(f_obj=user_fobj_mhe),
            P0=np.eye(nx + nd),
            x_bar0=np.array([1.2, 0.5, 0.0, 0.0]),
        ),
        bounds=Bounds(
            umin=np.array([0.0]), umax=np.array([2.0]),
            xmin=np.array([0.0, 0.0]), xmax=np.array([1.0, 1.0]),
        ),
        sol_opts_dyn=SolverOptions(max_iter=200),  # Sol_itmax=200 (Ex_ENMPC.py:255)
    )
