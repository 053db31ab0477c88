"""Nonlinear MPC on the CSTR (port of ``mpc_code_tpu/examples/nmpc.py``;
reference: Ex_NMPC.py).

Nonlinear continuous model where the feed flow F0 is the second disturbance
component (offree='nl').  The right-hand side is written in torch ops on
indexed components, so ``x`` may be one point (nx,) or lanes-minor (nx, L),
and ``torch.fx`` traces it for the CUDA sweep.  Constants are unchanged.
"""

import math

import numpy as np
import scipy.linalg as scla
import torch

from mpc_code_tpu_torch.config import (
    Bounds, ContinuousModel, ContinuousPlant, DisturbanceModel,
    EstimatorConfig, MPCConfig, SSCost, StageCost,
)

T0 = 350.0
c0 = 1.0
r = 0.219
k0 = 7.2e10
EoR = 8750.0
U0 = 915.6 * 60 / 1000
rho = 1000.0
Cp2 = 0.239
DH = -5.0e4
PI = math.pi
kT0 = k0 * math.exp(-EoR / T0)
Ar = PI * r**2


def _cstr_rhs(x, u, F0):
    rate = kT0 * torch.exp(-EoR * (1.0 / x[1] - 1.0 / T0)) * x[0]
    return torch.stack([
        F0 * (c0 - x[0]) / (Ar * x[2]) - rate,
        F0 * (T0 - x[1]) / (Ar * x[2]) - DH / (rho * Cp2) * rate
        + 2 * U0 / (r * rho * Cp2) * (u[0] - x[1]),
        (F0 - u[1]) / Ar,
    ])


def plant_fxp(x, t, u, pxp, pxmp):
    """Plant ODE with scheduled feed flow (Ex_NMPC.py:40-78).  The flows
    are tensors of the state's dtype: ``torch.where`` on two Python floats
    rounds them to f32 (ROADMAP Queue 3, F10)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    F0 = torch.where(t <= 5, c(0.1), torch.where(t <= 15, c(0.15),
                                                 torch.where(t <= 25, c(0.08), c(0.1))))
    return _cstr_rhs(x, u, F0)


def plant_fyp(x, u, t, pyp, pymp):
    return torch.stack([x[0], x[2]])  # Ex_NMPC.py:83-105


def model_fxm(x, u, d, t, px):
    """Model ODE with F0 = d[1] (nonlinear disturbance, Ex_NMPC.py:114-150)."""
    return _cstr_rhs(x, u, d[1])


def model_fym(x, u, d, t, py):
    return torch.stack([x[0], x[2]])  # Ex_NMPC.py:153-175


def make_config(Nsim: int = 201) -> MPCConfig:
    nx, nu, ny, nd = 3, 2, 2, 2

    def defSP(t):
        return (np.array([0.874317, 0.6528]), np.array([300.157, 0.1]), np.zeros(3))

    Qx_kf = 1.0e-5 * np.eye(nx)
    Qd_kf = np.eye(nd)

    return MPCConfig(
        nx=nx, nxp=3, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=0.2,
        model=ContinuousModel(fx=model_fxm, Mx=10, fy=model_fym),
        plant=ContinuousPlant(fx=plant_fxp, Mx=10, fy=plant_fyp),
        dist=DisturbanceModel(offree="nl"),
        x0_p=np.array([0.874317, 325.0, 0.6528]),
        x0_m=np.array([0.874317, 325.0, 0.6528]),
        u0=np.array([300.157, 0.1]),
        dhat0=np.array([0.0, 0.1]),
        ss_cost=SSCost(Qss=np.array([[10.0, 0.0], [0.0, 1.0]]), Rss=np.zeros((nu, nu))),
        stage_cost=StageCost(Q=np.eye(nx), R=0.1 * np.eye(nu)),
        estimator=EstimatorConfig(
            kind="ekf",
            Q_kf=scla.block_diag(Qx_kf, Qd_kf),
            R_kf=1.0e-4 * np.eye(ny),
            P0=np.ones((nx + nd, nx + nd)),
        ),
        bounds=Bounds(
            umin=np.array([295.0, 0.0]), umax=np.array([305.0, 0.25]),
            xmin=np.array([0.0, 315.0, 0.50]), xmax=np.array([1.0, 375.0, 0.75]),
            ymin=np.array([0.0, 0.5]), ymax=np.array([1.0, 1.0]),
            dmin=-100 * np.ones(nd), dmax=100 * np.ones(nd),
        ),
        defSP=defSP,
        R_wn=1e-7 * np.eye(ny),
    )
