"""LMPC on a nonlinear CSTR plant (port of
``mpc_code_tpu/examples/lmpc_nlplant.py``; reference: Ex_LMPC_nlplant.py).

Nonlinear continuous-time plant (RK4, Mx=10), affine linear controller model
linearized at (xlin, ulin), input-channel disturbance model (Bd=B, Cd=0),
Kalman filter, QP costs with S (DUForm), Riccati terminal weight.  The
plant ODE is written in torch ops on indexed components; its constants are
Python floats, which keep the state's dtype.
"""

import math

import numpy as np
import scipy.linalg as scla
import torch

from mpc_code_tpu_torch.config import (
    Bounds, ContinuousPlant, DisturbanceModel, EstimatorConfig, LinearModel,
    MPCConfig, SSCost, StageCost,
)

# CSTR physical constants (Ex_LMPC_nlplant.py:56-67)
F0 = 0.1
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


def cstr_fxp(x, t, u, pxp, pxmp):
    """Nonlinear CSTR ODE (Ex_LMPC_nlplant.py:40-76)."""
    rate = kT0 * torch.exp(-EoR * (1.0 / x[1] - 1.0 / T0)) * x[0]
    return torch.stack([
        F0 * (c0 - x[0]) / (PI * r**2 * x[2]) - rate,
        F0 * (T0 - x[1]) / (PI * r**2 * x[2]) - DH / (rho * Cp2) * rate
        + 2 * U0 / (r * rho * Cp2) * (u[0] - x[1]),
        (F0 - u[1]) / (PI * r**2),
    ])


def make_config(Nsim: int = 200) -> MPCConfig:
    nx, nu, ny, nd = 3, 2, 2, 2

    A = np.array([[0.51448, -0.00917517, -0.117995],
                  [53.6817, 2.15004, -3.77725],
                  [0.0, 0.0, 1.0]])
    B = np.array([[-0.0017669, 0.0864569],
                  [0.639423, 1.60696],
                  [0.0, -1.32737]])
    C = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    xlin = np.array([0.5, 350.0, 0.659])
    ulin = np.array([300.0, 0.1])

    def defSP(t):
        xsp = np.zeros(3)
        usp = np.array([299.963, 0.1])
        if t < 20:
            ysp = np.array([0.5, 0.659])
        elif t < 40:
            ysp = np.array([0.51, 0.659])
        else:
            ysp = np.array([0.50, 0.659])
        return ysp, usp, xsp

    Qx_kf = 1.0e-5 * np.eye(nx)
    Qd_kf = np.eye(nd)
    Q_kf = scla.block_diag(Qx_kf, Qd_kf)

    return MPCConfig(
        nx=nx, nxp=3, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=0.2,
        model=LinearModel(A=A, B=B, C=C, xlin=xlin, ulin=ulin),
        plant=ContinuousPlant(fx=cstr_fxp, Mx=10, Cp=C.copy()),
        dist=DisturbanceModel(offree="lin", Bd=B.copy(), Cd=np.zeros((ny, nd))),
        x0_p=np.array([0.5, 350.0, 0.659]),
        x0_m=np.array([0.5, 350.0, 0.659]),
        u0=np.array([300.0, 0.1]),
        ss_cost=SSCost(Qss=np.array([[10.0, 0.0], [0.0, 0.01]]), Rss=np.zeros((nu, nu))),
        stage_cost=StageCost(
            Q=np.array([[10.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
            S=np.array([[0.1, 0.0], [0.0, 0.1]]),
        ),
        estimator=EstimatorConfig(kind="kal", Q_kf=Q_kf, R_kf=1.0e-4 * np.eye(ny),
                                  P0=1e-3 * Q_kf),
        bounds=Bounds(
            umin=np.array([295.0, 0.0]), umax=np.array([305.0, 0.25]),
            xmin=np.array([0.0, 320.0, 0.45]), xmax=np.array([1.0, 375.0, 0.75]),
        ),
        defSP=defSP,
    )
