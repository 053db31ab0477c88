"""LMPC with extra model state, nx=4 != nxp=3 (port of
``mpc_code_tpu/examples/lmpcxp_nlplant.py``; reference: Ex_LMPCxp_nlplant.py).

Same nonlinear CSTR plant as lmpc_nlplant, but the controller model carries
an extra state (block-diagonal affine model), exercising the nx != nxp code
paths. Kalman filter, Bd=B, output bounds.
"""

import numpy as np
import scipy.linalg as scla

from mpc_code_tpu_torch.config import (
    Bounds, ContinuousPlant, DisturbanceModel, EstimatorConfig, LinearModel,
    MPCConfig, SSCost, StageCost,
)
from mpc_code_tpu_torch.examples.lmpc_nlplant import cstr_fxp


def make_config(Nsim: int = 200) -> MPCConfig:
    nx, nxp, nu, ny, nd = 4, 3, 2, 2, 2

    Alin = np.array([[0.51448, -0.00917517, -0.117995],
                     [53.6817, 2.15004, -3.77725],
                     [0.0, 0.0, 1.0]])
    Blin = np.array([[-0.0017669, 0.0864569],
                     [0.639423, 1.60696],
                     [0.0, -1.32737]])
    Clin = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    # extra state (Ex_LMPCxp_nlplant.py:92-99)
    Phi = 0.01
    A = scla.block_diag(Alin, Phi)
    B = np.vstack([Blin, np.array([[1.0 - Phi, 0.0]])])
    C = np.column_stack([Clin, (Phi / 10.0) * np.array([[1.0], [0.0]])])

    xlin = np.array([0.5, 350.0, 0.659, 0.0])
    ulin = np.array([300.0, 0.1])
    ylin = np.array([0.5, 0.659])

    Cp = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def defSP(t):
        xsp = np.zeros(4)
        usp = np.array([300.0, 0.1])
        ysp = np.array([0.5, 0.659]) if t < 20 else np.array([0.51, 0.659])
        return ysp, usp, xsp

    Qx_kf = 1.0e-2 * np.eye(nx)
    Qd_kf = np.eye(nd)
    Q_kf = scla.block_diag(Qx_kf, Qd_kf)

    return MPCConfig(
        nx=nx, nxp=nxp, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=0.2,
        model=LinearModel(A=A, B=B, C=C, xlin=xlin, ulin=ulin, ylin=ylin),
        plant=ContinuousPlant(fx=cstr_fxp, Mx=10, Cp=Cp),
        dist=DisturbanceModel(offree="lin", Bd=B.copy(), Cd=np.zeros((ny, nd))),
        x0_p=np.array([0.5, 350.0, 0.659]),
        x0_m=np.array([0.5, 350.0, 0.659, 0.0]),
        u0=np.array([300.0, 0.1]),
        ss_cost=SSCost(Qss=np.eye(ny), Rss=np.zeros((nu, nu))),
        stage_cost=StageCost(
            Q=np.diag([1.0, 1.0, 1.0, 0.1]),
            S=0.10 * np.eye(nu),
        ),
        estimator=EstimatorConfig(kind="kal", Q_kf=Q_kf, R_kf=1.0e-2 * np.eye(ny),
                                  P0=Q_kf),
        bounds=Bounds(
            umin=np.array([295.0, 0.0]), umax=np.array([305.0, 0.25]),
            xmin=np.array([0.0, 300.0, 0.45, -1.0]), xmax=np.array([1.0, 375.0, 0.75, 1.0]),
            ymin=np.array([0.0, 0.0]), ymax=np.array([1.0, 1.0]),
        ),
        defSP=defSP,
    )
