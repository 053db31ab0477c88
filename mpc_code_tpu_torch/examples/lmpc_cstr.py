"""Linearized CSTR LMPC with Kalman filter (port of
``mpc_code_tpu/examples/lmpc_cstr.py``; reference: Ex_LMPC_CSTR.py).

3-state linear system, input-disturbance model (Bd=I, Cd=0), additive plant
disturbances via def_pxp/def_pyp schedules, state/output bounds, QP costs,
Riccati terminal weight.
"""

import numpy as np
import scipy.linalg as scla

from mpc_code_tpu_torch.config import (
    Bounds, DisturbanceModel, EstimatorConfig, LinearModel, LinearPlant,
    MPCConfig, SSCost, StageCost,
)


def make_config(Nsim: int = 100) -> MPCConfig:
    nx, nu, ny, nd = 3, 2, 3, 3

    Ap = np.array([[0.2511, -3.368e-03, -7.056e-04],
                   [11.06, 0.3296, -2.545],
                   [0.0, 0.0, 1.0]])
    Bp = np.array([[-5.426e-03, 1.53e-05],
                   [1.297, 0.1218],
                   [0.0, -6.592e-02]])
    Cp = np.eye(3)

    def def_pxp(t):
        # state disturbance pulse for t <= 20 (Ex_LMPC_CSTR.py:40-60)
        return np.array([0.1, 0.0, 0.0]) if t <= 20 else np.zeros(3)

    def def_pyp(t):
        return np.array([0.1, 0.1, 0.0])  # Ex_LMPC_CSTR.py:62-79

    def defSP(t):
        xsp = np.zeros(3)
        if t <= 15:
            return np.array([0.2, 0.0, 0.0]), np.zeros(2), xsp
        return np.array([0.0, 0.0, 0.1]), np.zeros(2), xsp

    Qx_kf = 1.0e-7 * np.eye(nx)
    Qd_kf = np.eye(nd)

    return MPCConfig(
        nx=nx, nxp=3, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=1.0,
        model=LinearModel(A=Ap.copy(), B=Bp.copy(), C=Cp.copy()),
        plant=LinearPlant(Ap=Ap, Bp=Bp, Cp=Cp),
        dist=DisturbanceModel(offree="lin", Bd=np.eye(nd), Cd=np.zeros((ny, nd))),
        x0_p=3 * np.ones(3), x0_m=3 * np.ones(3), u0=np.zeros(2),
        ss_cost=SSCost(
            Qss=np.array([[20.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
            Rss=np.zeros((nu, nu)),
        ),
        stage_cost=StageCost(
            Q=np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
            R=0.1 * np.eye(nu),
        ),
        estimator=EstimatorConfig(
            kind="kal",
            Q_kf=scla.block_diag(Qx_kf, Qd_kf),
            R_kf=1.0e-7 * np.eye(ny),
            P0=1.0e-8 * np.eye(nx + nd),
        ),
        bounds=Bounds(
            umin=-10.0 * np.ones(nu), umax=10.0 * np.ones(nu),
            xmin=np.array([-10.0, -8.0, -10.0]), xmax=10.0 * np.ones(nx),
            ymin=np.array([-10.0, -8.0, -10.0]), ymax=10.0 * np.ones(ny),
        ),
        defSP=defSP,
        def_pxp=def_pxp,
        def_pyp=def_pyp,
    )
