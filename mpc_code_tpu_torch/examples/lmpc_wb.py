"""Wood-Berry-like 2x2 distillation LMPC (port of
``mpc_code_tpu/examples/lmpc_wb.py``; reference: Ex_LMPC_WB.py).

4-state/2-input/2-output linear system with plant/model mismatch, output
disturbance model (Bd=0, Cd=I), Luenberger observer with output-disturbance
gain, QP target cost (Qss,Rss), QP stage cost (Q, S -> DUForm), Riccati
terminal weight, input bounds, time-varying output setpoint.
"""

import numpy as np

from mpc_code_tpu_torch.config import (
    Bounds,
    DisturbanceModel,
    EstimatorConfig,
    LinearModel,
    LinearPlant,
    MPCConfig,
    SSCost,
    StageCost,
)


def make_config(Nsim: int = 100) -> MPCConfig:
    nx, nu, ny, nd = 4, 2, 2, 2

    # plant (Ex_LMPC_WB.py:35-37)
    Ap = np.diag([0.8871, 0.8324, 0.9092, 0.8703])
    Bp = np.array([[1, 0], [1, 0], [0.0, 1.0], [0, 2.0]])
    Cp = np.array([[1.4447, 0.0, -1.7169, 0.0], [0.0, 1.1064, 0.0, -1.2579]])

    # model with mismatch (Ex_LMPC_WB.py:41-45)
    A = np.diag([0.8871, 0.8324, 0.9092, 0.8703]) + 2 * np.diag([0.01, -0.01, -0.01, 0.01])
    B = Bp.copy()
    C = Cp.copy()

    # Luenberger gain (Ex_LMPC_WB.py:67-70)
    K = np.vstack([np.zeros((nx, nd)), np.eye(nd)])

    def defSP(t):
        xsp = np.zeros(4)
        if t <= 10:
            return np.zeros(2), np.zeros(2), xsp
        return np.array([1.0, -1.0]), np.zeros(2), xsp

    Qy = np.diag([1.0, 1.0])
    return MPCConfig(
        nx=nx, nxp=4, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=1.0,
        model=LinearModel(A=A, B=B, C=C),
        plant=LinearPlant(Ap=Ap, Bp=Bp, Cp=Cp),
        dist=DisturbanceModel(offree="lin", Bd=np.zeros((nx, nd)), Cd=np.eye(nd)),
        x0_p=np.zeros(4), x0_m=np.zeros(4), u0=np.zeros(2),
        ss_cost=SSCost(Qss=np.diag([1.0, 1.0]), Rss=np.zeros((nu, nu))),
        stage_cost=StageCost(Q=C.T @ Qy @ C, S=np.diag([10.0, 20.0])),
        estimator=EstimatorConfig(kind="lue", K=K),
        bounds=Bounds(umin=-0.5 * np.ones(nu), umax=0.5 * np.ones(nu)),
        defSP=defSP,
    )
