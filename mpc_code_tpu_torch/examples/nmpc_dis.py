"""Quadruple-tank discrete-time NMPC (port of ``mpc_code_tpu/examples/nmpc_dis.py``;
reference: Ex_NMPC_dis.py).

6-state (2 valve states + 4 tank levels) nonlinear DISCRETE model and plant
with a hand-rolled RK4 (Mx=5) inside the map and the levels clipped to
[0, 20], output disturbance model (Bd=0, Cd=I), Luenberger observer,
Delta-u bounds, Sss (DUssForm) steady-state cost, user terminal weight,
scheduled state disturbances, long setpoint program.

The maps are written in torch ops on indexed components, so each argument
may be one point or lanes-minor (dim, L), and ``torch.fx`` traces them for
the CUDA sweep.  The clip is ``torch.maximum``/``torch.minimum`` against
0-d module-level tensors, never ``torch.clamp``: at an exact bound JAX's
derivative of ``jnp.clip`` is 0.5, which ``torch.maximum`` reproduces
(ROADMAP Queue 3, F1); a 0-d constant lowers to a literal in the sweep's
generated code and broadcasts on both layouts.  The plant and the
Luenberger gain are carried as configuration data: the port has no closed
loop yet.
"""

import numpy as np
import torch

from mpc_code_tpu_torch.config import (
    Bounds, DisturbanceModel, DiscreteModel, DiscretePlant, EstimatorConfig,
    MPCConfig, SSCost, StageCost, TerminalCost,
)

H_STEP = 5.0  # sampling time (the discrete maps close over it, as in the reference)

# tank constants (Ex_NMPC_dis.py:40-70)
G = 981.0
A1O, A2O, A3O, A4O = 0.071, 0.057, 0.071, 0.057
A1, A2, A3, A4 = 28.0, 32.0, 28.0, 32.0
GM1, GM2 = 0.7, 0.6
H1MAX = H2MAX = 20.0
Q1MAX = (A1O + A4O) * (2.0 * G * H1MAX) ** 0.5
Q2MAX = (A2O + A3O) * (2.0 * G * H2MAX) ** 0.5
K1 = Q1MAX / 100.0
K2 = Q2MAX / 100.0
LEVEL_LO = torch.tensor(0.0, dtype=torch.float64)   # the levels' clip
LEVEL_HI = torch.tensor(20.0, dtype=torch.float64)


def _tank_rhs(x, u):
    """Continuous 4-tank dynamics with saturation clipping
    (Ex_NMPC_dis.py:39-91; if_else -> maximum/minimum)."""
    xc = torch.minimum(torch.maximum(x, LEVEL_LO), LEVEL_HI)

    def s(v):
        return torch.sqrt(2.0 * G * v)

    return torch.stack([
        -(A1O / A1) * s(xc[0]) + (A3O / A1) * s(xc[2]) + (GM1 / A1) * K1 * u[0],
        -(A2O / A2) * s(xc[1]) + (A4O / A2) * s(xc[3]) + (GM2 / A2) * K2 * u[1],
        -(A3O / A3) * s(xc[2]) + ((1.0 - GM2) / A3) * K2 * u[1],
        -(A4O / A4) * s(xc[3]) + ((1.0 - GM1) / A4) * K1 * u[0],
    ])


def _rk4_tanks(x0, u, Mx=5):
    dt = H_STEP / Mx
    x = x0
    for _ in range(Mx):
        k1 = _tank_rhs(x, u)
        k2 = _tank_rhs(x + dt / 2 * k1, u)
        k3 = _tank_rhs(x + dt / 2 * k2, u)
        k4 = _tank_rhs(x + dt * k3, u)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def plant_fxp(x, t, u, pxp, pxmp):
    """Discrete plant map: valve states copy u, tank levels RK4-integrated
    (Ex_NMPC_dis.py:94-128)."""
    return torch.cat([u, _rk4_tanks(x[2:6], u)])


def plant_fyp(x, u, t, pyp, pymp):
    return torch.stack([x[2], x[3]])


def model_fxm(x, u, d, t, px):
    """Discrete model map (Ex_NMPC_dis.py:240-272) — same structure."""
    return torch.cat([u, _rk4_tanks(x[2:6], u)])


def model_fym(x, u, d, t, px):
    return torch.stack([x[2], x[3]])


def def_pxp(t):
    """Scheduled upper-tank disturbances (Ex_NMPC_dis.py:155-178)."""
    if t <= 2250:
        return np.array([0.0, 0.0, 0.5, 0.0, 0.0, 0.0])
    if t <= 4000:
        return np.array([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    return np.zeros(6)


def defSP(t):
    """Setpoint program (Ex_NMPC_dis.py:330-375)."""
    usp = np.array([39.5185, 38.1743])
    if t <= 50:
        return np.array([11.9996, 12.1883]), usp, np.array([50.0, 50.0, 10.0, 10.0, 2.0, 2.0])
    if t <= 1000:
        return np.array([11.9996, 6.0]), usp, np.array([60.0, 50.0, 12.0, 8.0, 2.0, 2.0])
    if t <= 2000:
        return np.array([6.0, 6.0]), usp, np.array([60.0, 40.0, 12.0, 8.0, 2.0, 2.0])
    if t <= 3000:
        return np.array([12.0, 12.0]), usp, np.array([40.0, 40.0, 8.0, 8.0, 2.0, 2.0])
    if t <= 4000:
        return np.array([8.0, 12.0]), usp, np.array([40.0, 60.0, 8.0, 12.0, 2.0, 2.0])
    if t <= 5000:
        return np.array([10.0, 10.0]), usp, np.array([50.0, 50.0, 10.0, 10.0, 2.0, 2.0])
    return np.array([8.0, 12.0]), usp, np.array([40.0, 40.0, 8.0, 12.0, 2.0, 2.0])


def user_vfin(dx, xs):
    """User terminal weight (Ex_NMPC_dis.py:399-416); receives the
    QForm-shifted state like the reference call site."""
    return 100.0 * (dx @ dx)


def make_config(Nsim: int = 1000) -> MPCConfig:
    nx, nu, ny, nd = 6, 2, 2, 2
    K = np.vstack([np.zeros((nx, ny)), np.eye(nd)])

    return MPCConfig(
        nx=nx, nxp=6, nu=nu, ny=ny, nd=nd,
        Nsim=Nsim, N=50, h=H_STEP,
        model=DiscreteModel(Fx=model_fxm, fy=model_fym),
        plant=DiscretePlant(Fx=plant_fxp, fy=plant_fyp),
        dist=DisturbanceModel(offree="lin", Bd=np.zeros((nx, nd)), Cd=np.eye(nd)),
        x0_p=np.array([39.5794, 38.1492, 11.9996, 12.1883, 1.51364, 1.42194]),
        x0_m=np.array([39.5794, 38.1492, 11.9996, 12.1883, 1.51364, 1.42194]),
        u0=np.array([39.5794, 38.1492]),
        ss_cost=SSCost(Qss=np.eye(ny), Sss=np.zeros((nu, nu))),
        stage_cost=StageCost(
            Q=np.diag([1e3, 1e3, 1.0, 1.0, 1e-6, 1e-6]),
            S=np.array([[10.0, 0.0], [0.0, 10.0]]),
        ),
        terminal=TerminalCost(vfin=user_vfin),
        estimator=EstimatorConfig(kind="lue", K=K),
        bounds=Bounds(
            umin=np.zeros(nu), umax=100.0 * np.ones(nu),
            xmin=np.zeros(nx), xmax=np.array([100.0, 100.0, 20.0, 20.0, 20.0, 20.0]),
            ymin=np.zeros(ny), ymax=np.array([20.0, 20.0]),
            Dumin=np.array([-50.0, -50.0]), Dumax=np.array([50.0, 50.0]),
        ),
        defSP=defSP,
        def_pxp=def_pxp,
    )
