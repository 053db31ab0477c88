"""Linear estimators (port of ``mpc_code_tpu/estimators/linear.py``).

The time-varying KF, the static-gain correction (steady-state KF /
Luenberger) and the steady-state Kalman gain: the reference's `kalman`
(Estimator.py:263-311), `kalss` (Estimator.py:231-261) and `Kkalss`
(Estimator.py:103-229).  The per-lane Jacobians come from ``torch.func``
vmapped over the lanes: the output map's by ``jacfwd``, the state map's by
``jacrev``, since torch's forward mode through the RK4 sub-steps turns f32
tangents into f64 (ROADMAP Queue 3, F9) and is several times slower there;
the DARE is solved by doubling (``ops/dare.py``).

Augmented-model convention (the driver builds this every step at
MPC_code.py:546-575; it is built once here):
    Fx_es(csi, u, k, t, px) = [Fx_model(x, u, k, d, t, px); d],  csi = [x; d]
    Fy_es(csi, u, t, py)    = Fy_model(x, u, d, t, py)

The augmented maps act on one point.  ``kalman`` and ``kalss`` take a
leading batch dimension B on every per-lane argument (y, u, P, xhat, t,
px, py) and run on the device of those tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from mpc_code_tpu_torch.config import LinearModel, MPCConfig
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.ops.dare import dare_gain
from mpc_code_tpu_torch.ops.smalllin import solve_lu


class AugmentedModel(NamedTuple):
    fx: Callable  # Fx_es(csi, u, k, t, px)
    fy: Callable  # Fy_es(csi, u, t, py)
    n: int        # augmented state size (nx + nd, or nx when offree == 'no')


def build_augmented(cfg: MPCConfig, model: ModelFns) -> AugmentedModel:
    nx, nd = cfg.nx, cfg.nd
    if cfg.dist.offree != "no":

        def fx_es(csi, u, k, t, px):
            x, d = csi[:nx], csi[nx : nx + nd]
            return torch.cat([model.fx(x, u, k, d, t, px), d])

        def fy_es(csi, u, t, py):
            x, d = csi[:nx], csi[nx : nx + nd]
            return model.fy(x, u, d, t, py)

        return AugmentedModel(fx=fx_es, fy=fy_es, n=nx + nd)

    def fx_es(x, u, k, t, px):
        return model.fx(x, u, k, x.new_zeros(0), t, px)

    def fy_es(x, u, t, py):
        return model.fy(x, u, x.new_zeros(0), t, py)

    return AugmentedModel(fx=fx_es, fy=fy_es, n=nx)


def _gain_update(C, P_min, R):
    """``K = P C' (C P C' + R)^{-1}`` per lane, through the pivoted LU (a
    singular lane gives NaN for that lane only)."""
    S = C @ P_min @ C.mT + R
    return solve_lu(S.mT, (P_min @ C.mT).mT).mT


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def kalman(aug: AugmentedModel, h: float, y_k, u_k, Q, R, P_min, xhat_min, t_k, p_x, p_y):
    """Time-varying Kalman filter step (reference: Estimator.kalman,
    Estimator.py:263-311 — valid for linear models, guarded by the driver at
    MPC_code.py:643-646).  Returns (P_plus, P_corr, xhat_corr)."""
    A = vmap(jacrev(aug.fx), in_dims=(0, 0, None, 0, 0))(xhat_min, u_k, h, t_k, p_x)
    C = vmap(jacfwd(aug.fy))(xhat_min, u_k, t_k, p_y)
    yhat = vmap(aug.fy)(xhat_min, u_k, t_k, p_y)
    K = _gain_update(C, P_min, R)
    eye = torch.eye(A.shape[-1], dtype=P_min.dtype, device=P_min.device)
    P_corr = (eye - K @ C) @ P_min
    xhat_corr = xhat_min + _mv(K, y_k - yhat)
    P_plus = A @ P_corr @ A.mT + Q
    return P_plus, P_corr, xhat_corr


def kalss(aug: AugmentedModel, y_k, u_k, K, xhat_min, t_k, p_y):
    """Static-gain correction x+ = x + K(y - yhat): steady-state KF,
    Luenberger observer, or identity-gain StateFeedback
    (reference: Estimator.kalss, Estimator.py:231-261; MPC_code.py:577-581).
    ``K`` is shared by the lanes."""
    yhat = vmap(aug.fy)(xhat_min, u_k, t_k, p_y)
    return xhat_min + (y_k - yhat) @ K.mT


def kalss_gain(cfg: MPCConfig, model: ModelFns) -> torch.Tensor:
    """Steady-state Kalman gain on the disturbance-augmented pair
    (reference: Estimator.Kkalss, Estimator.py:103-229), in f64 on the CPU.

    For a ``LinearModel`` config A and C are the config's matrices (no model
    callables needed); otherwise the missing Jacobians come from
    ``torch.func.jacfwd`` of the model maps at the user's (x_ss, u_ss) point,
    the analog of the reference's symbolic Jacobian.
    """
    est = cfg.estimator
    nx, nd, ny = cfg.nx, cfg.nd, cfg.ny
    offree = cfg.dist.offree

    def T(v, n=None):
        if v is None:
            return torch.zeros(n, dtype=torch.float64)
        return torch.as_tensor(np.asarray(v, float))

    m = cfg.model
    A = C = None
    if isinstance(m, LinearModel):
        A = T(m.A)
        C = T(m.C) if m.C is not None else None

    d_ss = torch.zeros(nd, dtype=torch.float64)
    x_ss, u_ss = T(est.x_ss, nx), T(est.u_ss, cfg.nu)
    px_ss, py_ss = T(est.px_ss, cfg.npx), T(est.py_ss, cfg.npy)

    if A is None:
        if offree == "nl":
            aug = build_augmented(cfg, model)
            A = jacfwd(aug.fx)(torch.cat([x_ss, d_ss]), u_ss, cfg.h, 0.0, px_ss)
        else:
            A = jacfwd(lambda x: model.fx(x, u_ss, cfg.h, d_ss, 0.0, px_ss))(x_ss)
    if C is None or cfg.StateFeedback:
        if cfg.StateFeedback:
            C = torch.eye(ny, nx, dtype=torch.float64)
        else:
            C = jacfwd(lambda x: model.fy(x, u_ss, d_ss, 0.0, py_ss))(x_ss)

    naug = nx + nd
    if offree == "nl" and A.shape[1] == naug:
        Aaug = A.clone()
    else:
        Aaug = torch.eye(naug, dtype=torch.float64)
        Aaug[:nx, :nx] = A[:nx, :nx]
    if offree == "nl" and C.shape[1] == naug:
        Caug = C.clone()
    else:
        Caug = torch.zeros((ny, naug), dtype=torch.float64)
        Caug[:, :nx] = C[:, :nx]
    if offree == "lin":                      # Estimator.py:206-211
        Aaug[:nx, nx:] = T(cfg.dist.Bd)
        Caug[:, nx:] = T(cfg.dist.Cd)

    # the reference solves the DARE on (Aaug', Caug') and forms
    # P C'(CPC'+R)^-1 (Estimator.py:213-223): dare_gain does exactly that
    K, _ = dare_gain(Aaug, Caug, T(est.Q_kf), T(est.R_kf))
    return K
