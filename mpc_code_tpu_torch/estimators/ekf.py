"""Extended Kalman filter (port of ``mpc_code_tpu/estimators/ekf.py``).

Replacement for the reference's `ekf` (Estimator.py:313-386).  The update
order mirrors the reference exactly: output Jacobian C at the *predicted*
state, gain and correction, then state Jacobian A at the *corrected* state
for the covariance prediction.  Every per-lane argument carries a leading
batch dimension B.  The Jacobians are ``torch.func`` vmapped over the
lanes: C by ``jacfwd``, A by ``jacrev``, since forward mode through the
RK4 sub-steps turns f32 into f64 (ROADMAP Queue 3, F9).  The gain's solve
goes through ``ops/smalllin.py::solve_lu`` (a failing lane gives NaN for
that lane only).
"""

from __future__ import annotations

from torch.func import jacfwd, jacrev, vmap

from mpc_code_tpu_torch.estimators.linear import AugmentedModel, _gain_update, _mv


def ekf(aug: AugmentedModel, h: float, y_k, u_k, Q, R, P_min, xhat_min, t_k, p_x, p_y):
    """One EKF step. Returns (P_plus, P_corr, xhat_corr)."""
    yhat = vmap(aug.fy)(xhat_min, u_k, t_k, p_y)                    # Estimator.py:340
    C_k = vmap(jacfwd(aug.fy))(xhat_min, u_k, t_k, p_y)             # Estimator.py:343-348
    K_k = _gain_update(C_k, P_min, R)                               # Estimator.py:354-355
    P_corr = P_min - K_k @ C_k @ P_min                              # Estimator.py:358
    xhat_corr = xhat_min + _mv(K_k, y_k - yhat)                     # Estimator.py:367
    A_k = vmap(jacrev(aug.fx), in_dims=(0, 0, None, 0, 0))(
        xhat_corr, u_k, h, t_k, p_x)                                # Estimator.py:370-376
    P_plus = A_k @ P_corr @ A_k.mT + Q                              # Estimator.py:381
    return P_plus, P_corr, xhat_corr
