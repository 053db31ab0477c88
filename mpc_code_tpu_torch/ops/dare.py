"""Discrete algebraic Riccati equation (port of ``mpc_code_tpu/ops/dare.py``).

Batched replacement for ``scipy.linalg.solve_discrete_are``, which the
reference uses for the Riccati terminal cost (Utilities.py:409) and the
steady-state Kalman gain (Estimator.py:217).  The structure-preserving
doubling algorithm (SDA): quadratically convergent, only solves and
matmuls.  The JAX ``lax.scan`` of 30 iterations is a Python loop here;
every matrix may carry leading batch dimensions.
"""

from __future__ import annotations

import torch


def _t(M, like=None):
    if like is None:
        return torch.as_tensor(M)
    return torch.as_tensor(M, dtype=like.dtype, device=like.device)


def solve_dare(A, B, Q, R, iters: int = 30):
    """Solve ``A'PA - P - A'PB (B'PB + R)^{-1} B'PA + Q = 0`` for P.

    Same equation and argument convention as
    ``scipy.linalg.solve_discrete_are(A, B, Q, R)``.
    """
    A = _t(A)
    B, Q, R = _t(B, A), _t(Q, A), _t(R, A)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    # SDA initialization: A0 = A, G0 = B R^{-1} B', H0 = Q
    Ak, Gk, Hk = A, B @ torch.linalg.solve(R, B.mT), Q
    for _ in range(iters):
        W = eye + Gk @ Hk                    # I + G H
        WinvA = torch.linalg.solve(W, Ak)    # (I+GH)^{-1} A
        WinvG = torch.linalg.solve(W, Gk)    # (I+GH)^{-1} G
        A_next = Ak @ WinvA
        G_next = Gk + Ak @ WinvG @ Ak.mT
        H_next = Hk + WinvA.mT @ (Hk @ Ak)
        # symmetrize to control round-off drift
        Ak, Gk, Hk = A_next, 0.5 * (G_next + G_next.mT), 0.5 * (H_next + H_next.mT)
    return 0.5 * (Hk + Hk.mT)


def dare_gain(A, C, Q, R, iters: int = 30):
    """Steady-state Kalman gain ``K = P C' (C P C' + R)^{-1}``; returns (K, P).

    P solves the estimation DARE (the control DARE on the transposed pair,
    as the reference computes it at Estimator.py:213-223).
    """
    A = _t(A)
    C, R = _t(C, A), _t(R, A)
    P = solve_dare(A.mT, C.mT, Q, R, iters=iters)
    S = C @ P @ C.mT + R
    K = torch.linalg.solve(S.mT, (P @ C.mT).mT).mT
    return K, P
