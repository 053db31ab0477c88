"""Fixed-step Runge-Kutta integrators (port of ``mpc_code_tpu/ops/integrators.py``).

The reference integrates the time-augmented system [x; t]' = [f; 1] with an
RK4 scheme and ``Mx`` sub-steps per sampling interval (Utilities.py:157-183);
advancing ``t`` explicitly through the stages is arithmetically identical.

The saturation guard clips the ODE input state with ``torch.maximum`` /
``torch.minimum``, never ``torch.clamp``: at an exact bound JAX's
derivative of ``jnp.clip`` / ``jnp.maximum`` is 0.5, which
``torch.maximum`` reproduces and ``torch.clamp`` does not (ROADMAP
Queue 3, F1).
"""

from __future__ import annotations

from typing import Callable

import torch


def saturate(x, lo=None, hi=None):
    """Clip the ODE input state per component; ``x`` is (nx,) or (nx, L)."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device).reshape(shape))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device).reshape(shape))
    return x


def rk4(f: Callable, Mx: int) -> Callable:
    """Build a one-interval integrator for ``x' = f(x, t, *args)``.

    Returns ``F(x, t0, h, *args) -> x(t0 + h)`` using ``Mx`` RK4 sub-steps,
    matching CasADi ``simpleRK(f_aug, Mx)`` (reference: Utilities.py:157-183).
    """

    def step(x, t0, h, *args):
        dt = h / Mx
        tk = (t0.to(x.dtype) if torch.is_tensor(t0)
              else torch.tensor(t0, dtype=x.dtype, device=x.device))
        xk = x
        for _ in range(Mx):
            k1 = f(xk, tk, *args)
            k2 = f(xk + dt / 2 * k1, tk + dt / 2, *args)
            k3 = f(xk + dt / 2 * k2, tk + dt / 2, *args)
            k4 = f(xk + dt * k3, tk + dt, *args)
            xk = xk + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            tk = tk + dt
        return xk

    return step


def rk4_stage_jac(f: Callable, Mx: int, clip_lo=None, clip_hi=None):
    """Stage-sweep RK4 rollout with first-order Jacobians, batched.

    ``f`` is the raw reordered model ODE ``f(x, t, u, d, px)``, written so
    that ``x`` may arrive as (nx,) or lanes-minor (nx, L); ``clip_lo`` /
    ``clip_hi`` optionally saturate the ODE input state.  Returns
    ``F(xs (B,N,nx), us (B,N,nu), pxs (B,N,npx), t (B,), h (B,), d (B,nd))
    -> (xf (B,N,nx), Jx (B,N,nx,nx), Ju (B,N,nx,nu))``: on CUDA tensors the
    hand-written kernel of ``ops/sweep_cuda.py``, on CPU tensors its plain
    PyTorch version (nx+nu forward tangents through the sub-steps).
    """
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac

    return Rk4StageJac(f, Mx, clip_lo=clip_lo, clip_hi=clip_hi)


def map_stage_jac(f: Callable):
    """Discrete-map analog of ``rk4_stage_jac``.

    ``f`` is the model's one-step map ``x_next = f(x, u, d, t, px)`` (the
    NL-discrete form, Utilities.py:186-198), written so that each argument
    may arrive as one point or lanes-minor (dim, L).  Returns ``F(xs
    (B,N,nx), us (B,N,nu), pxs (B,N,npx), t (B,), d (B,nd)) -> (xf
    (B,N,nx), Jx (B,N,nx,nx), Ju (B,N,nx,nu))``: on CUDA tensors the
    hand-written kernel of ``ops/sweep_map_cuda.py``, on CPU tensors its
    plain PyTorch version (one evaluation plus nx+nu forward tangents).
    """
    from mpc_code_tpu_torch.ops.sweep_map_cuda import MapStageJac

    return MapStageJac(f)


def rk4_quad(f: Callable, q: Callable, Mx: int) -> Callable:
    """Integrate ``x' = f(x, t, *args)`` and the quadrature ``L' = q(x, t, *args)``.

    Returns ``F(x, t0, h, *args) -> (x(t0+h), ∫ q dt)``, the fixed-step RK4
    quadrature that replaces the reference's IDAS quadrature for ContForm
    economic objectives (reference: Control_Calc.py:109-111).
    """

    def step(x, t0, h, *args):
        dt = h / Mx
        tk = (t0.to(x.dtype) if torch.is_tensor(t0)
              else torch.tensor(t0, dtype=x.dtype, device=x.device))
        xk = x
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(Mx):
            k1 = f(xk, tk, *args)
            q1 = q(xk, tk, *args)
            k2 = f(xk + dt / 2 * k1, tk + dt / 2, *args)
            q2 = q(xk + dt / 2 * k1, tk + dt / 2, *args)
            k3 = f(xk + dt / 2 * k2, tk + dt / 2, *args)
            q3 = q(xk + dt / 2 * k2, tk + dt / 2, *args)
            k4 = f(xk + dt * k3, tk + dt, *args)
            q4 = q(xk + dt * k3, tk + dt, *args)
            xk = xk + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            acc = acc + dt / 6 * (q1 + 2 * q2 + 2 * q3 + q4)
            tk = tk + dt
        return xk, acc

    return step


def rk4_quad_stage_hess(f: Callable, q: Callable, Mx: int):
    """ContForm stage sweep: dynamics value and Jacobians, and the
    quadrature cost's value, gradient and Hessian, batched.

    ``f(x, t, u, d, px, xs, us, py)`` and ``q(...)`` (same arguments,
    scalar result) are written so that each argument may arrive as one
    point or lanes-minor (dim, L).  Returns ``F(xs (B,N,nx), us (B,N,nu),
    pxs (B,N,npx), pys (B,N,npy), t (B,), h (B,), d (B,nd), x_ss (B,nx),
    u_ss (B,nu)) -> (xf (B,N,nx), Jx, Ju, qv (B,N), gq (B,N,nz),
    Hq (B,N,nz,nz))``: on CUDA tensors the hand-written kernel of
    ``ops/sweep_cf_cuda.py``, on CPU tensors its plain PyTorch version.
    """
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import Rk4QuadStageHess

    return Rk4QuadStageHess(f, q, Mx)
