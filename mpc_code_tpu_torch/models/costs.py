"""Cost constructors (port of ``mpc_code_tpu/models/costs.py``).

Plain callables over torch tensors: ``xQx`` (the helper user costs
call), stage cost ``F_obj(x, u, y, xs, us,
ys)`` (Utilities.defF_obj:323-381), steady-state cost (defFss_obj:267-321),
terminal cost ``Vfin(dx, xs)`` (defVfin:383-420) and MHE stage cost
``F_obj_mhe(w, v, t)`` (defF_obj_mhe:675-709).  Matrix weights are
kept as f64 CPU tensors and cast to the argument's dtype and device at call
time with ``.to(x)``, which ``torch.fx`` records, so the CUDA code
generator (``ops/codegen.py``) sees a constant matrix.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mpc_code_tpu_torch.config import LinearModel, MHECost, MPCConfig, SSCost, StageCost
from mpc_code_tpu_torch.ops.dare import solve_dare


def _w(M):
    return torch.as_tensor(np.asarray(M, float))


def xQx(x, Q):
    """x' Q x (reference: Utilities.xQx, Utilities.py:247-265), with the
    weight cast to the argument's dtype and device."""
    return x @ (_w(Q).to(x) @ x)


def _abs(x):
    """|x| with JAX's derivative at 0, +1 (``jnp.abs``'s rule; ``torch.abs``
    has 0 there)."""
    return torch.where(x >= 0, x, -x)


def build_stage_cost(sc: StageCost) -> Callable:
    """F_obj(x, u, y, xs, us, ys) — LP, QP or user form."""
    if sc.r_x is not None:
        r_x = _w(sc.r_x)
        r_u = _w(sc.r_u if sc.r_u is not None else sc.r_Du)

        def f_obj(x, u, y, xs, us, ys):
            return (torch.sum(r_x.to(x) @ _abs(x))
                    + torch.sum(r_u.to(u) @ _abs(u)))

        return f_obj
    if sc.Q is not None:
        Q = _w(sc.Q)
        Ru = _w(sc.R if sc.R is not None else sc.S)

        def f_obj(x, u, y, xs, us, ys):
            return 0.5 * (x @ (Q.to(x) @ x) + u @ (Ru.to(u) @ u))

        return f_obj
    for f in (sc.f_cont, sc.f_dis, sc.f_coll):
        if f is not None:
            return f
    raise ValueError("stage cost is empty")


def build_ss_cost(ssc: SSCost) -> Callable:
    """Fss_obj(x, u, y, xsp, usp, ysp) — LP, QP or user form."""
    if ssc.rss_y is not None:
        r_y = _w(ssc.rss_y)
        r_u = _w(ssc.rss_u if ssc.rss_u is not None else ssc.rss_Du)

        def f(x, u, y, xsp, usp, ysp):
            return torch.sum(r_y.to(y) @ y) + torch.sum(r_u.to(u) @ _abs(u))

        return f
    if ssc.Qss is not None:
        Q = _w(ssc.Qss)
        Ru = _w(ssc.Rss if ssc.Rss is not None else ssc.Sss)

        def f(x, u, y, xsp, usp, ysp):
            return 0.5 * (y @ (Q.to(y) @ y) + u @ (Ru.to(u) @ u))

        return f
    if ssc.f_obj is not None:
        return ssc.f_obj
    raise ValueError("steady-state cost is empty")


def build_mhe_cost(mc: MHECost) -> Callable:
    """F_obj_mhe(w, v, t) — LP ``r_w·w + r_v·v`` (no abs: the reference's
    quirk, Utilities.py:692-696), QP ``0.5 (w'Qw + v'Rv)`` or the user's."""
    if mc.r_w is not None:
        r_w, r_v = _w(mc.r_w), _w(mc.r_v)

        def f(w, v, t):
            return torch.sum(r_w.to(w) @ w) + torch.sum(r_v.to(v) @ v)

        return f
    if mc.Q is not None:
        Q, R = _w(mc.Q), _w(mc.R)

        def f(w, v, t):
            return 0.5 * (w @ (Q.to(w) @ w) + v @ (R.to(v) @ v))

        return f
    if mc.f_obj is not None:
        return mc.f_obj
    raise ValueError("MHE cost is empty")


def build_terminal_cost(cfg: MPCConfig) -> Callable:
    """Vfin(dx, xs): the user callable, the DARE weight, or zero
    (Utilities.defVfin, Utilities.py:383-420).

    The caller passes dx already shifted by xs when QForm is on
    (Control_Calc.py:194-196, 209).  Riccati mode: P solves DARE(A, B, Q,
    R-or-S) of the linear model (MPC_code.py:253-255 swaps S for R when
    only S is given), once, in f64 on the CPU."""
    tc = cfg.terminal
    if tc.vfin is not None:
        return tc.vfin
    if tc.riccati:
        m = cfg.model
        if not isinstance(m, LinearModel):
            raise ValueError("Riccati terminal cost requires a linear model")
        sc = cfg.stage_cost
        P = solve_dare(_w(m.A), _w(m.B), _w(sc.Q),
                       _w(sc.R if sc.R is not None else sc.S))

        def vfin(dx, xs):
            return 0.5 * (dx @ (P.to(dx) @ dx))

        return vfin

    def vfin(dx, xs):
        return torch.zeros((), dtype=dx.dtype, device=dx.device)

    return vfin
