"""Cost constructors (port of ``mpc_code_tpu/models/costs.py``).

Plain callables over torch tensors: stage cost ``F_obj(x, u, y, xs, us,
ys)`` (Utilities.defF_obj:323-381), steady-state cost (defFss_obj:267-321)
and terminal cost ``Vfin(dx, xs)`` (defVfin:383-420).  Matrix weights are
kept as numpy and cast to the argument's dtype and device at call time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mpc_code_tpu_torch.config import MPCConfig, SSCost, StageCost


def _w(M, like):
    return torch.as_tensor(np.asarray(M, float), dtype=like.dtype,
                           device=like.device)


def build_stage_cost(sc: StageCost) -> Callable:
    """F_obj(x, u, y, xs, us, ys) — LP, QP or user form."""
    if sc.r_x is not None:
        r_x = np.asarray(sc.r_x, float)
        r_u = np.asarray(sc.r_u if sc.r_u is not None else sc.r_Du, float)

        def f_obj(x, u, y, xs, us, ys):
            return (torch.sum(_w(r_x, x) @ torch.abs(x))
                    + torch.sum(_w(r_u, u) @ torch.abs(u)))

        return f_obj
    if sc.Q is not None:
        Q = np.asarray(sc.Q, float)
        Ru = np.asarray(sc.R if sc.R is not None else sc.S, float)

        def f_obj(x, u, y, xs, us, ys):
            return 0.5 * (x @ (_w(Q, x) @ x) + u @ (_w(Ru, u) @ u))

        return f_obj
    for f in (sc.f_cont, sc.f_dis, sc.f_coll):
        if f is not None:
            return f
    raise ValueError("stage cost is empty")


def build_ss_cost(ssc: SSCost) -> Callable:
    """Fss_obj(x, u, y, xsp, usp, ysp) — LP, QP or user form."""
    if ssc.rss_y is not None:
        r_y = np.asarray(ssc.rss_y, float)
        r_u = np.asarray(ssc.rss_u if ssc.rss_u is not None else ssc.rss_Du, float)

        def f(x, u, y, xsp, usp, ysp):
            return torch.sum(_w(r_y, y) @ y) + torch.sum(_w(r_u, u) @ torch.abs(u))

        return f
    if ssc.Qss is not None:
        Q = np.asarray(ssc.Qss, float)
        Ru = np.asarray(ssc.Rss if ssc.Rss is not None else ssc.Sss, float)

        def f(x, u, y, xsp, usp, ysp):
            return 0.5 * (y @ (_w(Q, y) @ y) + u @ (_w(Ru, u) @ u))

        return f
    if ssc.f_obj is not None:
        return ssc.f_obj
    raise ValueError("steady-state cost is empty")


def build_terminal_cost(cfg: MPCConfig) -> Callable:
    """Vfin(dx, xs): the user callable, or zero.  The DARE terminal weight
    (``terminal.riccati``, linear models only) is not ported yet."""
    tc = cfg.terminal
    if tc.vfin is not None:
        return tc.vfin
    if tc.riccati:
        raise NotImplementedError(
            "the DARE terminal cost (ops/dare.py) is not ported yet "
            "(ROADMAP Queue 1 item 5)")

    def vfin(dx, xs):
        return torch.zeros((), dtype=dx.dtype, device=dx.device)

    return vfin
