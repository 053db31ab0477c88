"""Steady-state target problem (port of ``mpc_code_tpu/ocp/target.py``).

``build_target`` replaces the reference's ``opt_ss`` (Target_Calc.py:20-160):
the NLP over wss = [xs, us, ys] that the dense IPM (``solver/ipm.py``)
solves before every OCP.  The plant steady state, the plant optimum, the
modifier-adaptation update and the steady-state hunt of the JAX module
(``build_ssp``, ``build_ssp2``, ``make_lambda_update``, ``build_ss_id``)
are not ported yet (ROADMAP Queue 1 item 23).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.solver.nlp import NLP


@dataclass(frozen=True)
class TargetSpec:
    nlp: NLP
    lbw: np.ndarray
    ubw: np.ndarray
    lbg: np.ndarray
    ubg: np.ndarray


def _dim_of(fn, cfg: MPCConfig) -> int:
    if fn is None:
        return 0
    z = lambda n: torch.zeros(n, dtype=torch.float64)  # noqa: E731
    out = fn(z(cfg.nx), z(cfg.nu), z(cfg.ny), z(cfg.nd), z(()), z(cfg.npx), z(cfg.npy))
    return int(torch.as_tensor(out).numel())


def build_target(cfg: MPCConfig, model: ModelFns, fss_obj: Callable) -> TargetSpec:
    """Target problem over wss = [xs, us, ys].

    g = [Fx(xs,us)-xs ; Fy(xs,us)+lam(us-us_prev)-ys ; G_ss<=0 ; H_ss==0]
    (Target_Calc.py:71-109); cost with QForm_ss / DUssForm shifts
    (Target_Calc.py:111-124).  Parameters:
    {usp, ysp, xsp, d, us_prev, lam, t, px, py}, one lane each.
    """
    nx, nu, ny = cfg.nx, cfg.nu, cfg.ny
    nxu, nxuy = nx + nu, nx + nu + ny
    ngss = _dim_of(cfg.G_ineq_SS, cfg)
    nhss = _dim_of(cfg.H_eq_SS, cfg)
    h = cfg.h

    def split(w):
        return w[:nx], w[nx:nxu], w[nxu:nxuy]

    def g_fn(w, p):
        xs, us, ys = split(w)
        x_next = model.fx(xs, us, h, p["d"], p["t"], p["px"])
        y_next = model.fy(xs, us, p["d"], p["t"], p["py"]) + p["lam"] @ (us - p["us_prev"])
        rows = [x_next - xs, y_next - ys]
        if cfg.G_ineq_SS is not None:
            rows.append(cfg.G_ineq_SS(xs, us, ys, p["d"], p["t"], p["px"], p["py"]).reshape(-1))
        if cfg.H_eq_SS is not None:
            rows.append(cfg.H_eq_SS(xs, us, ys, p["d"], p["t"], p["px"], p["py"]).reshape(-1))
        return torch.cat(rows)

    def f_fn(w, p):
        xs, us, ys = split(w)
        dx, du, dy = xs, us, ys
        if cfg.QForm_ss:                       # Target_Calc.py:116-119
            dx = dx - p["xsp"]
            dy = dy - p["ysp"]
            du = du - p["usp"]
        if cfg.DUssForm:                       # Target_Calc.py:121-122
            du = us - p["us_prev"]
        return fss_obj(dx, du, dy, p["xsp"], p["usp"], p["ysp"])

    b = cfg.bounds
    lbw = np.full(nxuy, -np.inf)
    ubw = np.full(nxuy, np.inf)
    for name, sl in (("xmin", slice(0, nx)), ("umin", slice(nx, nxu)), ("ymin", slice(nxu, nxuy))):
        v = b.resolved("ss", name)
        if v is not None:
            lbw[sl] = v
    for name, sl in (("xmax", slice(0, nx)), ("umax", slice(nx, nxu)), ("ymax", slice(nxu, nxuy))):
        v = b.resolved("ss", name)
        if v is not None:
            ubw[sl] = v

    ng = nx + ny + ngss + nhss
    lbg = np.zeros(ng)
    ubg = np.zeros(ng)
    if ngss:
        lbg[nx + ny : nx + ny + ngss] = -np.inf  # Target_Calc.py:152-153

    return TargetSpec(nlp=NLP(f=f_fn, g=g_fn, nw=nxuy, ng=ng),
                      lbw=lbw, ubw=ubw, lbg=lbg, ubg=ubg)
