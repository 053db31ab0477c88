"""Multiple-shooting OCP transcription (port of ``mpc_code_tpu/ocp/shooting.py``).

Replacement for the reference's `opt_dyn` NLP factory
(Control_Calc.py:20-260): an ``NLP`` of plain callables for the dense IPM
(``solver/ipm.py::make_solver``) plus default bounds.  The decision layout
is the reference's, so warm-start shifting and solution extraction are
line-for-line auditable:

    w = [x_0, u_0, x_1, u_1, ..., u_{N-1}, x_N, (Sl)]      (nw = nxu*N+nx+ns)

Constraint ordering also mirrors the reference (Control_Calc.py:200-254):
    g   = [x0 - X_0, shooting defects_0..N-1, (terminal dx)]   == 0
    g1  = stagewise output bounds (ymin <= Y_k <= ymax), or the slack-relaxed
          one-sided pair when slacks are on
    g2  = stagewise Delta-u bounds
    g4  = user inequality constraints (<= 0)
    g5  = user equality constraints (== 0)

``f`` and ``g`` act on one lane, ``(w (nw,), p) -> ...``, with the
parameter dict ``{x0, xs, us, d, um1, t, lam (ny,nu), px (N,npx),
py (N,npy)}`` of that lane; the stage maps go through ``torch.func.vmap``
over the horizon, and the dense IPM vmaps the whole over the lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.ops.integrators import rk4_quad
from mpc_code_tpu_torch.solver.nlp import NLP


@dataclass(frozen=True)
class OCPSpec:
    nlp: NLP
    nw: int
    ns: int          # number of slack variables
    ng_user: int     # user inequality rows per stage
    nh_user: int     # user equality rows per stage
    lbw: np.ndarray  # default variable bounds (x0 rows get pinned per step)
    ubw: np.ndarray
    lbg: np.ndarray
    ubg: np.ndarray


def _user_constraint_dim(fn, cfg: MPCConfig) -> int:
    if fn is None:
        return 0
    z = lambda n: torch.zeros(n, dtype=torch.float64)  # noqa: E731
    out = fn(z(cfg.nx), z(cfg.nu), z(cfg.ny), z(cfg.nd), z(()), z(cfg.npx), z(cfg.npy))
    return int(torch.as_tensor(out).numel())


def build_ocp(cfg: MPCConfig, model: ModelFns, f_obj: Callable, vfin: Callable) -> OCPSpec:
    N, nx, nu, ny = cfg.N, cfg.nx, cfg.nu, cfg.ny
    nxu = nx + nu
    ng_user = _user_constraint_dim(cfg.G_ineq, cfg)
    nh_user = _user_constraint_dim(cfg.H_eq, cfg)
    ns = (2 * ny + ng_user + nh_user) if cfg.slacks else 0
    nw = nxu * N + nx + ns

    b = cfg.bounds
    ymin = b.resolved("dyn", "ymin")
    ymax = b.resolved("dyn", "ymax")
    xmin = b.resolved("dyn", "xmin")
    xmax = b.resolved("dyn", "xmax")
    umin = b.resolved("dyn", "umin")
    umax = b.resolved("dyn", "umax")
    y_free = ymin is None and ymax is None
    du_free = b.Dumin is None and b.Dumax is None
    # slack mode replaces infinite y bounds with big-M (Control_Calc.py:64-73)
    if not y_free:
        if ymin is None:
            ymin = (np.full(ny, -1e12) if cfg.slacks else np.full(ny, -np.inf))
        if ymax is None:
            ymax = (np.full(ny, 1e12) if cfg.slacks else np.full(ny, np.inf))

    Ws = None if cfg.Ws is None else torch.as_tensor(np.asarray(cfg.Ws, float))

    def c(a, like):
        return torch.as_tensor(np.asarray(a, float), dtype=like.dtype, device=like.device)

    cont_form = cfg.ContForm
    if cont_form:
        # ContForm integrates xdot = fx(x,u,d,t,px) + px and the continuous
        # economic stage cost as a quadrature over each interval
        # (Control_Calc.py:102-111,153-158; the reference uses adaptive IDAS,
        # this fixed-step RK4 with the model's Mx — documented difference)
        user_fx = cfg.model.fx
        Mx = getattr(cfg.model, "Mx", 10)

        def ode(x, t, u, d, px, xs, us, py):
            return user_fx(x, u, d, t, px) + px

        def quad(x, t, u, d, px, xs, us, py):
            y = model.fy(x, u, d, t, py)
            ystat = model.fy(xs, us, d, t, py)
            return f_obj(x, u, y, xs, us, ystat)

        integ_cont = rk4_quad(ode, quad, Mx)

    def unpack(w):
        body = w[: N * nxu].reshape(N, nxu)
        X = torch.cat([body[:, :nx], w[N * nxu : N * nxu + nx][None]], dim=0)  # (N+1, nx)
        U = body[:, nx:]                                   # (N, nu)
        Sl = w[nw - ns : nw] if ns else None
        return X, U, Sl

    def stage_quantities(w, p):
        X, U, Sl = unpack(w)
        Y = vmap(lambda x, u, py: model.fy(x, u, p["d"], p["t"], py))(X[:N], U, p["py"])
        Y = Y + (U - p["us"]) @ p["lam"].T  # KKT-matching correction (Control_Calc.py:130)
        return X, U, Sl, Y

    def _du(U, p):
        return U - torch.cat([p["um1"][None], U[:-1]], dim=0)

    def _cont_integrate(X, U, p):
        return vmap(lambda x, u, px, py: integ_cont(
            x, p["t"], cfg.h, u, p["d"], px, p["xs"], p["us"], py))(X[:N], U, p["px"], p["py"])

    def g_fn(w, p):
        X, U, Sl, Y = stage_quantities(w, p)
        if cont_form:
            xf, _ = _cont_integrate(X, U, p)
            defects = X[1:] - xf                           # Control_Calc.py:154-155
        else:
            x_next = vmap(lambda x, u, px: model.fx(x, u, cfg.h, p["d"], p["t"], px))(
                X[:N], U, p["px"])
            defects = x_next - X[1:]                       # Control_Calc.py:171
        rows = [p["x0"] - X[0], defects.reshape(-1)]       # Control_Calc.py:126
        dxN = X[N] - p["xs"] if cfg.QForm else X[N]
        if cfg.TermCons:
            rows.append(dxN)                               # Control_Calc.py:197-198
        if not y_free:
            g1v = Y.reshape(-1)
            if cfg.slacks:
                # one-sided slack-relaxed pair (Control_Calc.py:232-239)
                slb = Sl[ny : 2 * ny].repeat(N)
                sub = Sl[0:ny].repeat(N)
                ymin_t = c(ymin, w).repeat(N)
                ymax_t = c(ymax, w).repeat(N)
                g1v = torch.cat([ymin_t - g1v - slb, -ymax_t + g1v - sub])
            rows.append(g1v)
        if (not du_free) and (not cont_form):
            rows.append(_du(U, p).reshape(-1))
        if cfg.G_ineq is not None:
            G = vmap(lambda x, u, yk, px, py: cfg.G_ineq(
                x, u, yk, p["d"], p["t"], px, py).reshape(-1))(X[:N], U, Y, p["px"], p["py"])
            if cfg.slacks and cfg.slacksG:
                G = G - Sl[2 * ny : 2 * ny + ng_user][None, :]
            rows.append(G.reshape(-1))
        if cfg.H_eq is not None:
            Hc = vmap(lambda x, u, yk, px, py: cfg.H_eq(
                x, u, yk, p["d"], p["t"], px, py).reshape(-1))(X[:N], U, Y, p["px"], p["py"])
            if cfg.slacks and cfg.slacksH:
                Hc = Hc - Sl[2 * ny + ng_user : 2 * ny + ng_user + nh_user][None, :]
            rows.append(Hc.reshape(-1))
        return torch.cat(rows)

    def f_fn(w, p):
        X, U, Sl, Y = stage_quantities(w, p)
        if cont_form:
            _, q = _cont_integrate(X, U, p)
            total = torch.sum(q)
        else:
            ys = model.fy(p["xs"], p["us"], p["d"], p["t"], p["py"][0])  # Control_Calc.py:124
            DU = _du(U, p)
            dX, dU, dY = X[:N], U, Y
            if cfg.QForm:                                   # Control_Calc.py:176-179
                dX = dX - p["xs"]
                dU = dU - p["us"]
                dY = dY - ys
            if cfg.DUForm:                                  # Control_Calc.py:180-181
                dU = DU
            if cfg.DUFormEcon:
                stage = vmap(lambda dx, du, dy, du_k: f_obj(
                    dx, du, dy, p["xs"], du_k, ys))(dX, dU, dY, DU)
            else:
                stage = vmap(lambda dx, du, dy: f_obj(
                    dx, du, dy, p["xs"], p["us"], ys))(dX, dU, dY)
            total = torch.sum(stage)
            if cfg.slacks:
                total = total + N * (Sl @ (Ws.to(Sl) @ Sl))  # Control_Calc.py:187 (per stage)
        dxN = X[N] - p["xs"] if cfg.QForm else X[N]
        return total + vfin(dxN, p["xs"])                   # Control_Calc.py:209-210

    # --- constraint-row count & bounds (must match g_fn ordering) ---
    n_eq = nx * (N + 1) + (nx if cfg.TermCons else 0)
    n_y = 0 if y_free else (2 * ny * N if cfg.slacks else ny * N)
    n_du = 0 if (du_free or cont_form) else nu * N
    n_g4 = ng_user * N if cfg.G_ineq is not None else 0
    n_g5 = nh_user * N if cfg.H_eq is not None else 0
    ng_total = n_eq + n_y + n_du + n_g4 + n_g5

    lbg = np.zeros(ng_total)
    ubg = np.zeros(ng_total)
    i = n_eq
    if n_y:
        if cfg.slacks:
            lbg[i : i + n_y] = -np.inf   # both rows <= 0
            ubg[i : i + n_y] = 0.0
        else:
            lbg[i : i + n_y] = np.tile(ymin, N)
            ubg[i : i + n_y] = np.tile(ymax, N)
        i += n_y
    if n_du:
        Dumin = b.Dumin if b.Dumin is not None else np.full(nu, -np.inf)
        Dumax = b.Dumax if b.Dumax is not None else np.full(nu, np.inf)
        lbg[i : i + n_du] = np.tile(np.asarray(Dumin, float).reshape(-1), N)
        ubg[i : i + n_du] = np.tile(np.asarray(Dumax, float).reshape(-1), N)
        i += n_du
    if n_g4:
        lbg[i : i + n_g4] = -np.inf
        ubg[i : i + n_g4] = 0.0
        i += n_g4
    # g5 rows stay 0 == 0

    lbw = np.full(nw, -np.inf)
    ubw = np.full(nw, np.inf)
    if xmin is not None:
        for k in range(N + 1):
            lbw[k * nxu : k * nxu + nx] = xmin
    if xmax is not None:
        for k in range(N + 1):
            ubw[k * nxu : k * nxu + nx] = xmax
    if umin is not None:
        for k in range(N):
            lbw[k * nxu + nx : (k + 1) * nxu] = umin
    if umax is not None:
        for k in range(N):
            ubw[k * nxu + nx : (k + 1) * nxu] = umax
    if ns:
        lbw[nw - ns :] = 0.0            # Sl >= 0 (Control_Calc.py:217)

    return OCPSpec(
        nlp=NLP(f=f_fn, g=g_fn, nw=nw, ng=ng_total),
        nw=nw, ns=ns, ng_user=ng_user, nh_user=nh_user,
        lbw=lbw, ubw=ubw, lbg=lbg, ubg=ubg,
    )
