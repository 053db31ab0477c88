"""Gauss-Legendre collocation OCP transcription (port of
``mpc_code_tpu/ocp/collocation.py``).

Replacement for the reference's ``opt_dyn_CM`` (Control_Calc.py:264-567):
2-point Gauss-Legendre implicit collocation with internal stage states
s1, s2 per interval, decision layout

    w = [x_0, s1_0, s2_0, u_0, ..., x_N, (Sl)]      (stride nxuk = 3nx+nu)

collocation equations 1/h * D (S - X) = f(S, u) and state transition
X_{k+1} = X_k + b~' (S - X_k) (Control_Calc.py:372-383, 437, 473-481).

The reference evaluates the collocation dynamics with the stage-0 px at
every stage (par_xmk[:,0], Control_Calc.py:473-474); that quirk is kept
for parity, and ``stagewise_px=True`` gives the corrected form.

``f`` and ``g`` act on one lane, ``(w (nw,), p) -> ...``, as the shooting
transcription's do (``ocp/shooting.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.ocp.shooting import OCPSpec, _user_constraint_dim
from mpc_code_tpu_torch.solver.nlp import NLP

# Butcher tableau, 2-point Gauss-Legendre (Control_Calc.py:372-383)
_A11, _A12 = 1 / 4, 1 / 4 - np.sqrt(3) / 6
_A21, _A22 = 1 / 4 + np.sqrt(3) / 6, 1 / 4
_B = np.array([0.5, 0.5])
_AD = np.linalg.inv(np.array([[_A11, _A12], [_A21, _A22]]))
_BT = _AD.T @ _B  # b~


def build_ocp_collocation(cfg: MPCConfig, model: ModelFns, f_obj, vfin,
                          stagewise_px: bool = False) -> OCPSpec:
    N, nx, nu, ny = cfg.N, cfg.nx, cfg.nu, cfg.ny
    nxuk = 3 * nx + nu
    ng_user = _user_constraint_dim(cfg.G_ineq, cfg)
    nh_user = _user_constraint_dim(cfg.H_eq, cfg)
    ns = (2 * ny + ng_user + nh_user) if cfg.slacks else 0
    nw = nxuk * N + nx + ns

    user_fx = cfg.model.fx  # continuous-time map (Control_Calc.py:356-357)

    b = cfg.bounds
    ymin = b.resolved("dyn", "ymin")
    ymax = b.resolved("dyn", "ymax")
    xmin = b.resolved("dyn", "xmin")
    xmax = b.resolved("dyn", "xmax")
    umin = b.resolved("dyn", "umin")
    umax = b.resolved("dyn", "umax")
    y_free = ymin is None and ymax is None
    du_free = b.Dumin is None and b.Dumax is None
    if not y_free:
        if ymin is None:
            ymin = np.full(ny, -1e12) if cfg.slacks else np.full(ny, -np.inf)
        if ymax is None:
            ymax = np.full(ny, 1e12) if cfg.slacks else np.full(ny, np.inf)

    Ws = None if cfg.Ws is None else torch.as_tensor(np.asarray(cfg.Ws, float))
    h = float(cfg.h)
    bt0, bt1 = float(_BT[0]), float(_BT[1])
    ad = _AD.tolist()

    def c(a, like):
        return torch.as_tensor(np.asarray(a, float), dtype=like.dtype, device=like.device)

    def unpack(w):
        body = w[: N * nxuk].reshape(N, nxuk)
        X = torch.cat([body[:, :nx], w[N * nxuk : N * nxuk + nx][None]], dim=0)
        S1 = body[:, nx : 2 * nx]
        S2 = body[:, 2 * nx : 3 * nx]
        U = body[:, 3 * nx :]
        Sl = w[nw - ns : nw] if ns else None
        return X, S1, S2, U, Sl

    def stage_quantities(w, p):
        X, S1, S2, U, Sl = unpack(w)
        Y = vmap(lambda x, u, py: model.fy(x, u, p["d"], p["t"], py))(X[:N], U, p["py"])
        Y = Y + (U - p["us"]) @ p["lam"].T              # Control_Calc.py:405
        return X, S1, S2, U, Sl, Y

    def _du(U, p):
        return U - torch.cat([p["um1"][None], U[:-1]], dim=0)

    def g_fn(w, p):
        X, S1, S2, U, Sl, Y = stage_quantities(w, p)
        # state transition X_{k+1} = X_k + b1~(S1-X) + b2~(S2-X)  (437)
        x_next = X[:N] + bt0 * (S1 - X[:N]) + bt1 * (S2 - X[:N])
        defects = x_next - X[1:]
        rows = [p["x0"] - X[0], defects.reshape(-1)]
        dxN = X[N] - p["xs"] if cfg.QForm else X[N]
        if cfg.TermCons:
            rows.append(dxN)
        if not y_free:
            g1v = Y.reshape(-1)
            if cfg.slacks:
                slb = Sl[ny : 2 * ny].repeat(N)
                sub = Sl[0:ny].repeat(N)
                g1v = torch.cat([c(ymin, w).repeat(N) - g1v - slb,
                                 -c(ymax, w).repeat(N) + g1v - sub])
            rows.append(g1v)
        if not du_free:
            rows.append(_du(U, p).reshape(-1))
        # collocation equations (473-481); px frozen at stage 0 per reference
        px_stage = p["px"] if stagewise_px else p["px"][0].expand(p["px"].shape)

        def coll(xk, s1, s2, u, px):
            r1 = (1 / h) * (ad[0][0] * (s1 - xk) + ad[0][1] * (s2 - xk)) - user_fx(
                s1, u, p["d"], p["t"], px)
            r2 = (1 / h) * (ad[1][0] * (s1 - xk) + ad[1][1] * (s2 - xk)) - user_fx(
                s2, u, p["d"], p["t"], px)
            return torch.cat([r1, r2])

        g3 = vmap(coll)(X[:N], S1, S2, U, px_stage)
        rows.append(g3.reshape(-1))
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
        X, S1, S2, U, Sl, Y = stage_quantities(w, p)
        ys = model.fy(p["xs"], p["us"], p["d"], p["t"], p["py"][0])
        DU = _du(U, p)
        dX, dU, dY = X[:N], U, Y
        dS1, dS2 = S1, S2
        if cfg.QForm:                                     # Control_Calc.py:458-464
            dX = dX - p["xs"]
            dU = dU - p["us"]
            dY = dY - ys
            dS1 = dS1 - p["xs"]
            dS2 = dS2 - p["xs"]
        if cfg.DUForm:
            dU = DU
        dS = torch.cat([dS1, dS2], dim=1)
        if cfg.DUFormEcon:
            stage = vmap(lambda dx, du, dy, du_k, dsk: f_obj(
                dx, du, dy, p["xs"], du_k, ys, dsk))(dX, dU, dY, DU, dS)
        else:
            stage = vmap(lambda dx, du, dy, dsk: f_obj(
                dx, du, dy, p["xs"], p["us"], ys, dsk))(dX, dU, dY, dS)
        total = torch.sum(stage)
        if cfg.slacks:
            total = total + N * (Sl @ (Ws.to(Sl) @ Sl))
        dxN = X[N] - p["xs"] if cfg.QForm else X[N]
        return total + vfin(dxN, p["xs"])

    # constraint bounds: [eq (init+defects+term); g1; g2; g3 coll; g4; g5]
    n_eq = nx * (N + 1) + (nx if cfg.TermCons else 0)
    n_y = 0 if y_free else (2 * ny * N if cfg.slacks else ny * N)
    n_du = 0 if du_free else nu * N
    n_g3 = 2 * nx * N
    n_g4 = ng_user * N if cfg.G_ineq is not None else 0
    n_g5 = nh_user * N if cfg.H_eq is not None else 0
    ng_total = n_eq + n_y + n_du + n_g3 + n_g4 + n_g5
    lbg = np.zeros(ng_total)
    ubg = np.zeros(ng_total)
    i = n_eq
    if n_y:
        if cfg.slacks:
            lbg[i : i + n_y] = -np.inf
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
    i += n_g3  # collocation equalities stay 0
    if n_g4:
        lbg[i : i + n_g4] = -np.inf
        i += n_g4

    lbw = np.full(nw, -np.inf)
    ubw = np.full(nw, np.inf)
    for k in range(N + 1):
        if xmin is not None:
            lbw[k * nxuk : k * nxuk + nx] = xmin
        if xmax is not None:
            ubw[k * nxuk : k * nxuk + nx] = xmax
    for k in range(N):
        if xmin is not None:                              # Control_Calc.py:552-556
            lbw[k * nxuk + nx : k * nxuk + 3 * nx] = np.tile(xmin, 2)
        if xmax is not None:
            ubw[k * nxuk + nx : k * nxuk + 3 * nx] = np.tile(xmax, 2)
        if umin is not None:
            lbw[k * nxuk + 3 * nx : (k + 1) * nxuk] = umin
        if umax is not None:
            ubw[k * nxuk + 3 * nx : (k + 1) * nxuk] = umax
    if ns:
        lbw[nw - ns :] = 0.0

    return OCPSpec(
        nlp=NLP(f=f_fn, g=g_fn, nw=nw, ng=ng_total),
        nw=nw, ns=ns, ng_user=ng_user, nh_user=nh_user,
        lbw=lbw, ubw=ubw, lbg=lbg, ubg=ubg,
    )
