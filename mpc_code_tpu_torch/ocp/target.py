"""Steady-state NLP builders (port of ``mpc_code_tpu/ocp/target.py``).

Replacements for the reference factories, each an NLP on one point for the
dense IPM (``solver/ipm.py``), which batches over lanes:
- ``build_target``: ``opt_ss`` (Target_Calc.py:20-160), the steady-state
  target over wss = [xs, us, ys] solved before every OCP;
- ``build_ssp``: ``opt_ssp`` (Utilities.py:543-583), the plant steady
  state for a fixed input (modifier adaptation);
- ``build_ssp2``: ``opt_ssp2`` (Utilities.py:585-672), the plant's
  economic optimum;
- ``build_ss_id``: ``opt_ss_id`` (SS_JAC_ID.py:124-201), the steady-state
  hunt of the auto-linearisation (``ident.py``).

``make_lambda_update`` is the modifier-adaptation filter (``defLambdaT``,
Utilities.py:498-541) on one point; its Jacobians are taken by ``jacrev``
(forward mode through the RK4 sub-steps turns f32 into f64, ROADMAP
Queue 3, F9), where JAX's are ``jacfwd``: the same derivatives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import jacrev

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.models.model import ModelFns, PlantFns
from mpc_code_tpu_torch.ops.smalllin import solve_lu
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


def _box(lo, hi, size):
    """(lbw, ubw) of ``size`` from optional bounds, infinite where absent."""
    return (np.full(size, -np.inf) if lo is None else np.asarray(lo, float).reshape(-1),
            np.full(size, np.inf) if hi is None else np.asarray(hi, float).reshape(-1))


def _plant_box(b):
    # the plant's state box defaults to the model's (MPC_code.py:268-269)
    return (b.xpmin if b.xpmin is not None else b.xmin,
            b.xpmax if b.xpmax is not None else b.xmax)


def build_ssp(cfg: MPCConfig, plant: PlantFns) -> TargetSpec:
    """Plant steady state for a fixed input (modifier adaptation step (a)).

    w = xs_plant; g = Fx_p(xs,u)-xs == 0; f = ||Fx_p(xs,u)-xs||^2
    (Utilities.py:543-583).  Parameters: {t, us, pxp, pxmp, d}.
    """
    nxp, h = cfg.nxp, cfg.h

    def resid(w, p):
        if plant.nominal:
            x_next = plant.fx(w, p["us"], h, p["d"], p["t"], p["pxmp"])
        else:
            x_next = plant.fx(w, p["us"], p["pxp"], p["t"], h, p["pxmp"])
        return x_next - w

    def f_fn(w, p):
        r = resid(w, p)
        return r @ r

    lbw, ubw = _box(*_plant_box(cfg.bounds), nxp)
    return TargetSpec(nlp=NLP(f=f_fn, g=resid, nw=nxp, ng=nxp),
                      lbw=lbw, ubw=ubw, lbg=np.zeros(nxp), ubg=np.zeros(nxp))


def build_ssp2(cfg: MPCConfig, plant: PlantFns, fss_obj2: Callable) -> TargetSpec:
    """True plant economic optimum over wss = [xs_p, us, ys]
    (Utilities.py:585-672).  Parameters: {usp, ysp, xsp, pyp, t, pxp, pxmp,
    pymp}.

    Mirrors the reference's QForm_ss quirk where dx = Xs - Xs = 0
    (Utilities.py:647-650).
    """
    nxp, nu, ny = cfg.nxp, cfg.nu, cfg.ny
    nxu, nxuy = nxp + nu, nxp + nu + ny
    h = cfg.h

    def split(w):
        return w[:nxp], w[nxu - nu:nxu], w[nxu:nxuy]

    def g_fn(w, p):
        xs, us, ys = split(w)
        x_next = plant.fx(xs, us, p["pxp"], p["t"], h, p["pxmp"])
        y_next = plant.fy(xs, us, p["pyp"], p["t"], p["pymp"])
        return torch.cat([x_next - xs, y_next - ys])

    def f_fn(w, p):
        xs, us, ys = split(w)
        dx, du, dy = xs, us, ys
        if cfg.QForm_ss:
            dx = dx - xs          # reference quirk: identically zero
            dy = dy - p["ysp"]
            du = du - p["usp"]
        return fss_obj2(dx, du, dy, p["xsp"], p["usp"], p["ysp"])

    b = cfg.bounds
    lbw, ubw = (np.concatenate(a) for a in zip(
        _box(*_plant_box(b), nxp), _box(b.umin, b.umax, nu), _box(b.ymin, b.ymax, ny)))
    ng = nxp + ny
    return TargetSpec(nlp=NLP(f=f_fn, g=g_fn, nw=nxuy, ng=ng),
                      lbw=lbw, ubw=ubw, lbg=np.zeros(ng), ubg=np.zeros(ng))


def make_lambda_update(cfg: MPCConfig, model: ModelFns, plant: PlantFns) -> Callable:
    """Modifier-adaptation lambda update (reference: defLambdaT,
    Utilities.py:498-541) on one point: the steady-state output
    sensitivities of model and plant by the implicit-function theorem,
    ``dy/du = dFy/dx (I - dFx/dx)^{-1} dFx/du``, filtered with alpha_mod
    (Utilities.py:535-537).  ``lambda_update(lam_prev, xps, xs, us, d, t,
    pxp, pyp, px, py, pxmp, pymp) -> lam``; vmap it over lanes."""
    h, nd, alpha = cfg.h, cfg.nd, cfg.alpha_mod

    def sens(fx, fy, xs, us):
        Ax = jacrev(lambda x: fx(x, us))(xs)
        Bu = jacrev(lambda u: fx(xs, u))(us)
        Cx = jacrev(fy)(xs)
        eye = torch.eye(Ax.shape[0], dtype=Ax.dtype, device=Ax.device)
        return Cx @ solve_lu(eye - Ax, Bu)

    def grad_model(xs, us, d, t, px, py):
        return sens(lambda x, u: model.fx(x, u, h, d, t, px),
                    lambda x: model.fy(x, us, d, t, py), xs, us)

    def grad_plant(xps, us, pxp, t, pxmp, pyp, pymp):
        if plant.nominal:
            d0 = xps.new_zeros(nd)
            return sens(lambda x, u: plant.fx(x, u, h, d0, t, pxmp),
                        lambda x: plant.fy(x, us, d0, t, pyp), xps, us)
        return sens(lambda x, u: plant.fx(x, u, pxp, t, h, pxmp),
                    lambda x: plant.fy(x, us, pyp, t, pymp), xps, us)

    def lambda_update(lam_prev, xps, xs, us, d, t, pxp, pyp, px, py, pxmp, pymp):
        gp = grad_plant(xps, us, pxp, t, pxmp, pyp, pymp)
        gm = grad_model(xs, us, d, t, px, py)
        return (1 - alpha) * lam_prev + alpha * (gp - gm)   # Utilities.py:535-537

    return lambda_update


def build_ss_id(cfg: MPCConfig, model: ModelFns) -> TargetSpec:
    """Steady-state hunt for auto-linearisation (SS_JAC_ID.opt_ss_id,
    SS_JAC_ID.py:124-201): minimise ||Fx-xs||^2 + ||Fy-ys||^2 subject to the
    same maps as equality constraints and the base box bounds.
    Parameters: {d, t, px, py}.
    """
    nx, nu, ny = cfg.nx, cfg.nu, cfg.ny
    nxu, nxuy = nx + nu, nx + nu + ny
    h = cfg.h

    def resids(w, p):
        xs, us, ys = w[:nx], w[nx:nxu], w[nxu:nxuy]
        rx = model.fx(xs, us, h, p["d"], p["t"], p["px"]) - xs
        ry = model.fy(xs, us, p["d"], p["t"], p["py"]) - ys
        return rx, ry

    def g_fn(w, p):
        return torch.cat(resids(w, p))

    def f_fn(w, p):
        rx, ry = resids(w, p)
        return rx @ rx + ry @ ry

    b = cfg.bounds
    lbw, ubw = (np.concatenate(a) for a in zip(
        _box(b.xmin, b.xmax, nx), _box(b.umin, b.umax, nu), _box(b.ymin, b.ymax, ny)))
    ng = nx + ny
    return TargetSpec(nlp=NLP(f=f_fn, g=g_fn, nw=nxuy, ng=ng),
                      lbw=lbw, ubw=ubw, lbg=np.zeros(ng), ubg=np.zeros(ng))
