"""Steady-state identification and auto-linearisation (port of ``mpc_code_tpu/ident.py``).

Replacement for the reference's `SS_JAC_ID.ss_p_jac_id`
(SS_JAC_ID.py:14-121): find a model steady state by minimising
||Fx(x,u)-x||^2 + ||Fy(x,u)-y||^2 subject to the same maps as equalities
and the base box bounds (``ocp/target.py::build_ss_id`` by the dense IPM,
one lane), then linearise the model there.  The Jacobians are taken by
``torch.func.jacrev`` (JAX: ``jacfwd``; forward mode through the RK4
sub-steps turns f32 into f64 in torch, ROADMAP Queue 3, F9).

The driver hook (MPC_code.py:84-91) then rebuilds the controller model as
the affine linearisation: ``apply_ss_jac_id`` returns the updated config.
The identification runs on ``device`` (default ``cuda``) in f64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacrev

from mpc_code_tpu_torch.config import LinearModel, MPCConfig
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.models.model import build_model
from mpc_code_tpu_torch.ocp.target import build_ss_id
from mpc_code_tpu_torch.solver.ipm import make_solver


def ss_p_jac_id(cfg: MPCConfig, device=None):
    """Returns (A, B, C, D, xlin, ulin, ylin) at the identified steady
    state, as numpy f64."""
    dev = resolve_device(device)
    # linear-disturbance injection is dropped while identifying
    # (SS_JAC_ID.py:19-23)
    offree = cfg.dist.offree
    cfg_id = cfg.replace(dist=dataclasses.replace(
        cfg.dist, offree="no" if offree == "lin" else offree))
    model = build_model(cfg_id)
    spec = build_ss_id(cfg_id, model)
    solve = make_solver(spec.nlp)

    nx, nu, h = cfg.nx, cfg.nu, cfg.h
    kw = dict(dtype=torch.float64, device=dev)
    d0, px0, py0 = (torch.zeros(n, **kw) for n in (cfg.nd, cfg.npx, cfg.npy))
    t0 = torch.zeros((), **kw)
    x0m = torch.as_tensor(np.asarray(cfg.x0_m, float).reshape(-1), **kw)
    u0 = torch.as_tensor(np.asarray(cfg.u0, float).reshape(-1), **kw)
    w0 = torch.cat([x0m, u0, model.fy(x0m, u0, d0, t0, py0)])    # SS_JAC_ID.py:78-82
    par = dict(d=d0[None], t=t0[None], px=px0[None], py=py0[None])
    res = solve(w0[None], par, spec.lbw, spec.ubw, spec.lbg, spec.ubg)
    w = res.w[0]
    xl, ul = w[:nx], w[nx:nx + nu]

    A = jacrev(lambda x: model.fx(x, ul, h, d0, t0, px0))(xl)
    B = jacrev(lambda u: model.fx(xl, u, h, d0, t0, px0))(ul)
    C = jacrev(lambda x: model.fy(x, ul, d0, t0, py0))(xl)
    D = jacrev(lambda u: model.fy(xl, u, d0, t0, py0))(ul)
    wn = w.cpu().numpy()
    return (*(a.cpu().numpy() for a in (A, B, C, D)),
            wn[:nx], wn[nx:nx + nu], wn[nx + nu:])


def apply_ss_jac_id(cfg: MPCConfig, device=None) -> MPCConfig:
    """Rebuild the config with the identified affine linear model
    (MPC_code.py:86-91)."""
    A, B, C, D, xlin, ulin, ylin = ss_p_jac_id(cfg, device=device)
    return cfg.replace(model=LinearModel(A=A, B=B, C=C, xlin=xlin, ulin=ulin, ylin=ylin))
