"""Batched closed-loop MPC step (port of ``mpc_code_tpu/loop/batched.py``).

One sampling instant of the reference's closed loop (MPC_code.py:485-875)
for a batch of B scenarios at once: measure -> estimate -> steady-state
target (dense IPM) -> OCP (the structured IPM, warm-started from the
shifted previous primal solution and the shifted duals, or the dense IPM
on the shooting OCP) -> plant.  Time-varying parameters over the horizon,
time-varying setpoints, white process and measurement noise and the real
(non-nominal) plant all run inside the step; the exogenous data of each
instant enters through one :class:`~mpc_code_tpu_torch.loop.schedules.StepInput`
shared by every lane (JAX vmaps the step with ``in_axes=(0, None)``,
``parallel/mesh.py:86-87``).

Layout.  Every field of :class:`MPCCarry` and :class:`MPCStepOut` has a
leading batch dimension B; each lane has its own plant state.  Where the
JAX step selects with ``jnp.where(ok, ...)`` on one lane, this one selects
per lane with ``torch.where(ok[:, None], ...)``: a lane whose target is
infeasible keeps its previous target, a lane whose OCP is infeasible keeps
its input and warm start and predicts its estimate by the model
(MPC_code.py:714-718, 786-805), and the masked solver loops freeze each
lane once it is done, so one diverged lane never stalls the batch.

Estimators: kalss and lue (static gain), kal (linear models only), ekf and
the MHE (``estimators/mhe.py``, both prior updates), whose growing-horizon
warmup runs in the step from the cold window ``init_carry`` builds
(MPC_code.py:591-598), or from a host-warmed window
(``init_carry(cfg, mhe=carry_from_runtime(loop.mhe_rt, P), state=
loop.final_state)`` after a ``ClosedLoop`` warmup).  Modifier adaptation
(the plant steady state, the lambda filter and the plant optimum,
MPC_code.py:829-874) runs in the step per lane.  There is no ``lax.scan``: :func:`run_traced` is
a host loop over the steps on device tensors, and
:func:`run_traced_checkpointed` the same loop in segments with an NPZ
checkpoint after each.  ``batch_hint``, the expected batch, reaches
``build_structured_ocp``, where it engages the sweep autotune
(``ops/sweep_autotune.py``) under ``MPC_TPU_SWEEP_AUTOTUNE=1``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import LinearModel, MPCConfig
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.estimators.ekf import ekf
from mpc_code_tpu_torch.estimators.linear import build_augmented, kalman, kalss, kalss_gain
from mpc_code_tpu_torch.loop.schedules import StepInput, default_step_input, make_step_inputs
from mpc_code_tpu_torch.models import (
    build_model, build_plant, build_ss_cost, build_stage_cost, build_terminal_cost,
)
from mpc_code_tpu_torch.ocp.shooting import _user_constraint_dim, build_ocp
from mpc_code_tpu_torch.ocp.target import (
    build_ssp, build_ssp2, build_target, make_lambda_update,
)
from mpc_code_tpu_torch.ops.linalg import sqrtm_psd
from mpc_code_tpu_torch.solver.ipm import make_solver
from mpc_code_tpu_torch.solver.nlp import STATUS_INFEASIBLE


class MPCCarry(NamedTuple):
    x: torch.Tensor       # plant state (B, nxp)
    xhat: torch.Tensor    # model state estimate (B, nx)
    dhat: torch.Tensor    # disturbance estimate (B, nd)
    P: torch.Tensor       # estimator covariance (B, naug, naug)
    u: torch.Tensor       # last applied input (B, nu)
    xs: torch.Tensor      # current state target (B, nx)
    us: torch.Tensor      # current input target (B, nu)
    w_prev: torch.Tensor  # previous OCP solution, flat layout (B, nw)
    ocp_ok: torch.Tensor  # last OCP feasibility flag (B,)
    t: torch.Tensor       # time (B,)
    mhe: Any = None       # MHECarry window state (kind='mhe' only)
    lam: Any = None       # modifier-adaptation lambda (B, ny, nu) (Adaptation only)
    # dual/barrier warm start of the structured OCP solver (dict with
    # zl/zu/lam/nus (B, N, .) and mu/sf/ok (B,), shifted one stage per step
    # like the primal warm start; None = dual warm start off)
    duals: Any = None


class MPCStepOut(NamedTuple):
    x: torch.Tensor        # plant state at measurement time (history Xp)
    y: torch.Tensor        # measured output (history Yp)
    yhat: torch.Tensor     # pre-correction model output (history Y_HAT)
    u: torch.Tensor
    xs: torch.Tensor
    us: torch.Tensor
    ys: torch.Tensor
    xhat: torch.Tensor     # post-correction estimate
    dhat: torch.Tensor
    status_ss: torch.Tensor
    status_dyn: torch.Tensor
    ocp_iters: torch.Tensor
    lam: Any = None        # updated lambda (Adaptation only)
    cor: Any = None        # lam_prev @ (us - us_prev) (Adaptation only)
    upopt: Any = None      # plant-optimum input (Adaptation only)
    ypopt: Any = None      # plant-optimum output (Adaptation only)
    ss_iters: Any = None   # target solver iterations (the port's own field)
    mhe_status: Any = None  # MHE window solve status and iterations (port's own)
    mhe_iters: Any = None


def _vec(v):
    return np.asarray(v, float).reshape(-1)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def make_mpc_step(cfg: MPCConfig, ysp=None, usp=None, xsp=None,
                  use_structured: Optional[bool] = None, device=None,
                  target_dtype=None, batch_hint: Optional[int] = None) -> Callable:
    """Build ``step(carry, inp=None, mark=None) -> (MPCCarry, MPCStepOut)``.

    ``inp`` is the :class:`StepInput` of this instant, shared by every lane
    (one row of ``make_step_inputs(cfg, Nsim)``); when omitted a fixed
    default (setpoints from ``ysp/usp/xsp``, zero parameters, no noise) is
    used.  The step runs on ``device`` (default ``cuda``) in the dtype of
    the carry.  ``use_structured`` (default: whenever the config is not
    estimation-only) solves the OCP with the structured Riccati IPM and the
    dual warm start of ``carry.duals``; ``False`` solves the dense shooting
    OCP with the dense IPM.  ``target_dtype`` (default: the carry's) is the
    dtype the steady-state target is solved in; its answer is cast back.
    ``mark(name)``, if given, is called after each
    phase of the step ("estimate", "target", "ocp", "plant"), so that a
    caller can time them.  ``batch_hint``: the batch the step will be
    called with, for the structured OCP's sweep autotune (JAX
    ``loop/batched.py:100-104``).
    """
    dev = resolve_device(device)
    nx, nu, nd, N = cfg.nx, cfg.nu, cfg.nd, cfg.N
    nxu = nx + nu
    est = cfg.estimator
    kind = est.kind
    if kind not in ("kalss", "lue", "kal", "ekf", "mhe"):
        raise ValueError(f"estimator kind {kind!r} unsupported in the batched "
                         "step (supported: kalss, lue, kal, ekf, mhe)")
    if kind == "kal" and not isinstance(cfg.model, LinearModel):
        # the reference hard-exits (MPC_code.py:643-646)
        raise ValueError(
            "estimator kind 'kal' requires a LinearModel (reference "
            "MPC_code.py:643-646); use 'ekf' for nonlinear models")
    estimating = bool(cfg.estimating)
    adaptation = (not estimating) and cfg.Adaptation

    model = build_model(cfg)
    plant = build_plant(cfg, model)
    aug = build_augmented(cfg, model)
    if kind == "mhe":
        from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced

        mhe_step, _ = make_mhe_traced(cfg, model, device=dev)

    if use_structured is None:
        use_structured = not estimating
    elif use_structured and estimating:
        raise ValueError("use_structured=True but the config is estimation-only")
    if not estimating:
        f_obj = build_stage_cost(cfg.stage_cost)
        vfin = build_terminal_cost(cfg)
        tspec = build_target(cfg, model, build_ss_cost(cfg.ss_cost))
        ospec = build_ocp(cfg, model, f_obj, vfin)
        target_solve = make_solver(tspec.nlp, cfg.sol_opts_ss)
        nw, ns = ospec.nw, ospec.ns
    if use_structured:
        from mpc_code_tpu_torch.solver.riccati import (
            build_structured_ocp, make_structured_solver,
        )

        socp = build_structured_ocp(cfg, model, f_obj, vfin, device=dev,
                                    batch_hint=batch_hint)
        struct_solve = make_structured_solver(socp, cfg.sol_opts_dyn)
        ns_s = socp.ns
        nup = socp.nxa - nx - ns_s
        du_aug = nup > 0
    elif not estimating:
        ocp_solve = make_solver(ospec.nlp, cfg.sol_opts_dyn)
    if adaptation:
        ssp_spec = build_ssp(cfg, plant)
        ssp_solve = make_solver(ssp_spec.nlp, cfg.sol_opts_ss)
        fss2 = cfg.ss_cost.f_obj if nx != cfg.nxp else build_ss_cost(cfg.ss_cost)
        ssp2_spec = build_ssp2(cfg, plant, fss2)
        ssp2_solve = make_solver(ssp2_spec.nlp, cfg.sol_opts_ss)
        lambda_update = vmap(make_lambda_update(cfg, model, plant))

    K_gain = None
    if kind in ("kalss", "lue"):
        if cfg.StateFeedback and cfg.dist.offree == "no":
            K_gain = torch.eye(aug.n, dtype=torch.float64)
        elif est.K is not None:
            K_gain = torch.as_tensor(np.asarray(est.K, float))
        else:
            K_gain = kalss_gain(cfg, model)

    def mat(v):
        return None if v is None else torch.as_tensor(np.asarray(v, float))

    Qkf, Rkf = mat(est.Q_kf), mat(est.R_kf)
    dmin, dmax = (None if v is None else mat(_vec(v))
                  for v in (cfg.bounds.dmin, cfg.bounds.dmax))
    # noise shaping (MPC_code.py:537-541, 823-827)
    Rv = None if cfg.R_wn is None else sqrtm_psd(mat(cfg.R_wn))
    GQw = None
    if cfg.Q_wn is not None and cfg.G_wn is not None:
        GQw = mat(cfg.G_wn) @ sqrtm_psd(mat(cfg.Q_wn))
    x0_m, u0, x0_p = mat(_vec(cfg.x0_m)), mat(_vec(cfg.u0)), mat(_vec(cfg.x0_p))
    if not estimating:
        t_bounds = (tspec.lbw, tspec.ubw, tspec.lbg, tspec.ubg)
        o_lbw, o_ubw = mat(ospec.lbw), mat(ospec.ubw)
    default_inp = default_step_input(cfg, ysp=ysp, usp=usp, xsp=xsp)
    with_d = cfg.dist.offree != "no"     # the estimator's state carries d
    h = cfg.h

    def step(c: MPCCarry, inp: Optional[StepInput] = None,
             mark: Optional[Callable[[str], None]] = None):
        if inp is None:
            inp = default_inp
        Bsz = c.x.shape[0]
        kw = dict(dtype=c.x.dtype, device=c.x.device)

        def T(v):
            return None if v is None else torch.as_tensor(v, **kw)

        def lanes(v):
            v = T(v)
            return v.expand((Bsz,) + tuple(v.shape))

        inp = StepInput(*(T(a) for a in inp))
        t_k = c.t
        px0, py0 = lanes(inp.px_h[0]), lanes(inp.py_h[0])
        pxp, pyp = lanes(inp.pxp), lanes(inp.pyp)
        pxmp, pymp = lanes(inp.pxmp), lanes(inp.pymp)
        lam_k = c.lam if adaptation else torch.zeros((Bsz, cfg.ny, nu), **kw)

        # pre-correction model output (MPC_code.py:524)
        yhat_k = vmap(model.fy)(c.xhat, c.u, c.dhat, t_k, py0)

        # measurement (MPC_code.py:531-541)
        if plant.nominal:
            y_k = vmap(plant.fy)(c.x, c.u, c.dhat, t_k, py0)
        else:
            y_k = vmap(plant.fy)(c.x, c.u, pyp, t_k, pymp)
        if Rv is not None:
            y_k = y_k + T(Rv) @ inp.v_wn

        # estimator (MPC_code.py:546-668)
        x_es = torch.cat([c.xhat, c.dhat], -1) if with_d else c.xhat
        P, mhe_c, mhe_out = c.P, c.mhe, {}
        if kind in ("kalss", "lue"):
            x_es = kalss(aug, y_k, c.u, T(K_gain), x_es, t_k, py0)
        elif kind == "kal":
            P, _, x_es = kalman(aug, h, y_k, c.u, T(Qkf), T(Rkf), P, x_es, t_k, px0, py0)
        elif kind == "ekf":
            P, _, x_es = ekf(aug, h, y_k, c.u, T(Qkf), T(Rkf), P, x_es, t_k, px0, py0)
        else:
            info = {}
            mhe_c, x_es = mhe_step(c.mhe, y_k, c.u, x_es, t_k, px0, py0, info=info)
            mhe_out = dict(mhe_status=info["status"], mhe_iters=info["iters"])
        if with_d:
            xhat = x_es[:, :nx]
            dhat = x_es[:, nx : nx + nd]
            if dmin is not None:                       # MPC_code.py:660-665
                dhat = torch.minimum(torch.maximum(dhat, T(dmin)), T(dmax))
        else:
            xhat, dhat = x_es, c.dhat
        if mark is not None:
            mark("estimate")

        def plant_step(x, u):
            # plant update incl. process noise (MPC_code.py:813-827)
            if plant.nominal:
                xn = vmap(plant.fx, in_dims=(0, 0, None, 0, 0, 0))(
                    x, u, h, dhat, t_k, pxmp)
            else:
                xn = vmap(plant.fx, in_dims=(0, 0, 0, 0, None, 0))(
                    x, u, pxp, t_k, h, pxmp)
            if GQw is not None:
                xn = xn + T(GQw) @ inp.w_wn
            return xn

        if estimating:
            # estimation-only mode (MPC_code.py:200, 675): no target/OCP,
            # the input is never recomputed, the correction is carried
            x_next = plant_step(c.x, c.u)
            if mark is not None:
                mark("plant")
            zero_i = torch.zeros(Bsz, dtype=torch.int32, device=kw["device"])
            carry = c._replace(x=x_next, xhat=xhat, dhat=dhat, P=P, t=t_k + h, mhe=mhe_c)
            out = MPCStepOut(x=c.x, y=y_k, yhat=yhat_k, u=c.u, xs=c.xs,
                             us=c.us, ys=yhat_k, xhat=xhat, dhat=dhat,
                             status_ss=zero_i, status_dyn=zero_i, ocp_iters=zero_i,
                             **mhe_out)
            return carry, out

        # target problem (MPC_code.py:693-718); the guess mirrors the host
        # loop's fixed x0_m/u0-based guess
        x0_mB, u0B = lanes(x0_m), lanes(u0)
        par_ss = dict(usp=lanes(inp.usp), ysp=lanes(inp.ysp), xsp=lanes(inp.xsp),
                      d=dhat, us_prev=c.us, lam=lam_k, t=t_k, px=px0, py=py0)
        wss0 = torch.cat([x0_mB, u0B, vmap(model.fy)(x0_mB, u0B, dhat, t_k, py0)], -1)
        if target_dtype is not None:
            wss0 = wss0.to(target_dtype)
            par_ss = {k: v.to(target_dtype) for k, v in par_ss.items()}
        rss = target_solve(wss0, par_ss, *t_bounds)
        ss_ok = (rss.status != STATUS_INFEASIBLE)[:, None]
        w_ss = rss.w.to(kw["dtype"])
        xs = torch.where(ss_ok, w_ss[:, :nx], c.xs)          # MPC_code.py:714-718
        us = torch.where(ss_ok, w_ss[:, nx:nxu], c.us)
        cor = (_mv(lam_k, us - c.us) if adaptation else None)  # MPC_code.py:721-724
        ys = vmap(model.fy)(xs, us, dhat, t_k, py0)          # MPC_code.py:730-731
        if mark is not None:
            mark("target")

        # OCP with pinned x0 and shifted warm start (flat layout carried;
        # MPC_code.py:757-764)
        shifted = torch.cat([c.w_prev[:, nxu : nw - ns], c.us, c.xs,
                             c.w_prev[:, nw - ns : nw]], -1)
        w0 = torch.where(c.ocp_ok[:, None], shifted, c.w_prev)
        par = dict(x0=xhat, xs=xs, us=us, d=dhat, um1=c.u, t=t_k, lam=lam_k,
                   px=lanes(inp.px_h), py=lanes(inp.py_h))
        model_next = vmap(model.fx, in_dims=(0, 0, None, 0, 0, 0))
        if use_structured:
            body0 = w0[:, : N * nxu].reshape(Bsz, N, nxu)
            Xg = torch.cat([body0[:, :, :nx], w0[:, None, N * nxu : N * nxu + nx]], 1)
            Ug = body0[:, :, nx:]
            if du_aug:
                Uprev = torch.cat([c.u[:, None], Ug[:, :-1]], 1)
                Xg = torch.cat([Xg, torch.cat([Uprev, Ug[:, -1:]], 1)], -1)
            if ns_s:
                # the shared slack's carried and input slots start from the
                # flat layout's Sl tail
                Sl_prev = w0[:, nw - ns : nw - ns + ns_s]
                Xg = torch.cat([Xg, Sl_prev[:, None].expand(Bsz, N + 1, ns_s)], -1)
                Ug = torch.cat([Ug, Sl_prev[:, None].expand(Bsz, N, ns_s)], -1)
            # dual/barrier warm start: the previous step's multipliers
            # shifted one stage (the primal's shift, MPC_code.py:740-764,
            # extended to the duals); gated off after an infeasible step
            # exactly like the primal freeze
            rs = struct_solve(par, Xg.contiguous(), Ug.contiguous(), ws=c.duals)
            ok = rs.status != STATUS_INFEASIBLE
            if c.duals is not None:
                def _shift(a):
                    return torch.cat([a[:, 1:], a[:, -1:]], 1)

                duals_n = dict(zl=_shift(rs.zl), zu=_shift(rs.zu),
                               lam=_shift(rs.lam), nus=_shift(rs.nus),
                               mu=rs.mu, sf=rs.sf, ok=ok)
            else:
                duals_n = None
            okc = ok[:, None]
            u_k = torch.where(okc, rs.U[:, 0, :nu], c.u)         # MPC_code.py:786-805
            xhat_next = torch.where(okc, rs.X[:, 1, :nx],
                                    model_next(xhat, c.u, h, dhat, t_k, px0))
            body_n = torch.cat([rs.X[:, :N, :nx], rs.U[:, :, :nu]], -1).reshape(Bsz, -1)
            # the flat layout's Sl tail: the solved slack (the carried state
            # at stage 1), zero-padded where the dense layout reserves more
            # slots (slacks=True with no y bounds)
            w_new = torch.cat([body_n, rs.X[:, N, :nx],
                               rs.X[:, 1, nx + nup : nx + nup + ns_s],
                               torch.zeros((Bsz, ns - ns_s), **kw)], -1)
            w_prev = torch.where(okc, w_new, c.w_prev)
            status_dyn, iters_dyn = rs.status, rs.iters
        else:
            lbw = T(o_lbw).expand(Bsz, nw).clone()
            ubw = T(o_ubw).expand(Bsz, nw).clone()
            lbw[:, :nx] = xhat
            ubw[:, :nx] = xhat
            r = ocp_solve(w0, par, lbw, ubw, ospec.lbg, ospec.ubg)
            ok = r.status != STATUS_INFEASIBLE
            okc = ok[:, None]
            u_k = torch.where(okc, r.w[:, nxu - nu : nxu], c.u)  # MPC_code.py:786-805
            xhat_next = torch.where(okc, r.w[:, nxu : nxu + nx],
                                    model_next(xhat, c.u, h, dhat, t_k, px0))
            w_prev = torch.where(okc, r.w, c.w_prev)
            duals_n = c.duals
            status_dyn, iters_dyn = r.status, r.iters
        if mark is not None:
            mark("ocp")

        # plant update (MPC_code.py:813-827)
        x_next = plant_step(c.x, u_k)

        # modifier adaptation (MPC_code.py:829-874): the plant's steady
        # state, the lambda filter update and the plant's economic optimum
        lam_new, upopt, ypopt = c.lam, None, None
        if adaptation:
            x0_pB = lanes(x0_p)
            res_p = ssp_solve(x0_pB, dict(t=t_k, us=us, pxp=pxp, pxmp=pxmp, d=dhat),
                              ssp_spec.lbw, ssp_spec.ubw, ssp_spec.lbg, ssp_spec.ubg)
            lam_new = lambda_update(lam_k, res_p.w, xs, us, dhat, t_k, pxp, pyp,
                                    px0, py0, pxmp, pymp)
            par_ssp2 = dict(usp=lanes(inp.usp), ysp=lanes(inp.ysp),
                            xsp=torch.zeros((Bsz, cfg.nxp), **kw), pyp=pyp, t=t_k,
                            pxp=pxp, pxmp=pxmp, pymp=pymp)
            if plant.nominal:
                y0_p = vmap(plant.fy)(x0_pB, u0B, dhat, t_k, py0)
            else:
                y0_p = vmap(plant.fy)(x0_pB, u0B, pyp, t_k, pymp)
            res_p2 = ssp2_solve(torch.cat([x0_pB, u0B, y0_p], -1), par_ssp2,
                                ssp2_spec.lbw, ssp2_spec.ubw, ssp2_spec.lbg, ssp2_spec.ubg)
            upopt = res_p2.w[:, cfg.nxp:cfg.nxp + nu]
            ypopt = res_p2.w[:, cfg.nxp + nu:]
        if mark is not None:
            mark("plant")

        carry = MPCCarry(x=x_next, xhat=xhat_next, dhat=dhat, P=P, u=u_k,
                         xs=xs, us=us, w_prev=w_prev, ocp_ok=ok,
                         t=t_k + h, mhe=mhe_c, lam=lam_new, duals=duals_n)
        out = MPCStepOut(x=c.x, y=y_k, yhat=yhat_k, u=u_k, xs=xs, us=us,
                         ys=ys, xhat=xhat, dhat=dhat, status_ss=rss.status,
                         status_dyn=status_dyn, ocp_iters=iters_dyn,
                         lam=lam_new if adaptation else None, cor=cor, upopt=upopt,
                         ypopt=ypopt, ss_iters=rss.iters, **mhe_out)
        return carry, out

    return step


def init_carry(cfg: MPCConfig, x0=None, mhe=None, state=None,
               dual_ws: Optional[bool] = None, batch: Optional[int] = None,
               device=None, dtype=None) -> MPCCarry:
    """Initial carry mirroring the reference's loop-state init
    (MPC_code.py:442-484), for a batch of lanes on ``device`` (default
    ``cuda``).

    ``x0``: the plant's initial state, (nx,) shared or (B, nx) one per lane
    (default ``cfg.x0_p``); ``batch`` sets B when ``x0`` is not given per
    lane (default 1).  ``dtype`` defaults to that of a floating ``x0``
    tensor, else f64.  The estimate starts at ``cfg.x0_m`` and the warm
    start at (x0_m, u0) on every stage.
    ``state``: a dict with the host loop's final state (x, xhat, dhat, u,
    P, t and optionally xs/us, w_opt/ocp_feasible): continue from it.
    ``dual_ws``: carry the structured OCP solver's dual/barrier warm start
    (default: whenever the config is not estimation-only).  Pass ``False``
    when stepping with ``use_structured=False``.
    ``mhe``: an ``MHECarry`` of B lanes to start the MHE from; for
    estimator kind 'mhe' it defaults to the cold window of
    ``make_mhe_cold_carry`` (the growing-horizon warmup runs in the step).
    """
    dev = resolve_device(device)
    nx, nu, nd, N = cfg.nx, cfg.nu, cfg.nd, cfg.N
    naug = nx + nd if cfg.dist.offree != "no" else nx
    if state is not None and x0 is None:
        x0 = state["x"]
    if dtype is None:
        dtype = (x0.dtype if torch.is_tensor(x0) and x0.is_floating_point()
                 else torch.float64)
    kw = dict(dtype=dtype, device=dev)

    def T(v):
        return torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v, float), **kw)

    x0 = T(_vec(cfg.x0_p) if x0 is None else x0)
    Bsz = x0.shape[0] if x0.dim() == 2 else (1 if batch is None else int(batch))

    def lanes(v):
        v = T(v)
        return v.expand((Bsz,) + tuple(v.shape)).clone()

    if x0.dim() == 1:
        x0 = lanes(x0)
    x0_m, u0 = _vec(cfg.x0_m), _vec(cfg.u0)
    dhat0 = np.zeros(nd) if cfg.dhat0 is None else _vec(cfg.dhat0)
    P0 = (np.asarray(cfg.estimator.P0, float) if cfg.estimator.P0 is not None
          else np.zeros((naug, naug)))
    nxu = nx + nu
    ns = (2 * cfg.ny + _user_constraint_dim(cfg.G_ineq, cfg)
          + _user_constraint_dim(cfg.H_eq, cfg)) if cfg.slacks else 0
    nw = nxu * N + nx + ns
    # [x0_m, u0] on every stage, x0_m at N, the slack tail (if any) at 0
    w0 = np.concatenate([np.tile(np.concatenate([x0_m, u0]), N), x0_m, np.zeros(ns)])
    lam0 = np.zeros((cfg.ny, nu)) if cfg.Adaptation and not cfg.estimating else None
    if dual_ws is None:
        dual_ws = not cfg.estimating
    duals0 = None
    if dual_ws:
        # zero template with ok=False: step 0 runs the cold dual init and
        # every later step warm-starts from the shifted multipliers
        from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

        socp0 = build_structured_ocp(cfg, build_model(cfg),
                                     build_stage_cost(cfg.stage_cost),
                                     build_terminal_cost(cfg), device=dev)
        nzs0 = socp0.nxa + socp0.nu + socp0.ni
        duals0 = dict(zl=torch.zeros((Bsz, N, nzs0), **kw),
                      zu=torch.zeros((Bsz, N, nzs0), **kw),
                      lam=torch.zeros((Bsz, N, socp0.nxa), **kw),
                      nus=torch.zeros((Bsz, N, socp0.ni), **kw),
                      mu=torch.zeros(Bsz, **kw), sf=torch.ones(Bsz, **kw),
                      ok=torch.zeros(Bsz, dtype=torch.bool, device=dev))
    if cfg.estimator.kind == "mhe" and mhe is None:
        from mpc_code_tpu_torch.estimators.mhe import make_mhe_cold_carry

        inp0 = default_step_input(cfg)
        mhe = make_mhe_cold_carry(cfg, px0=inp0.px_h[0], py0=inp0.py_h[0],
                                  batch=Bsz, device=dev, dtype=dtype)
    carry = MPCCarry(x=x0, xhat=lanes(x0_m), dhat=lanes(dhat0), P=lanes(P0),
                     u=lanes(u0), xs=lanes(x0_m), us=lanes(u0), w_prev=lanes(w0),
                     ocp_ok=torch.ones(Bsz, dtype=torch.bool, device=dev),
                     t=torch.zeros(Bsz, **kw), mhe=mhe,
                     lam=None if lam0 is None else lanes(lam0), duals=duals0)
    if state is not None:
        carry = carry._replace(
            xhat=lanes(state["xhat"]), dhat=lanes(state["dhat"]),
            u=lanes(state["u"]), P=lanes(state["P"]),
            t=torch.full((Bsz,), float(state["t"]), **kw))
        if state.get("xs") is not None:
            carry = carry._replace(xs=lanes(state["xs"]), us=lanes(state["us"]))
        if state.get("w_opt") is not None and np.asarray(state["w_opt"]).shape == (nw,):
            carry = carry._replace(
                w_prev=lanes(state["w_opt"]),
                ocp_ok=torch.full((Bsz,), bool(state["ocp_feasible"]), device=dev))
        if state.get("lam") is not None and lam0 is not None:
            carry = carry._replace(lam=lanes(state["lam"]))
    return carry


def _is_record(v):
    return isinstance(v, tuple) and hasattr(v, "_fields")


def map_carry(fn, v):
    """``fn`` on every array of a nested carry value (dicts entry by entry,
    NamedTuples field by field; None kept)."""
    if isinstance(v, dict):
        return {k: map_carry(fn, x) for k, x in v.items()}
    if _is_record(v):
        return type(v)(*(map_carry(fn, x) for x in v))
    return None if v is None else fn(v)


def cast_carry(carry: MPCCarry, dtype) -> MPCCarry:
    """The carry with every floating tensor (those of the duals and of the
    MHE window too) cast to ``dtype``: to step a state of one run in
    another precision."""
    return map_carry(lambda v: v.to(dtype) if v.is_floating_point() else v, carry)


def tile_carry(carry: MPCCarry, batch: int) -> MPCCarry:
    """A carry of one lane repeated over ``batch`` lanes: every tensor's
    leading axis of 1 (those of the duals and of the MHE window too)
    expanded and copied."""
    def tile(v):
        if v.shape[:1] != (1,):
            raise ValueError(f"tile_carry needs one lane, got shape {tuple(v.shape)}")
        return v.expand((batch,) + tuple(v.shape[1:])).clone()

    return map_carry(tile, carry)


def stack_outputs(outs: Sequence[MPCStepOut]) -> MPCStepOut:
    """The per-step outputs of a run stacked over a leading ``(Nsim,)`` axis:
    ``(Nsim, B, ...)``, the axis order of JAX's vmapped scan."""
    return MPCStepOut(*(None if getattr(outs[0], f) is None
                        else torch.stack([getattr(o, f) for o in outs])
                        for f in MPCStepOut._fields))


def run_traced(cfg: MPCConfig, carry0: Optional[MPCCarry] = None,
               Nsim: Optional[int] = None, inputs: Optional[StepInput] = None,
               t0: float = 0.0, k0: int = 0,
               use_structured: Optional[bool] = None, device=None):
    """Run the full-fidelity closed loop for ``Nsim`` steps.

    A host loop over the steps on device tensors (the JAX ``lax.scan`` has
    no counterpart): precomputes the schedule/noise stack, steps the batch,
    and returns ``(final_carry, history)`` with the simulator's history
    keys, each ``(Nsim, B, ...)``.  ``carry0`` defaults to
    ``init_carry(cfg)``, one lane.
    """
    dev = resolve_device(device)
    Nsim = cfg.Nsim if Nsim is None else Nsim
    if inputs is None:
        inputs = make_step_inputs(cfg, Nsim, t0=t0, k0=k0)
    if carry0 is None:
        carry0 = init_carry(cfg, device=dev,
                            dual_ws=None if use_structured is not False else False)
    step = make_mpc_step(cfg, use_structured=use_structured, device=dev)
    return _run_steps(step, carry0, inputs)


def _run_steps(step, carry, inputs):
    """Step ``carry`` through every row of ``inputs``; returns the final
    carry and the history."""
    outs = []
    for k in range(len(inputs.ysp)):
        carry, out = step(carry, StepInput(*(a[k] for a in inputs)))
        outs.append(out)
    return carry, history_from_outputs(stack_outputs(outs))


def _items(v, name):
    """(dotted name, tensor) of every tensor in a nested carry value: a
    dict entry by entry (``duals.<key>``), a NamedTuple field by field
    (``mhe.sm.<field>``); None is left out."""
    if v is None:
        return
    if isinstance(v, dict):
        for k, x in v.items():
            yield from _items(x, f"{name}.{k}")
    elif _is_record(v):
        for f, x in zip(v._fields, v):
            yield from _items(x, f"{name}.{f}")
    else:
        yield name, v


def _carry_arrays(carry: MPCCarry) -> Dict[str, np.ndarray]:
    """The carry as named numpy arrays, field by field, nested fields under
    dotted names; None fields are left out."""
    return {k: a.detach().cpu().numpy()
            for name, v in zip(MPCCarry._fields, carry) for k, a in _items(v, name)}


def _carry_from_arrays(template: MPCCarry, arrays, device) -> MPCCarry:
    """The inverse of ``_carry_arrays`` on ``device``, shaped by
    ``template`` (its None fields stay None)."""
    def build(v, name):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: build(x, f"{name}.{k}") for k, x in v.items()}
        if _is_record(v):
            return type(v)(*(build(x, f"{name}.{f}") for f, x in zip(v._fields, v)))
        return torch.as_tensor(np.asarray(arrays[name]), device=device)

    return MPCCarry(*(build(v, name) for name, v in zip(MPCCarry._fields, template)))


def run_traced_checkpointed(cfg: MPCConfig, path: str, segment: int = 100,
                            carry0: Optional[MPCCarry] = None,
                            Nsim: Optional[int] = None, t0: float = 0.0,
                            use_structured: Optional[bool] = None,
                            resume: bool = True, device=None):
    """``run_traced`` in segments of ``segment`` steps with an NPZ
    checkpoint written after each (JAX ``batched.py:532-602``).

    ``path`` is rewritten atomically after every segment with the carry
    (field by field), the history so far and the resume index; if the file
    exists (and ``resume``), the run continues from it, so a killed sweep
    loses at most one segment.  ``carry0`` (default ``init_carry(cfg)``, one
    lane) also gives the structure a checkpoint is read back into.
    """
    import os
    import tempfile

    dev = resolve_device(device)
    Nsim = cfg.Nsim if Nsim is None else Nsim
    if carry0 is None:
        carry0 = init_carry(cfg, device=dev,
                            dual_ws=None if use_structured is not False else False)
    k_done, carry = 0, carry0
    hist_acc: Dict[str, list] = {}
    if resume and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            k_done = int(z["__k_done__"])
            t0 = float(z["__t_next__"])
            carry = _carry_from_arrays(
                carry0, {k[len("__carry_"):-2]: z[k] for k in z.files
                         if k.startswith("__carry_")}, dev)
            for key in z.files:
                if not key.startswith("__"):
                    hist_acc[key] = [z[key]]

    step = make_mpc_step(cfg, use_structured=use_structured, device=dev)

    def save():
        payload = {f"__carry_{k}__": v for k, v in _carry_arrays(carry).items()}
        payload["__k_done__"] = np.asarray(k_done)
        payload["__t_next__"] = np.asarray(t0)
        for key, parts in hist_acc.items():
            payload[key] = np.concatenate(parts, axis=0)
        # the suffix must be ".npz": np.savez appends it to any other name
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                                   suffix=".npz")
        os.close(fd)
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    while k_done < Nsim:
        n = min(segment, Nsim - k_done)
        carry, H_seg = _run_steps(step, carry, make_step_inputs(cfg, n, t0=t0, k0=k_done))
        for key, v in H_seg.items():
            hist_acc.setdefault(key, []).append(v)
        k_done += n
        t0 += n * cfg.h
        save()
    return carry, {k: np.concatenate(v, axis=0) for k, v in hist_acc.items()}


def history_from_outputs(outs: MPCStepOut) -> Dict[str, np.ndarray]:
    """Map stacked MPCStepOut tensors to the simulator's history keys."""
    H = {
        "Xp": outs.x, "Yp": outs.y, "Y_HAT": outs.yhat, "U": outs.u,
        "XS": outs.xs, "US": outs.us, "YS": outs.ys, "X_HAT_CORR": outs.xhat,
        "D_HAT": outs.dhat, "STATUS_SS": outs.status_ss,
        "STATUS_DYN": outs.status_dyn, "OCP_ITERS": outs.ocp_iters,
        "SS_ITERS": outs.ss_iters, "MHE_STATUS": outs.mhe_status,
        "MHE_ITERS": outs.mhe_iters, "LAMBDA": outs.lam, "COR": outs.cor,
        "Upopt": outs.upopt, "Ypopt": outs.ypopt,
    }
    return {k: v.detach().cpu().numpy() for k, v in H.items() if v is not None}
