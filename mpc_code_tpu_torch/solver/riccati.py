"""Structure-exploiting interior-point solver for shooting OCPs (parts 1-4).

Port of ``mpc_code_tpu/solver/riccati.py`` for four configurations: plain
continuous shooting (the batched CSTR NMPC bench), discrete-map shooting
(the quadruple tank, Ex_NMPC_dis), linear-model shooting (the LMPC
examples) and the ContForm economic transcription (Ex_ENMPC), each with
or without output bounds, the shooting forms also
with the u_prev state augmentation that Delta-u bounds and Delta-u costs
(``DUForm``, ``DUFormEcon``) need, with the Gauss-Newton Hessian, the
monotone barrier, the rollout-free adaptive step controller
(``ls_mode='adaptive'``), best-iterate bookkeeping and the closed loop's
cross-solve dual/barrier warm start (``solve(..., ws=)``: the previous
step's multipliers and barrier, shifted one stage and rescaled to the new
objective scaling).  Plain continuous shooting and linear-model shooting
also take the exact Lagrangian Hessian (the default of
``SolverOptions``).  Every other
configuration raises ``NotImplementedError`` naming its ROADMAP item.

Layout.  The JAX solver is written for one lane and batched with ``vmap``;
here every solver function takes an explicit leading batch dimension B.
The user's model and cost callables still act on one point, so the stage
functions of ``StructuredOCP`` take one (state, input, stage-parameter)
point and their derivatives come from ``torch.func`` (``grad``,
``hessian``, ``jacfwd``, ``jacrev``) vmapped over the B*N (scenario,
stage) points.

Per iteration the solver runs two hand-written CUDA kernels on the card:
a derivative sweep, either the RK4 stage-Jacobian sweep
(``ops/sweep_cuda.py``) or, for a discrete model, the map's stage-Jacobian
sweep (``ops/sweep_map_cuda.py``), both through
``StructuredOCP.stage_dyn_jac``, or, for a ContForm OCP, the joint
dynamics-and-quadrature sweep (``ops/sweep_cf_cuda.py``, through
``StructuredOCP.stage_cf``, which also gives the stage cost's value,
gradient and Hessian), or, under the exact Hessian, the fused generic
stage-derivative sweep (``solver/sweep_kernel.py``: every output of
``make_stage_derivs`` in one pass), and the Riccati KKT solve
(``solver/riccati_kernel.py``).  A linear model has no derivative
kernel, in JAX as here: its stage derivatives come from
``make_stage_derivs`` by ``torch.func``, and the Riccati KKT solve is
its one kernel.  The rest is IPM algebra on whole tensors.

The JAX ``lax.while_loop`` under ``vmap`` runs until every lane is done and
freezes each lane as soon as its own condition ``(~done) & (it < cap)`` is
false; the masked loop here does the same, so per-lane ``iters`` and
``status`` match.  Deciding whether any lane is still active costs one
host synchronisation per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from mpc_code_tpu_torch.config import (
    DiscreteModel, LinearModel, MPCConfig, SolverOptions,
)
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.solver.nlp import (
    STATUS_ACCEPTABLE, STATUS_INFEASIBLE, STATUS_SOLVED,
)
from mpc_code_tpu_torch.solver.riccati_kernel import riccati_kkt

_TAU_MIN = 0.99
_MAX_BACKTRACK = 20
_KAPPA_EPS = 10.0
_KAPPA_MU = 0.2
_THETA_MU = 1.5

# per-lane rank of each entry of the parameter dict p
PARAM_NDIM = {"x0": 1, "xs": 1, "us": 1, "d": 1, "um1": 1, "t": 0,
              "lam": 2, "px": 2, "py": 2}


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def batch_params(p: dict, Bsz: int, dtype, device, ndim: Optional[dict] = None) -> dict:
    """Parameter dict with a leading batch dimension on every entry.

    Each entry of ``p`` is given either for one lane, and then shared by
    all B lanes, or with a leading B; ``ndim`` gives each key's per-lane
    rank (default ``PARAM_NDIM``, the OCP's {x0, xs, us, d, um1, t, lam,
    px (N,npx), py (N,npy)}, the JAX solver's parameter pytree).  Floating
    entries are cast to ``dtype``; boolean ones (a stage mask) stay
    boolean."""
    ndim = PARAM_NDIM if ndim is None else ndim
    out = {}
    for k, v in p.items():
        v = torch.as_tensor(v, device=device)
        if v.dtype != torch.bool:
            # cast from the value given: a Python float keeps its f64 digits
            v = torch.as_tensor(p[k], dtype=dtype, device=device)
        nd = ndim.get(k, v.dim())
        if v.dim() == nd:
            v = v.expand((Bsz,) + tuple(v.shape))
        elif v.dim() != nd + 1 or v.shape[0] != Bsz:
            raise ValueError(f"parameter {k!r} has shape {tuple(v.shape)}; "
                             f"expected rank {nd} or ({Bsz}, ...)")
        out[k] = v
    return out


def stage_params(p: dict, N: int) -> dict:
    """One entry per (scenario, stage) point, flattened to B*N: the shared
    per-lane data, ``px``/``py`` of that stage, ``py0`` (stage 0) and
    ``k0``, whether the point is stage 0 (the JAX stage functions' ``k ==
    0``)."""
    Bsz = p["xs"].shape[0]

    def rep(v):
        return v.unsqueeze(1).expand((Bsz, N) + tuple(v.shape[1:])).reshape(
            (Bsz * N,) + tuple(v.shape[1:]))

    pk = {k: rep(p[k]) for k in ("xs", "us", "d", "um1", "t", "lam")}
    pk["px"] = p["px"].reshape(Bsz * N, -1)
    pk["py"] = p["py"].reshape(Bsz * N, -1)
    pk["py0"] = rep(p["py"][:, 0])
    pk["k0"] = (torch.arange(N, device=p["xs"].device) == 0).repeat(Bsz)
    if "_sf" in p:
        pk["_sf"] = rep(p["_sf"])
    return pk


def terminal_params(p: dict) -> dict:
    """The terminal cost's parameters: the OCP's ``xs``."""
    return {"xs": p["xs"]}


class ParamHook(NamedTuple):
    """How the solver reads an OCP's parameter dict ``p``: each key's
    per-lane rank (``batch_params``), ``stage(p, N)`` the per-point dict
    the stage functions see, flattened to B*N, and ``terminal(p)`` the
    terminal cost's.  The JAX solver hands its stage functions the whole
    pytree with the stage index ``k``; here the hook does the indexing
    once per solve."""
    ndim: dict
    stage: Callable
    terminal: Callable


OCP_PARAMS = ParamHook(PARAM_NDIM, stage_params, terminal_params)


@dataclass(frozen=True)
class StructuredOCP:
    """Stagewise OCP over the (scaled) augmented state xa.

    ``cost`` and ``ineq`` act on one point ``(xa, u, pk)``, where
    ``pk`` is one (scenario, stage) slice of ``params.stage(p, N)``;
    ``cost_N`` on one ``(xa, pN)`` with ``pN = params.terminal(p)`` and
    ``"_sf"``.  ``params`` defaults to the OCP's parameter dict
    (``OCP_PARAMS``); the MHE (``ocp/mhe.py``) brings its own.
    ``stage_dyn_jac`` is batched: ``(X (B,N,nxa), U (B,N,nu), p) ->
    (dval, A, B)`` in scaled units through the CUDA sweep on the card.
    A ContForm OCP has ``stage_cf`` instead: ``(X, U, p) -> (dval, A, B,
    qv (B,N), gq (B,N,nz), Hq (B,N,nz,nz))``, the quadrature cost's value,
    gradient and Hessian (scaled) from the same rollout.  ``ineq`` is None
    when ``ni = 0``.  ``dyn`` is the scaled one-interval map on one point
    ``(xa, u, pk) -> xa_next``, which the exact Lagrangian Hessian
    traverses, and ``lowering`` what the fused stage sweep's code
    generator needs; both are None where the exact Hessian is not ported
    (the discrete map, ContForm, the u_prev augmentation of a continuous
    model).  A ``LinearModel`` has ``dyn`` (with the u_prev rows) and
    neither a sweep nor a lowering: the solver differentiates ``dyn`` by
    ``torch.func``, as JAX does.
    """

    N: int
    nxa: int
    nu: int
    ni: int
    cost: Callable
    cost_N: Callable
    ineq: Optional[Callable]
    lbi: np.ndarray
    ubi: np.ndarray
    lbx: np.ndarray
    ubx: np.ndarray
    lbu: np.ndarray
    ubu: np.ndarray
    x0_of_p: Callable
    sxa: np.ndarray
    su: np.ndarray
    si: np.ndarray
    stage_dyn_jac: Optional[Callable]
    device: torch.device
    sweep: Optional[Callable] = None   # the sweep kernel's wrapper it runs
    stage_cf: Optional[Callable] = None
    dyn: Optional[Callable] = None
    lowering: Optional["StageLowering"] = None
    params: ParamHook = OCP_PARAMS


# the per-point parameters of the lowered stage cost and rows, in order
POINT_ARGS = ("t", "xs", "us", "d", "um1", "lam", "py", "py0")


class StageLowering(NamedTuple):
    """The raw (unscaled) stage functions of a continuous-shooting OCP in
    the form the fused stage sweep (``solver/sweep_kernel.py``) lowers to
    CUDA: the user ODE ``ode(x, t, u, d, px)`` with its RK4 sub-steps, the
    interval, the guard's bounds, ``Bd`` (None unless offree='lin') and
    LinPar; the stage cost and rows as ``f(xa, u, *POINT_ARGS)``."""
    ode: Callable
    Mx: int
    h: float
    clip_lo: Optional[np.ndarray]
    clip_hi: Optional[np.ndarray]
    Bd: Optional[np.ndarray]
    lin_par: bool
    cost: Callable
    ineq: Optional[Callable]
    nx: int
    ny: int


class StructResult(NamedTuple):
    X: torch.Tensor      # (B, N+1, nxa)
    U: torch.Tensor      # (B, N, nu)
    f: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    kkt_err: torch.Tensor
    feas_err: torch.Tensor
    zl: torch.Tensor     # (B, N, nxa+nu+ni) lower-bound duals
    zu: torch.Tensor
    lam: torch.Tensor    # (B, N, nxa) defect multipliers
    nus: torch.Tensor    # (B, N, ni) inequality multipliers
    mu: torch.Tensor     # final barrier parameter
    sf: torch.Tensor     # objective scaling the duals/mu are in


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _dense(op, a, b):
    """``op(a, b)`` written into a contiguous tensor in one pass: a sweep
    kernel's outputs are views of lane-innermost planes, and the Riccati
    kernel reads contiguous (B, N, ...) tensors."""
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape), dtype=a.dtype,
                      device=a.device)
    return op(a, b, out=out)


def build_structured_ocp(cfg: MPCConfig, model: ModelFns, f_obj, vfin,
                         device=None) -> StructuredOCP:
    """Map the reference OCP (opt_dyn form) onto the stagewise structure.

    Uses the parameter dict {x0, xs, us, d, um1, t, lam, px (N,npx),
    py (N,npy)}.  Runs on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    b = cfg.bounds
    cont_form = cfg.ContForm
    # ContForm wins over Collocation, and ignores Delta-u rows and the
    # discrete cost forms, as in the reference (JAX riccati.py:244-249, 287-290)
    if cfg.Collocation and not cont_form:
        raise _todo("Collocation", "Queue 1 item 20")
    ymin = b.resolved("dyn", "ymin")
    ymax = b.resolved("dyn", "ymax")
    y_free = ymin is None and ymax is None
    if cfg.slacks and not y_free:
        raise _todo("shared output slacks", "Queue 1 item 21")
    if cfg.TermCons:
        raise _todo("TermCons", "Queue 1 item 21")
    if cfg.H_eq is not None or cfg.G_ineq is not None:
        raise _todo("user stage constraints H_eq / G_ineq", "Queue 1 item 21")
    nx, nu, ny = cfg.nx, cfg.nu, cfg.ny
    # the state is augmented with u_{k-1} whenever Delta-u appears in the
    # bounds or in the cost (JAX riccati.py:238-249)
    du_bounds = not cont_form and not (b.Dumin is None and b.Dumax is None)
    du_coupled = not cont_form and (du_bounds or cfg.DUForm or cfg.DUFormEcon)
    nup = nu if du_coupled else 0
    xmin = b.resolved("dyn", "xmin")
    xmax = b.resolved("dyn", "xmax")
    umin = b.resolved("dyn", "umin")
    umax = b.resolved("dyn", "umax")
    nxa = nx + nup
    ni = (0 if y_free else ny) + (nu if du_bounds else 0)
    h = float(cfg.h)
    qform = cfg.QForm

    def y_of(x, u, pk):
        return model.fy(x, u, pk["d"], pk["t"], pk["py"]) + pk["lam"] @ (u - pk["us"])

    def um1_of(xa, pk):
        """u_{k-1}: the parameter at stage 0, the carried slot after it
        (JAX riccati.py:405, 454)."""
        if not du_coupled:
            return pk["um1"]
        return torch.where(pk["k0"], pk["um1"], xa[nx:])

    if cont_form:
        # integrate xdot = fx(x,u,d,t,px) + px and the continuous economic
        # stage cost as a quadrature over each interval (JAX riccati.py:
        # 311-333; Control_Calc.py:102-111,153-158)
        from mpc_code_tpu_torch.ops.integrators import (
            rk4_quad, rk4_quad_stage_hess,
        )

        user_fx_c, Mx_c = cfg.model.fx, cfg.model.Mx

        def _ode(x, t, u, d, px, xs, us, py):
            return user_fx_c(x, u, d, t, px) + px

        def _quad(x, t, u, d, px, xs, us, py):
            y = model.fy(x, u, d, t, py)
            ystat = model.fy(xs, us, d, t, py)
            return f_obj(x, u, y, xs, us, ystat)

        integ_cont = rk4_quad(_ode, _quad, Mx_c)

        def raw_cost(xa, u, pk):
            return integ_cont(xa, pk["t"], h, u, pk["d"], pk["px"], pk["xs"],
                              pk["us"], pk["py"])[1]
    else:
        def raw_cost(xa, u, pk):
            x = xa[:nx]
            yk = y_of(x, u, pk)
            ys = model.fy(pk["xs"], pk["us"], pk["d"], pk["t"], pk["py0"])
            du_k = u - um1_of(xa, pk)
            dx, du, dy = x, u, yk
            if qform:
                dx = dx - pk["xs"]
                du = du - pk["us"]
                dy = dy - ys
            if cfg.DUForm:
                du = du_k
            us_obj = du_k if cfg.DUFormEcon else pk["us"]
            return f_obj(dx, du, dy, pk["xs"], us_obj, ys)

    def raw_ineq(xa, u, pk):
        rows = [] if y_free else [y_of(xa[:nx], u, pk)]
        if du_bounds:
            rows.append(u - um1_of(xa, pk))
        return torch.cat(rows)

    def row_bounds(lo, hi, n):
        return (np.asarray(lo, float).reshape(-1) if lo is not None else np.full(n, -np.inf),
                np.asarray(hi, float).reshape(-1) if hi is not None else np.full(n, np.inf))

    rows_lo, rows_hi = [], []
    if not y_free:
        lo, hi = row_bounds(ymin, ymax, ny)
        rows_lo.append(lo)
        rows_hi.append(hi)
    if du_bounds:
        lo, hi = row_bounds(b.Dumin, b.Dumax, nu)
        rows_lo.append(lo)
        rows_hi.append(hi)
    lbi = np.concatenate(rows_lo) if ni else np.zeros(0)
    ubi = np.concatenate(rows_hi) if ni else np.zeros(0)
    lbx, ubx = row_bounds(xmin, xmax, nx)
    lbx = np.concatenate([lbx, np.full(nup, -np.inf)])
    ubx = np.concatenate([ubx, np.full(nup, np.inf)])
    lbu, ubu = row_bounds(umin, umax, nu)

    # per-variable scaling from the box bounds: internally x~ = x / sxa
    def _scales(lo, hi):
        mag = np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                         np.abs(np.where(np.isfinite(hi), hi, 0.0)))
        return np.where(mag > 1.0, mag, 1.0)

    sxa, su, si = _scales(lbx, ubx), _scales(lbu, ubu), _scales(lbi, ubi)

    def cost_s(xa, u, pk):
        return raw_cost(_t(sxa, xa) * xa, _t(su, u) * u, pk)

    def cost_N_s(xa, pN):
        x = (_t(sxa, xa) * xa)[:nx]
        return vfin(x - pN["xs"] if qform else x, pN["xs"])

    def ineq_s(xa, u, pk):
        return raw_ineq(_t(sxa, xa) * xa, _t(su, u) * u, pk) / _t(si, xa)

    def x0_s(p):
        x0a = torch.cat([p["x0"], p["um1"]], -1) if du_coupled else p["x0"]
        return x0a / _t(sxa, x0a)

    common = dict(N=cfg.N, nxa=nxa, nu=nu, ni=ni, cost=cost_s,
                  cost_N=cost_N_s, ineq=ineq_s if ni else None,
                  lbi=lbi / si, ubi=ubi / si, lbx=lbx / sxa, ubx=ubx / sxa,
                  lbu=lbu / su, ubu=ubu / su, x0_of_p=x0_s,
                  sxa=sxa, su=su, si=si, device=dev)

    if cont_form:
        # the joint rollout sweep: dynamics Jacobians and the quadrature
        # cost's gradient and Hessian from one pass (JAX riccati.py:686-715)
        sweep_cf = rk4_quad_stage_hess(_ode, _quad, Mx_c)
        sz = np.concatenate([sxa, su])

        def stage_cf(Xs, Us, p):
            s_x, s_u, s_z = _t(sxa, Xs), _t(su, Us), _t(sz, Xs)
            hb = torch.full((Xs.shape[0],), h, dtype=Xs.dtype, device=Xs.device)
            xf, Jx, Ju, qv, gq, Hq = sweep_cf(
                Xs * s_x, Us * s_u, p["px"], p["py"], p["t"], hb, p["d"],
                p["xs"], p["us"])
            A = _dense(torch.mul, Jx, s_x[None, :] / s_x[:, None])
            Bm = _dense(torch.mul, Ju, s_u[None, :] / s_x[:, None])
            return (_dense(torch.div, xf, s_x), A, Bm, qv, _dense(torch.mul, gq, s_z),
                    _dense(torch.mul, Hq, s_z[:, None] * s_z[None, :]))

        return StructuredOCP(**common, stage_dyn_jac=None, sweep=sweep_cf,
                             stage_cf=stage_cf)

    m = cfg.model
    if isinstance(m, LinearModel):
        # no dynamics sweep: JAX takes its fast sweep only for the
        # continuous and discrete forms (JAX riccati.py:604-606), and the
        # solver differentiates this generic map (JAX dyn, :376-389, scaled
        # as dyn_s, :411-414) by torch.func
        def dyn_lin(xa, u, pk):
            uu = _t(su, u) * u
            xn = model.fx((_t(sxa, xa) * xa)[:nx], uu, h, pk["d"], pk["t"], pk["px"])
            if du_coupled:
                xn = torch.cat([xn, uu])
            return xn / _t(sxa, xa)

        return StructuredOCP(**common, stage_dyn_jac=None, dyn=dyn_lin)

    # the dynamics sweep: value and Jacobians of the model's step for all
    # stages in one pass; the augmented u_prev rows have a constant
    # Jacobian structure assembled here (JAX riccati.py:600-679)
    Bd = (np.asarray(cfg.dist.Bd, float)
          if cfg.dist.offree == "lin" and cfg.dist.Bd is not None else None)
    lin_par = cfg.LinPar
    exact = {}
    if isinstance(m, DiscreteModel):
        from mpc_code_tpu_torch.ops.integrators import map_stage_jac

        sweep = map_stage_jac(m.Fx)

        def run_sweep(x, u, p):
            return sweep(x, u, p["px"], p["t"], p["d"])
    else:
        from mpc_code_tpu_torch.ops.integrators import rk4_stage_jac

        _ufx = m.fx

        def _ode(xx, tt, uu, dd, pp):
            return _ufx(xx, uu, dd, tt, pp)

        sweep = rk4_stage_jac(_ode, m.Mx, clip_lo=m.clip_lo, clip_hi=m.clip_hi)

        def run_sweep(x, u, p):
            hb = torch.full((x.shape[0],), h, dtype=x.dtype, device=x.device)
            return sweep(x, u, p["px"], p["t"], hb, p["d"])

        if not du_coupled:
            # the one-interval map the exact Lagrangian Hessian traverses:
            # the model's RK4 on the guarded state, + Bd d, + px (JAX
            # riccati.py:376-390, dyn_s :559-560), the same t at every stage
            def dyn_s(xa, u, pk):
                xn = model.fx(_t(sxa, xa) * xa, _t(su, u) * u, h, pk["d"],
                              pk["t"], pk["px"])
                return xn / _t(sxa, xa)

            def cost_at(xa, u, t, xs, us, d, um1, lam, py, py0):
                return raw_cost(xa, u, dict(t=t, xs=xs, us=us, d=d, um1=um1,
                                            lam=lam, py=py, py0=py0))

            def ineq_at(xa, u, t, xs, us, d, um1, lam, py, py0):
                return raw_ineq(xa, u, dict(t=t, xs=xs, us=us, d=d, um1=um1,
                                            lam=lam, py=py, py0=py0))

            exact = dict(dyn=dyn_s, lowering=StageLowering(
                ode=_ode, Mx=int(m.Mx), h=h, clip_lo=m.clip_lo,
                clip_hi=m.clip_hi, Bd=Bd, lin_par=lin_par, cost=cost_at,
                ineq=ineq_at if ni else None, nx=nx, ny=ny))

    def stage_dyn_jac(Xs, Us, p):
        s_x, s_u = _t(sxa, Xs), _t(su, Us)
        u = Us * s_u
        xf, Jx, Ju = run_sweep((Xs * s_x)[..., :nx], u, p)
        if Bd is not None:
            xf = xf + (p["d"] @ _t(Bd, Xs).T)[:, None]
        if lin_par:
            xf = xf + p["px"]
        if du_coupled:
            xf = torch.cat([xf, u], -1)
            Jx = torch.nn.functional.pad(Jx, (0, nup, 0, nup))
            eye_u = torch.eye(nu, dtype=Us.dtype, device=Us.device)
            Ju = torch.cat([Ju, eye_u.expand(Ju.shape[:2] + (nu, nu))], -2)
        dval = _dense(torch.div, xf, s_x)
        A = _dense(torch.mul, Jx, s_x[None, :] / s_x[:, None])
        Bm = _dense(torch.mul, Ju, s_u[None, :] / s_x[:, None])
        return dval, A, Bm

    return StructuredOCP(**common, stage_dyn_jac=stage_dyn_jac, sweep=sweep, **exact)


def make_stage_derivs(s: StructuredOCP, hessian: str = "exact",
                      skip_dyn: bool = False, skip_cost: bool = False) -> Callable:
    """Per-point derivative sweep ``(z (nz,), pk, lam_k, nu_k) -> (H, gc, A,
    B, E, ival, dval)``, the JAX ``make_stage_derivs`` without the stage
    equalities: the cost's Hessian and gradient (``pk["_sf"]`` scales the
    objective), the dynamics' Jacobians with their value and the
    inequality Jacobian with its value.  ``hessian='exact'`` gives H =
    ∇²(sf·c + lam_k·dyn + nu_k·ineq), ``'gauss_newton'`` H = ∇²(sf·c).
    With ``skip_dyn`` (Gauss-Newton only: the caller gets the dynamics
    from ``s.stage_dyn_jac``) it is ``(z, pk) -> (H, gc, E, ival)``, and
    with ``skip_cost`` as well (the ContForm joint sweep gives H and gc)
    ``(E, ival)``; there E and ival are left out when ``s.ni == 0``.
    Batch it with ``torch.func.vmap`` over (scenario, stage) points."""
    if (skip_dyn or skip_cost) and hessian != "gauss_newton":
        raise ValueError("skip_dyn/skip_cost require hessian='gauss_newton' "
                         "(the exact Lagrangian Hessian traverses the dynamics)")
    if skip_cost and not skip_dyn:
        raise ValueError("skip_cost implies skip_dyn (the ContForm joint "
                         "sweep provides both)")
    if not skip_dyn and s.dyn is None:
        raise _todo("the full stage sweep (and the exact Hessian) for the "
                    "discrete map, ContForm and the u_prev augmentation",
                    "Queue 1 item 21")
    nxa, ni = s.nxa, s.ni
    nz = nxa + s.nu

    def c_of_z(zz, pk):
        return pk["_sf"] * s.cost(zz[:nxa], zz[nxa:], pk)

    def ineq_aux(zz, pk):
        v = s.ineq(zz[:nxa], zz[nxa:], pk)
        return v, v

    if skip_dyn:
        def split_derivs(z, pk):
            out = () if skip_cost else (torch.func.hessian(c_of_z)(z, pk),
                                        grad(c_of_z)(z, pk))
            if ni:
                out += jacfwd(ineq_aux, has_aux=True)(z, pk)
            return out

        return split_derivs

    def dyn_aux(zz, pk):
        v = s.dyn(zz[:nxa], zz[nxa:], pk)
        return v, v

    def L_of_z(zz, pk, lam_k, nu_k):
        # sums of products, not dot products: torch.func's Hessian of a
        # dot product leaves f32 (ROADMAP Queue 3, F4)
        val = c_of_z(zz, pk) + (lam_k * s.dyn(zz[:nxa], zz[nxa:], pk)).sum()
        if ni:
            val = val + (nu_k * s.ineq(zz[:nxa], zz[nxa:], pk)).sum()
        return val

    # reverse over reverse: torch's forward mode runs Python decompositions
    # for every op that mixes a tensor and a Python number, several times
    # slower through the RK4 sub-steps on the CPU (PERF.md, kernel 5)
    def stage_derivs(z, pk, lam_k, nu_k):
        if hessian == "gauss_newton":
            H = jacrev(jacrev(c_of_z))(z, pk)
        else:
            H = jacrev(jacrev(L_of_z))(z, pk, lam_k, nu_k)
        gc = grad(c_of_z)(z, pk)
        Jd, dval = jacrev(dyn_aux, has_aux=True)(z, pk)
        if ni:
            E, ival = jacrev(ineq_aux, has_aux=True)(z, pk)
        else:
            E, ival = z.new_zeros((0, nz)), z.new_zeros(0)
        return H, gc, Jd[:, :nxa], Jd[:, nxa:], E, ival, dval

    return stage_derivs


def _amax0(a):
    """Per-lane max over all trailing dims, with 0 included (jnp ``initial=0``)."""
    flat = a.flatten(1)
    if flat.shape[1] == 0:
        return torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.maximum(flat.amax(1), torch.zeros((), dtype=a.dtype, device=a.device))


def _amax(a):
    return a.flatten(1).amax(1)


def _amin(a):
    return a.flatten(1).amin(1)


def _lane(v, like):
    """(B,) per-lane value broadcast against a (B, ...) tensor."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _nan0(a):
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


def make_structured_solver(s: StructuredOCP, opts: SolverOptions = SolverOptions(),
                           parallel: bool = False) -> Callable:
    """Build ``solve(p, X0, U0, max_iter=None, ws=None) -> StructResult``
    for a batch.

    X0 (B, N+1, nxa), U0 (B, N, nu) warm starts in user units; X0[:, 0] is
    overwritten by the pinned initial state from p.  ``max_iter`` overrides
    ``opts.max_iter`` per call (pass-1 cap and rescue share one solver).
    ``ws`` is the cross-solve dual/barrier warm start of the closed loop: a
    dict with ``zl``, ``zu`` (B, N, nxa+nu+ni), ``lam`` (B, N, nxa), ``nus``
    (B, N, ni), ``mu``, ``sf`` and ``ok`` (B,), the previous step's result
    shifted one stage; a lane with ``ok`` False starts cold."""
    if parallel:
        raise _todo("the associative-scan Riccati (parallel=True)",
                    "Queue 1 item 21")
    if opts.mu_strategy != "monotone":
        raise _todo(f"mu_strategy={opts.mu_strategy!r}", "Queue 1 item 21")
    if opts.ls_mode != "adaptive":
        raise _todo(f"ls_mode={opts.ls_mode!r}", "Queue 1 item 21")
    if opts.hessian not in ("exact", "gauss_newton"):
        raise ValueError(f"unknown hessian {opts.hessian!r}: "
                         "use 'exact' or 'gauss_newton'")
    exact = opts.hessian == "exact"
    if exact and s.dyn is None:
        raise _todo("hessian='exact' for the discrete map, ContForm and the "
                    "u_prev augmentation", "Queue 1 item 21")
    if opts.ls_parallel:
        raise _todo("ls_parallel", "Queue 1 item 21")
    if int(opts.sweep_every) > 1:
        raise _todo("sweep_every > 1", "Queue 1 item 21")
    if opts.dual_init != "zero":
        raise _todo(f"dual_init={opts.dual_init!r}", "Queue 1 item 21")
    if opts.debug:
        raise _todo("debug printing", "Queue 1 item 29")

    N, nxa, nu, ni = s.N, s.nxa, s.nu, s.ni
    nz = nxa + nu
    # The route is chosen here, once, from the OCP's structure.
    # Gauss-Newton: the split sweep, dynamics from their kernel and the
    # cost and rows by torch.func; ContForm's joint sweep also gives the
    # stage cost's value, gradient and Hessian (JAX fast_cf, riccati.py:
    # 1150-1154).  An OCP with neither a sweep kernel nor a lowering (a
    # LinearModel) takes every output from make_stage_derivs vmapped over
    # the B*N points, under either Hessian, as JAX does outside any Pallas
    # kernel (JAX riccati.py:1150-1155, 1396-1398).  Otherwise every output
    # comes from the fused stage sweep, with the iterate's multipliers (JAX
    # riccati.py:1394-1400); the card has no other path for it, so it
    # always launches its kernel there.
    fast_cf = s.stage_cf is not None and not exact
    split = (s.stage_dyn_jac is not None and not exact) or fast_cf
    generic = (s.stage_dyn_jac is None and s.stage_cf is None
               and s.lowering is None and s.dyn is not None)
    fused = None
    v_stage = v_full = None
    if generic:
        v_full = vmap(make_stage_derivs(s, opts.hessian))
    elif not split:
        from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

        fused = make_stage_sweep(s, opts.hessian)
    elif ni or not fast_cf:
        v_stage = vmap(make_stage_derivs(s, "gauss_newton", skip_dyn=True,
                                         skip_cost=fast_cf))

    def _cstage(zz, pk):
        return pk["_sf"] * s.cost(zz[:nxa], zz[nxa:], pk)

    def _cN(xx, pN):
        return pN["_sf"] * s.cost_N(xx, pN)

    v_cost = vmap(_cstage)
    v_grad_c0 = vmap(grad(lambda zz, pk: s.cost(zz[:nxa], zz[nxa:], pk)))
    v_cost_N = vmap(_cN)
    v_grad_N = vmap(grad(_cN))
    v_hess_N = vmap(hessian(_cN))
    v_grad_N0 = vmap(grad(lambda xx, pN: s.cost_N(xx, pN)))
    v_ineq = vmap(lambda zz, pk: s.ineq(zz[:nxa], zz[nxa:], pk)) if ni else None

    def _mdiv(num, den, mask):
        return torch.where(mask, num / torch.where(mask, den, torch.ones_like(den)),
                           torch.zeros_like(num))

    def solve(p, X0, U0, max_iter=None, ws=None) -> StructResult:
        dev = s.device
        X0 = torch.as_tensor(X0, device=dev)
        U0 = torch.as_tensor(U0, device=dev)
        dtype = torch.float64 if U0.dtype == torch.float64 else torch.float32
        X0, U0 = X0.to(dtype), U0.to(dtype)
        Bsz = X0.shape[0]
        L = Bsz * N
        f32 = dtype == torch.float32
        tiny = 1e-30 if f32 else 1e-300
        kw = dict(dtype=dtype, device=dev)
        inf = torch.tensor(float("inf"), **kw)

        def T(a):
            return torch.as_tensor(np.asarray(a, float), **kw)

        p = batch_params(p, Bsz, dtype, dev, s.params.ndim)
        lbx, ubx, lbu, ubu, lbi, ubi = (T(s.lbx), T(s.ubx), T(s.lbu), T(s.ubu),
                                        T(s.lbi), T(s.ubi))
        INF = 1e18
        hlx, hux, hlu, huu, hli, hui = (lbx > -INF, ubx < INF, lbu > -INF,
                                        ubu < INF, lbi > -INF, ubi < INF)
        lbz = torch.cat([lbx, lbu, lbi])
        ubz = torch.cat([ubx, ubu, ubi])
        hlz, huz = lbz > -INF, ubz < INF
        eye_nz = torch.eye(nz, **kw)
        eye_x = torch.eye(nxa, **kw)

        def mkZ(X_, U_, S_):
            return torch.cat([X_[:, 1:], U_, S_], dim=-1)

        x0a = s.x0_of_p(p)
        mu0 = torch.full((Bsz,), opts.mu_init, **kw)
        sxa_t, su_t = T(s.sxa), T(s.su)

        def push(z, lb, ub, hl, hu):
            pl = torch.minimum(1e-2 * torch.clamp(lb.abs(), min=1.0),
                               1e-2 * torch.where(hu, ub - lb, inf))
            pu = torch.minimum(1e-2 * torch.clamp(ub.abs(), min=1.0),
                               1e-2 * torch.where(hl, ub - lb, inf))
            zlo = torch.where(hl, lb + pl, -inf)
            zhi = torch.where(hu, ub - pu, inf)
            return torch.minimum(torch.maximum(z, zlo), zhi)

        # warm starts arrive in user units; work internally in scaled units
        X_init = _nan0(X0) / sxa_t
        X_init = torch.cat([x0a[:, None], push(X_init[:, 1:], lbx, ubx, hlx, hux)],
                           dim=1)
        U_init = push(_nan0(U0) / su_t, lbu, ubu, hlu, huu)

        # gradient-based objective scaling (IPOPT gmax=100 analog)
        pk = s.params.stage(p, N)
        pN = s.params.terminal(p)
        Zs0 = torch.cat([X_init[:, :N], U_init], dim=-1).reshape(L, nz)
        g0 = v_grad_c0(Zs0, pk)
        gN0 = v_grad_N0(X_init[:, N], pN)
        gmax0 = torch.maximum(_amax0(g0.reshape(Bsz, -1).abs()), _amax0(gN0.abs()))
        sf = torch.clamp(100.0 / torch.clamp(gmax0, min=1e-8), max=1.0)
        p["_sf"] = sf
        pk["_sf"] = sf.repeat_interleave(N)
        pN["_sf"] = sf

        S_init = (push(v_ineq(Zs0, pk).reshape(Bsz, N, ni), lbi, ubi, hli, hui)
                  if ni else torch.zeros((Bsz, N, 0), **kw))

        def dual_init(z, lb, ub, hl, hu):
            m0 = _lane(mu0, z)
            one = torch.ones_like(z)
            zl = torch.where(hl, torch.clamp(m0 / torch.where(hl, z - lb, one),
                                             1e-8, 1e8), 0.0)
            zu = torch.where(hu, torch.clamp(m0 / torch.where(hu, ub - z, one),
                                             1e-8, 1e8), 0.0)
            return zl, zu

        zl0, zu0 = dual_init(mkZ(X_init, U_init, S_init), lbz, ubz, hlz, huz)
        lam0 = torch.zeros((Bsz, N, nxa), **kw)
        nus0 = torch.zeros((Bsz, N, ni), **kw)
        if ws is not None:
            # cross-solve dual/barrier warm start (the closed loop's regime,
            # JAX riccati.py:1296-1330).  The carried duals are in the
            # previous solve's objective scaling: rescale by sf_new/sf_old
            # (stationarity and complementarity both scale linearly with
            # sf).  ws["ok"] gates each lane (False -> the cold init above)
            ws_ok = torch.as_tensor(ws["ok"], device=dev).to(torch.bool).expand(Bsz)
            rs = sf / torch.clamp(torch.as_tensor(ws["sf"], **kw), min=1e-12)

            def carried(v):
                v = torch.as_tensor(v, **kw)
                return _nan0(v * _lane(rs, v))

            def gate(new, old):
                return torch.where(_lane(ws_ok, old), new, old)

            zl0 = gate(torch.where(hlz, torch.clamp(carried(ws["zl"]), 1e-8, 1e8), 0.0), zl0)
            zu0 = gate(torch.where(huz, torch.clamp(carried(ws["zu"]), 1e-8, 1e8), 0.0), zu0)
            lam0 = gate(carried(ws["lam"]), lam0)
            if ni:
                nus0 = gate(carried(ws["nus"]), nus0)
            # the carried barrier is floored at max(tol/10, 1e-6): a converged
            # tight-tol solve leaves mu ~ tol/10, and the monotone strategy
            # can only decrease it, so starting the next, shifted problem
            # that low strands the iterate off the central path; capped at
            # mu_init
            mu_w = torch.clamp(torch.as_tensor(ws["mu"], **kw) * rs,
                               max(opts.tol / 10.0, 1e-6), opts.mu_init)
            mu0 = torch.where(ws_ok, mu_w, mu0)
        full = lambda v: torch.full((Bsz,), v, **kw)  # noqa: E731
        st = dict(
            X=X_init, U=U_init, S=S_init, lam=lam0, nus=nus0,
            zl=zl0, zu=zu0, mu=mu0, nu_pen=full(1.0), delta=full(0.0),
            it=torch.zeros(Bsz, dtype=torch.int32, device=dev),
            done=torch.zeros(Bsz, dtype=torch.bool, device=dev),
            kkt0=full(float("inf")), feas=full(float("inf")),
            psi_prev=full(float("inf")), acap=full(1.0),
            bX=X_init, bU=U_init, bS=S_init,
            bkkt=full(float("inf")), bfeas=full(float("inf")),
        )

        def total_cost(X, U):
            Zs = torch.cat([X[:, :N], U], dim=-1).reshape(L, nz)
            return v_cost(Zs, pk).reshape(Bsz, N).sum(1) + v_cost_N(X[:, N], pN)

        def bar_of(Z):
            one = torch.ones_like(Z)
            tl = torch.where(hlz, torch.log(torch.clamp(torch.where(hlz, Z - lbz, one),
                                                        min=tiny)), 0.0)
            tu = torch.where(huz, torch.log(torch.clamp(torch.where(huz, ubz - Z, one),
                                                        min=tiny)), 0.0)
            return tl.flatten(1).sum(1) + tu.flatten(1).sum(1)

        def sweep(st):
            """H, gc, A, Bm, E, ival, dval at the iterate, and qv, the
            ContForm quadrature there (None otherwise)."""
            X, U = st["X"], st["U"]
            if fused is not None:
                return fused(*fused.inputs(X[:, :N], U, p, st["lam"], st["nus"])) + (None,)
            Zs = torch.cat([X[:, :N], U], dim=-1).reshape(L, nz)
            if v_full is not None:
                out = v_full(Zs, pk, st["lam"].reshape(L, nxa), st["nus"].reshape(L, ni))
                # A and B are column blocks of one Jacobian: copied out, as
                # the Riccati kernel reads contiguous (B, N, ...) tensors (F11)
                shapes = ((nz, nz), (nz,), (nxa, nxa), (nxa, nu), (ni, nz), (ni,), (nxa,))
                return tuple(o.reshape((Bsz, N) + sh).contiguous()
                             for o, sh in zip(out, shapes)) + (None,)
            derivs = v_stage(Zs, pk) if v_stage is not None else ()
            qv = None
            if fast_cf:
                dval, A, Bm, qv, gq, Hq = s.stage_cf(X[:, :N], U, p)
                H, gc = sf[:, None, None, None] * Hq, sf[:, None, None] * gq
            else:
                H, gc = derivs[0].reshape(Bsz, N, nz, nz), derivs[1].reshape(Bsz, N, nz)
                derivs = derivs[2:]
                dval, A, Bm = s.stage_dyn_jac(X[:, :N], U, p)
            if ni:
                E, ival = derivs[0].reshape(Bsz, N, ni, nz), derivs[1].reshape(Bsz, N, ni)
            else:
                E, ival = torch.zeros((Bsz, N, 0, nz), **kw), torch.zeros((Bsz, N, 0), **kw)
            return H, gc, A, Bm, E, ival, dval, qv

        def ipm_step(st, H, gc, A, Bm, E, ival, dval, qv):
            X, U, S = st["X"], st["U"], st["S"]
            lam, nus, zl, zu = st["lam"], st["nus"], st["zl"], st["zu"]
            mu_c = st["mu"]
            Z = mkZ(X, U, S)
            r_d = dval - X[:, 1:]
            r_i = ival - S

            # KKT errors at the current point from the stage data
            AtL = torch.einsum("bkai,bka->bki", A, lam)
            BtL = torch.einsum("bkai,bka->bki", Bm, lam)
            EtZ = torch.einsum("bkia,bki->bka", E, nus)
            gx_full = gc[..., :nxa] + AtL + EtZ[..., :nxa]
            gu_full = gc[..., nxa:] + BtL + EtZ[..., nxa:]
            gradN = v_grad_N(X[:, N], pN)
            rx = torch.cat([gx_full[:, 1:] - lam[:, :N - 1],
                            (gradN - lam[:, N - 1])[:, None]], dim=1)
            stat_z = torch.cat([rx, gu_full, -nus], dim=-1) - (zl - zu)

            cl_c = (Z - lbz) * zl
            cu_c = (ubz - Z) * zu
            cmax_all = torch.maximum(_amax(torch.where(hlz, cl_c, -inf)),
                                     _amax(torch.where(huz, cu_c, -inf)))
            cmin_all = torch.minimum(_amin(torch.where(hlz, cl_c, inf)),
                                     _amin(torch.where(huz, cu_c, inf)))
            e_stat = _amax0(stat_z.abs())
            e_stat = torch.where(torch.isnan(e_stat), inf, e_stat)
            e_feas = torch.maximum(_amax0(r_d.abs()), _amax0(r_i.abs()))
            e_feas = torch.where(torch.isnan(e_feas), inf, e_feas)
            scale = torch.clamp((lam.abs().flatten(1).sum(1)
                                 + nus.abs().flatten(1).sum(1)
                                 + (zl + zu).flatten(1).sum(1))
                                / (N * (nz + ni) + nxa + 1.0), min=100.0) / 100.0

            def kkt_at(mu_v):
                e_comp = torch.clamp(torch.maximum(cmax_all - mu_v, mu_v - cmin_all),
                                     min=0.0)
                e = torch.maximum(e_stat / scale,
                                  torch.maximum(e_feas, e_comp / scale))
                return torch.where(torch.isnan(e), inf, e)

            e_mu = kkt_at(mu_c)
            e_0 = kkt_at(torch.zeros_like(mu_c))
            feas = e_feas
            done_now = e_0 <= opts.tol
            if opts.track_best:
                better = e_0 < st["bkkt"]
                bX_n = torch.where(_lane(better, X), X, st["bX"])
                bU_n = torch.where(_lane(better, U), U, st["bU"])
                bS_n = torch.where(_lane(better, S), S, st["bS"])
                bkkt_n = torch.where(better, e_0, st["bkkt"])
                bfeas_n = torch.where(better, feas, st["bfeas"])
            else:
                bX_n, bU_n, bS_n = st["bX"], st["bU"], st["bS"]
                bkkt_n, bfeas_n = st["bkkt"], st["bfeas"]
            mu = torch.where(e_mu <= _KAPPA_EPS * mu_c,
                             torch.clamp(torch.minimum(_KAPPA_MU * mu_c,
                                                       mu_c ** _THETA_MU),
                                         min=opts.tol / 10.0),
                             mu_c)
            mu_z = _lane(mu, Z)

            # barrier sigmas and gradient on the merged Z layout
            sigZ = _mdiv(zl, Z - lbz, hlz) + _mdiv(zu, ubz - Z, huz)
            sigX_stage = torch.cat([torch.zeros((Bsz, 1, nxa), **kw),
                                    sigZ[:, :N - 1, :nxa]], dim=1)
            sigX_term = sigZ[:, N - 1, :nxa]
            sigU = sigZ[..., nxa:nxa + nu]
            sigS = torch.clamp(sigZ[..., nxa + nu:], min=1e-12)

            Hs = _dense(torch.add, H, torch.einsum("bkia,bki,bkic->bkac", E, sigS, E))
            Hs = Hs + eye_nz * torch.cat([sigX_stage, sigU], dim=-1)[:, :, None, :]
            PN_h = _dense(torch.add, v_hess_N(X[:, N], pN), torch.diag_embed(sigX_term))
            pN_cost = gradN
            Hs = Hs + st["delta"][:, None, None, None] * eye_nz
            PN_h = PN_h + st["delta"][:, None, None] * eye_x

            one = torch.ones_like(Z)
            bgZ = _mdiv(mu_z * one, Z - lbz, hlz) - _mdiv(mu_z * one, ubz - Z, huz)
            bgS = bgZ[..., nxa + nu:]

            # one KKT solve
            g_extra = torch.einsum("bkia,bki->bka", E, sigS * r_i - bgS)
            bg_q = torch.cat([torch.cat([torch.zeros((Bsz, 1, nxa), **kw),
                                         bgZ[:, :N - 1, :nxa]], dim=1),
                              bgZ[..., nxa:nxa + nu]], dim=-1)
            q = gc + g_extra - bg_q
            pN_g = pN_cost - bgZ[:, N - 1, :nxa]
            solvable, Ks, kf, P_seq, p_seq, dX, dU = riccati_kkt(
                Hs, q, A, Bm, r_d, PN_h, pN_g, torch.zeros(Bsz, **kw),
                nxa=nxa, nu=nu)
            dX, dU = _nan0(dX), _nan0(dU)
            dS = torch.einsum("bkia,bka->bki", E,
                              torch.cat([dX[:, :N], dU], dim=-1)) + r_i
            dnu = _nan0(sigS * dS - (nus + bgS))
            lam_new = _nan0(torch.einsum("bkij,bkj->bki", P_seq, dX[:, 1:]) + p_seq)
            lam_new = torch.where(_lane(solvable, lam_new), lam_new, lam)
            dlam = lam_new - lam

            # fraction to boundary + adaptive step controller
            tau = torch.clamp(1.0 - mu, min=_TAU_MIN)
            tau_z = _lane(tau, Z)
            dZ = torch.cat([dX[:, 1:], dU, dS], dim=-1)
            neg, pos = dZ < 0, dZ > 0
            al = torch.where(hlz & neg, -tau_z * (Z - lbz)
                             / torch.where(neg, dZ, -one), inf)
            au = torch.where(huz & pos, tau_z * (ubz - Z)
                             / torch.where(pos, dZ, one), inf)
            alpha_max = torch.clamp(torch.minimum(_amin(al), _amin(au)), max=1.0)

            dzl = torch.where(hlz, -zl + _mdiv(mu_z * one - zl * dZ, Z - lbz, hlz), 0.0)
            dzu = torch.where(huz, -zu + _mdiv(mu_z * one + zu * dZ, ubz - Z, huz), 0.0)

            def ftb_dual(zv, dzv):
                n_ = dzv < 0
                return torch.where(n_, -tau_z * zv / torch.where(n_, dzv, -one), inf)

            ad = torch.clamp(torch.minimum(_amin(ftb_dual(zl, dzl)),
                                           _amin(ftb_dual(zu, dzu))), max=1.0)

            c_norm = r_d.abs().flatten(1).sum(1) + r_i.abs().flatten(1).sum(1)
            lam_inf = torch.maximum(_amax0(lam_new.abs()), _amax0((nus + dnu).abs()))
            nu_pen = torch.maximum(1.5 * lam_inf + 1e-4, 0.5 * st["nu_pen"])
            if qv is not None:
                # the ContForm sweep already integrated the stage quadrature
                # at this point: no second cost rollout (JAX riccati.py:1883-1888)
                cost0 = sf * qv.sum(1) + v_cost_N(X[:, N], pN)
            else:
                cost0 = total_cost(X, U)
            psi0 = cost0 - mu * bar_of(Z) + nu_pen * c_norm
            slack_tol = 10.0 * torch.finfo(dtype).eps * (psi0.abs() + 1.0)
            psi0_c = torch.where(torch.isnan(psi0), inf, psi0)
            increased = (~torch.isfinite(psi0_c)) | (psi0_c > st["psi_prev"] + slack_tol)
            acap_n = torch.where(increased,
                                 torch.clamp(st["acap"] * 0.25, min=0.5 ** _MAX_BACKTRACK),
                                 torch.ones_like(psi0))
            alpha = torch.where(solvable, alpha_max * acap_n, torch.zeros_like(psi0))
            delta = st["delta"]
            delta_n = torch.where(solvable,
                                  torch.clamp(delta / 2.0, min=0.0) * (delta > 1e-9),
                                  torch.clamp(delta * 10.0, min=1e-5))

            a_x = _lane(alpha, X)
            X_n = torch.cat([X[:, :1], X[:, 1:] + a_x * dX[:, 1:]], dim=1)
            U_n = U + a_x * dU
            S_n = S + a_x * dS
            Z_n = Z + a_x * dZ
            ks_sig = 1e6 if f32 else 1e10
            gl_n = torch.clamp(torch.where(hlz, Z_n - lbz, one), min=tiny)
            gu_n = torch.clamp(torch.where(huz, ubz - Z_n, one), min=tiny)
            ad_z = _lane(ad, Z)
            zl_n = torch.where(hlz, torch.minimum(torch.maximum(
                zl + ad_z * dzl, mu_z / (ks_sig * gl_n)), ks_sig * mu_z / gl_n), 0.0)
            zu_n = torch.where(huz, torch.minimum(torch.maximum(
                zu + ad_z * dzu, mu_z / (ks_sig * gu_n)), ks_sig * mu_z / gu_n), 0.0)

            new = dict(X=X_n, U=U_n, S=S_n, lam=lam + a_x * dlam,
                       nus=nus + a_x * dnu, zl=zl_n, zu=zu_n, mu=mu,
                       nu_pen=nu_pen, delta=delta_n, it=st["it"] + 1,
                       done=torch.zeros_like(st["done"]), kkt0=e_0, feas=feas,
                       psi_prev=psi0_c, acap=acap_n,
                       bX=bX_n, bU=bU_n, bS=bS_n, bkkt=bkkt_n, bfeas=bfeas_n)
            # a lane that converged at this point keeps its iterate
            stay = dict(st, done=torch.ones_like(st["done"]), kkt0=e_0, feas=feas,
                        bX=bX_n, bU=bU_n, bS=bS_n, bkkt=bkkt_n, bfeas=bfeas_n)
            return {k: torch.where(_lane(done_now, new[k]), stay[k], new[k])
                    for k in new}

        it_cap = opts.max_iter if max_iter is None else int(max_iter)
        while True:
            active = (~st["done"]) & (st["it"] < it_cap)
            if not bool(active.any()):       # one host sync per iteration
                break
            cand = ipm_step(st, *sweep(st))
            st = {k: torch.where(_lane(active, v), cand[k], v)
                  for k, v in st.items()}

        # fall back to the best-KKT iterate only when the final one is
        # materially worse (10x margin)
        if opts.track_best:
            use_best = st["bkkt"] < 0.1 * st["kkt0"]
        else:
            use_best = torch.zeros_like(st["done"])
        X_fin = torch.where(_lane(use_best, st["X"]), st["bX"], st["X"])
        U_fin = torch.where(_lane(use_best, st["U"]), st["bU"], st["U"])
        kkt_fin = torch.where(use_best, st["bkkt"], st["kkt0"])
        feas_fin = torch.where(use_best, st["bfeas"], st["feas"])
        status = torch.where(
            kkt_fin <= opts.tol, STATUS_SOLVED,
            torch.where(feas_fin <= opts.constr_viol_tol, STATUS_ACCEPTABLE,
                        STATUS_INFEASIBLE)).to(torch.int32)
        pk1 = dict(pk, _sf=torch.ones(L, **kw))
        pN1 = dict(pN, _sf=torch.ones(Bsz, **kw))
        Zf = torch.cat([X_fin[:, :N], U_fin], dim=-1).reshape(L, nz)
        f_val = v_cost(Zf, pk1).reshape(Bsz, N).sum(1) + v_cost_N(X_fin[:, N], pN1)
        return StructResult(X=X_fin * sxa_t, U=U_fin * su_t, f=f_val,
                            status=status, iters=st["it"], kkt_err=kkt_fin,
                            feas_err=feas_fin, zl=st["zl"], zu=st["zu"],
                            lam=st["lam"], nus=st["nus"], mu=st["mu"], sf=sf)

    return solve
