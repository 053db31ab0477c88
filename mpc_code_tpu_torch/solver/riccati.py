"""Structure-exploiting interior-point solver for the stagewise OCPs.

Port of ``mpc_code_tpu/solver/riccati.py`` for five transcriptions:
plain continuous shooting (the batched CSTR NMPC bench), discrete-map
shooting (the quadruple tank, Ex_NMPC_dis), linear-model shooting (the
LMPC examples), the ContForm economic transcription (Ex_ENMPC) and
Gauss-Legendre collocation, condensed exactly within each stage; each
with or without output bounds, soft output bounds (the shared slacks,
with ``slacksG`` and ``slacksH``), user stage inequalities (``G_ineq``)
and equalities (``H_eq``) and the terminal equality (``TermCons``), the
shooting forms also with the u_prev state augmentation that Delta-u
bounds and Delta-u costs (``DUForm``, ``DUFormEcon``) need.  Every
option of JAX's solver is here: the exact Lagrangian Hessian (the
default of ``SolverOptions``) on every transcription and the
Gauss-Newton one; the monotone, 'adaptive' (LOQO centrality) and
'mehrotra' (predictor-corrector) barriers; the rollout-free adaptive
step controller (``ls_mode='adaptive'``) and Armijo backtracking on the
merit, its trials one at a time or all in one batched rollout
(``ls_parallel``); stale-derivative sub-steps (``sweep_every``); zero or
costate initial defect multipliers (``dual_init``); the associative-scan
Riccati (``parallel=True``, ``riccati_parallel``); best-iterate
bookkeeping and the closed loop's cross-solve dual/barrier warm start
(``solve(..., ws=)``: the previous step's multipliers and barrier, shifted
one stage and rescaled to the new objective scaling), and the debug
printing.  What JAX refuses raises JAX's ``ValueError``.

Layout.  The JAX solver is written for one lane and batched with ``vmap``;
here every solver function takes an explicit leading batch dimension B.
The user's model and cost callables still act on one point, so the stage
functions of ``StructuredOCP`` take one (state, input, stage-parameter)
point and their derivatives come from ``torch.func`` (``grad``,
``hessian``, ``jacrev``) vmapped over the B*N (scenario,
stage) points.

Per iteration the solver runs two hand-written CUDA kernels on the card:
a derivative sweep, either the RK4 stage-Jacobian sweep
(``ops/sweep_cuda.py``) or, for a discrete model, the map's stage-Jacobian
sweep (``ops/sweep_map_cuda.py``), both through
``StructuredOCP.stage_dyn_jac``, or, for a ContForm OCP, the joint
dynamics-and-quadrature sweep (``ops/sweep_cf_cuda.py``, through
``StructuredOCP.stage_cf``, which also gives the stage cost's value,
gradient and Hessian), or the fused generic stage-derivative sweep
(``solver/sweep_kernel.py``: every output of ``make_stage_derivs`` in one
pass) wherever JAX's fast sweep is off: under the exact Hessian on every
form, and under either Hessian on the forms without a split sweep (a
``LinearModel``, whose affine step it lowers as a map, a collocated OCP,
ContForm with slacks, the MHE's window); and the Riccati KKT solve
(``solver/riccati_kernel.py``).  Every form ``build_structured_ocp``
builds has the fused sweep's lowering (``StageLowering``), with the
shared slacks and the user rows (G_ineq, H_eq), and so has the MHE's
window (``ocp/mhe.py::WindowLowering``); the solver refuses an OCP with
neither a split sweep nor a lowering.  With TermCons
or H_eq the KKT solve is the bordered recursion ``riccati_bordered``,
and under ``parallel=True`` the associative scan ``riccati_parallel``,
both in plain PyTorch as JAX has no Pallas kernel for them.  The line
search's trial points, the stale-derivative sub-steps' values and the
costate recursion's Jacobian (where the OCP has no ``stage_dyn_jac``)
come from the generic map ``dyn``, as in JAX.  The rest is IPM algebra on
whole tensors.

Under Gauss-Newton an OCP that has both a dynamics sweep and a lowering
(the continuous or the discrete map) can take its stage derivatives by
either route: ``"split"`` (the dynamics sweep plus the cost and rows by
``torch.func``, the default) or ``"fused"`` (the fused stage sweep's
Gauss-Newton build).  ``make_structured_solver(..., impl=)`` picks one;
``build_structured_ocp(..., batch_hint=B)`` under
``MPC_TPU_SWEEP_AUTOTUNE=1`` times both at B lanes and records the faster
as the OCP's ``sweep_impl`` (``ops/sweep_autotune.py``).
``SolverOptions.debug`` prints JAX's per-iteration line for every lane.

The JAX ``lax.while_loop`` under ``vmap`` runs until every lane is done and
freezes each lane as soon as its own condition ``(~done) & (it < cap)`` is
false; the masked loop here does the same, so per-lane ``iters`` and
``status`` match.  Deciding whether any lane is still active costs one
host synchronisation per pass (and backtracking one more per trip of its
search, at most 12 a pass).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacrev, vmap

from mpc_code_tpu_torch.config import (
    DiscreteModel, LinearModel, MPCConfig, SolverOptions,
)
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.ops.smalllin import cho_solve, chol, solve_lu
from mpc_code_tpu_torch.solver.nlp import (
    STATUS_ACCEPTABLE, STATUS_INFEASIBLE, STATUS_SOLVED, debug_lines,
)
from mpc_code_tpu_torch.solver.riccati_kernel import riccati_kkt

_TAU_MIN = 0.99
_ETA_LS = 1e-4
# the backtracking ladder alpha_j = alpha_max 0.5^e(j), e(j) = j + max(j - 4,
# 0): halving for the first _LS_FINE trials, then quartering, down to the
# floor exponent _MAX_BACKTRACK in _LS_TRIPS trials (JAX riccati.py:56-74)
_MAX_BACKTRACK = 20
_LS_FINE = 4
_LS_TRIPS = 12
_KAPPA_EPS = 10.0
_KAPPA_MU = 0.2
_THETA_MU = 1.5


def _ls_exp(j: int) -> int:
    """The ladder's exponent e(j)."""
    return j + max(j - _LS_FINE, 0)


# per-lane rank of each entry of the parameter dict p
PARAM_NDIM = {"x0": 1, "xs": 1, "us": 1, "d": 1, "um1": 1, "t": 0,
              "lam": 2, "px": 2, "py": 2}


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
    per-lane data, ``px``/``py`` of that stage, ``py0`` and ``px0``
    (stage 0's) and ``k0``, whether the point is stage 0 (the JAX stage
    functions' ``k == 0``)."""
    Bsz = p["xs"].shape[0]

    def rep(v):
        return v.unsqueeze(1).expand((Bsz, N) + tuple(v.shape[1:])).reshape(
            (Bsz * N,) + tuple(v.shape[1:]))

    pk = {k: rep(p[k]) for k in ("xs", "us", "d", "um1", "t", "lam")}
    pk["px"] = p["px"].reshape(Bsz * N, -1)
    pk["py"] = p["py"].reshape(Bsz * N, -1)
    pk["py0"] = rep(p["py"][:, 0])
    pk["px0"] = rep(p["px"][:, 0])
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
    ``(xa, u, pk) -> xa_next`` (with the u_prev and slack rows), on every
    route: the exact Lagrangian Hessian traverses it by ``torch.func``, as
    JAX does, and the line search, the stale sub-steps and the costate
    recursion evaluate it.  ``lowering`` is what the fused stage sweep's
    code generator needs, given for every form ``build_structured_ocp``
    builds.  A ``LinearModel``, a collocated OCP and a ContForm OCP with
    slacks have no split sweep.  ``ns``
    shared slacks ride the tails of xa and u (``nu_ctrl``
    inputs before them); ``n_tc`` terminal equality rows hold x_N[:n_tc]
    at ``tc_target(p)`` (B, n_tc); ``eq`` gives the ``n_eq`` stage
    equality rows on one point.
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
    ns: int = 0                  # shared slacks folded into the xa and u tails
    nu_ctrl: int = 0             # the true inputs (nu less the slack slots)
    n_tc: int = 0                # terminal equality rows (TermCons: nx)
    tc_target: Optional[Callable] = None   # p -> (B, n_tc) scaled x_N target
    n_eq: int = 0                # user stage equality rows (H_eq)
    eq: Optional[Callable] = None          # (xa, u, pk) -> (n_eq,) h rows
    sweep_impl: str = "split"    # Gauss-Newton stage derivatives: "split" | "fused"


# the per-point parameters of the lowered stage cost and rows, in order;
# after them "px" where user rows read it, "s_coll" (the collocation stage
# states) and "k0" (the stage-0 flag: Delta-u reads the parameter um1 there
# and the carried slots after it; the slacks are the input slots there)
POINT_ARGS = ("t", "xs", "us", "d", "um1", "lam", "py", "py0")


class StageLowering(NamedTuple):
    """The raw (unscaled) stage functions of an OCP in the form the fused
    stage sweep (``solver/sweep_kernel.py``) lowers to CUDA.  ``kind``
    names the one-interval step:

    - ``"rk4"``: ``Mx`` RK4 sub-steps of the user ODE ``ode(x, t, u, d,
      px)`` on the guarded state (``clip_lo``, ``clip_hi``), then ``+ Bd
      d`` (``Bd`` None unless offree='lin') and ``+ px`` under LinPar;
    - ``"map"``: the discrete map ``fmap(x, u, d, t, px)``, then the same
      terms: the user's map of a ``DiscreteModel``, or a ``LinearModel``'s
      affine step with its own ``Bd d`` and ``px`` (``Bd`` None, ``lin_par``
      False);
    - ``"cf"``: ContForm, ``Mx`` RK4 sub-steps of ``ode(x, t, u, d, px,
      xs, us, py)`` together with the quadrature ``quad(...)`` of the stage
      cost, which is the stage cost (``cost`` is then the slack penalty, or
      None);
    - ``"coll"``: the 2-point Gauss-Legendre collocation step of the raw
      ODE ``ode(x, t, u, d, px)`` (no guard), ``n_newton`` Newton steps on
      values and one differentiable step; px is stage 0's unless
      ``stagewise_px``.  The stage states S reach the cost and the rows as
      the point argument ``"s_coll"``.

    The stage cost and the inequality (``ineq``) and equality (``eq``)
    rows are ``f(xa, u, *point_args)``.  ``nup`` is the width of the
    u_prev augmentation (0 or nu): the state's tail carries u_{k-1}, the
    map copies u into it (B's identity block, scaled by su / sxa), and the
    cost and rows read it through ``point_args``' ``k0``.  ``ns`` shared
    slacks follow in the state and in the input: the map writes the input
    slots at stage 0 and carries the state's after it.  ``eq`` has
    ``n_eq`` rows."""
    ode: Optional[Callable]
    Mx: int
    h: float
    clip_lo: Optional[np.ndarray]
    clip_hi: Optional[np.ndarray]
    Bd: Optional[np.ndarray]
    lin_par: bool
    cost: Optional[Callable]
    ineq: Optional[Callable]
    nx: int
    ny: int
    kind: str = "rk4"
    fmap: Optional[Callable] = None
    quad: Optional[Callable] = None
    nup: int = 0
    point_args: tuple = POINT_ARGS
    ns: int = 0
    eq: Optional[Callable] = None
    n_eq: int = 0
    n_newton: int = 0
    stagewise_px: bool = False


def _point_fn(raw, names):
    """``raw(xa, u, pk)`` as a function of ``(xa, u, *names)``, ``pk`` the
    dict of those names: the signature the code generator traces."""
    args = ", ".join(names)
    fields = ", ".join(f"{n}={n}" for n in names)
    scope = {}
    exec(f"def bind(raw):\n    def at(xa, u, {args}):\n"
         f"        return raw(xa, u, dict({fields}))\n    return at\n", scope)
    return scope["bind"](raw)


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
                         device=None, stagewise_px: bool = False,
                         n_colloc_newton: int = 8,
                         batch_hint: Optional[int] = None) -> StructuredOCP:
    """Map the reference OCP (opt_dyn / opt_dyn_CM form) onto the stagewise
    structure.

    Uses the parameter dict {x0, xs, us, d, um1, t, lam, px (N,npx),
    py (N,npy)}.  Runs on ``device`` (default ``cuda``).

    ``batch_hint``: the batch the solver built from this OCP will run.
    With ``MPC_TPU_SWEEP_AUTOTUNE=1`` and a hint, the Gauss-Newton stage
    derivatives' two routes are timed on this OCP at that batch (cached,
    ``ops/sweep_autotune.py``) and the faster becomes ``sweep_impl`` (JAX
    riccati.py:617-631).

    Collocation (opt_dyn_CM, Control_Calc.py:264-567) is condensed exactly
    within each stage: the 2-point Gauss-Legendre stage states S = [s1; s2]
    solve the collocation equations 1/h D (S - x) = f(S, u) by
    ``n_colloc_newton`` Newton steps on detached values, then one
    differentiable Newton step around that root gives the derivatives of
    the implicit function (JAX riccati.py:335-374).  The reference's
    stage-0 px freeze (Control_Calc.py:473-474) is kept; ``stagewise_px``
    gives the corrected form.  The state box on s1, s2 becomes ``2 nx``
    inequality rows on the condensed S(x, u).

    Shared output slacks (Control_Calc.py:187, 217, 232-239): one slack
    vector Sl >= 0 for the whole horizon, with the penalty N Sl' Ws Sl, is
    folded into the stage structure as extra input slots that decide it at
    stage 0 and extra state slots that carry it after (JAX riccati.py:
    256-300): ``nxa = nx (+ nu) + ns``, ``nu = nu + ns``.  ``slacksG`` and
    ``slacksH`` extend Sl over the user rows.  ``TermCons`` is the terminal
    equality of ``n_tc`` rows at ``tc_target(p)``; ``H_eq`` the ``n_eq``
    stage equalities ``eq``."""
    from mpc_code_tpu_torch.ocp.shooting import _user_constraint_dim

    dev = resolve_device(device)
    b = cfg.bounds
    cont_form = cfg.ContForm
    ng_user = _user_constraint_dim(cfg.G_ineq, cfg)
    nh_user = _user_constraint_dim(cfg.H_eq, cfg)
    ymin = b.resolved("dyn", "ymin")
    ymax = b.resolved("dyn", "ymax")
    y_free = ymin is None and ymax is None
    nx, nu, ny, N = cfg.nx, cfg.nu, cfg.ny, cfg.N
    # the state is augmented with u_{k-1} whenever Delta-u appears in the
    # bounds or in the cost; ContForm ignores Delta-u rows and the discrete
    # cost forms, as in the reference (JAX riccati.py:238-249)
    du_bounds = not cont_form and not (b.Dumin is None and b.Dumax is None)
    du_coupled = not cont_form and (du_bounds or cfg.DUForm or cfg.DUFormEcon)
    nup = nu if du_coupled else 0
    # one shared slack pair relaxes the output bounds; slacksG and slacksH
    # extend it over the user rows (Control_Calc.py:133-143)
    slacks = bool(cfg.slacks) and not y_free
    slacks_g = slacks and bool(cfg.slacksG) and ng_user > 0
    slacks_h = slacks and bool(cfg.slacksH) and nh_user > 0
    ns = ((2 * ny + (ng_user if slacks_g else 0) + (nh_user if slacks_h else 0))
          if slacks else 0)
    if slacks and cfg.Ws is None:
        raise ValueError("slacks=True requires Ws")
    # an f64 CPU tensor cast at call time, as the model's matrices are
    # (what torch.fx records for the code generator: a constant matrix)
    Ws_t = torch.as_tensor(np.asarray(cfg.Ws, float)[:ns, :ns]) if slacks else None
    sl_h_off = 2 * ny + (ng_user if slacks_g else 0)
    # ContForm wins over Collocation: the reference's ContForm branch never
    # emits the collocation equations (Control_Calc.py:428-436)
    colloc = bool(cfg.Collocation) and not cont_form
    xmin = b.resolved("dyn", "xmin")
    xmax = b.resolved("dyn", "xmax")
    umin = b.resolved("dyn", "umin")
    umax = b.resolved("dyn", "umax")
    ni_coll = 2 * nx if colloc and (xmin is not None or xmax is not None) else 0
    nxa = nx + nup + ns
    nu_eff = nu + ns
    ni = ((0 if y_free else (2 * ny if slacks else ny)) + (nu if du_bounds else 0)
          + ng_user + ni_coll)
    h = float(cfg.h)
    qform = cfg.QForm

    def split(xa, ua):
        """(x, u): the model's state and input of the augmented pair."""
        return xa[:nx], ua[:nu]

    def slack_of(xa, ua, pk):
        """The shared slack: the input slots at stage 0, the carried state
        slots after it."""
        return torch.where(pk["k0"], ua[nu:], xa[nx + nup:])

    def y_of(x, u, pk):
        return model.fy(x, u, pk["d"], pk["t"], pk["py"]) + pk["lam"] @ (u - pk["us"])

    def um1_of(xa, pk):
        """u_{k-1}: the parameter at stage 0, the carried slot after it
        (JAX riccati.py:405, 454)."""
        if not du_coupled:
            return pk["um1"]
        return torch.where(pk["k0"], pk["um1"], xa[nx:nx + nup])

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

        def _cont_step(x, u, pk):
            return integ_cont(x, pk["t"], h, u, pk["d"], pk["px"], pk["xs"],
                              pk["us"], pk["py"])

    if colloc:
        # the tableau of ocp/collocation.py
        from mpc_code_tpu_torch.ocp.collocation import _AD, _BT
        from mpc_code_tpu_torch.ops.smalllin import solve_lu_ad

        ad, bt = _AD.tolist(), _BT.tolist()
        user_fx_coll = cfg.model.fx

        def _coll_res(S, x, u, d, t, px):
            s1, s2 = S[:nx], S[nx:]
            r1 = ((ad[0][0] * (s1 - x) + ad[0][1] * (s2 - x)) / h
                  - user_fx_coll(s1, u, d, t, px))
            r2 = ((ad[1][0] * (s1 - x) + ad[1][1] * (s2 - x)) / h
                  - user_fx_coll(s2, u, d, t, px))
            return torch.cat([r1, r2])

        def _newton(S, x, u, d, t, px):
            J = jacrev(_coll_res)(S, x, u, d, t, px)
            return S - solve_lu_ad(J, _coll_res(S, x, u, d, t, px))

        def _coll_S(x, u, pk):
            # px frozen at stage 0 per the reference quirk
            px = pk["px"] if stagewise_px else pk["px0"]
            d, t = pk["d"], pk["t"]
            # the root on detached values: no derivative, of either mode,
            # flows through these steps
            xd, ud = x.detach(), u.detach()
            S = torch.cat([xd, xd])
            for _ in range(n_colloc_newton):
                S = _newton(S, xd, ud, d, t, px).detach()
            # one differentiable step around the root: exact first
            # derivatives of the implicit function (residual ~ 0)
            return _newton(S, x, u, d, t, px)

        def _coll_next(x, u, pk):
            S = _coll_S(x, u, pk)
            s1, s2 = S[:nx], S[nx:]
            return x + bt[0] * (s1 - x) + bt[1] * (s2 - x)   # Control_Calc.py:437

    def raw_dyn(xa, ua, pk):
        """The one-interval map of the augmented state (JAX riccati.py:
        376-390): the model's step (or the ContForm quadrature's, or the
        condensed collocation step), then the u_prev and slack slots."""
        x, u = split(xa, ua)
        if cont_form:
            xn = _cont_step(x, u, pk)[0]
        elif colloc:
            xn = _coll_next(x, u, pk)
        else:
            xn = model.fx(x, u, h, pk["d"], pk["t"], pk["px"])
        parts = [xn]
        if du_coupled:
            parts.append(u)
        if slacks:
            parts.append(slack_of(xa, ua, pk))
        return torch.cat(parts) if len(parts) > 1 else xn

    def coll_S(x, u, pk):
        """The collocation stage states: the point argument ``s_coll``
        where the fused stage sweep's step has computed them, else the
        condensed Newton solve."""
        return pk["s_coll"] if "s_coll" in pk else _coll_S(x, u, pk)

    def slack_cost(xa, ua, pk):
        # the real penalty once (stage 0), a decoupled PD dummy on the
        # unused input slots after it; sums of products, as torch.func's
        # Hessian of a dot product leaves f32 (F4)
        s_in = ua[nu:]
        return torch.where(pk["k0"], N * (s_in * (Ws_t.to(s_in) @ s_in)).sum(),
                           0.5 * (s_in * s_in).sum())

    def raw_cost(xa, ua, pk):
        x, u = split(xa, ua)
        if cont_form:
            val = _cont_step(x, u, pk)[1]
        else:
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
            if colloc:
                # the collocation-aware objective F_obj(..., ds)
                # (Control_Calc.py:458-464, 483)
                dS = coll_S(x, u, pk)
                if qform:
                    dS = dS - torch.cat([pk["xs"], pk["xs"]])
                val = f_obj(dx, du, dy, pk["xs"], us_obj, ys, dS)
            else:
                val = f_obj(dx, du, dy, pk["xs"], us_obj, ys)
        if slacks:
            val = val + slack_cost(xa, ua, pk)
        return val

    def raw_ineq(xa, ua, pk):
        x, u = split(xa, ua)
        rows = []
        if not y_free:
            yk = y_of(x, u, pk)
            if slacks:
                # Sl[:ny] relaxes the upper bound, Sl[ny:2ny] the lower
                # (Control_Calc.py:232-239)
                s_k = slack_of(xa, ua, pk)
                rows += [yk + s_k[ny:2 * ny], yk - s_k[:ny]]
            else:
                rows.append(yk)
        if du_bounds:
            rows.append(u - um1_of(xa, pk))
        if ng_user:
            # the user's stage inequality over the corrected output
            gk = cfg.G_ineq(x, u, y_of(x, u, pk), pk["d"], pk["t"], pk["px"],
                            pk["py"]).reshape(-1)
            if slacks_g:
                gk = gk - slack_of(xa, ua, pk)[2 * ny:2 * ny + ng_user]
            rows.append(gk)
        if ni_coll:
            # the state box on the condensed stage states s1, s2
            # (Control_Calc.py:552-556)
            rows.append(coll_S(x, u, pk))
        return torch.cat(rows)

    def raw_eq(xa, ua, pk):
        # the user's stage equality over the corrected output, softened by
        # its slack entries under slacksH (Control_Calc.py:140-145)
        x, u = split(xa, ua)
        hk = cfg.H_eq(x, u, y_of(x, u, pk), pk["d"], pk["t"], pk["px"],
                      pk["py"]).reshape(-1)
        if slacks_h:
            hk = hk - slack_of(xa, ua, pk)[sl_h_off:sl_h_off + nh_user]
        return hk

    def row_bounds(lo, hi, n):
        return (np.asarray(lo, float).reshape(-1) if lo is not None else np.full(n, -np.inf),
                np.asarray(hi, float).reshape(-1) if hi is not None else np.full(n, np.inf))

    rows_lo, rows_hi = [], []
    if not y_free:
        lo, hi = row_bounds(ymin, ymax, ny)
        if slacks:
            rows_lo += [lo, np.full(ny, -np.inf)]
            rows_hi += [np.full(ny, np.inf), hi]
        else:
            rows_lo.append(lo)
            rows_hi.append(hi)
    if du_bounds:
        lo, hi = row_bounds(b.Dumin, b.Dumax, nu)
        rows_lo.append(lo)
        rows_hi.append(hi)
    if ng_user:
        rows_lo.append(np.full(ng_user, -np.inf))
        rows_hi.append(np.zeros(ng_user))
    if ni_coll:
        lo, hi = row_bounds(xmin, xmax, nx)
        rows_lo.append(np.tile(lo, 2))
        rows_hi.append(np.tile(hi, 2))
    lbi = np.concatenate(rows_lo) if ni else np.zeros(0)
    ubi = np.concatenate(rows_hi) if ni else np.zeros(0)
    lbx, ubx = row_bounds(xmin, xmax, nx)
    lbx = np.concatenate([lbx, np.full(nup, -np.inf), np.zeros(ns)])   # carried Sl >= 0
    ubx = np.concatenate([ubx, np.full(nup + ns, np.inf)])
    lbu, ubu = row_bounds(umin, umax, nu)
    lbu = np.concatenate([lbu, np.zeros(ns)])                          # Sl >= 0
    ubu = np.concatenate([ubu, np.full(ns, np.inf)])

    # per-variable scaling from the box bounds: internally x~ = x / sxa
    def _scales(lo, hi):
        mag = np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                         np.abs(np.where(np.isfinite(hi), hi, 0.0)))
        return np.where(mag > 1.0, mag, 1.0)

    sxa, su, si = _scales(lbx, ubx), _scales(lbu, ubu), _scales(lbi, ubi)

    def dyn_s(xa, u, pk):
        return raw_dyn(_t(sxa, xa) * xa, _t(su, u) * u, pk) / _t(sxa, xa)

    def cost_s(xa, u, pk):
        return raw_cost(_t(sxa, xa) * xa, _t(su, u) * u, pk)

    def cost_N_s(xa, pN):
        x = (_t(sxa, xa) * xa)[:nx]
        return vfin(x - pN["xs"] if qform else x, pN["xs"])

    def ineq_s(xa, u, pk):
        return raw_ineq(_t(sxa, xa) * xa, _t(su, u) * u, pk) / _t(si, xa)

    def eq_s(xa, u, pk):
        return raw_eq(_t(sxa, xa) * xa, _t(su, u) * u, pk)

    def x0_s(p):
        parts = [p["x0"]] + ([p["um1"]] if du_coupled else [])
        if slacks:
            parts.append(p["x0"].new_zeros(p["x0"].shape[:-1] + (ns,)))   # inert slot
        x0a = torch.cat(parts, -1) if len(parts) > 1 else p["x0"]
        return x0a / _t(sxa, x0a)

    # the terminal equality x_N = xs (QForm) or x_N = 0 (the reference's
    # literal semantics without QForm, Control_Calc.py:196-198) on the
    # true state slots, in scaled units, for a batch of lanes
    n_tc = nx if cfg.TermCons else 0

    def tc_target(p):
        return p["xs"] / _t(sxa[:nx], p["xs"]) if qform else torch.zeros_like(p["xs"])

    common = dict(N=N, nxa=nxa, nu=nu_eff, ni=ni, cost=cost_s,
                  cost_N=cost_N_s, ineq=ineq_s if ni else None,
                  lbi=lbi / si, ubi=ubi / si, lbx=lbx / sxa, ubx=ubx / sxa,
                  lbu=lbu / su, ubu=ubu / su, x0_of_p=x0_s,
                  sxa=sxa, su=su, si=si, device=dev, ns=ns, nu_ctrl=nu,
                  n_tc=n_tc, tc_target=tc_target if n_tc else None,
                  n_eq=nh_user, eq=eq_s if nh_user else None)

    # the stage cost and rows in the raw forms the fused stage sweep lowers
    # (StageLowering), on every form: the point's parameters they read are
    # POINT_ARGS, px where user rows read it, the collocation stage states
    # s_coll (computed once by the step) and the stage-0 flag k0 where the
    # u_prev slots or the slacks are read
    point_args = (POINT_ARGS + (("px",) if ng_user or nh_user else ())
                  + (("s_coll",) if colloc else ())
                  + (("k0",) if du_coupled or slacks else ()))
    lowering_common = dict(
        h=h, ineq=_point_fn(raw_ineq, point_args) if ni else None,
        eq=_point_fn(raw_eq, point_args) if nh_user else None, n_eq=nh_user, nx=nx, ny=ny,
        nup=nup, ns=ns, point_args=point_args)
    cost_at = _point_fn(raw_cost, point_args)

    if colloc:
        # no split sweep: every stage derivative comes from the fused stage
        # sweep, which runs the condensed step (JAX riccati.py:604, the
        # fast sweep is for shooting only; JAX's make_stage_sweep takes it)
        def _coll_ode(xx, tt, uu, dd, pp):
            return user_fx_coll(xx, uu, dd, tt, pp)

        low = StageLowering(kind="coll", ode=_coll_ode, Mx=1, clip_lo=None, clip_hi=None,
                            Bd=None, lin_par=False, cost=cost_at,
                            n_newton=int(n_colloc_newton), stagewise_px=bool(stagewise_px),
                            **lowering_common)
        return StructuredOCP(**common, stage_dyn_jac=None, dyn=dyn_s, lowering=low)

    if cont_form:
        # the quadrature is the stage cost; the slack penalty, if any, is
        # the lowered cost beside it
        low = StageLowering(kind="cf", ode=_ode, quad=_quad, Mx=int(Mx_c),
                            clip_lo=None, clip_hi=None, Bd=None, lin_par=False,
                            cost=_point_fn(slack_cost, point_args) if slacks else None,
                            **lowering_common)
        if slacks:
            # the slack augmentation keeps JAX's generic route (JAX
            # riccati.py:686-690): no joint sweep, the fused stage sweep
            return StructuredOCP(**common, stage_dyn_jac=None, dyn=dyn_s, lowering=low)
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

        # the generic map beside the sweep: the line search's trial rollouts
        # and the costate recursion's Jacobian (JAX :1273-1279).  Under the
        # exact Hessian the fused stage sweep integrates the state and the
        # quadrature together, as _cont_step does (JAX riccati.py:329-333,
        # 376-380), with lam's and the rows' terms
        return StructuredOCP(**common, stage_dyn_jac=None, sweep=sweep_cf,
                             stage_cf=stage_cf, dyn=dyn_s, lowering=low)

    m = cfg.model
    if isinstance(m, LinearModel):
        # no dynamics sweep: JAX takes its fast sweep only for the
        # continuous and discrete forms (JAX riccati.py:604-606), so the
        # fused stage sweep takes every stage derivative, as JAX's
        # make_stage_sweep does; the affine step (with its Bd d and its
        # px, which the linear form always adds) is lowered as a map
        def _lin_step(xx, uu, dd, tt, pp):
            return model.fx(xx, uu, h, dd, tt, pp)

        low = StageLowering(kind="map", ode=None, fmap=_lin_step, Mx=1, clip_lo=None,
                            clip_hi=None, Bd=None, lin_par=False, cost=cost_at,
                            **lowering_common)
        return StructuredOCP(**common, stage_dyn_jac=None, dyn=dyn_s, lowering=low)

    # the dynamics sweep: value and Jacobians of the model's step for all
    # stages in one pass; the augmented u_prev and slack rows have a
    # constant Jacobian structure assembled here (JAX riccati.py:600-679)
    Bd = (np.asarray(cfg.dist.Bd, float)
          if cfg.dist.offree == "lin" and cfg.dist.Bd is not None else None)
    lin_par = cfg.LinPar
    # the one-interval map beside the sweep, on every route (JAX riccati.py:
    # 376-390, dyn_s :559-560): the model's step (RK4 on the guarded state,
    # + Bd d, + px; or the discrete map), then the u_prev and slack slots.
    # The fused stage sweep lowers it with the cost and the rows
    exact = dict(dyn=dyn_s)
    if isinstance(m, DiscreteModel):
        from mpc_code_tpu_torch.ops.integrators import map_stage_jac

        sweep = map_stage_jac(m.Fx)

        def run_sweep(x, u, p):
            return sweep(x, u, p["px"], p["t"], p["d"])

        exact["lowering"] = StageLowering(
            kind="map", ode=None, fmap=m.Fx, Mx=1, clip_lo=None, clip_hi=None,
            Bd=Bd, lin_par=lin_par, cost=cost_at, **lowering_common)
    else:
        from mpc_code_tpu_torch.ops.integrators import rk4_stage_jac

        _ufx = m.fx

        def _ode(xx, tt, uu, dd, pp):
            return _ufx(xx, uu, dd, tt, pp)

        sweep = rk4_stage_jac(_ode, m.Mx, clip_lo=m.clip_lo, clip_hi=m.clip_hi)

        def run_sweep(x, u, p):
            hb = torch.full((x.shape[0],), h, dtype=x.dtype, device=x.device)
            return sweep(x, u, p["px"], p["t"], hb, p["d"])

        exact["lowering"] = StageLowering(
            kind="rk4", ode=_ode, Mx=int(m.Mx), clip_lo=m.clip_lo,
            clip_hi=m.clip_hi, Bd=Bd, lin_par=lin_par, cost=cost_at,
            **lowering_common)

    def stage_dyn_jac(Xs, Us, p):
        s_x, s_u = _t(sxa, Xs), _t(su, Us)
        xa, ua = Xs * s_x, Us * s_u
        u = ua[..., :nu]
        xf, Jx, Ju = run_sweep(xa[..., :nx], u, p)
        if Bd is not None:
            xf = xf + (p["d"] @ _t(Bd, Xs).T)[:, None]
        if lin_par:
            xf = xf + p["px"]
        if du_coupled or slacks:
            parts = [xf]
            A = Jx.new_zeros(Jx.shape[:2] + (nxa, nxa))
            Bm = Ju.new_zeros(Ju.shape[:2] + (nxa, nu_eff))
            A[..., :nx, :nx] = Jx
            Bm[..., :nx, :nu] = Ju
            if du_coupled:
                parts.append(u)
                Bm[..., nx:nx + nu, :nu] = torch.eye(nu, dtype=Us.dtype, device=Us.device)
            if slacks:
                # s_{k+1} = s_in at stage 0, s_k after it
                k0 = torch.arange(N, device=Xs.device) == 0
                parts.append(torch.where(k0[:, None], ua[..., nu:], xa[..., nx + nup:]))
                eye_s = torch.eye(ns, dtype=Us.dtype, device=Us.device)
                A[:, 1:, nx + nup:, nx + nup:] = eye_s
                Bm[:, 0, nx + nup:, nu:] = eye_s
            xf, Jx, Ju = torch.cat(parts, -1), A, Bm
        dval = _dense(torch.div, xf, s_x)
        A = _dense(torch.mul, Jx, s_x[None, :] / s_x[:, None])
        Bm = _dense(torch.mul, Ju, s_u[None, :] / s_x[:, None])
        return dval, A, Bm

    socp = StructuredOCP(**common, stage_dyn_jac=stage_dyn_jac, sweep=sweep, **exact)
    if os.environ.get("MPC_TPU_SWEEP_AUTOTUNE", "0") == "1" and batch_hint is not None:
        from mpc_code_tpu_torch.ops.sweep_autotune import autotune_sweep_impl

        socp = dataclasses.replace(socp, sweep_impl=autotune_sweep_impl(
            cfg, socp, int(batch_hint), verbose=True))
    return socp


def make_stage_derivs(s: StructuredOCP, hessian: str = "exact",
                      skip_dyn: bool = False, skip_cost: bool = False) -> Callable:
    """Per-point derivative sweep ``(z (nz,), pk, lam_k, nu_k[, mu_k]) ->
    (H, gc, A, B, E, ival, dval[, Cz, hval])``, the JAX
    ``make_stage_derivs`` (JAX riccati.py:973-1070): the cost's Hessian and
    gradient (``pk["_sf"]`` scales the objective), the dynamics' Jacobians
    with their value, the inequality Jacobian with its value and, when the
    OCP has stage equalities (``s.n_eq``), their Jacobian ``Cz = [Cx Cu]``
    and value, with ``mu_k`` their multipliers.  ``hessian='exact'`` gives
    H = ∇²(sf·c + lam_k·dyn + nu_k·ineq + mu_k·eq), ``'gauss_newton'`` H =
    ∇²(sf·c).  With ``skip_dyn`` (Gauss-Newton only: the caller gets the
    dynamics from ``s.stage_dyn_jac``) it is ``(z, pk) -> (H, gc[, E,
    ival][, Cz, hval])``, and with ``skip_cost`` as well (the ContForm
    joint sweep gives H and gc) ``([E, ival][, Cz, hval])``: E and ival are
    left out when ``s.ni == 0``, Cz and hval when ``s.n_eq == 0``.  Batch
    it with ``torch.func.vmap`` over (scenario, stage) points."""
    if (skip_dyn or skip_cost) and hessian != "gauss_newton":
        raise ValueError("skip_dyn/skip_cost require hessian='gauss_newton' "
                         "(the exact Lagrangian Hessian traverses the dynamics)")
    if skip_cost and not skip_dyn:
        raise ValueError("skip_cost implies skip_dyn (the ContForm joint "
                         "sweep provides both)")
    nxa, ni, n_eq = s.nxa, s.ni, s.n_eq
    nz = nxa + s.nu

    def c_of_z(zz, pk):
        return pk["_sf"] * s.cost(zz[:nxa], zz[nxa:], pk)

    def ineq_aux(zz, pk):
        v = s.ineq(zz[:nxa], zz[nxa:], pk)
        return v, v

    def eq_aux(zz, pk):
        v = s.eq(zz[:nxa], zz[nxa:], pk)
        return v, v

    if skip_dyn:
        # the rows' Jacobians in reverse mode: torch.func.jacfwd of a 0-dim
        # tensor plus a Python float, as user rows are written, returns an
        # f64 Jacobian for f32 inputs (ROADMAP Queue 3, F12)
        def split_derivs(z, pk):
            out = () if skip_cost else (torch.func.hessian(c_of_z)(z, pk),
                                        grad(c_of_z)(z, pk))
            if ni:
                out += jacrev(ineq_aux, has_aux=True)(z, pk)
            if n_eq:
                out += jacrev(eq_aux, has_aux=True)(z, pk)
            return out

        return split_derivs

    def dyn_aux(zz, pk):
        v = s.dyn(zz[:nxa], zz[nxa:], pk)
        return v, v

    def L_of_z(zz, pk, lam_k, nu_k, mu_k):
        # sums of products, not dot products: torch.func's Hessian of a
        # dot product leaves f32 (ROADMAP Queue 3, F4)
        val = c_of_z(zz, pk) + (lam_k * s.dyn(zz[:nxa], zz[nxa:], pk)).sum()
        if ni:
            val = val + (nu_k * s.ineq(zz[:nxa], zz[nxa:], pk)).sum()
        if n_eq:
            val = val + (mu_k * s.eq(zz[:nxa], zz[nxa:], pk)).sum()
        return val

    # reverse over reverse: torch's forward mode runs Python decompositions
    # for every op that mixes a tensor and a Python number, several times
    # slower through the RK4 sub-steps on the CPU (PERF.md, kernel 5)
    def stage_derivs(z, pk, lam_k, nu_k, mu_k=None):
        if hessian == "gauss_newton":
            H = jacrev(jacrev(c_of_z))(z, pk)
        else:
            H = jacrev(jacrev(L_of_z))(z, pk, lam_k, nu_k, mu_k)
        gc = grad(c_of_z)(z, pk)
        Jd, dval = jacrev(dyn_aux, has_aux=True)(z, pk)
        if ni:
            E, ival = jacrev(ineq_aux, has_aux=True)(z, pk)
        else:
            E, ival = z.new_zeros((0, nz)), z.new_zeros(0)
        out = (H, gc, Jd[:, :nxa], Jd[:, nxa:], E, ival, dval)
        if n_eq:
            out += jacrev(eq_aux, has_aux=True)(z, pk)
        return out

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


def _tr(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _finite(L):
    """Per lane: every entry of a factor finite (a failed Cholesky leaves
    NaN on its lane, F2/F3)."""
    return torch.isfinite(L).flatten(1).all(1)


def _stage_q(Hk, qk, Ak, Bk, rdk, P, pv, nxa):
    """The stage's quadratic model under the value function (P, p):
    Qxx, Quu, Qxu, qx, qu."""
    AtP, BtP = _tr(Ak) @ P, _tr(Bk) @ P
    Pr = pv + _mv(P, rdk)
    return (Hk[:, :nxa, :nxa] + AtP @ Ak, Hk[:, nxa:, nxa:] + BtP @ Bk,
            Hk[:, :nxa, nxa:] + AtP @ Bk, qk[:, :nxa] + _mv(_tr(Ak), Pr),
            qk[:, nxa:] + _mv(_tr(Bk), Pr))


def _sym(M):
    return 0.5 * (M + _tr(M))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _root_xi(Hm0, f0, ok):
    """The terminal multiplier from Hm_0 xi = -f_0, with -Hm_0 positive
    definite when the constraint is reachable; a tiny jitter flows into
    ``ok`` through the Cholesky (JAX riccati.py:862-868)."""
    n_tc = Hm0.shape[-1]
    M = -Hm0
    eps = torch.finfo(M.dtype).eps
    eps_x = 10.0 * eps * (1.0 + M.diagonal(dim1=-2, dim2=-1).abs().amax(-1))
    Lx = chol(M + eps_x[:, None, None] * _eye(n_tc, M))
    ok = ok & _finite(Lx)
    return _nan0(cho_solve(Lx, f0)), ok


def riccati_bordered(Hs, q, A, B, rd, PN, pN, Cz, hv, rT, *, nxa, nu):
    """Riccati backward and forward pass with stage equality rows and a
    terminal equality, for a batch of lanes: one recursion for JAX's three
    (riccati.py:728-971), ``_riccati_eqstage`` (n_tc = 0), ``_riccati_tc``
    (n_eq = 0) and ``_riccati_eqstage_tc``.  n_eq = Cz.shape[2] and n_tc =
    rT.shape[1]; either may be 0, and its rows are then empty.

    Stage k carries the linearised user equality Cx dx + Cu du + hv = 0,
    ``Cz = [Cx Cu]`` (B, N, n_eq, nxa+nu); the bordered stage system is
    eliminated through the Schur complement S = Cu Quu^-1 Cu' (positive
    definite when Cu has full row rank), for three right-hand sides: the
    dx coupling K, the constant kf and the terminal multiplier's coupling
    Kxi, with rhs (F B)'.  The terminal equality dx_N[:n_tc] + rT = 0
    enters the value function as its affine dependence on the multiplier
    xi: V_k(dx, xi) = 1/2 dx'P dx + p'dx + xi'(F dx + f) + 1/2 xi'Hm xi,
    from (PN, pN, F = [I 0], f = rT, Hm = 0) at N; at the root Hm_0 xi =
    -f_0.  The rollout takes du = kf + K dx + Kxi xi, the stage multipliers
    are mu_k = S^-1 (Cx~ dx + h~) - S^-1 Cu Quu^-1 (F B)' xi and the defect
    multipliers lam_k = P_{k+1} dx_{k+1} + p_{k+1} + F_{k+1}' xi.  A failed
    Cholesky of Quu, S or -Hm_0 clears the lane's ``ok``.  Returns (ok
    (B,), Ks, kf, P_seq, p_seq, F_seq (B, N, n_tc, nxa), xi (B, n_tc),
    mu_seq (B, N, n_eq), dX (B, N+1, nxa), dU)."""
    Bsz, N = Hs.shape[:2]
    n_eq, n_tc = Cz.shape[2], rT.shape[1]
    eps_s = 100.0 * torch.finfo(Hs.dtype).eps
    ok = torch.ones(Bsz, dtype=torch.bool, device=Hs.device)
    P, pv = PN, pN
    F = Hs.new_zeros((Bsz, n_tc, nxa))
    F[:, :, :n_tc] = _eye(n_tc, Hs)
    fv, Hm = rT, Hs.new_zeros((Bsz, n_tc, n_tc))
    zero_e = Hs.new_zeros((Bsz, n_eq, n_tc))
    outs = [[None] * N for _ in range(9)]
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[:, k], B[:, k]
        Cx, Cu = Cz[:, k, :, :nxa], Cz[:, k, :, nxa:]
        Qxx, Quu, Qxu, qx, qu = _stage_q(Hs[:, k], q[:, k], Ak, Bk, rd[:, k], P, pv, nxa)
        L = chol(Quu)
        ok = ok & _finite(L)
        Qi_Cut = cho_solve(L, _tr(Cu))
        S = _sym(Cu @ Qi_Cut) + eps_s * _eye(n_eq, Hs)
        Ls = chol(S)
        ok = ok & _finite(Ls)

        def bordered(g, e):
            # du = -(Quu^-1 g + Quu^-1 Cu' S^-1 (e - Cu Quu^-1 g)), and the
            # multiplier's response S^-1 (e - Cu Quu^-1 g); g, e as columns
            w = cho_solve(L, g)
            s_r = cho_solve(Ls, e - Cu @ w)
            return -(w + Qi_Cut @ s_r), s_r

        FB = F @ Bk
        Kk, Si_Cxt = bordered(_tr(Qxu), Cx)
        kk, Si_ht = (a[..., 0] for a in bordered(qu[..., None], hv[:, k, :, None]))
        Kxi, Si_Cxi = bordered(_tr(FB), zero_e)
        for o, v in zip(outs, (Kk, kk, Kxi, Si_Cxt, Si_ht, Si_Cxi, P, pv, F)):
            o[k] = v
        if n_eq:
            # the bordered gains are not Quu's own optimum: the whole quadratic
            P = _sym(Qxx + Qxu @ Kk + _tr(Kk) @ _tr(Qxu) + _tr(Kk) @ Quu @ Kk)
            pv = qx + _mv(Qxu, kk) + _mv(_tr(Kk), qu + _mv(Quu, kk))
        else:
            P = _sym(Qxx + Qxu @ Kk)
            pv = qx + _mv(Qxu, kk)
        fv = fv + _mv(F, rd[:, k]) + _mv(FB, kk)
        F = F @ Ak + FB @ Kk
        Hm = _sym(Hm + FB @ Kxi)
    xi, ok = _root_xi(Hm, fv, ok) if n_tc else (fv, ok)
    Ks, kf, Kxis, SiC, Sih, SiXi, P_seq, p_seq, F_seq = outs
    dx = Hs.new_zeros((Bsz, nxa))
    dX, dU, mus = [dx], [], []
    for k in range(N):
        du = kf[k] + _mv(Ks[k], dx) + _mv(Kxis[k], xi)
        mus.append(_mv(SiC[k], dx) + Sih[k] + _mv(SiXi[k], xi))
        dx = _mv(A[:, k], dx) + _mv(B[:, k], du) + rd[:, k]
        dX.append(dx)
        dU.append(du)
    st = lambda v: torch.stack(v, 1)  # noqa: E731
    return (ok, st(Ks), st(kf), st(P_seq), st(p_seq), st(F_seq), xi, st(mus),
            st(dX), st(dU))


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 1; a has as many entries as b
    or one more."""
    out = a.new_empty(a.shape[:1] + (a.shape[1] + b.shape[1],) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def associative_scan(fn, elems, reverse=False):
    """``jax.lax.associative_scan`` along dim 1 of each tensor of the tuple
    ``elems``, with the same pairing, so that the rounding follows JAX's:
    adjacent pairs are combined, the pairs scanned by recursion, and the
    even entries filled in from the odd ones.  ``fn(a, b)`` gets tuples of
    slices, ``a`` the earlier entries; with ``reverse`` the sequence is
    flipped first and the result flipped back, so ``a`` holds the higher
    original index, as in JAX."""
    if reverse:
        elems = tuple(e.flip(1) for e in elems)

    def scan(el):
        n = el[0].shape[1]
        if n < 2:
            return el
        odd = scan(fn(tuple(e[:, 0:n - 1:2] for e in el), tuple(e[:, 1::2] for e in el)))
        rest = tuple(e[:, 2::2] for e in el)
        even = fn(tuple(o[:, :-1] for o in odd) if n % 2 == 0 else odd, rest)
        even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(el, even))
        return tuple(_interleave(a, b) for a, b in zip(even, odd))

    out = scan(tuple(elems))
    return tuple(o.flip(1) for o in out) if reverse else out


def riccati_parallel(Hs, q, A, B, rd, PN, pN, *, nxa):
    """The associative-scan Riccati of ``parallel=True`` (JAX riccati.py:
    1591-1677 and the forward scan :1736-1750), for a batch of lanes.

    Each stage, u eliminated, is an element of the parallel LQT value
    function recursion (Sarkka & Garcia-Fernandez, 'Temporal
    Parallelization of Dynamic Programming'):
        Ae = A - B Huu^-1 Hux      be = r - B Huu^-1 qu
        Ce = B Huu^-1 B'           Je = Hxx - Hxu Huu^-1 Hux
        eta = -(qx - Hxu Huu^-1 qu)
    with the terminal element (0, 0, 0, -pN, PN).  A reverse inclusive scan
    of these gives (P_k, p_k) = (J_{k..N}, -eta_{k..N}) at every k in
    O(log N) depth; the gains follow stage by stage, and the rollout is an
    associative scan of the affine maps dx -> (A + B K) dx + r + B kf.  JAX
    runs this outside any Pallas kernel, as batched small products and
    solves, and so does the port, in plain PyTorch: the merges' solves go
    through ``ops/smalllin.py``.  Returns (ok (B,), Ks, kf, P_seq, p_seq,
    dX (B, N+1, nxa), dU)."""
    Bsz, N = Hs.shape[:2]
    eye = _eye(nxa, Hs)
    Huu, Hxu, Hxx = Hs[..., nxa:, nxa:], Hs[..., :nxa, nxa:], Hs[..., :nxa, :nxa]
    qx, qu = q[..., :nxa], q[..., nxa:]
    L = chol(Huu)
    ok = _finite(L)
    Hi_ux = cho_solve(L, _tr(Hxu))          # Huu^-1 Hux
    Hi_qu = cho_solve(L, qu)
    Hi_Bt = cho_solve(L, _tr(B))            # Huu^-1 B'
    zx = Hs.new_zeros((Bsz, 1, nxa))
    zxx = Hs.new_zeros((Bsz, 1, nxa, nxa))
    elems = (torch.cat([A - B @ Hi_ux, zxx], 1),
             torch.cat([rd - _mv(B, Hi_qu), zx], 1),
             torch.cat([_sym(B @ Hi_Bt), zxx], 1),
             torch.cat([-(qx - _mv(Hxu, Hi_qu)), -pN[:, None]], 1),
             torch.cat([_sym(Hxx - Hxu @ Hi_ux), PN[:, None]], 1))

    def comp(e1, e2):
        # e1 the earlier window (i -> j), e2 the later (j -> l)
        A1, b1, C1, n1, J1 = e1
        A2, b2, C2, n2, J2 = e2
        sol = solve_lu(eye + C1 @ J2,
                       torch.cat([A1, (b1 + _mv(C1, n2))[..., None], C1], -1))
        MA1, Mb, MC1 = sol[..., :nxa], sol[..., nxa], sol[..., nxa + 1:]
        sol2 = solve_lu(eye + J2 @ C1,
                        torch.cat([(n2 - _mv(J2, b1))[..., None], J2 @ A1], -1))
        return (A2 @ MA1, _mv(A2, Mb) + b2, _sym(A2 @ MC1 @ _tr(A2) + C2),
                _mv(_tr(A1), sol2[..., 0]) + n1, _sym(_tr(A1) @ sol2[..., 1:] + J1))

    # the reverse scan feeds fn(higher index, lower index); comp takes
    # (earlier, later): swapped, as in JAX riccati.py:1659-1662
    suf = associative_scan(lambda a, b: comp(b, a), elems, reverse=True)
    P_nxt, p_nxt = suf[4][:, 1:], -suf[3][:, 1:]
    Bt = _tr(B)
    Lf = chol(Huu + Bt @ P_nxt @ B)
    ok = ok & _finite(Lf)
    Ks = -cho_solve(Lf, _tr(Hxu) + Bt @ P_nxt @ A)
    kf = -cho_solve(Lf, qu + _mv(Bt, _mv(P_nxt, rd) + p_nxt))

    def acomp(a, b):
        (Ma, va), (Mb, vb) = a, b
        return Mb @ Ma, _mv(Mb, va) + vb

    vc = associative_scan(acomp, (A + B @ Ks, rd + _mv(B, kf)))[1]
    dX = torch.cat([zx, vc], 1)
    return ok, Ks, kf, P_nxt, p_nxt, dX, kf + _mv(Ks, dX[:, :N])


def make_structured_solver(s: StructuredOCP, opts: SolverOptions = SolverOptions(),
                           parallel: bool = False, impl: Optional[str] = None) -> Callable:
    """Build ``solve(p, X0, U0, max_iter=None, ws=None) -> StructResult``
    for a batch.

    X0 (B, N+1, nxa), U0 (B, N, nu) warm starts in user units; X0[:, 0] is
    overwritten by the pinned initial state from p.  ``max_iter`` overrides
    ``opts.max_iter`` per call (pass-1 cap and rescue share one solver).
    ``ws`` is the cross-solve dual/barrier warm start of the closed loop: a
    dict with ``zl``, ``zu`` (B, N, nxa+nu+ni), ``lam`` (B, N, nxa), ``nus``
    (B, N, ni), ``mu``, ``sf`` and ``ok`` (B,), the previous step's result
    shifted one stage; a lane with ``ok`` False starts cold.

    ``parallel=True`` takes the associative-scan Riccati
    (``riccati_parallel``) in place of the Riccati KKT kernel, with a
    permanent 1e-6 floor on the regularisation of the whole stage Hessian
    (JAX riccati.py:1103-1117, 1584-1589).

    ``impl`` (default the OCP's ``sweep_impl``) is the Gauss-Newton stage
    derivatives' route: ``"split"`` or ``"fused"`` (the fused stage
    sweep's Gauss-Newton build; the OCP needs a lowering).  ``opts.debug``
    prints JAX's line (riccati.py:2020-2026) for every lane at every
    step, in lane order, copying its values to the host."""
    impl = s.sweep_impl if impl is None else impl
    if impl not in ("split", "fused"):
        raise ValueError(f"unknown impl {impl!r}: use 'split' or 'fused'")
    if opts.mu_strategy not in ("monotone", "adaptive", "mehrotra"):
        raise ValueError(f"unknown mu_strategy {opts.mu_strategy!r}: "
                         "use 'monotone', 'adaptive' or 'mehrotra'")
    if opts.ls_mode not in ("backtrack", "adaptive"):
        raise ValueError(f"unknown ls_mode {opts.ls_mode!r}: "
                         "use 'backtrack' or 'adaptive'")
    if opts.hessian not in ("exact", "gauss_newton"):
        raise ValueError(f"unknown hessian {opts.hessian!r}: "
                         "use 'exact' or 'gauss_newton'")
    N, nxa, nu, ni = s.N, s.nxa, s.nu, s.ni
    nz = nxa + nu
    n_tc, n_eq = s.n_tc, s.n_eq
    termcons = n_tc > 0    # terminal equality: the terminal-multiplier recursion
    eqcons = n_eq > 0      # stage equalities: the bordered-stage recursion
    if (termcons or eqcons) and parallel:
        raise ValueError("TermCons / stage equalities (H_eq) are not "
                         "supported with the parallel-scan Riccati variant; "
                         "use the sequential default")
    exact = opts.hessian == "exact"
    if impl == "fused" and not exact and s.lowering is None:
        raise ValueError("impl='fused' needs an OCP whose stage functions the fused "
                         "stage sweep lowers (StructuredOCP.lowering)")
    mehrotra = opts.mu_strategy == "mehrotra"
    ls_adaptive = opts.ls_mode == "adaptive"
    # ls_parallel only chooses how backtracking evaluates its trials
    ls_parallel = opts.ls_parallel and not ls_adaptive
    sweep_every = max(int(opts.sweep_every), 1)
    delta_floor = 1e-6 if parallel else 0.0
    # the held bound pairs of a lane (Mehrotra's average complementarity)
    lbz_np = np.concatenate([s.lbx, s.lbu, s.lbi])
    ubz_np = np.concatenate([s.ubx, s.ubu, s.ubi])
    c_cnt = max(N * int((lbz_np > -1e18).sum() + (ubz_np < 1e18).sum()), 1)

    # The route is chosen here, once, from the OCP's structure, as JAX
    # chooses it (JAX riccati.py:1150-1166).  Gauss-Newton on an OCP with a
    # split sweep: the dynamics from their kernel and the cost and rows by
    # torch.func; ContForm's joint sweep also gives the stage cost's value,
    # gradient and Hessian (JAX fast_cf).  Everything else with a lowering
    # (every form build_structured_ocp builds: the exact Hessian, and under
    # Gauss-Newton a LinearModel, a collocated OCP and ContForm with slacks;
    # and the MHE's window under both, as JAX's opt-in route wraps every
    # OCP without a split sweep) takes every output from the fused stage
    # sweep, with the iterate's multipliers (JAX make_stage_sweep,
    # riccati.py:1394-1398); the card has no other path for it, so it
    # always launches its kernel there.  Under Gauss-Newton impl='fused'
    # takes the fused stage sweep's Gauss-Newton build in place of the
    # split sweep.
    fast_cf = s.stage_cf is not None and not exact
    split = ((s.stage_dyn_jac is not None and not exact) or fast_cf) and impl == "split"
    fused = v_stage = None
    if split:
        if ni or eqcons or not fast_cf:
            v_stage = vmap(make_stage_derivs(s, "gauss_newton", skip_dyn=True,
                                             skip_cost=fast_cf))
    elif s.lowering is not None:
        from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

        fused = make_stage_sweep(s, opts.hessian)
    else:
        raise ValueError("an OCP without a split sweep needs the fused stage sweep's "
                         "lowering (StructuredOCP.lowering)")

    def _cstage(zz, pk):
        return pk["_sf"] * s.cost(zz[:nxa], zz[nxa:], pk)

    def _cN(xx, pN):
        return pN["_sf"] * s.cost_N(xx, pN)

    def _dyn(zz, pk):
        return s.dyn(zz[:nxa], zz[nxa:], pk)

    def _vals(zz, pk):
        # primal values and cost gradient only, for the stale-derivative
        # sub-steps (JAX riccati.py:1402-1418)
        out = (grad(_cstage)(zz, pk), _dyn(zz, pk))
        if ni:
            out += (s.ineq(zz[:nxa], zz[nxa:], pk),)
        if eqcons:
            out += (s.eq(zz[:nxa], zz[nxa:], pk),)
        return out

    v_cost = vmap(_cstage)
    v_grad_c0 = vmap(grad(lambda zz, pk: s.cost(zz[:nxa], zz[nxa:], pk)))
    v_cost_N = vmap(_cN)
    v_grad_N = vmap(grad(_cN))
    v_hess_N = vmap(hessian(_cN))
    v_grad_N0 = vmap(grad(lambda xx, pN: s.cost_N(xx, pN)))
    v_ineq = vmap(lambda zz, pk: s.ineq(zz[:nxa], zz[nxa:], pk)) if ni else None
    v_eq = vmap(lambda zz, pk: s.eq(zz[:nxa], zz[nxa:], pk)) if eqcons else None
    v_dyn = vmap(_dyn)
    v_vals = vmap(_vals)
    # the dynamics' Jacobian in x by reverse mode (forward mode gave f64
    # Jacobians for f32 inputs, ROADMAP Queue 3, F9 and F12)
    v_dyn_x = vmap(lambda zz, pk: jacrev(_dyn)(zz, pk)[:, :nxa])

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
        nzs = lbz.shape[0]
        eye_nz = torch.eye(nz, **kw)
        eye_x = torch.eye(nxa, **kw)

        def mkZ(X_, U_, S_):
            return torch.cat([X_[:, 1:], U_, S_], dim=-1)

        x0a = s.x0_of_p(p)
        tc_tgt = s.tc_target(p) if termcons else None
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
        if opts.dual_init == "costate":
            # the adjoint recursion at the warm start's rollout, the
            # stagewise least-squares stationarity solution for the defect
            # multipliers: lam_k = qx_{k+1} + A_{k+1}' lam_{k+1}, lam_{N-1} =
            # grad Vfin (JAX riccati.py:1264-1295); g0 and gN0 from the
            # scaling probe, and one dynamics-Jacobian sweep
            if s.stage_dyn_jac is not None:
                A_i = s.stage_dyn_jac(X_init[:, :N], U_init, p)[1]
            else:
                A_i = v_dyn_x(Zs0, pk).reshape(Bsz, N, nxa, nxa)
            qx = sf[:, None, None] * g0.reshape(Bsz, N, nz)[..., :nxa]
            lam_k = sf[:, None] * gN0
            lams = [lam_k]
            for k in range(N - 1, 0, -1):
                lam_k = qx[:, k] + _mv(_tr(A_i[:, k]), lam_k)
                lams.append(lam_k)
            lam_ls = _nan0(torch.stack(lams[::-1], 1))
            # IPOPT-style safeguard, per lane: an exploding least-squares
            # solution (an ignited rollout) is worse than the zero init
            lam0 = torch.where(_lane(_amax(lam_ls.abs()) < 1e4, lam_ls), lam_ls, lam0)
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
            zl=zl0, zu=zu0, mu=mu0, nu_pen=full(1.0), delta=full(delta_floor),
            it=torch.zeros(Bsz, dtype=torch.int32, device=dev),
            done=torch.zeros(Bsz, dtype=torch.bool, device=dev),
            kkt0=full(float("inf")), feas=full(float("inf")),
            xi=torch.zeros((Bsz, n_tc), **kw), mu_h=torch.zeros((Bsz, N, n_eq), **kw),
            psi_prev=full(float("inf")), acap=full(1.0),
            bX=X_init, bU=U_init, bS=S_init,
            bkkt=full(float("inf")), bfeas=full(float("inf")),
        )

        def lane_sum(a):
            return a.flatten(1).sum(1)

        def total_cost(X, U, pk_=pk, pN_=pN):
            n_l = X.shape[0]
            Zs = torch.cat([X[:, :N], U], dim=-1).reshape(n_l * N, nz)
            return v_cost(Zs, pk_).reshape(n_l, N).sum(1) + v_cost_N(X[:, N], pN_)

        def bar_of(Z):
            one = torch.ones_like(Z)
            tl = torch.where(hlz, torch.log(torch.clamp(torch.where(hlz, Z - lbz, one),
                                                        min=tiny)), 0.0)
            tu = torch.where(huz, torch.log(torch.clamp(torch.where(huz, ubz - Z, one),
                                                        min=tiny)), 0.0)
            return lane_sum(tl) + lane_sum(tu)

        def sweep(st):
            """H, gc, A, Bm, E, ival, dval, Cz, hval at the iterate, and qv,
            the ContForm quadrature there (None otherwise)."""
            X, U = st["X"], st["U"]
            no_eq = (torch.zeros((Bsz, N, 0, nz), **kw), torch.zeros((Bsz, N, 0), **kw))
            if fused is not None:
                mu_h = st["mu_h"] if eqcons else torch.zeros((Bsz, N, 0), **kw)
                return fused(*fused.inputs(X[:, :N], U, p, st["lam"], st["nus"], mu_h)) + (None,)
            Zs = torch.cat([X[:, :N], U], dim=-1).reshape(L, nz)
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
                derivs = derivs[2:]
            else:
                E, ival = torch.zeros((Bsz, N, 0, nz), **kw), torch.zeros((Bsz, N, 0), **kw)
            Cz, hval = ((derivs[0].reshape(Bsz, N, n_eq, nz), derivs[1].reshape(Bsz, N, n_eq))
                        if eqcons else no_eq)
            return H, gc, A, Bm, E, ival, dval, Cz, hval, qv

        def values(st):
            """gc, ival, dval, hval at the iterate without derivatives: the
            stale-derivative sub-steps' re-evaluation (JAX riccati.py:
            1402-1418), by the generic map (no kernel)."""
            Zs = torch.cat([st["X"][:, :N], st["U"]], dim=-1).reshape(L, nz)
            out = v_vals(Zs, pk)
            gc, dval = out[0].reshape(Bsz, N, nz), out[1].reshape(Bsz, N, nxa)
            ival = out[2].reshape(Bsz, N, ni) if ni else torch.zeros((Bsz, N, 0), **kw)
            hval = out[-1].reshape(Bsz, N, n_eq) if eqcons else torch.zeros((Bsz, N, 0), **kw)
            return gc, ival, dval, hval

        def residuals(X, U, S, pk_, tgt):
            """r_d, r_i, r_T, r_h at a trial point of n_l lanes (JAX
            riccati.py:1351-1363): one rollout of the generic map."""
            n_l = X.shape[0]
            Zs = torch.cat([X[:, :N], U], dim=-1).reshape(n_l * N, nz)
            r_d = v_dyn(Zs, pk_).reshape(n_l, N, nxa) - X[:, 1:]
            r_i = (v_ineq(Zs, pk_).reshape(n_l, N, ni) - S if ni
                   else X.new_zeros((n_l, N, 0)))
            r_T = X[:, N, :n_tc] - tgt if termcons else X.new_zeros((n_l, 0))
            r_h = (v_eq(Zs, pk_).reshape(n_l, N, n_eq) if eqcons
                   else X.new_zeros((n_l, N, 0)))
            return r_d, r_i, r_T, r_h

        def capped(*rs):
            # the residuals' l1 norm with overflow capped and NaN as 0
            out = 0
            for r in rs:
                out = out + lane_sum(torch.nan_to_num(r, posinf=1e30, neginf=-1e30).abs())
            return out

        def ipm_step(st, H, gc, A, Bm, E, ival, dval, Cz, hval, qv):
            X, U, S = st["X"], st["U"], st["S"]
            lam, nus, zl, zu = st["lam"], st["nus"], st["zl"], st["zu"]
            xi, mu_h = st["xi"], st["mu_h"]
            mu_c = st["mu"]
            Z = mkZ(X, U, S)
            one = torch.ones_like(Z)
            r_d = dval - X[:, 1:]
            r_i = ival - S
            r_T = X[:, N, :n_tc] - tc_tgt if termcons else X.new_zeros((Bsz, 0))
            r_h = hval

            # KKT errors at the current point from the stage data
            AtL = torch.einsum("bkai,bka->bki", A, lam)
            BtL = torch.einsum("bkai,bka->bki", Bm, lam)
            EtZ = torch.einsum("bkia,bki->bka", E, nus)
            if eqcons:
                EtZ = EtZ + torch.einsum("bkia,bki->bka", Cz, mu_h)
            gx_full = gc[..., :nxa] + AtL + EtZ[..., :nxa]
            gu_full = gc[..., nxa:] + BtL + EtZ[..., nxa:]
            gradN = v_grad_N(X[:, N], pN)
            rx = torch.cat([gx_full[:, 1:] - lam[:, :N - 1],
                            (gradN - lam[:, N - 1])[:, None]], dim=1)
            if termcons:
                # the terminal multiplier enters x_N's stationarity
                rx = rx.clone()
                rx[:, N - 1, :n_tc] += xi
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
            e_feas = torch.maximum(e_feas, torch.maximum(_amax0(r_T.abs()),
                                                         _amax0(r_h.abs())))
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
            if opts.mu_strategy == "adaptive":
                # the LOQO centrality rule (IPOPT mu_strategy=adaptive,
                # quality_function=loqo; JAX riccati.py:1523-1539): mu =
                # sigma * the average complementarity, sigma = 0.1 min(0.05
                # (1-xi)/xi, 2)^3 with the centrality xi = min_i c_i / avg c_i
                # over one lane's bound products
                cv = torch.cat([torch.where(hlz, cl_c, torch.nan).flatten(1),
                                torch.where(huz, cu_c, torch.nan).flatten(1)], 1)
                cm = torch.isfinite(cv)
                m_cnt = cm.sum(1)
                avg_c = (torch.where(cm, cv, 0.0).sum(1)
                         / torch.clamp(m_cnt, min=1).to(dtype))
                xi_c = (torch.where(cm, cv, inf).amin(1)
                        / torch.clamp(avg_c, min=tiny))
                sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi_c) / torch.clamp(xi_c, min=1e-6),
                                          max=2.0) ** 3
                mu_ad = torch.clamp(sigma * avg_c, opts.tol / 10.0, 1e4)
                mu = torch.where(m_cnt > 0, mu_ad, mu)

            # barrier sigmas on the merged Z layout; the barrier gradient is
            # built per direction from componentwise complementarity targets
            # (numerators), so that the Mehrotra corrector can inject its
            # second-order terms
            def bg_of(tl, tu):
                return _mdiv(tl * one, Z - lbz, hlz) - _mdiv(tu * one, ubz - Z, huz)

            def dz_of(dZc, tl, tu):
                dzl = torch.where(hlz, -zl + _mdiv(tl * one - zl * dZc, Z - lbz, hlz), 0.0)
                dzu = torch.where(huz, -zu + _mdiv(tu * one + zu * dZc, ubz - Z, huz), 0.0)
                return dzl, dzu

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
            # the carried regularisation shifts the whole stage Hessian (the
            # parallel composition needs its windows well posed)
            Hs = Hs + st["delta"][:, None, None, None] * eye_nz
            PN_h = PN_h + st["delta"][:, None, None] * eye_x

            def direction(bgZ):
                """One KKT solve for the merged barrier-gradient right-hand
                side ``bgZ`` (laid out as Z), reusing the mu-independent
                Hs, PN_h and sigmas (JAX riccati.py:1679-1773)."""
                bgS = bgZ[..., nxa + nu:]
                g_extra = torch.einsum("bkia,bki->bka", E, sigS * r_i - bgS)
                bg_q = torch.cat([torch.cat([torch.zeros((Bsz, 1, nxa), **kw),
                                             bgZ[:, :N - 1, :nxa]], dim=1),
                                  bgZ[..., nxa:nxa + nu]], dim=-1)
                q = gc + g_extra - bg_q
                pN_g = pN_cost - bgZ[:, N - 1, :nxa]
                # the KKT solve (JAX riccati.py:1703-1734): with TermCons or
                # H_eq the bordered recursion, plain PyTorch for JAX's three
                # (JAX has no Pallas kernel for them); parallel=True the
                # associative scan, plain PyTorch as JAX's; else kernel 2
                xi_new, mu_h_new = xi, mu_h
                if termcons or eqcons:
                    (solvable, Ks, kf, P_seq, p_seq, F_seq, xi_new, mu_seq,
                     dX, dU) = riccati_bordered(Hs, q, A, Bm, r_d, PN_h, pN_g, Cz, r_h,
                                                r_T, nxa=nxa, nu=nu)
                elif parallel:
                    solvable, Ks, kf, P_seq, p_seq, dX, dU = riccati_parallel(
                        Hs, q, A, Bm, r_d, PN_h, pN_g, nxa=nxa)
                else:
                    solvable, Ks, kf, P_seq, p_seq, dX, dU = riccati_kkt(
                        Hs, q, A, Bm, r_d, PN_h, pN_g, torch.zeros(Bsz, **kw),
                        nxa=nxa, nu=nu)
                    # no direction on a lane whose KKT solve failed: the plain
                    # version carries NaN there, which is zeroed below as the
                    # JAX package zeroes it, and kernel 2 finite values from
                    # its clamped pivots, which would reach the dual step on
                    # the card (ROADMAP Queue 3, F17)
                    dX = torch.where(_lane(solvable, dX), dX, 0.0)
                    dU = torch.where(_lane(solvable, dU), dU, 0.0)
                if termcons:
                    xi_new = torch.where(_lane(solvable, xi_new), xi_new, xi)
                if eqcons:
                    mu_h_new = torch.where(_lane(solvable, mu_seq), _nan0(mu_seq), mu_h)
                dX, dU = _nan0(dX), _nan0(dU)
                dS = torch.einsum("bkia,bka->bki", E,
                                  torch.cat([dX[:, :N], dU], dim=-1)) + r_i
                dnu = _nan0(sigS * dS - (nus + bgS))
                # defect multipliers lam_k = P_{k+1} dx_{k+1} + p_{k+1} (+ F' xi)
                lam_new = torch.einsum("bkij,bkj->bki", P_seq, dX[:, 1:]) + p_seq
                if termcons:
                    lam_new = lam_new + torch.einsum("bkia,bi->bka", F_seq, xi_new)
                lam_new = _nan0(lam_new)
                lam_new = torch.where(_lane(solvable, lam_new), lam_new, lam)
                return (solvable, dX, dU, dS, dnu, lam_new, xi_new, mu_h_new,
                        q, g_extra, pN_g)

            if mehrotra:
                # Mehrotra predictor-corrector (JAX riccati.py:1785-1838): the
                # affine predictor, a pure primal-dual Newton step (zero
                # complementarity targets), then the corrector
                zero = torch.zeros_like(mu)
                _, dXa, dUa, dSa = direction(torch.zeros((Bsz, N, nzs), **kw))[:4]
                dZa = torch.cat([dXa[:, 1:], dUa, dSa], dim=-1)
                dzl_a, dzu_a = dz_of(dZa, _lane(zero, Z), _lane(zero, Z))
                # the step lengths to the boundary (tau = 1)
                neg, pos = dZa < 0, dZa > 0
                al1 = torch.where(hlz & neg, -(Z - lbz) / torch.where(neg, dZa, -one), inf)
                au1 = torch.where(huz & pos, (ubz - Z) / torch.where(pos, dZa, one), inf)
                a_p = torch.clamp(torch.minimum(_amin(al1), _amin(au1)), max=1.0)
                nl, nu_ = dzl_a < 0, dzu_a < 0
                a_d = torch.clamp(torch.minimum(
                    _amin(torch.where(nl, -zl / torch.where(nl, dzl_a, -one), inf)),
                    _amin(torch.where(nu_, -zu / torch.where(nu_, dzu_a, -one), inf))),
                    max=1.0)
                # the average complementarity now and at the affine probe

                def comp_sum(ap, ad):
                    Zp = Z + _lane(ap, Z) * dZa
                    ad_z = _lane(ad, Z)
                    gl = torch.where(hlz, Zp - lbz, 0.0)
                    gu = torch.where(huz, ubz - Zp, 0.0)
                    return lane_sum(gl * (zl + ad_z * dzl_a)) + lane_sum(gu * (zu + ad_z * dzu_a))

                mu_avg = comp_sum(zero, zero) / c_cnt
                mu_aff = comp_sum(a_p, a_d) / c_cnt
                sigma_m = torch.clamp((mu_aff / torch.clamp(mu_avg, min=tiny)) ** 3, 0.0, 1.0)
                mu = torch.clamp(sigma_m * mu_avg, opts.tol / 10.0, 1e4)
                mu_z = _lane(mu, Z)
                # corrector targets mu - dprim dz_aff (lower), mu + dprim
                # dz_aff (upper), held within [0.01 mu, 100 mu]: unbounded
                # second-order terms destabilise f32 lanes far from the
                # central path
                lo_t, hi_t = 0.01 * mu_z, 100.0 * mu_z
                tl = torch.minimum(torch.maximum(mu_z + (-dZa * dzl_a), lo_t), hi_t)
                tu = torch.minimum(torch.maximum(mu_z + dZa * dzu_a, lo_t), hi_t)
            else:
                mu_z = _lane(mu, Z)
                tl = tu = mu_z
            bgZ = bg_of(tl, tu)
            (solvable, dX, dU, dS, dnu, lam_new, xi_new, mu_h_new,
             q, g_extra, pN_g) = direction(bgZ)
            bgS = bgZ[..., nxa + nu:]
            dlam = lam_new - lam

            # fraction to boundary
            tau = torch.clamp(1.0 - mu, min=_TAU_MIN)
            tau_z = _lane(tau, Z)
            dZ = torch.cat([dX[:, 1:], dU, dS], dim=-1)
            neg, pos = dZ < 0, dZ > 0
            al = torch.where(hlz & neg, -tau_z * (Z - lbz)
                             / torch.where(neg, dZ, -one), inf)
            au = torch.where(huz & pos, tau_z * (ubz - Z)
                             / torch.where(pos, dZ, one), inf)
            alpha_max = torch.clamp(torch.minimum(_amin(al), _amin(au)), max=1.0)

            # dual steps towards the (componentwise) complementarity targets
            dzl, dzu = dz_of(dZ, tl, tu)

            def ftb_dual(zv, dzv):
                n_ = dzv < 0
                return torch.where(n_, -tau_z * zv / torch.where(n_, dzv, -one), inf)

            ad = torch.clamp(torch.minimum(_amin(ftb_dual(zl, dzl)),
                                           _amin(ftb_dual(zu, dzu))), max=1.0)

            c_norm = (r_d.abs().flatten(1).sum(1) + r_i.abs().flatten(1).sum(1)
                      + r_T.abs().sum(1) + r_h.abs().flatten(1).sum(1))
            lam_inf = torch.maximum(_amax0(lam_new.abs()), _amax0((nus + dnu).abs()))
            lam_inf = torch.maximum(lam_inf, torch.maximum(_amax0(xi_new.abs()),
                                                           _amax0(mu_h_new.abs())))
            nu_pen = torch.maximum(1.5 * lam_inf + 1e-4, 0.5 * st["nu_pen"])
            if qv is not None:
                # the ContForm sweep already integrated the stage quadrature
                # at this point: no second cost rollout (JAX riccati.py:1883-1888)
                cost0 = sf * qv.sum(1) + v_cost_N(X[:, N], pN)
            else:
                cost0 = total_cost(X, U)
            psi0 = cost0 - mu * bar_of(Z) + nu_pen * c_norm
            slack_tol = 10.0 * torch.finfo(dtype).eps * (psi0.abs() + 1.0)

            if ls_adaptive:
                # the rollout-free step controller: the cap quarters when the
                # merit rose over the last iteration, and resets on a decrease
                psi0_c = torch.where(torch.isnan(psi0), inf, psi0)
                increased = (~torch.isfinite(psi0_c)) | (psi0_c > st["psi_prev"] + slack_tol)
                acap_n = torch.where(increased,
                                     torch.clamp(st["acap"] * 0.25, min=0.5 ** _MAX_BACKTRACK),
                                     torch.ones_like(psi0))
                alpha = alpha_max * acap_n
                accepted = torch.ones_like(solvable)
                psi_keep = psi0_c
            else:
                alpha, accepted = line_search(
                    X, U, S, Z, dX, dU, dS, dZ, q, g_extra, pN_g, bgS, mu, nu_pen, psi0,
                    c_norm, slack_tol, alpha_max, st["kkt0"] < 1e-5, (r_d, r_i, r_T, r_h))
                acap_n, psi_keep = st["acap"], st["psi_prev"]
            alpha = torch.where(solvable, alpha, torch.zeros_like(psi0))
            delta = st["delta"]
            if parallel:
                delta_kept = torch.clamp(delta / 2.0, min=delta_floor)
            else:
                delta_kept = torch.clamp(delta / 2.0, min=0.0) * (delta > 1e-9)
            delta_n = torch.where(solvable, delta_kept, torch.clamp(delta * 10.0, min=1e-5))

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

            if opts.debug:
                debug_lines(
                    "it={it} mu={mu:.2e} a={a:.2e} amax={am:.2e} acc={acc} slv={slv} "
                    "|dX|={ndx:.2e} |dU|={ndu:.2e} nupen={np:.2e} psi0={p0:.3e} "
                    "kkt={k:.3e} feas={f:.2e} done={d}",
                    it=st["it"], mu=mu, a=alpha, am=alpha_max, acc=accepted, slv=solvable,
                    ndx=dX.abs().flatten(1).amax(1), ndu=dU.abs().flatten(1).amax(1),
                    np=nu_pen, p0=psi0, k=e_0, f=feas, d=done_now)

            new = dict(X=X_n, U=U_n, S=S_n, lam=lam + a_x * dlam,
                       nus=nus + a_x * dnu, zl=zl_n, zu=zu_n, mu=mu,
                       xi=xi + _lane(alpha, xi) * (xi_new - xi),
                       mu_h=mu_h + a_x * (mu_h_new - mu_h),
                       nu_pen=nu_pen, delta=delta_n, it=st["it"] + 1,
                       done=torch.zeros_like(st["done"]), kkt0=e_0, feas=feas,
                       psi_prev=psi_keep, acap=acap_n,
                       bX=bX_n, bU=bU_n, bS=bS_n, bkkt=bkkt_n, bfeas=bfeas_n)
            # a lane that converged at this point keeps its iterate
            stay = dict(st, done=torch.ones_like(st["done"]), kkt0=e_0, feas=feas,
                        bX=bX_n, bU=bU_n, bS=bS_n, bkkt=bkkt_n, bfeas=bfeas_n)
            return {k: torch.where(_lane(done_now, new[k]), stay[k], new[k])
                    for k in new}

        def line_search(X, U, S, Z, dX, dU, dS, dZ, q, g_extra, pN_g, bgS, mu, nu_pen,
                        psi0, c_norm, slack_tol, alpha_max, near_opt, res0):
            """The step of ls_mode='backtrack' (JAX riccati.py:1925-1991): the
            first alpha_max 0.5^e(j), e(j) = j + max(j - 4, 0), j < 12, whose
            trial point lowers the merit enough (Armijo), or, where the merit
            overflowed, the residuals by 1%; alpha_max 0.5^20 when none does,
            alpha_max at once near the optimum.  Returns (alpha, accepted)."""
            # the a = 0 point's residuals are those of the sweep: no rollout
            c_norm_capped = capped(*res0)
            psi0_finite = torch.isfinite(psi0)
            dphi = (lane_sum((q - g_extra) * torch.cat([dX[:, :N], dU], dim=-1))
                    + (pN_g * dX[:, N]).sum(-1) - lane_sum(bgS * dS))
            dpsi = dphi - nu_pen * c_norm

            def trial_ok(a):
                """Whether each trial step a (n_t, B) is accepted: one
                residual rollout of every (trial, lane) at once, flattened to
                n_t * B lanes (reductions per lane, so that a trial's outcome
                is the same whether it is evaluated alone or with others)."""
                n_t = a.shape[0]

                def rep(v):
                    return v if n_t == 1 else v.repeat((n_t,) + (1,) * (v.dim() - 1))

                a_l = a.reshape(n_t * Bsz)
                aX = a_l[:, None, None]
                Xt = torch.cat([rep(X[:, :1]), rep(X[:, 1:]) + aX * rep(dX[:, 1:])], 1)
                Ut = rep(U) + aX * rep(dU)
                St = rep(S) + aX * rep(dS)
                pk_t = {k: rep(v) for k, v in pk.items()}
                pN_t = {k: rep(v) for k, v in pN.items()}
                r_t = residuals(Xt, Ut, St, pk_t, rep(tc_tgt) if termcons else None)
                mer = (total_cost(Xt, Ut, pk_t, pN_t) - rep(mu) * bar_of(rep(Z) + aX * rep(dZ))
                       + rep(nu_pen) * (lane_sum(r_t[0].abs()) + lane_sum(r_t[1].abs())
                                        + lane_sum(r_t[2].abs()) + lane_sum(r_t[3].abs())))
                ok_merit = mer <= rep(psi0) + _ETA_LS * a_l * rep(dpsi) + rep(slack_tol)
                ok_resto = capped(*r_t) <= 0.99 * rep(c_norm_capped)
                return torch.where(rep(psi0_finite), ok_merit, ok_resto).reshape(n_t, Bsz)

            fallback = alpha_max * 0.5 ** _MAX_BACKTRACK
            if ls_parallel:
                # every trial in one batched rollout of (_LS_TRIPS, B) lanes;
                # the step is the first acceptable one, as the sequential
                # loop's (JAX riccati.py:1962-1984)
                alphas = alpha_max[None] * torch.tensor(
                    [0.5 ** _ls_exp(j) for j in range(_LS_TRIPS)], **kw)[:, None]
                oks = trial_ok(alphas)
                any_ok = oks.any(0)
                first = alphas.gather(0, oks.to(torch.uint8).argmax(0)[None])[0]
                return (torch.where(near_opt, alpha_max,
                                    torch.where(any_ok, first, fallback)),
                        any_ok | near_opt)
            # the trips of JAX's while loop under vmap: every lane's trial at
            # once, a lane's alpha fixed when it is accepted; the loop ends
            # when every lane is, after at most _LS_TRIPS trips, at one host
            # synchronisation a trip (so up to _LS_TRIPS more a pass)
            accepted = near_opt.clone()
            alpha = alpha_max.clone()
            for j in range(_LS_TRIPS):
                if bool(accepted.all()):
                    break
                a = alpha_max * 0.5 ** _ls_exp(j)
                searching = ~accepted
                alpha = torch.where(searching, a, alpha)
                accepted = accepted | (searching & trial_ok(a[None])[0])
            return torch.where(accepted, alpha, fallback), accepted

        it_cap = opts.max_iter if max_iter is None else int(max_iter)
        while True:
            active = (~st["done"]) & (st["it"] < it_cap)
            if not bool(active.any()):       # one host sync per loop pass
                break
            sw = sweep(st)
            cand = ipm_step(st, *sw)
            # stale-derivative sub-steps (sweep_every = K > 1, JAX riccati.py:
            # 2043-2061): K-1 modified-Newton steps that reuse H, A, B, E and
            # Cz with re-evaluated values and cost gradients; a lane done or
            # at the cap passes through
            H, _, A, Bm, E, _, _, Cz = sw[:8]
            for _ in range(sweep_every - 1):
                gc2, ival2, dval2, hval2 = values(cand)
                nxt = ipm_step(cand, H, gc2, A, Bm, E, ival2, dval2, Cz, hval2, None)
                hold = cand["done"] | (cand["it"] >= it_cap)
                cand = {k: torch.where(_lane(hold, v), v, nxt[k]) for k, v in cand.items()}
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
