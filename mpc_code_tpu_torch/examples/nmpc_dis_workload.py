"""Batched quadruple-tank discrete NMPC controller solves (Ex_NMPC_dis).

Per scenario lane, through the port's entry points: the steady-state
target NLP (``ocp/target.py``, DUssForm: ``du = us - us_prev``) by the
dense IPM (``solver/ipm.py``), then a cold solve of the structured OCP at
that target by the structured IPM with the Gauss-Newton Hessian.  The OCP
carries u_{k-1} in the state (nxa = nx + nu = 8) for its Delta-u rows and
its Delta-u stage cost, and its derivative sweep is the discrete map's
stage-Jacobian kernel (``ops/sweep_map_cuda.py``).  The OCP runs in the
lanes' dtype; the target is solved in TARGET_DTYPE = float64 whatever the
lanes' dtype: in float32 the dense IPM (the JAX package's too, iteration
for iteration) creeps towards this target at about 10% a step and stops
at the cap of 30 far from it, since Sss = 0 leaves the cost without
curvature in x and u.  The configuration is ``examples/nmpc_dis.py``
at its full width: nx=6, nu=2, ny=nd=2, N=50, h=5, the map's own RK4 with
Mx=5, ni = ny + nu = 4.

Lanes are drawn from ``seed``, one row per lane (so the first k lanes of
any batch are the same), from these boxes:
- tank levels 1-2 uniform on LEVEL12_LO..LEVEL12_HI = [6, 14]^2 and
  tanks 3-4 on LEVEL34_LO..LEVEL34_HI = [0.5, 3]^2, around the example's
  x0 = [.., 12.0, 12.19, 1.51, 1.42];
- the previous input u_{-1} uniform on UM1_LO..UM1_HI = [30, 50]^2,
  around u0 = [39.58, 38.15], and the previous target input ``us_prev``
  equal to it; the valve states x0[0:2] equal it too, since the map copies
  u into them;
- the output-disturbance estimate uniform on D_LO..D_HI = [-0.5, 0.5]^2;
- the setpoint: lane i takes entry i mod 7 of ``defSP``'s program
  (SP_TIMES), and its time t.
The OCP starts from X tiled with [x0; u_{-1}] and U tiled with the lane's
target input.

    prob = make_problem(device)
    lanes = draw_lanes(16384, device)
    out = run_pipeline(prob, lanes)
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import MPCConfig, SolverOptions
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.nmpc_dis import defSP, make_config
from mpc_code_tpu_torch.models import (
    build_model, build_ss_cost, build_stage_cost, build_terminal_cost,
)
from mpc_code_tpu_torch.models.model import ModelFns
from mpc_code_tpu_torch.ocp.target import TargetSpec, build_target
from mpc_code_tpu_torch.solver.ipm import make_solver
from mpc_code_tpu_torch.solver.nlp import STATUS_INFEASIBLE
from mpc_code_tpu_torch.solver.riccati import (
    StructuredOCP, build_structured_ocp, make_structured_solver,
)

N = 50
LEVEL12_LO, LEVEL12_HI = np.array([6.0, 6.0]), np.array([14.0, 14.0])
LEVEL34_LO, LEVEL34_HI = np.array([0.5, 0.5]), np.array([3.0, 3.0])
UM1_LO, UM1_HI = np.array([30.0, 30.0]), np.array([50.0, 50.0])
D_LO, D_HI = np.array([-0.5, -0.5]), np.array([0.5, 0.5])
# one time inside each of the 7 pieces of defSP's setpoint program
SP_TIMES = (0.0, 1000.0, 2000.0, 3000.0, 4000.0, 5000.0, 6000.0)
U_BOX = np.array([100.0, 100.0])  # width of the input bounds [0, 100]
# the workload's solver options: single-precision tolerances, cap 30
TARGET_OPTS = SolverOptions.for_f32()
TARGET_DTYPE = torch.float64
OCP_OPTS = SolverOptions.for_f32(max_iter=30, hessian="gauss_newton")


class Problem(NamedTuple):
    cfg: MPCConfig
    model: ModelFns
    tspec: TargetSpec
    target_solve: Callable
    socp: StructuredOCP
    ocp_solve: Callable
    device: torch.device


class Lanes(NamedTuple):
    """Per-lane inputs of one controller step, each with a leading B."""
    x0: torch.Tensor     # (B, nx) state estimate
    d: torch.Tensor      # (B, nd) disturbance estimate
    um1: torch.Tensor    # (B, nu) previous input u_{-1}
    us_prev: torch.Tensor  # (B, nu) previous target input (DUssForm)
    t: torch.Tensor      # (B,) time
    ysp: torch.Tensor    # (B, ny) setpoints
    usp: torch.Tensor    # (B, nu)
    xsp: torch.Tensor    # (B, nx)

    def to(self, *args, **kw):
        return Lanes(*[a.to(*args, **kw) for a in self])


def make_problem(device=None, Nh=N, target_opts=TARGET_OPTS,
                 ocp_opts=OCP_OPTS) -> Problem:
    """The Ex_NMPC_dis target and OCP solvers on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    cfg = make_config().replace(N=Nh)
    model = build_model(cfg)
    tspec = build_target(cfg, model, build_ss_cost(cfg.ss_cost))
    socp = build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device=dev)
    return Problem(cfg, model, tspec, make_solver(tspec.nlp, target_opts), socp,
                   make_structured_solver(socp, ocp_opts), dev)


def setpoints(ts, dtype=torch.float64, device="cpu"):
    """``defSP`` at each time of ``ts``: (ysp, usp, xsp) with a leading B."""
    sp = [defSP(float(t)) for t in ts]
    return tuple(torch.as_tensor(np.stack([s[i] for s in sp]), dtype=dtype,
                                 device=device) for i in range(3))


def draw_lanes(batch, device=None, seed=0, dtype=torch.float32) -> Lanes:
    """The lanes drawn from the boxes with ``seed``, one row per lane,
    rounded to f32 so that every dtype sees the same lanes."""
    lo = np.concatenate([LEVEL12_LO, LEVEL34_LO, UM1_LO, D_LO])
    hi = np.concatenate([LEVEL12_HI, LEVEL34_HI, UM1_HI, D_HI])
    rows = np.random.default_rng(seed).uniform(lo, hi, size=(batch, 8))
    rows = rows.astype(np.float32).astype(np.float64)
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    um1 = rows[:, 4:6]
    x0 = np.concatenate([um1, rows[:, 0:4]], 1)
    ts = np.array([SP_TIMES[i % len(SP_TIMES)] for i in range(batch)])
    ysp, usp, xsp = setpoints(ts, **kw)
    return Lanes(torch.as_tensor(x0, **kw), torch.as_tensor(rows[:, 6:8], **kw),
                 torch.as_tensor(um1, **kw), torch.as_tensor(um1, **kw),
                 torch.as_tensor(ts, **kw), ysp, usp, xsp)


def solve_targets(prob: Problem, lanes: Lanes):
    """The steady-state target of every lane: ``(xs, us, result)``, from
    the closed loop's cold guess (x0_m, u0), solved in TARGET_DTYPE; xs and
    us come back in the lanes' dtype.  A lane whose target solve is
    infeasible keeps (x0_m, u0), as the JAX loop keeps its carried
    target."""
    cfg, model = prob.cfg, prob.model
    dtype = lanes.x0.dtype
    lanes = lanes.to(TARGET_DTYPE)
    d = lanes.d
    kw = dict(dtype=d.dtype, device=d.device)
    Bsz = d.shape[0]
    nx, nu, ny = cfg.nx, cfg.nu, cfg.ny
    x0_m = torch.as_tensor(np.asarray(cfg.x0_m, float), **kw)
    u0 = torch.as_tensor(np.asarray(cfg.u0, float), **kw)
    zeros = lambda *s: torch.zeros((Bsz,) + s, **kw)  # noqa: E731
    par = dict(usp=lanes.usp, ysp=lanes.ysp, xsp=lanes.xsp, d=d,
               us_prev=lanes.us_prev, lam=zeros(ny, nu), t=lanes.t,
               px=zeros(cfg.npx), py=zeros(cfg.npy))
    y0 = vmap(lambda dd: model.fy(x0_m, u0, dd, 0.0, torch.zeros(cfg.npy, **kw)))(d)
    w0 = torch.cat([x0_m.expand(Bsz, nx), u0.expand(Bsz, nu), y0], 1)
    ts = prob.tspec
    r = prob.target_solve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)
    ok = (r.status != STATUS_INFEASIBLE)[:, None]
    xs = torch.where(ok, r.w[:, :nx], x0_m)
    us = torch.where(ok, r.w[:, nx:nx + nu], u0)
    return xs.to(dtype), us.to(dtype), r


def ocp_params(cfg, lanes: Lanes, xs, us):
    kw = dict(dtype=xs.dtype, device=xs.device)
    return dict(x0=lanes.x0, xs=xs, us=us, d=lanes.d, um1=lanes.um1, t=lanes.t,
                lam=torch.zeros((cfg.ny, cfg.nu), **kw),
                px=torch.zeros((cfg.N, cfg.npx), **kw),
                py=torch.zeros((cfg.N, cfg.npy), **kw))


def solve_ocps(prob: Problem, lanes: Lanes, xs, us):
    """Cold solves of the Delta-u OCP at each lane's target, from X tiled
    with [x0; u_{-1}] and U tiled with the target input."""
    Nh = prob.cfg.N
    x0a = torch.cat([lanes.x0, lanes.um1], 1)
    X0 = x0a[:, None].expand(-1, Nh + 1, -1)
    U0 = us[:, None].expand(-1, Nh, -1)
    return prob.ocp_solve(ocp_params(prob.cfg, lanes, xs, us), X0, U0)


def run_pipeline(prob: Problem, lanes: Lanes) -> dict:
    """Targets, then OCPs, for a batch of lanes.  Returns numpy per-lane
    results and the phases' host times (each ends in a device sync)."""
    dev = lanes.x0.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    xs, us, rt = solve_targets(prob, lanes)
    sync()
    t1 = time.perf_counter()
    r = solve_ocps(prob, lanes, xs, us)
    sync()
    t2 = time.perf_counter()
    out = {k: v.cpu().numpy() for k, v in dict(
        xs=xs, us=us, target_status=rt.status, target_iters=rt.iters,
        status=r.status, iters=r.iters, kkt=r.kkt_err, feas=r.feas_err,
        U=r.U, X=r.X).items()}
    out["times"] = dict(target_s=t1 - t0, ocp_s=t2 - t1,
                        total_s=time.perf_counter() - t0)
    return out
