"""Batched economic NMPC controller solves (Ex_ENMPC) through the port's entry points.

Per scenario lane: the economic steady-state target NLP (``ocp/target.py``)
by the dense IPM (``solver/ipm.py``), then a cold solve of the ContForm OCP
at that target by the structured IPM with the Gauss-Newton Hessian, whose
derivative sweep is the joint dynamics-and-quadrature kernel
(``ops/sweep_cf_cuda.py``).  The configuration is ``examples/enmpc.py`` at
its full width: nx=2, nu=1, ny=nd=2, N=25, h=2.0, Mx=10.

Lanes are drawn from ``seed``: the initial state uniform on the box
X0_LO..X0_HI around the example's plant and model initial states
(x0_p = [0.9, 0.1], x0_m = [1.2, 0.5]), and the output-disturbance estimate
uniform on D_LO..D_HI, so each lane has its own economic target.  The OCP
starts from X tiled with x0 and U tiled with the lane's target input.

    prob = make_problem(device)
    lanes = draw_lanes(16384, device)
    out = run_pipeline(prob, lanes)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import MPCConfig, SolverOptions
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.enmpc import make_config
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

N, MX = 25, 10
X0_LO = np.array([0.5, 0.1])      # initial-state box around x0_p / x0_m
X0_HI = np.array([1.2, 0.6])
D_LO = np.array([-0.05, -0.05])   # output-disturbance estimate box
D_HI = np.array([0.05, 0.05])
U_BOX = np.array([2.0])           # width of the input bounds [0, 2]
# the workload's solver options: single-precision tolerances, cap 30
TARGET_OPTS = SolverOptions.for_f32()
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
    x0: torch.Tensor     # (B, nx) initial state
    d: torch.Tensor      # (B, nd) output-disturbance estimate


def make_problem(device=None, Nh=N, Mx=MX, target_opts=TARGET_OPTS,
                 ocp_opts=OCP_OPTS) -> Problem:
    """The Ex_ENMPC target and OCP solvers on ``device`` (default the card)."""
    dev = resolve_device(device)
    cfg = make_config().replace(N=Nh)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, Mx=Mx))
    model = build_model(cfg)
    tspec = build_target(cfg, model, build_ss_cost(cfg.ss_cost))
    socp = build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device=dev)
    return Problem(cfg, model, tspec, make_solver(tspec.nlp, target_opts), socp,
                   make_structured_solver(socp, ocp_opts), dev)


def draw_lanes(batch, device=None, seed=0, dtype=torch.float32) -> Lanes:
    """``Lanes(x0 (B, nx), d (B, nd))`` drawn from the boxes with ``seed``, one
    row per lane (so the first k lanes of any batch are the same), rounded
    to f32 so that every dtype sees the same lanes."""
    lo, hi = np.concatenate([X0_LO, D_LO]), np.concatenate([X0_HI, D_HI])
    rows = np.random.default_rng(seed).uniform(lo, hi, size=(batch, 4))
    rows = torch.as_tensor(rows.astype(np.float32), dtype=dtype,
                           device=resolve_device(device))
    return Lanes(rows[:, :2].contiguous(), rows[:, 2:].contiguous())


def solve_targets(prob: Problem, lanes: Lanes):
    """The economic target of every lane: ``(xs, us, result)``.  A lane
    whose target solve is infeasible keeps the closed loop's initial target
    (x0_m, u0), as the JAX loop keeps its carried one."""
    cfg, model = prob.cfg, prob.model
    d = lanes.d
    kw = dict(dtype=d.dtype, device=d.device)
    Bsz = d.shape[0]
    nx, nu, ny = cfg.nx, cfg.nu, cfg.ny
    x0_m = torch.as_tensor(np.asarray(cfg.x0_m, float), **kw)
    u0 = torch.as_tensor(np.asarray(cfg.u0, float), **kw)
    zeros = lambda *s: torch.zeros((Bsz,) + s, **kw)  # noqa: E731
    par = dict(usp=zeros(nu), ysp=zeros(ny), xsp=zeros(nx), d=d,
               us_prev=u0.expand(Bsz, nu), lam=zeros(ny, nu), t=zeros(),
               px=zeros(cfg.npx), py=zeros(cfg.npy))
    y0 = vmap(lambda dd: model.fy(x0_m, u0, dd, 0.0, torch.zeros(cfg.npy, **kw)))(d)
    w0 = torch.cat([x0_m.expand(Bsz, nx), u0.expand(Bsz, nu), y0], 1)
    ts = prob.tspec
    r = prob.target_solve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)
    ok = (r.status != STATUS_INFEASIBLE)[:, None]
    xs = torch.where(ok, r.w[:, :nx], x0_m)
    us = torch.where(ok, r.w[:, nx:nx + nu], u0)
    return xs, us, r


def ocp_params(cfg, lanes: Lanes, xs, us):
    x0 = lanes.x0
    Bsz = x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    return dict(x0=x0, xs=xs, us=us, d=lanes.d,
                um1=torch.as_tensor(np.asarray(cfg.u0, float), **kw).expand(Bsz, cfg.nu),
                t=0.0, lam=torch.zeros((cfg.ny, cfg.nu), **kw),
                px=torch.zeros((cfg.N, cfg.npx), **kw),
                py=torch.zeros((cfg.N, cfg.npy), **kw))


def solve_ocps(prob: Problem, lanes: Lanes, xs, us):
    """Cold solves of the ContForm OCP at each lane's target."""
    Nh = prob.cfg.N
    X0 = lanes.x0[:, None].expand(-1, Nh + 1, -1)
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
