"""The bench workload of ``bench.py`` through the port's entry points.

Batched cold solves of the CSTR NMPC OCP (``examples/nmpc.py``, N=50, RK4
Mx=10, the bench's saturation guard, ``bench.py:81-84``) by the structured
solver with the Gauss-Newton Hessian (or, with ``hessian="exact"``, the
exact Lagrangian Hessian, as ``bench.py:100`` runs under
``BENCH_HESS=exact``), by default the monotone barrier, the adaptive
line search and ``track_best``.  The pipeline is ``bench.py:236-295``: a
forward-simulated warm start, pass 1 at a cap of 12 iterations, then one
combined steady/coolhold rescue call at cap 40 for the lanes that failed.

    cfg, model, socp, solve = make_problem(device)
    x0s = draw_x0(16384, device)
    status, iters, feas, kkt, U, times = run_pipeline(cfg, model, solve, x0s)

The solver options that ``bench.py:95-120`` reads from its ``BENCH_*``
variables are ``make_problem``'s arguments: ``parallel`` (the
associative-scan Riccati), the pass-1 ``mu_strategy``, ``ls_mode``,
``ls_parallel``, ``sweep_every`` and ``dual_init``.  The rescue always
runs the monotone barrier: with another pass-1 strategy ``make_problem``
builds it a second solver, as ``bench.py:111-120`` does.

Config overrides drive the same workload through other transcriptions of
the same OCP: ``make_problem(device, Collocation=True)`` (the tracking
cost handed over as the collocation form's ``f_coll``),
``make_problem(device, slacks=True, Ws=10 * np.eye(4))`` (soft output
bounds; ``run_pipeline(..., ns=socp.ns)`` pads the warm start's slack
slots) or ``TermCons=True``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import SolverOptions, StageCost
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.nmpc import make_config
from mpc_code_tpu_torch.models import (
    build_model, build_stage_cost, build_terminal_cost,
)
from mpc_code_tpu_torch.models.costs import xQx
from mpc_code_tpu_torch.solver.riccati import (
    build_structured_ocp, make_structured_solver,
)

N, MX = 50, 10
MAXIT1, MAXIT_R, RESCUE_CAP = 12, 40, 512
XLO = np.array([0.3, 318.0, 0.55])  # sampled operating region (bench.py:301-302)
XHI = np.array([0.95, 340.0, 0.70])
X_SS = np.array([0.874317, 325.0, 0.6528])
U_SS = np.array([300.157, 0.1])
U_COOL = np.array([295.0, 0.1])
D_NOM = np.array([0.0, 0.1])
CLIP_LO = np.array([0.0, 280.0, 0.4])
CLIP_HI = np.array([2.0, 420.0, 1.0])
U_BOX = np.array([305.0 - 295.0, 0.25])   # width of the input bounds


class PipelineSolve:
    """The pipeline's two solvers: calling it runs pass 1's; ``rescue`` is
    the rescue calls' (pass 1's own when it is monotone)."""

    def __init__(self, solve, rescue):
        self.solve, self.rescue = solve, rescue

    def __call__(self, *args, **kwargs):
        return self.solve(*args, **kwargs)


def make_problem(device=None, Nh=N, Mx=MX, hessian="gauss_newton", parallel=False,
                 mu_strategy="monotone", ls_mode="adaptive", ls_parallel=False,
                 sweep_every=1, dual_init="zero", batch_hint=None, impl=None,
                 **overrides):
    """``(cfg, model, socp, solve)`` for the bench configuration on
    ``device`` (default the card), with the OCP Hessian ``hessian``, the
    solver options ``parallel``, ``mu_strategy`` (pass 1's), ``ls_mode``,
    ``ls_parallel``, ``sweep_every`` and ``dual_init`` (``SolverOptions``'s
    fields), and the config fields ``overrides``.  ``batch_hint`` reaches
    ``build_structured_ocp`` (the sweep autotune under
    ``MPC_TPU_SWEEP_AUTOTUNE=1``); ``impl`` (default the OCP's
    ``sweep_impl``) is the solvers' Gauss-Newton route, 'split' or
    'fused'.  ``solve`` is a
    ``PipelineSolve``.  With ``Collocation=True`` the config's tracking
    cost 0.5 (dx'Q dx + du'R du) becomes the collocation form's ``f_coll``,
    which leaves its stage-state argument unused."""
    cfg = make_config().replace(N=Nh, R_wn=None, **overrides)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, Mx=Mx, clip_lo=CLIP_LO.astype(np.float32),
        clip_hi=CLIP_HI.astype(np.float32)))
    if cfg.Collocation:
        Q, R = cfg.stage_cost.Q, cfg.stage_cost.R

        def f_coll(x, u, y, xs, us, ys, s_coll):
            return 0.5 * (xQx(x, Q) + xQx(u, R))

        cfg = cfg.replace(stage_cost=StageCost(f_coll=f_coll))
    model = build_model(cfg)
    socp = build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device=device,
                                batch_hint=batch_hint)

    def solver(mu):
        return make_structured_solver(socp, SolverOptions(
            max_iter=MAXIT_R, tol=1e-3, constr_viol_tol=1e-3, mu_init=1e-1,
            hessian=hessian, mu_strategy=mu, ls_mode=ls_mode, ls_parallel=ls_parallel,
            sweep_every=sweep_every, dual_init=dual_init, track_best=True),
            parallel=parallel, impl=impl)

    solve = solver(mu_strategy)
    rescue = solve if mu_strategy == "monotone" else solver("monotone")
    return cfg, model, socp, PipelineSolve(solve, rescue)


def draw_x0(batch, device=None, seed=0, dtype=torch.float32):
    """The bench's initial states: ``batch`` draws from the operating box
    with ``seed``, rounded to f32 as ``bench.py`` draws them."""
    x0 = np.random.default_rng(seed).uniform(XLO, XHI, size=(batch, 3))
    return torch.as_tensor(x0.astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def bench_params(cfg, x0s, Nh=N):
    """The solver's parameters for the bench: setpoint, nominal
    disturbance, no parameter perturbations."""
    return dict(x0=x0s, xs=X_SS, us=U_SS, d=D_NOM, um1=U_SS, t=0.0,
                lam=np.zeros((cfg.ny, cfg.nu)), px=np.zeros((Nh, cfg.npx)),
                py=np.zeros((Nh, cfg.npy)))


def warm_start(cfg, model, x0, u_ws, Nh=N):
    """Forward-simulated warm start clipped into the box, frozen on
    overflow (bench.py:152-163), for a batch of lanes."""
    kw = dict(dtype=x0.dtype, device=x0.device)
    d = torch.as_tensor(D_NOM, **kw)
    px0 = torch.zeros(cfg.npx, **kw)
    lo = torch.as_tensor(np.asarray(cfg.bounds.xmin, float), **kw)
    hi = torch.as_tensor(np.asarray(cfg.bounds.xmax, float), **kw)
    step = vmap(lambda x, u: model.fx(x, u, cfg.h, d, 0.0, px0))
    xs, x = [x0], x0
    for _ in range(Nh):
        xn = torch.minimum(torch.maximum(step(x, u_ws), lo), hi)
        xn = torch.where(torch.isfinite(xn), xn, x)
        xs.append(xn)
        x = xn
    return torch.stack(xs, 1), u_ws[:, None].expand(-1, Nh, -1).contiguous()


def run_pipeline(cfg, model, solve, x0s, rescue_cap=RESCUE_CAP, Nh=N, ns=0, nup=0):
    """Pass 1 at cap MAXIT1, then one combined steady/coolhold rescue call
    per ``rescue_cap`` failed lanes at cap MAXIT_R
    (bench.py:236-295).  ``solve`` runs pass 1, and its ``rescue``, where
    it has one (a ``PipelineSolve``), the rescue calls.  Returns numpy
    status, iters, feas, kkt, U (the model's inputs) and the per-phase
    host times.  ``ns``: the OCP's
    shared slacks (``socp.ns``), whose state and input slots the warm
    start fills with 0; ``nup``: its u_prev slots (``socp.nxa - cfg.nx -
    socp.ns``, under DUForm or Delta-u bounds), which it fills with the
    warm start's input."""
    dev, dtype = x0s.device, x0s.dtype
    kw = dict(dtype=dtype, device=dev)
    nx, nu = cfg.nx, cfg.nu

    def guess(x0, u_ws):
        X0, U0 = warm_start(cfg, model, x0, u_ws, Nh)
        if nup:
            X0 = torch.cat([X0, u_ws[:, None].expand(-1, Nh + 1, -1)], -1)
        if ns:
            X0 = torch.nn.functional.pad(X0, (0, ns))
            U0 = torch.nn.functional.pad(U0, (0, ns))
        return X0, U0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rescue = getattr(solve, "rescue", solve)
    times = {}
    t0 = time.perf_counter()
    nb = x0s.shape[0]
    X0, U0 = guess(x0s, torch.as_tensor(U_SS, **kw).expand(nb, nu))
    sync()
    t1 = time.perf_counter()
    r = solve(bench_params(cfg, x0s, Nh), X0, U0, max_iter=MAXIT1)
    sync()
    t2 = time.perf_counter()
    status = r.status.cpu().numpy().copy()
    iters = r.iters.cpu().numpy().copy()
    feas = r.feas_err.cpu().numpy().copy()
    kkt = r.kkt_err.cpu().numpy().copy()
    U = r.U[..., :nu].cpu().numpy().copy()
    t3 = time.perf_counter()
    times.update(warm_start_s=t1 - t0, pass1_s=t2 - t1, fetch_s=t3 - t2)
    bad = np.where(status == 2)[0]
    x0_np = x0s.cpu().numpy()
    n_calls = 0
    for i0 in range(0, len(bad), rescue_cap):
        # rows [0, cap) start from the steady input, [cap, 2 cap) from the
        # coolhold input; unused rows repeat the first failed lane
        sel = bad[i0:i0 + rescue_cap]
        n = len(sel)
        xr = np.repeat(x0_np[sel[:1]], 2 * rescue_cap, axis=0)
        xr[:n] = x0_np[sel]
        xr[rescue_cap:rescue_cap + n] = x0_np[sel]
        uw = np.repeat(np.stack([U_SS, U_COOL]), rescue_cap, axis=0)
        xr_t = torch.as_tensor(xr, **kw)
        X0r, U0r = guess(xr_t, torch.as_tensor(uw, **kw))
        rr = rescue(bench_params(cfg, xr_t, Nh), X0r, U0r, max_iter=MAXIT_R)
        s2 = np.stack([rr.status.cpu().numpy(), rr.iters.cpu().numpy(),
                       rr.feas_err.cpu().numpy(), rr.kkt_err.cpu().numpy()], 1)
        U2 = rr.U[..., :nu].cpu().numpy()
        st_s, st_c = s2[:n], s2[rescue_cap:rescue_cap + n]
        use_s = st_s[:, 0] != 2
        pick = np.where(use_s[:, None], st_s, st_c)
        status[sel] = pick[:, 0].astype(status.dtype)
        feas[sel] = pick[:, 2]
        kkt[sel] = pick[:, 3]
        U[sel] = np.where(use_s[:, None, None], U2[:n],
                          U2[rescue_cap:rescue_cap + n])
        iters[sel] = (iters[sel] + st_s[:, 1].astype(iters.dtype)
                      + np.where(use_s, 0, st_c[:, 1]).astype(iters.dtype))
        n_calls += 1
    sync()
    times["rescue_s"] = time.perf_counter() - t3
    times["rescue_calls"] = n_calls
    times["rescue_lanes"] = int(len(bad))
    times["total_s"] = time.perf_counter() - t0
    return status, iters, feas, kkt, U, times
