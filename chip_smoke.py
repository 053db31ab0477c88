#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mpc_code_tpu_torch``).

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit:

    python3 chip_smoke.py

Arguments name the phases to run, as ``PHASES`` spells them (for trying
one phase on the card): ``python3 chip_smoke.py lmpc_loop clb``.

It never imports JAX or the JAX package.  Phases:

1. the card's name and power limit (nvidia-smi), then builds the CUDA
   kernels of the seven paths from ``mpc_code_tpu_torch/csrc``, one
   ``nvcc`` each, all started together;
2. kernel phases: each kernel against its plain PyTorch version on the
   card at its path's shapes, in f64 and f32, with the normalised error
   ``|a-b|/(1+|b|)``, the kernel time, the time of the call as the solver
   makes it, the plain version's time (CUDA events) and the build's
   registers and spill bytes (ptxas): the RK4 stage-Jacobian sweep and
   the Riccati KKT solve at the CSTR path's shapes, the ContForm joint
   sweep and the Riccati KKT solve at the ENMPC path's (N=25, nxa=2,
   nu=1), the discrete map's stage-Jacobian sweep and the Riccati KKT
   solve at the quadruple tank's (N=50, nxa=8, nu=2), the fused stage
   sweep at the exact-Hessian CSTR path's (N=50, nz=5, ni=2; the Riccati
   KKT solve has the CSTR path's shapes there) and at the exact runs' of
   phase 11 (the quadruple tank's discrete map with u_prev, N=50, nz=10,
   ni=4; ENMPC's ContForm, N=25, nz=3; the CSTR with DUForm, N=50, nz=7),
   each in its exact build and in its Gauss-Newton build, the Riccati KKT solve at the LMPC loop's
   (N=50, nxa=5, nu=2), the bench port's (N=20, nxa=3, nu=2, 1024
   lanes) and the structured MHE's (N=11, nxa=4, nu=4); the
   elementary functions: the ``elem`` ODE (every function the code
   generator lowers, lanes on JAX's special points) through kernel 1, the
   tanh map through kernel 3, Ex_ENMPC's ODE with a tanh and sigmoid
   quadrature through kernel 4, the cart-pole's kernel 1 and kernel 2 at
   (20, 4, 1), and kernel 5's exact builds of the elem OCP and the
   cart-pole; kernel 5 on Ex_ENMPC's MHE window (N=11, nz=8), the batched
   MHE's (maskable: pad lanes) in its exact and its Gauss-Newton build and
   the host MHE's in its exact build, the arrival and pad lanes held on
   their own; an f32 sweep (kernels 1, 3, 5) must also lie
   no farther from the f64 plain version than twice its f32 plain version;
   the plain versions of kernels 4 and 5 run in one block of lanes
   (``card_plain``);
3. CSTR slice phase: the bench workload through the port's entry points —
   batched cold solves of the CSTR NMPC OCP, B=16384, N=50, Mx=10, seed-0
   draws, pass-1 cap 12, one combined steady/coolhold rescue at 2x512
   lanes with cap 40 — with the launch counters read around the timed run;
   the failing lanes are checked against ``fixtures/tail_verdict.json``;
   64 lanes are cross-checked against the port's plain path on the CPU in
   f64: the card's f64 run, the main run's f32 answers and the plain path
   in f32 on the CPU (every phase's CPU runs go to two worker processes at
   the start and run beside the card's phases);
4. ENMPC slice phase: ``examples/enmpc_workload.py`` — per lane the
   economic target by the dense IPM, then a cold solve of the ContForm OCP
   at it — B=16384, N=25, Mx=10, seed-0 draws, f32, with the launch
   counters read around the timed run (each kernel once per OCP
   iteration); every failing lane re-solved on the CPU in f64 and
   classified; 64 lanes cross-checked as in phase 3, with the Riccati
   ``ok`` flags of every iteration recorded in each run;
5. quadruple-tank (nmpc_dis) slice phase: ``examples/nmpc_dis_workload.py``
   — per lane the steady-state target by the dense IPM, then a cold solve
   of the Delta-u OCP (the u_prev augmentation, nxa=8) at it — B=16384,
   N=50, seed-0 draws, f32, checked as in phase 4;
6. exact-Hessian CSTR phase (``cstr_exact``): phase 3's workload with
   ``hessian="exact"``, whose derivative sweep is the fused stage sweep
   (kernel 1 must not launch); the Riccati ``ok`` flags of a pass-1 solve
   and the lanes on which the regularisation delta rose; every failing
   lane classified infeasible by ``fixtures/tail_verdict.json`` or failing
   its re-solve on the CPU in f64 too; the 64-lane cross-check of phase 3
   against the CPU f64 exact path;
7. closed-loop phase (``cstr_loop``): ``examples/closed_loop_workload.py``
   — the warm batched CSTR NMPC closed loop (EKF, dense-IPM target in
   f64, structured OCP under Gauss-Newton warm-started from the shifted primal
   and dual solution, non-nominal plant, output noise), B=16384 lanes,
   LOOP_NSIM=2 steps, f32 — with per step the wall time, the target and
   OCP iterations, the infeasible shares, the launches of kernels 1 and 2
   (both on every step) and the share of non-finite lanes; a summary of
   the cold step 0 against the warm steps and the warm step's phase split;
   the first 64 lanes run on the card in f64 against the CPU f64 run,
   with one f32 step from each of their steps' states held against the
   f64 step (the free-running f32 lanes' drift is reported);
8. LMPC closed-loop phase (``lmpc_loop``): ``examples/lmpc_loop_workload.py``
   — the linear-model MPC on the nonlinear CSTR plant (Kalman filter,
   dense-IPM target in f64, structured OCP of the affine model with the
   u_prev rows, nxa=5, whose only kernel is the Riccati KKT solve),
   B=16384 lanes, LOOP_NSIM steps, f32 — checked as phase 7, with the
   kernel's launches equal to the OCP solver's passes on every step, and
   steps 0 and 1 replayed with their OCP under the profiler for its
   launches per pass;
9. the bench port (``clb``): ``examples/closed_loop_bench.py`` at its
   defaults (B=1024, 20 steps, cap 10), its two lines, built through
   ``make_closed_loop_runner`` with the tool's AOT key; then the mesh
   phase (``mesh``): the bench port's configuration on MESH_B lanes for
   MESH_STEPS steps through the runner on a one-rank NCCL mesh against
   the unsharded runner (statuses, iterations and U), kernel 2's launches
   against the OCP solver's passes, ``aggregate_metrics`` over NCCL
   against the host's count, and ``entry.dryrun_multichip(1)``;
10. the constrained phase (``constrained``): the bench workload of phase 3
   through three other transcriptions of the CSTR OCP, CONSTRAINED_B lanes, f32:
   Gauss-Legendre collocation condensed within each stage (kernel 2 at
   (50, 3, 2), kernels 1 and 5 idle), soft output bounds by the shared
   slacks (kernels 1 and 2, kernel 2 at (50, 7, 6), first held against its
   plain version) and the terminal equality with a stage equality (kernel
   1 and the plain constrained recursions, kernel 2 idle), with the
   solves/s, statuses, iterations and launches against the solver's
   passes; 8 lanes in f64 on the card held to the CPU's f64 run, the
   first 4 to the dense transcription on the CPU, and x_N = xs under
   TermCons; and the bordered recursion on the card against the CPU with
   and without each kind of row;
11. the solver options (``solver_options``): the bench workload of phase 3
   on OPTIONS_B lanes in f32 under its default settings and under each
   option of the structured solver (``parallel=True``, the 'adaptive' and
   'mehrotra' barriers, backtracking sequential and in one batched
   rollout, ``sweep_every=2``, costate duals), then three OCPs under the
   exact Hessian through kernel 5's builds of their forms (the nmpc_dis
   and ENMPC workloads with the examples' exact Hessian, the CSTR with
   DUForm): solves/s, ok_fraction, iterations and every
   kernel's launches against the solver's own counts; 8 lanes of each run
   in f64 on the card held to the CPU's f64 run; and the autotune run: the
   sweep autotune's probe of the two Gauss-Newton routes (kernel 1 with
   ``torch.func``, or kernel 5's Gauss-Newton build) at 16,384 lanes, its
   cache, and the winner's route with the same checks; then the debug
   phase (``debug``): ``SolverOptions(debug=True)`` on 2 lanes of the
   CSTR structured solve and one dense target solve in f64, lanes x passes
   lines, lane 0's numbers against the CPU f64 run's; then the
   cart-pole (``cartpole``): acados's pendulum on a cart (``sin``, ``cos``)
   at N=20 on CARTPOLE_B lanes in f32 under the Gauss-Newton Hessian
   (kernels 1 and 2) and the exact one (kernels 5 and 2): solves/s,
   ok_fraction, iterations, launches against the solver's passes, 8 lanes
   in f64 held to the CPU's f64 run (Gauss-Newton's after 8 passes);
12. the ENMPC flagship loop (``enmpc_loop``): ``examples/enmpc_loop_workload.py``
   — economic NMPC with the MHE ('smooth' prior update, N_mhe=10, its
   window by the structured IPM at (N, nxa, nu) = (11, 4, 4), its stage
   derivatives by kernel 5's window build), the
   economic target by the dense IPM and the ContForm OCP under
   Gauss-Newton, B=16384 lanes from step 0 (the growing-horizon warmup),
   ENMPC_NSIM steps,
   f32 throughout — checked as phase 7, with on every step kernels 2's
   and 5's launches in the MHE equal to the MHE solver's passes, kernel 2's
   in the OCP to the OCP solver's, kernel 4's equal to the OCP's passes
   (and kernel 5 not in the OCP), the non-finite
   shares of the MHE's P, x_bar, Pycondx_inv and the estimate, the last
   step (the first with the MHE's dual warm start) replayed with the MHE
   and the OCP under the profiler, and the 64-lane
   f64 check holding every MHE, target and OCP iteration and status and the
   estimate too;
13. the host loop (``host_loop``, run before phase 12 so that phase 12's
   CPU reference finishes beside it): ``loop/simulator.py::ClosedLoop`` on the
   card in f64 on ``fixtures/enmpc.npz`` (the host MHE, its window solves
   on kernels 5 and 2 at one lane) and ``fixtures/nmpc.npz`` (the EKF),
   every recorded key within the fixtures'
   1e-4, the native host core built and loaded, per step the phase times,
   iterations and statuses, kernels 2's and 5's launches in the MHE equal
   to its passes and no other launch, one host
   step under the profiler (launches, device-to-host copies), and the
   command line (``examples/__main__.py``) at Ex_ENMPC's size, its history
   file read back; the nmpc fixture and the command line each in a
   process of its own on the card, beside the ENMPC fixture (kernel 2 at
   one lane is held against its plain version in the enmpc_mhe kernel
   phase);
14. the warm hand-off (``enmpc_handoff``): the ENMPC flagship's host
   warmup (``ClosedLoop``, N_mhe + 2 = 12 steps, f32 on the card, in a
   process of its own started with phase 13) held
   against the CPU's f64 run, then ``carry_from_runtime`` into the batched
   step, B=16384 lanes for HANDOFF_T steady steps, checked as phase 12
   from the handed-off carry;
15. the AOT artifact (``aot``): two processes on the card (started with
   phase 13's), one after the other, fresh kernel build directories and
   one fresh artifact directory: the bench port's runner with
   ``aot_key="auto"``; the second loads the first's kernel library and
   runs no nvcc, its outputs bitwise equal;
16. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

The kernel phases and phase 3 run alone on the card.  From there on
three processes share it: this one (phases 4-8, 10, the debug phase and
the cart-pole),
one for phase 9 (the bench port, the mesh) and phase 11's solver options
and one for phases 13, 12, 14 and 15
(``PARTS``; each started as ``python3 chip_smoke.py --part ...`` with CPU
workers of its own), and the check lanes of phases 7 and 12 run in
processes of their own beside them.  Any failed phase exits non-zero without the last line.
With no CUDA device, or outside a checkout of the repository, it exits 2.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback
from typing import Any, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B = 16384                          # lanes of the bench and ENMPC workloads
N_CHECK = 64                       # lanes cross-checked on the CPU in f64
CPU_REF_WORKERS = 3                # processes that run the CPU cross-check paths
                                   # in each of the smoke's processes (PARTS)
CPU_REF_THREADS = 2                # torch threads in each

TOL_F64 = 1e-10
# map_stage_jac: the kernel and the plain version, each in f32, differ by
# up to 3.608e-4 on the check's lanes: levels down to 0.5 with little
# inflow drain towards 0 inside the map, where the square root's
# derivative grows (PERF.md, kernel 3; each is also held to the plain
# version in f64 there).  stage_sweep: 4.379e-4 (in gc), while the kernel
# and the plain version, each in f32, lie 4.267e-3 from the plain version
# in f64, to the digit: f32 rounding of the second-order tangents through
# the exponential, not the kernel (PERF.md, kernel 5)
TOL_F32 = {"rk4_stage_jac": 1e-4, "riccati_kkt": 1e-3, "rk4_quad_stage_hess": 1e-4,
           "map_stage_jac": 1e-3, "stage_sweep": 1e-3}
# Converged U against the CPU f64 path, over the input box.  Two f64 runs
# differ only in rounding order and stop on the same iterate: U_TOL.  An f32
# run measures its KKT error with f32 rounding, and near the 1e-3 tolerance
# that decides on which iteration a lane stops.  A lane that stops on the
# same iteration as the f64 run is held to U_TOL too.  A lane that stops on
# another has taken more (or fewer) steps along a flat valley of the cost,
# and is held to U_TOL_MOVED: above the largest such move of the port's f32
# runs on these 64 lanes, on the card and on the CPU (PERF.md, section 2).
U_TOL = 1e-2
U_TOL_MOVED = 3e-2
# The exact-Hessian CSTR path (cstr_exact) keeps these rules and measures
# its own largest move: its f32 runs stop on another iteration than f64 on
# 10-12 of the 64 lanes and go further along the valley, up to 5.423e-2 of
# the box on the card and 5.408e-2 in the plain f32 path on the CPU (lane
# 8: 9-10 iterations against f64's 7; PERF.md, section 2), while the card's
# f64 run agrees with the CPU to 9.5e-14.
EXACT_U_TOL_MOVED = 6e-2
OK_FRACTION_MIN = 0.998
# The controller paths (ENMPC, nmpc_dis): converged U against the CPU f64
# path, over the input box.  A lane that stops on another iteration than
# f64 is allowed CONTROLLER_U_TOL_MOVED, a step of 1% of the box (not
# measured: no lane has; PERF.md, section 2).  Either path fails on any
# failing lane (status 2) that f64 does not share.
# ENMPC, box [0, 2]: the card's f32 answers and the CPU f32 path lie
# 3.727e-5 away on the 64 lanes and stop on the same iteration as f64 on
# every lane, the card's f64 run 1.2e-15; ENMPC_U_TOL keeps a 25x margin.
# nmpc_dis, box [0, 100] (targets in f64 on every run): 9.076e-8, the
# card's f64 run 1.1e-15; the f32 OCP stops on an iterate that f64 also
# reaches, so NMPC_DIS_U_TOL allows 100x that.
ENMPC_U_TOL = 1e-3
NMPC_DIS_U_TOL = 1e-5
CONTROLLER_U_TOL_MOVED = 1e-2
CONTROLLER_OK_FRACTION_MIN = 0.999
RESOLVE_MAX = 64                   # failing lanes re-solved on the CPU in f64
# The closed loop (cstr_loop): B lanes of the warm batched CSTR loop for
# LOOP_NSIM steps.  The card's f64 run of the check lanes against the CPU
# f64 run: equal statuses and OCP iterations at every step and U, Xp to
# LOOP_F64_TOL (normalised |a-b|/(1+|b|)).  f32 against f64, step by step:
# from each step's f64 state (cast to f32) one f32 step on the card, its U
# against the f64 step's over the input box: U_TOL, or U_TOL_MOVED where
# the OCP converged on another iteration; at most LOOP_STATUS_DIFF_MAX
# lanes may differ in OCP infeasibility at any step.  A lane-step whose f32
# OCP stopped at the cap short of the tolerance (status 1: feasible, KKT
# error above 1e-3) where f64 stopped elsewhere is reported, not held to
# a converged answer's tolerance, as the controller paths classify their
# status-1 lanes: the f32 solver stalls there at a KKT error of ~1e-3 to
# 7e-3, the JAX package's f32 solver too (PERF.md, PR 7).  The free-running f32
# trajectory is reported against the f64 one and not held to these: a
# lane's target or OCP that flips between infeasible (keep the previous
# target or input) and feasible on rounding jumps its input, and the loop
# carries that on (PERF.md, PR 7: up to 0.59 of the box by step 9, while
# every single f32 step lies within 2.1e-2 of f64 from the same state).
# 2 steps (the cold step and a warm one; 6 and then 4 before) keep the
# whole smoke, with enmpc_loop's and the host loop's phases, inside its
# time limit
LOOP_NSIM = 2
LOOP_F64_TOL = 1e-6
LOOP_STATUS_DIFF_MAX = 1
# The LMPC loop (lmpc_loop) keeps these rules with one change: its f32 OCP
# stops at the cap short of the tolerance on every feasible lane-step (the
# JAX package's f32 solver too, PERF.md section 6), so a lane-step on which
# both precisions stop at the cap unconverged is labelled feasible (1) or
# not (2) by its feasibility error at the cap; those are reported apart,
# and a lane-step that differs in infeasibility (at most
# LOOP_STATUS_DIFF_MAX a step) is not held to a U tolerance.
# The ENMPC flagship loop (enmpc_loop) keeps the closed loops' rules for
# ENMPC_NSIM steps: the traced MHE's growing-horizon warmup (steps 0-8),
# its first full window and prior update (step 9, steps >= N_mhe - 1) and
# its first dual warm start (step 10, steps >= N_mhe); the JAX tool runs
# N_mhe + 2 + 20 = 32.  Its statuses and
# iterations (MHE, target, OCP) and U, Xp and the estimate are held as
# the other loops' U and Xp; ENMPC_PROFILE_STEPS are replayed under the
# profiler.
ENMPC_NSIM = 11
ENMPC_PROFILE_STEPS = (10,)
# The host loop (host_loop): the fixtures of tools/record_fixtures.py:28-36
# through ClosedLoop on the card in f64, every recorded key within the
# fixtures' bar (tests/test_fixtures.py:37); step HOST_PROFILE_STEP of
# the ENMPC fixture (a full window) under the profiler.  The hand-off
# (enmpc_handoff): the host warmup of N_mhe + 2 steps in f32 on the card,
# then HANDOFF_T steady steps of B lanes (the JAX tool runs 20; 8, then
# 6 before).  The command line's run takes CLI_NSIM steps: both cut to
# keep the whole smoke, with the constrained phase and the mesh, debug and
# aot phases, under 1,100 s.  The
# one-lane host runs (the nmpc fixture, the command line, the hand-off's
# host warmup) and the enmpc_loop check lanes each run in a process of
# their own on the card beside the loops' part (CARD_WORKERS): each keeps
# the card busy a few per cent of the time (PERF.md section 5).
HOST_FIXTURES = (("enmpc", 8, 8, 5), ("nmpc", 10, 10, None))
FIXTURE_BAR = 1e-4
FIXTURE_KEYS = ("Xp", "Yp", "U", "XS", "US", "YS", "X_HAT", "D_HAT")
HOST_PROFILE_STEP = 6
HANDOFF_T = 4
CLI_NSIM = 1
CARD_WORKERS = 4
HANDOFF_REF_THREADS = 4            # the continuation's CPU run, alone by then
CLB_BATCH, CLB_STEPS = 1024, 20    # the bench port's defaults
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"float32": 67e12, "float64": 34e12}   # without tensor cores


def log(msg):
    print(msg, flush=True)


def ptxas_lines(build_log):
    """(dtype, line) for each register and spill line of nvcc's ``-Xptxas
    -v`` report, the dtype read from the kernel's mangled name."""
    out, dtype = [], "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            dtype = "float32" if "IfE" in line else "float64" if "IdE" in line else "?"
        elif "registers" in line or "spill" in line:
            out.append((dtype, line.strip().replace("ptxas info    : ", "")))
    return out


def ptxas_summary(build_log):
    """{dtype: "R registers, S bytes spill stores, L bytes spill loads"}
    from nvcc's ``-Xptxas -v`` report: registers and spill bytes of each
    build (of every function ptxas reports for that dtype)."""
    regs, spills = {}, {}
    for dtype, line in ptxas_lines(build_log):
        if "Used " in line:
            regs.setdefault(dtype, []).append(line.split("Used ", 1)[1].split(",")[0])
        elif "spill stores" in line:
            spills.setdefault(dtype, []).append(line.split(",", 1)[1].strip())
    return {dt: ", ".join(regs.get(dt, []) + spills.get(dt, []))
            for dt in sorted(set(regs) | set(spills))}


def nerr(a, b):
    """max |a-b| / (1+|b|) over finite reference entries."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1 + b.abs())).max()) if a.numel() else 0.0


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def sweep_inputs(dtype, device, clip_lo, clip_hi, seed=1):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import N, XHI, XLO

    rng = np.random.default_rng(seed)
    xs = rng.uniform(XLO, XHI, size=(B, N, 3))
    us = rng.uniform([295.0, 0.0], [305.0, 0.25], size=(B, N, 2))
    pxs = rng.normal(size=(B, N, 3)) * 1e-3
    t = np.zeros(B)
    h = np.full(B, 0.2)
    d = np.stack([np.zeros(B), rng.uniform(0.08, 0.12, B)], 1)
    kw = dict(dtype=dtype, device=device)
    arrs = [torch.as_tensor(a, **kw) for a in (xs, us, pxs, t, h, d)]
    # lanes whose state sits exactly on a clip bound (F1): the bounds the
    # guard applies, as the working dtype sees them
    clip_lanes = [0, 1, 2, 3]
    clip_lo = torch.as_tensor(clip_lo, **kw)
    clip_hi = torch.as_tensor(clip_hi, **kw)
    arrs[0][0, :, 1] = clip_lo[1]
    arrs[0][1, :, 0] = clip_hi[0]
    arrs[0][2, :, 2] = clip_lo[2]
    arrs[0][3, :, 1] = clip_hi[1]
    return arrs, clip_lanes


def riccati_inputs(dtype, device, nxa=3, nu=2, N=50, seed=2, batch=B):
    import torch

    rng = np.random.default_rng(seed)
    nz = nxa + nu
    M = rng.normal(size=(batch, N, nz, nz)) * 0.5
    Hs = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(nz)
    q = rng.normal(size=(batch, N, nz))
    A = 0.9 * np.eye(nxa) + 0.1 * rng.normal(size=(batch, N, nxa, nxa))
    Bm = rng.normal(size=(batch, N, nxa, nu)) * 0.5
    rd = rng.normal(size=(batch, N, nxa)) * 0.1
    MP = rng.normal(size=(batch, nxa, nxa))
    PN = MP @ np.swapaxes(MP, -1, -2) + np.eye(nxa)
    pN = rng.normal(size=(batch, nxa))
    delta = np.zeros(batch)
    # one lane with an indefinite Quu (none at one lane, the host MHE's
    # call, which is timed on a lane that factors)
    bad_lane = 7 if batch > 7 else None
    if bad_lane is not None:
        Hs[bad_lane, N - 1, nxa:, nxa:] = -1e3 * np.eye(nu)
    kw = dict(dtype=dtype, device=device)
    return ([torch.as_tensor(a, **kw) for a in (Hs, q, A, Bm, rd, PN, pN, delta)],
            bad_lane)


def kernel_phase(dev, socp, results):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import MX, N
    from mpc_code_tpu_torch.ops import sweep_cuda

    failures = []
    sweep = socp.sweep
    ptx = results["rk4_stage_jac"].get("ptxas_summary", {})
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).replace("torch.", "")
        # --- kernel 1: RK4 stage-Jacobian sweep
        arrs, clip_lanes = sweep_inputs(dtype, dev, sweep.clip_lo, sweep.clip_hi)
        got = sweep(*arrs)
        ref = sweep.plain(*arrs)
        torch.cuda.synchronize()
        err = max(nerr(g, r) for g, r in zip(got, ref))
        err_clip = max(nerr(g[clip_lanes], r[clip_lanes]) for g, r in zip(got, ref))
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        # each f32 result against the plain version in f64 on the same inputs
        err64 = [0.0, 0.0]
        if dtype == torch.float32:
            ref64 = sweep.plain(*[a.double() for a in arrs])
            err64 = [max(nerr(x, r) for x, r in zip(res, ref64)) for res in (got, ref)]
            del ref64
        # the kernel alone on the (B, N, .) operands, outputs allocated once,
        # and the call as the solver makes it
        bound = sweep.bind(*arrs)
        ms = cuda_ms(lambda: sweep.fire(bound), 20)
        wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
        plain_ms = cuda_ms(lambda: sweep.plain(*arrs), 2)
        nx, nu, npx, nd = 3, 2, 3, 2
        byt = sweep_cuda.sweep_bytes(B, N, nx, nu, nd, npx, arrs[0].element_size())
        ops_lane = sweep_cuda.sweep_ops_per_lane(
            sweep.f, nx, nu, MX, sweep.clip_lo, sweep.clip_hi)
        ops = B * N * ops_lane
        t_b, t_o = byt / H100_BYTES_PER_S * 1e3, ops / H100_FLOPS[tname] * 1e3
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32["rk4_stage_jac"]
        log(f"# kernel rk4_stage_jac {tname}: max_norm_err={err:.3e} "
            f"clip_lanes={err_clip:.3e} max_abs_err={abs_err:.3e} (tol {tol:g}) "
            f"vs_plain_f64: kernel {err64[0]:.3e} plain {err64[1]:.3e} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
            f"{ops_lane} operations per lane) ptxas: {ptx.get(tname)}")
        # in f32 the kernel also lies no farther from the f64 plain version
        # than twice the f32 plain version does
        closer = err64[0] <= 2 * err64[1] + TOL_F64
        if not (err <= tol and err_clip <= tol and closer):
            failures.append(f"rk4_stage_jac {tname} error {err:.3e} > {tol:g}, against "
                            f"f64 {err64[0]:.3e} vs plain {err64[1]:.3e}")
        results["rk4_stage_jac"][tname] = dict(
            max_norm_err=err, clip_norm_err=err_clip, max_abs_err=abs_err,
            err_vs_f64=err64, ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms,
            bytes_ms=t_b, ops_ms=t_o)

        # --- kernel 2: Riccati KKT
        failures += riccati_check(dev, dtype, N, socp.nxa, socp.nu,
                                  results["riccati_kkt"])
    return failures


def riccati_check(dev, dtype, N, nxa, nu, out, batch=B):
    """Kernel 2 against its plain version at (N, nxa, nu) on ``batch``
    lanes; the numbers go into ``out[dtype name]``.  Returns the
    failures."""
    import torch

    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    tname = str(dtype).replace("torch.", "")
    ins, bad_lane = riccati_inputs(dtype, dev, nxa, nu, N, batch=batch)
    got = rk.riccati_kkt(*ins, nxa=nxa, nu=nu)
    ref = rk.riccati_ref(*ins, nxa=nxa, nu=nu)
    torch.cuda.synchronize()
    ok_g, ok_r = got[0], ref[0]
    flags_equal = bool((ok_g == ok_r).all())
    okm = ok_r & ok_g
    err = max(nerr(g[okm], r[okm]) for g, r in zip(got[1:], ref[1:]))
    abs_err = max(float((g[okm] - r[okm]).abs().max())
                  for g, r in zip(got[1:], ref[1:]))
    # the kernel alone into preallocated outputs, and the call as the
    # solver makes it (riccati.py: riccati_kkt on its (B, N, ...) tensors)
    outs = rk.empty_outputs(batch, N, nxa, nu, dtype, dev)
    ms = cuda_ms(lambda: rk.launch(ins, outs, nxa=nxa, nu=nu), 20)
    call_ms = cuda_ms(lambda: rk.riccati_kkt(*ins, nxa=nxa, nu=nu), 20)
    geo = rk.launch_geometry(N, nxa, nu, ins[0].element_size())
    plain_ms = cuda_ms(lambda: rk.riccati_ref(*ins, nxa=nxa, nu=nu), 2)
    byt = rk.riccati_bytes(batch, N, nxa, nu, ins[0].element_size())
    ops = rk.riccati_ops(batch, N, nxa, nu)
    t_b, t_o = byt / H100_BYTES_PER_S * 1e3, ops / H100_FLOPS[tname] * 1e3
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32["riccati_kkt"]
    log(f"# kernel riccati_kkt ({N}, {nxa}, {nu}) B={batch} {tname}: max_norm_err={err:.3e} "
        f"max_abs_err={abs_err:.3e} (tol {tol:g}) ok_flags_equal={flags_equal} "
        f"bad_lane_ok={bad_lane is not None and bool(ok_g[bad_lane])} "
        f"n_not_ok={int((~ok_r).sum())} "
        f"kernel_ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}) "
        f"{geo.group} threads a lane, {geo.lanes} lanes a block, ring depth "
        f"{geo.depth}, {geo.smem} B shared a block")
    out[tname] = dict(max_norm_err=err, max_abs_err=abs_err, ms=ms,
                      wrapper_ms=call_ms, plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o,
                      depth=geo.depth, smem=geo.smem)
    if not (err <= tol and flags_equal
            and (bad_lane is None or not bool(ok_g[bad_lane]))):
        return [f"riccati_kkt ({N}, {nxa}, {nu}) {tname}: err {err:.3e} "
                f"(tol {tol:g}), ok flags equal {flags_equal}"]
    return []


def cf_inputs(dtype, device, N, seed=3):
    """Inputs of the ContForm sweep at the ENMPC path's shapes: states and
    inputs over their boxes, small parameters, each lane's target near
    the economic optimum."""
    import torch

    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0.0, 1.0, size=(B, N, 2)), rng.uniform(0.0, 2.0, size=(B, N, 1)),
            rng.normal(size=(B, N, 2)) * 1e-3, rng.normal(size=(B, N, 2)) * 1e-3,
            np.zeros(B), np.full(B, 2.0), rng.uniform(-0.05, 0.05, size=(B, 2)),
            rng.uniform([0.4, 0.4], [0.6, 0.5], size=(B, 2)),
            rng.uniform(0.8, 1.3, size=(B, 1))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def enmpc_kernel_phase(dev, eprob, results):
    """Kernel 4 (the ContForm joint sweep) and kernel 2 at the ENMPC
    path's shapes, each against its plain version."""
    import torch

    from mpc_code_tpu_torch.ops import sweep_cf_cuda

    failures = []
    cfg = eprob.cfg
    sweep = eprob.socp.sweep
    dims = (cfg.nx, cfg.nu, cfg.nd, cfg.npx, cfg.npy)
    nz = cfg.nx + cfg.nu
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).replace("torch.", "")
        arrs = cf_inputs(dtype, dev, cfg.N)
        got = sweep(*arrs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()            # host-bound: seconds per call
        ref = card_plain(sweep, *arrs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [nerr(g, r) for g, r in zip(got, ref)]
        err = max(errs)
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        sym = float((got[5] - got[5].transpose(-1, -2)).abs().max())
        planes = sweep.pack(*arrs)
        ms = cuda_ms(lambda: sweep.launch_planes(planes), 20)
        wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
        byt = sweep_cf_cuda.cf_bytes(B, cfg.N, *dims, arrs[0].element_size())
        ops_lane = sweep.ops_per_lane(*dims)
        t_b = byt / H100_BYTES_PER_S * 1e3
        t_o = B * cfg.N * ops_lane / H100_FLOPS[tname] * 1e3
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32["rk4_quad_stage_hess"]
        log(f"# kernel rk4_quad_stage_hess {tname}: max_norm_err={err:.3e} per output "
            f"(xf, Jx, Ju, qv, gq, Hq) {['%.2e' % e for e in errs]} "
            f"max_abs_err={abs_err:.3e} (tol {tol:g}) Hq_asym={sym:.1e} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
            f"{ops_lane} operations per lane, {nz} tangents and "
            f"{nz * (nz + 1) // 2} second-order tangents)")
        if not (err <= tol and sym == 0.0):
            failures.append(f"rk4_quad_stage_hess {tname} error {err:.3e} > {tol:g}")
        results["rk4_quad_stage_hess"][tname] = dict(
            max_norm_err=err, max_abs_err=abs_err, ms=ms, wrapper_ms=wrap_ms,
            plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o)
        failures += riccati_check(dev, dtype, cfg.N, eprob.socp.nxa, eprob.socp.nu,
                                  results["riccati_kkt_enmpc"])
    return failures


def map_inputs(dtype, device, N, seed=4):
    """Inputs of the discrete-map sweep at the nmpc_dis path's shapes:
    valve states and inputs over [0, 100], tank levels over [0.5, 20],
    small parameters, disturbances over the lane box.  Lane 0 has a level
    exactly on the clip bound 20 (a tie, F1), lane 1 one above it, and lane
    2 an empty tank 3 with no inflow (sqrt at 0: non-finite tangents, as in
    JAX)."""
    import torch

    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.uniform(0.0, 100.0, size=(B, N, 2)),
                         rng.uniform(0.5, 20.0, size=(B, N, 4))], -1)
    us = rng.uniform(0.0, 100.0, size=(B, N, 2))
    xs[0, :, 2] = 20.0
    xs[1, :, 3] = 21.0
    xs[2, :, 4] = 0.0
    us[2, :, 1] = 0.0
    arrs = [xs, us, rng.normal(size=(B, N, 6)) * 1e-3, np.zeros(B),
            rng.uniform(-0.5, 0.5, size=(B, 2))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def nonfinite_err(got, ref):
    """(max normalised error over entries finite in both, whether the
    non-finite entries sit in the same places, lanes with any)."""
    err, same, lanes = 0.0, True, set()
    for g, r in zip(got, ref):
        fg, fr = g.isfinite(), r.isfinite()
        same = same and bool((fg == fr).all())
        lanes |= {int(i) for i in (~fr.flatten(1).all(1)).nonzero().flatten()}
        m = fg & fr
        if m.any():
            err = max(err, nerr(g[m], r[m]))
    return err, same, sorted(lanes)


def nmpc_dis_kernel_phase(dev, dprob, results):
    """Kernel 3 (the discrete map's stage-Jacobian sweep) and kernel 2 at
    the nmpc_dis path's shapes, each against its plain version."""
    import torch

    from mpc_code_tpu_torch.ops import sweep_map_cuda

    failures = []
    cfg = dprob.cfg
    sweep = dprob.socp.sweep
    nx, nu, nd, npx = cfg.nx, cfg.nu, cfg.nd, cfg.npx
    ptx = results["map_stage_jac"].get("ptxas_summary", {})
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).replace("torch.", "")
        arrs = map_inputs(dtype, dev, cfg.N)
        got = sweep(*arrs)
        ref = sweep.plain(*arrs)
        torch.cuda.synchronize()
        err, same, nf_lanes = nonfinite_err(got, ref)
        # each f32 result against the plain version in f64 on the same inputs
        ref64 = sweep.plain(*[a.double() for a in arrs])
        err64 = [nonfinite_err(r, ref64)[0] for r in (got, ref)]
        abs_err = max(float((g - r)[g.isfinite() & r.isfinite()].abs().max())
                      for g, r in zip(got, ref))
        err_tie = max(nerr(g[:2], r[:2]) for g, r in zip(got, ref))
        # the kernel alone on the (B, N, .) operands, outputs allocated once,
        # and the call as the solver makes it
        bound = sweep.bind(*arrs)
        ms = cuda_ms(lambda: sweep.fire(bound), 20)
        wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
        plain_ms = cuda_ms(lambda: sweep.plain(*arrs), 2)
        byt = sweep_map_cuda.map_bytes(B, cfg.N, nx, nu, nd, npx, arrs[0].element_size())
        ops_lane = sweep_map_cuda.map_ops_per_lane(sweep.f, nx, nu, nd, npx)
        t_b = byt / H100_BYTES_PER_S * 1e3
        t_o = B * cfg.N * ops_lane / H100_FLOPS[tname] * 1e3
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32["map_stage_jac"]
        log(f"# kernel map_stage_jac {tname}: max_norm_err={err:.3e} "
            f"tie_lanes={err_tie:.3e} max_abs_err={abs_err:.3e} (tol {tol:g}) "
            f"vs_plain_f64: kernel {err64[0]:.3e} plain {err64[1]:.3e} "
            f"nonfinite_lanes={nf_lanes} nonfinite_pattern_equal={same} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
            f"{ops_lane} operations per lane) ptxas: {ptx.get(tname)}")
        # and the kernel no farther from the f64 plain version than twice
        # the plain version in the same dtype
        closer = err64[0] <= 2 * err64[1] + TOL_F64
        if not (err <= tol and err_tie <= tol and same and closer):
            failures.append(f"map_stage_jac {tname} error {err:.3e} > {tol:g}, "
                            f"non-finite pattern equal {same}, against f64 "
                            f"{err64[0]:.3e} vs plain {err64[1]:.3e}")
        results["map_stage_jac"][tname] = dict(
            max_norm_err=err, tie_norm_err=err_tie, max_abs_err=abs_err,
            err_vs_f64=err64, nonfinite_lanes=nf_lanes, ms=ms, wrapper_ms=wrap_ms,
            plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o)
        failures += riccati_check(dev, dtype, cfg.N, dprob.socp.nxa, dprob.socp.nu,
                                  results["riccati_kkt_nmpc_dis"])
    return failures


def lmpc_kernel_phase(dev, lsocp, csocp, results):
    """Kernel 2 at the shapes of the two linear-model paths, against its
    plain version: the LMPC loop's OCP, (N, nxa, nu) = (50, 5, 2) on B
    lanes, and the bench port's, (20, 3, 2) on CLB_BATCH lanes."""
    import torch

    failures = []
    for dtype in (torch.float64, torch.float32):
        failures += riccati_check(dev, dtype, lsocp.N, lsocp.nxa, lsocp.nu,
                                  results["riccati_kkt_lmpc"])
        failures += riccati_check(dev, dtype, csocp.N, csocp.nxa, csocp.nu,
                                  results["riccati_kkt_clb"], batch=CLB_BATCH)
    return failures


def enmpc_mhe_kernel_phase(dev, msocp, results):
    """Kernel 2 at the structured MHE's shapes, (N, nxa, nu) = (11, 4, 4)
    on B lanes and on one lane (as the host MHE of host_loop calls it, at
    the example's full window, N_mhe=10), against its plain version."""
    import torch

    failures = []
    for dtype in (torch.float64, torch.float32):
        failures += riccati_check(dev, dtype, msocp.N, msocp.nxa, msocp.nu,
                                  results["riccati_kkt_enmpc_mhe"])
    for dtype in (torch.float64, torch.float32):
        failures += riccati_check(dev, dtype, msocp.N, msocp.nxa, msocp.nu,
                                  results["riccati_kkt_host_mhe"], batch=1)
    return failures


def stage_sweep_inputs(dtype, device, socp, cfg=None, seed=5):
    """Inputs of the fused stage sweep at a CSTR path's shapes: states and
    inputs over the bench's box (scaled), multipliers of the size the
    solves meet, small parameters.  With the guard (the shooting forms)
    scenario 0 has its third state on the guard's lower bound at every
    stage, 1 its first state on its lower bound and 2 its third on its
    upper bound (ties, F1); those states have unit scale, so the bound is
    exact in the working dtype.  After every other draw: with DUForm (nxa =
    5) the u_prev slots, which follow the state, drawn as the inputs are;
    the shared slacks' state and input slots over [0, 0.3]; and the stage
    equalities' multipliers (mu_h, the seventh input; zero-width without
    stage equalities)."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import N, XHI, XLO

    rng = np.random.default_rng(seed)
    low = socp.lowering
    X = rng.uniform(XLO, XHI, size=(B, N, 3)) / socp.sxa[:3]
    tie = []
    if low.clip_lo is not None:
        X[0, :, 2] = float(low.clip_lo[2])
        X[1, :, 0] = float(low.clip_lo[0])
        X[2, :, 2] = float(low.clip_hi[2])
        tie = [0, 1, 2]
    U = rng.uniform([295.0, 0.0], [305.0, 0.25], size=(B, N, 2)) / socp.su[:2]
    arrs = [X, U, rng.normal(size=(B, N, socp.nxa)), rng.normal(size=(B, N, socp.ni)) * 0.1,
            rng.normal(size=(B, N, 3)) * 1e-3, rng.normal(size=(B, N, 2)) * 1e-3,
            np.zeros(B), rng.uniform(0.5, 1.0, B),
            np.array([0.874317, 325.0, 0.6528]) + rng.normal(size=(B, 3)) * 1e-2,
            np.array([300.157, 0.1]) + rng.normal(size=(B, 2)) * 1e-3,
            np.stack([np.zeros(B), rng.uniform(0.08, 0.12, B)], 1),
            np.tile([300.157, 0.1], (B, 1)), rng.normal(size=(B, 4)) * 1e-2]
    nup = socp.nxa - 3 - socp.ns
    if nup:
        up = rng.uniform([295.0, 0.0], [305.0, 0.25], size=(B, N, 2)) / socp.sxa[3:5]
        arrs[0] = np.concatenate([X, up], -1)
    if socp.ns:
        arrs[0] = np.concatenate([arrs[0], rng.uniform(0.0, 0.3, size=(B, N, socp.ns))], -1)
        arrs[1] = np.concatenate([U, rng.uniform(0.0, 0.3, size=(B, N, socp.ns))], -1)
    arrs.insert(6, rng.normal(size=(B, N, socp.n_eq)))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], tie


def lin_sweep_inputs(dtype, device, socp, cfg, seed=9):
    """Inputs of the fused stage sweep at a linear-model path's shapes
    (the LMPC loop's affine CSTR model with u_prev, nxa = 5; the bench
    port's linear CSTR, nxa = 3): states, u_prev slots and inputs within 5%
    of the example's x0_m and u0 (scaled), multipliers of the size the
    solves meet, small parameters.  No guard, so no tie."""
    import torch

    rng = np.random.default_rng(seed)
    N, nx, nuc = socp.N, cfg.nx, socp.nu_ctrl
    x0, u0 = np.asarray(cfg.x0_m, float), np.asarray(cfg.u0, float)
    X = x0 * (1 + 0.05 * rng.normal(size=(B, N, nx)))
    if socp.nxa > nx:                  # the u_prev slots
        X = np.concatenate([X, u0 * (1 + 0.05 * rng.normal(size=(B, N, nuc)))], -1)
    U = u0 * (1 + 0.05 * rng.normal(size=(B, N, nuc)))
    arrs = [X / socp.sxa, U / socp.su, rng.normal(size=(B, N, socp.nxa)),
            rng.normal(size=(B, N, socp.ni)) * 0.1, rng.normal(size=(B, N, cfg.npx)) * 1e-3,
            rng.normal(size=(B, N, cfg.npy)) * 1e-3, rng.uniform(0.0, 1.0, B),
            rng.uniform(0.5, 1.0, B), x0 * (1 + 0.01 * rng.normal(size=(B, nx))),
            u0 * (1 + 0.01 * rng.normal(size=(B, nuc))), rng.normal(size=(B, cfg.nd)) * 1e-2,
            u0 * (1 + 0.01 * rng.normal(size=(B, nuc))),
            rng.normal(size=(B, cfg.ny * nuc)) * 1e-2]
    arrs.insert(6, np.zeros((B, socp.N, socp.n_eq)))      # mu_h
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], []


def nmpc_dis_sweep_inputs(dtype, device, socp, cfg=None, seed=6):
    """Inputs of the fused stage sweep at the quadruple tank's exact
    shapes (N=50, nxa=8, nu=2, ni=4), in the workload's boxes: valve
    states, u_prev and inputs over [30, 50], levels 1-2 over [6, 14] and
    3-4 over [0.5, 3] (with these inflows no tank drains to 0 inside the
    map), multipliers of the size the solves meet, small parameters.
    Scenario 0 has level 1 and scenario 1 level 2 exactly on the clip
    bound 20 at every stage (ties, F1; the level's scale is 20, so the
    bound is exact in the working dtype)."""
    import torch

    rng = np.random.default_rng(seed)
    N = socp.N
    x = np.concatenate([rng.uniform(30.0, 50.0, size=(B, N, 2)),
                        rng.uniform(6.0, 14.0, size=(B, N, 2)),
                        rng.uniform(0.5, 3.0, size=(B, N, 2)),
                        rng.uniform(30.0, 50.0, size=(B, N, 2))], -1)
    x[0, :, 2] = 20.0
    x[1, :, 3] = 20.0
    U = rng.uniform(30.0, 50.0, size=(B, N, 2))
    arrs = [x / socp.sxa, U / socp.su, rng.normal(size=(B, N, 8)),
            rng.normal(size=(B, N, 4)) * 0.1, rng.normal(size=(B, N, 6)) * 1e-3,
            rng.normal(size=(B, N, 2)) * 1e-3, rng.uniform(0.0, 6000.0, B),
            rng.uniform(0.5, 1.0, B), rng.uniform(5.0, 15.0, size=(B, 6)),
            rng.uniform(30.0, 50.0, size=(B, 2)), rng.uniform(-0.5, 0.5, size=(B, 2)),
            rng.uniform(30.0, 50.0, size=(B, 2)), rng.normal(size=(B, 4)) * 1e-2]
    arrs.insert(6, np.zeros((B, socp.N, socp.n_eq)))      # mu_h
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], [0, 1]


def enmpc_sweep_inputs(dtype, device, socp, cfg=None, seed=7):
    """Inputs of the fused stage sweep at the ENMPC path's exact shapes
    (ContForm, N=25, nxa=2, nu=1, ni=0): states and inputs over their
    boxes, the kernel 4 check's parameters, each lane's target near the
    economic optimum."""
    import torch

    rng = np.random.default_rng(seed)
    N = socp.N
    arrs = [rng.uniform(0.0, 1.0, size=(B, N, 2)) / socp.sxa,
            rng.uniform(0.0, 2.0, size=(B, N, 1)) / socp.su, rng.normal(size=(B, N, 2)),
            np.zeros((B, N, 0)), rng.normal(size=(B, N, 2)) * 1e-3,
            rng.normal(size=(B, N, 2)) * 1e-3, np.zeros(B), rng.uniform(0.5, 1.0, B),
            rng.uniform([0.4, 0.4], [0.6, 0.5], size=(B, 2)),
            rng.uniform(0.8, 1.3, size=(B, 1)), rng.uniform(-0.05, 0.05, size=(B, 2)),
            rng.uniform(0.8, 1.3, size=(B, 1)), rng.normal(size=(B, 2)) * 1e-2]
    arrs.insert(6, np.zeros((B, socp.N, socp.n_eq)))      # mu_h
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], []


# ---------------------------------------------------------------------------
# the elementary functions' models: ``elem`` (every function the code
# generator lowers), the tanh map and quadrature, the cart-pole
# ---------------------------------------------------------------------------


def torch_fns():
    """The functions the models below call, by name, in torch (the tests
    hand in JAX's under the same names)."""
    import types

    import torch

    return types.SimpleNamespace(
        tanh=torch.tanh, sigmoid=torch.sigmoid, sin=torch.sin, cos=torch.cos, tan=torch.tan,
        asin=torch.asin, acos=torch.acos, atan=torch.atan, atan2=torch.atan2,
        sinh=torch.sinh, cosh=torch.cosh, log1p=torch.log1p, expm1=torch.expm1,
        rsqrt=torch.rsqrt, reciprocal=torch.reciprocal, square=torch.square, sign=torch.sign,
        clamp=torch.clamp, pow=torch.pow, erf=torch.erf, stack=torch.stack)


def elem_ode(F):
    """A small ODE (nx = 3, nu = 2) whose right side calls every function
    the code generator lowers, each argument inside its domain on the
    lanes' box (x, u in [-1, 1]).  Its special points: clamp's tie at x_1
    = px_1 - 0.5 (traced bounds), sign at u_0 = 0, pow's base 0 at u_1 = 0
    (the exponent in (2, 3): finite second derivatives) and atan2's origin
    at x_2 = 0, u_0 = 0.5 (nan derivatives, as JAX's)."""
    def fx(x, u, d, t, px):
        a, s = F.tanh(x[0]), F.sigmoid(x[1])
        return F.stack([
            -0.5 * x[0] + F.sin(x[1]) * F.cos(u[0]) + 0.2 * F.asin(0.9 * a)
            + 0.1 * F.atan2(x[2], u[0] - 0.5),
            -0.3 * x[1] + 0.2 * F.acos(0.8 * (2.0 * s - 1.0)) + 0.1 * F.tan(0.5 * a)
            + 0.1 * F.atan(x[2]) + 0.05 * F.sinh(a) - 0.05 * F.cosh(0.5 * a) * F.sign(u[0]),
            -0.4 * x[2] + 0.1 * F.log1p(s) + 0.1 * F.expm1(0.5 * a)
            + 0.1 * F.rsqrt(1.0 + x[2] * x[2]) + 0.1 * F.reciprocal(2.0 + s)
            + 0.1 * F.square(u[1]) + 0.1 * F.erf(x[0])
            + 0.05 * F.clamp(x[1], min=px[1] - 0.5, max=px[0] + 0.5)
            + 0.05 * F.pow(u[1] * u[1], 2.5 + 0.5 * a) + 0.02 * 2.0 ** u[1]])
    return fx


def elem_cost(F):
    """The elem OCP's stage cost: tracking plus every function again."""
    def f_dis(x, u, y, xs, us, ys):
        dx0, dx1, dx2 = x[0] - xs[0], x[1] - xs[1], x[2] - xs[2]
        return (0.5 * (dx0 * dx0 + dx1 * dx1 + dx2 * dx2) + 0.05 * (u[0] * u[0] + u[1] * u[1])
                + 0.01 * (F.tanh(x[0]) * F.sigmoid(x[1]) + F.sin(x[2]) * F.cos(u[0])
                          + F.tan(0.5 * F.tanh(x[1])) + F.asin(0.5 * F.tanh(x[2]))
                          + F.acos(0.5 * F.sigmoid(x[0])) + F.atan(u[1])
                          + F.sinh(0.5 * F.tanh(x[0])) + F.cosh(0.3 * x[1])
                          + F.log1p(F.sigmoid(x[2])) + F.expm1(0.2 * x[0])
                          + F.rsqrt(1.0 + u[0] * u[0]) + F.reciprocal(2.0 + F.sigmoid(u[1]))
                          + F.erf(x[1]) + F.sign(x[0]) * x[1] + F.square(x[2])
                          + F.clamp(x[2], -0.5, 0.5) + F.pow(1.0 + F.sigmoid(x[0]), u[0])
                          + F.atan2(x[1], 2.0 + x[2] * x[2]) + 2.0 ** u[1]))
    return f_dis


def elem_config(cfgm, F, N=20, Mx=2):
    """The elem OCP: ``elem_ode`` (h = 0.5, RK4 at Mx sub-steps, no
    guard), ``elem_cost``, a quadratic terminal cost, |u| <= 2 (a scale of
    2, exact in either dtype) and no disturbance.  ``cfgm``: the package's
    config module."""
    return cfgm.MPCConfig(
        nx=3, nxp=3, nu=2, ny=3, nd=0, Nsim=1, N=N, h=0.5,
        model=cfgm.ContinuousModel(fx=elem_ode(F), Mx=Mx,
                                   fy=lambda x, u, d, t, py: F.stack([x[0], x[1], x[2]])),
        dist=cfgm.DisturbanceModel(offree="no"),
        x0_p=np.zeros(3), x0_m=np.zeros(3), u0=np.zeros(2),
        stage_cost=cfgm.StageCost(f_dis=elem_cost(F)),
        terminal=cfgm.TerminalCost(vfin=lambda dx, xs: 0.5 * (dx[0] * dx[0] + dx[1] * dx[1]
                                                             + dx[2] * dx[2])),
        bounds=cfgm.Bounds(umin=np.array([-2.0, -2.0]), umax=np.array([2.0, 2.0])))


def tanh_map(F):
    """The discrete map of the JAX package's own kernel-3 test
    (``tests/test_sweep_pallas.py:73``), nx = 2, nu = 1."""
    def Fmap(x, u, d, t, px):
        return F.stack([0.9 * x[0] + 0.1 * F.tanh(x[1]) + u[0],
                        x[1] - 0.2 * x[0] * u[0] + px[0] + d[0] * t])
    return Fmap


def tanh_quad(F):
    """A ContForm quadrature with tanh and sigmoid, on Ex_ENMPC's
    arguments: tracking of the target with a tanh-shaped input penalty
    and a sigmoid-weighted state term."""
    def q(x, t, u, d, px, xs, us, py):
        e0, e1 = x[0] - xs[0], x[1] - xs[1]
        return (e0 * e0 + e1 * e1) * (1.0 + F.sigmoid(4.0 * x[0] - 2.0)) \
            + 0.1 * F.tanh(u[0] - us[0]) * (u[0] - us[0])
    return q


# The cart-pole of acados's getting-started example
# (examples/acados_python/getting_started/pendulum_model.py and
# minimal_example_ocp.py): x = (p, theta, v, omega), u = F; M = 1 kg, m =
# 0.1 kg, l = 0.8 m, g = 9.81; Tf = 1 s over N = 20 intervals; |F| <= 80;
# the cost 0.5 (x'Qx + u'Ru), Q = 2 diag(1e3, 1e3, 1e-2, 1e-2), R = 2e-2,
# the terminal weight Q.  RK4 at one sub-step an interval: acados's ERK
# with 4 stages and one step (its default).  The 2,048 initial states are
# drawn with seed 0 from CARTPOLE_BOX: the pole within 0.5 rad of upright,
# the cart within 0.5 m of the origin, both rates within 0.5 (with rates of
# 1, 3% of the lanes fail under either Hessian, in f64 too).
CARTPOLE_M, CARTPOLE_m, CARTPOLE_l, CARTPOLE_g = 1.0, 0.1, 0.8, 9.81
CARTPOLE_Q = (2e3, 2e3, 2e-2, 2e-2)
CARTPOLE_R = 2e-2
CARTPOLE_FMAX = 80.0
CARTPOLE_N, CARTPOLE_TF, CARTPOLE_MX = 20, 1.0, 1
CARTPOLE_BOX = (np.array([-0.5, -0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5, 0.5]))


def cartpole_config(cfgm, F, N=CARTPOLE_N, Mx=CARTPOLE_MX):
    """The cart-pole OCP (its interval Tf / CARTPOLE_N at any N)."""
    M, m, l, g = CARTPOLE_M, CARTPOLE_m, CARTPOLE_l, CARTPOLE_g
    Q = CARTPOLE_Q

    def fx(x, u, d, t, px):
        s, c = F.sin(x[1]), F.cos(x[1])
        den = M + m - m * c * c
        return F.stack([x[2], x[3],
                        (-m * l * s * x[3] * x[3] + m * g * c * s + u[0]) / den,
                        (-m * l * c * s * x[3] * x[3] + u[0] * c + (M + m) * g * s)
                        / (l * den)])

    def vfin(dx, xs):
        return 0.5 * (Q[0] * dx[0] * dx[0] + Q[1] * dx[1] * dx[1] + Q[2] * dx[2] * dx[2]
                      + Q[3] * dx[3] * dx[3])

    return cfgm.MPCConfig(
        nx=4, nxp=4, nu=1, ny=4, nd=0, Nsim=1, N=N, h=CARTPOLE_TF / CARTPOLE_N,
        model=cfgm.ContinuousModel(fx=fx, Mx=Mx,
                                   fy=lambda x, u, d, t, py: F.stack([x[0], x[1], x[2], x[3]])),
        dist=cfgm.DisturbanceModel(offree="no"),
        x0_p=np.zeros(4), x0_m=np.zeros(4), u0=np.zeros(1),
        stage_cost=cfgm.StageCost(Q=np.diag(Q), R=np.array([[CARTPOLE_R]])),
        terminal=cfgm.TerminalCost(vfin=vfin),
        bounds=cfgm.Bounds(umin=np.array([-CARTPOLE_FMAX]), umax=np.array([CARTPOLE_FMAX])))


def cartpole_params(cfg, x0s, N):
    """The solver's parameters: the upright setpoint, no parameters."""
    B = len(x0s)
    return dict(x0=x0s, xs=np.zeros((B, 4)), us=np.zeros((B, 1)), d=np.zeros((B, 0)),
                um1=np.zeros((B, 1)), t=np.zeros(B), lam=np.zeros((B, cfg.ny, 1)),
                px=np.zeros((B, N, cfg.npx)), py=np.zeros((B, N, cfg.npy)))


def cartpole_x0(batch, seed=0):
    lo, hi = CARTPOLE_BOX
    return np.random.default_rng(seed).uniform(lo, hi, size=(batch, 4))


def structured(cfg, dev):
    """``cfg``'s structured OCP on ``dev``."""
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device=dev)


# The elementary functions' kernel checks (phase "elementary kernel"),
# 16,384 scenarios of ELEM_N stages: the elem ODE through kernel 1 (RK4 at
# ELEM_MX sub-steps), the tanh map through kernel 3, Ex_ENMPC's ODE with the
# tanh quadrature through kernel 4 (its path's N and Mx), and the cart-pole's
# Gauss-Newton route (kernel 1 of its ODE, kernel 2 at (20, 4, 1)).  The elem
# lanes 0-3 sit on the special points (``elem_ode``): lane 3's outputs are
# nan on both sides.  Kernel 5's elem build runs RK4 at one sub-step (every
# sub-step is one more inlined copy of the ODE on second-order numbers).
ELEM_N, ELEM_MX, ELEM_K5_MX = 20, 2, 1
ELEM_NAN_LANES = (3,)


def elem_kernel_inputs(dtype, device, seed=10):
    """Kernel 1's elem inputs: x, u in [-1, 1], px of 0.1, h = 0.5, no
    disturbance; lanes 0-3 on the special points."""
    import torch

    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1.0, 1.0, (B, ELEM_N, 3))
    us = rng.uniform(-1.0, 1.0, (B, ELEM_N, 2))
    pxs = rng.normal(0.0, 0.1, (B, ELEM_N, 2))
    pxs[0, :, 1], xs[0, :, 1] = 0.0, -0.5        # clamp's tie
    us[1, :, 0] = 0.0                            # sign at 0
    us[2, :, 1] = 0.0                            # pow's base 0
    xs[3, :, 2], us[3, :, 0] = 0.0, 0.5          # atan2's origin
    arrs = [xs, us, pxs, np.zeros(B), np.full(B, 0.5), np.zeros((B, 0))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def tanh_map_inputs(dtype, device, seed=11):
    import torch

    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, ELEM_N, 2)), rng.normal(size=(B, ELEM_N, 1)),
            rng.normal(size=(B, ELEM_N, 1)), rng.normal(size=(B,)), rng.normal(size=(B, 1))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def cartpole_kernel_inputs(dtype, device, seed=12):
    """Kernel 1's cart-pole inputs: states over CARTPOLE_BOX, |F| <= 80,
    the interval 0.05 s, no parameters."""
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = CARTPOLE_BOX
    arrs = [rng.uniform(lo, hi, (B, CARTPOLE_N, 4)),
            rng.uniform(-CARTPOLE_FMAX, CARTPOLE_FMAX, (B, CARTPOLE_N, 1)),
            np.zeros((B, CARTPOLE_N, 4)), np.zeros(B), np.full(B, CARTPOLE_TF / CARTPOLE_N),
            np.zeros((B, 0))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


# The plain versions of kernels 4 and 5 on the card run over one block of
# PLAIN_CARD_LANES (scenario, stage) lanes in place of their modules'
# default blocks (2^16 and 2^17 lanes), which bound what a CPU run's
# reverse-mode graph holds: on the card such a plain version is bound by
# its host's op dispatch, the same few thousand ops a block whatever its
# width, so one block of the checks' 409,600-819,200 lanes takes a
# fraction of the seven blocks' time.  A block the card's memory
# does not hold falls back to the default blocks.
PLAIN_CARD_LANES = 1 << 20


def card_plain(sweep, *arrs):
    """``sweep``'s plain version on the card's tensors ``arrs``."""
    import torch

    from mpc_code_tpu_torch.ops import sweep_cf_cuda
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    saved = sk.PLAIN_BLOCK_LANES, sweep_cf_cuda.PLAIN_BLOCK_LANES
    try:
        sk.PLAIN_BLOCK_LANES = sweep_cf_cuda.PLAIN_BLOCK_LANES = PLAIN_CARD_LANES
        try:
            return sweep.plain(*arrs)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            log(f"# plain version of {sweep.kernel}: one block does not fit, default blocks")
            sk.PLAIN_BLOCK_LANES, sweep_cf_cuda.PLAIN_BLOCK_LANES = saved
            return sweep.plain(*arrs)
    finally:
        sk.PLAIN_BLOCK_LANES, sweep_cf_cuda.PLAIN_BLOCK_LANES = saved


def lane_sweep_check(dev, key, sweep, inputs, dims, bytes_fn, ops_lane, tol, results,
                     special=(), nan_lanes=()):
    """One sweep of kernels 1, 3 or 4 against its plain version in f64 and
    f32 on ``inputs(dtype, dev)``: every output within ``tol`` (f64 TOL_F64)
    over the entries finite on both sides, non-finite entries in the same
    places and only on ``nan_lanes``, the ``special`` lanes within the
    same bar, and in f32 no farther from the f64 plain version than twice
    the f32 plain version; the kernel's, the call's and the plain
    version's times, the bound and ptxas's report.  Returns the
    failures."""
    import torch

    failures = []
    ptx = results[key].get("ptxas_summary", {})
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).replace("torch.", "")
        arrs = inputs(dtype, dev)
        got = sweep(*arrs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()            # host-bound: seconds per call
        ref = card_plain(sweep, *arrs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, same, nf_lanes = nonfinite_err(got, ref)
        err_special = nonfinite_err([g[list(special)] for g in got],
                                    [r[list(special)] for r in ref])[0] if special else 0.0
        abs_err = max(float((g - r)[g.isfinite() & r.isfinite()].abs().max())
                      for g, r in zip(got, ref))
        err64 = [0.0, 0.0]
        if dtype == torch.float32:
            ref64 = card_plain(sweep, *[a.double() for a in arrs])
            err64 = [nonfinite_err(r, ref64)[0] for r in (got, ref)]
            del ref64
        if sweep.in_place:
            bound = sweep.bind(*arrs)
            ms = cuda_ms(lambda: sweep.fire(bound), 20)
        else:
            planes = sweep.pack(*arrs)
            ms = cuda_ms(lambda: sweep.launch_planes(planes), 20)
        wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
        Bsz, N = arrs[0].shape[:2]
        t_b = bytes_fn(Bsz, N, *dims, arrs[0].element_size()) / H100_BYTES_PER_S * 1e3
        t_o = Bsz * N * ops_lane / H100_FLOPS[tname] * 1e3
        bar = TOL_F64 if dtype == torch.float64 else tol
        log(f"# kernel {key} {tname}: max_norm_err={err:.3e} special_lanes={err_special:.3e} "
            f"max_abs_err={abs_err:.3e} (tol {bar:g}) vs_plain_f64: kernel {err64[0]:.3e} "
            f"plain {err64[1]:.3e} nonfinite_lanes={nf_lanes} nonfinite_pattern_equal={same} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
            f"{ops_lane} operations per lane) ptxas: {ptx.get(tname)}")
        closer = err64[0] <= 2 * err64[1] + TOL_F64
        if not (err <= bar and err_special <= bar and same and closer
                and set(nf_lanes) <= set(nan_lanes)):
            failures.append(f"{key} {tname} error {err:.3e} > {bar:g}, non-finite lanes "
                            f"{nf_lanes} (pattern equal {same}), against f64 "
                            f"{err64[0]:.3e} vs plain {err64[1]:.3e}")
        results[key][tname] = dict(
            max_norm_err=err, special_norm_err=err_special, max_abs_err=abs_err,
            err_vs_f64=err64, nonfinite_lanes=nf_lanes, ms=ms, wrapper_ms=wrap_ms,
            plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o)
    return failures


def elementary_sweeps(eprob, cp_socp):
    """The sweeps of the elementary kernel phase: key -> (sweep, build
    dims)."""
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import Rk4QuadStageHess
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac
    from mpc_code_tpu_torch.ops.sweep_map_cuda import MapStageJac

    fx, ec = elem_ode(torch_fns()), eprob.cfg
    return {"rk4_stage_jac_elem": (Rk4StageJac(lambda x, t, u, d, px: fx(x, u, d, t, px),
                                               ELEM_MX), (3, 2, 0, 2)),
            "rk4_stage_jac_cartpole": (cp_socp.sweep, (4, 1, 0, 4)),
            "map_stage_jac_tanh": (MapStageJac(tanh_map(torch_fns())), (2, 1, 1, 1)),
            "rk4_quad_stage_hess_tanh": (
                Rk4QuadStageHess(eprob.socp.sweep.f, tanh_quad(torch_fns()),
                                 eprob.socp.sweep.Mx),
                (ec.nx, ec.nu, ec.nd, ec.npx, ec.npy))}


def elementary_kernel_phase(dev, sweeps, eprob, cp_socp, results):
    """The elementary functions through kernels 1, 3 and 4 (``sweeps``,
    ``elementary_sweeps``), and kernel 2 at the cart-pole's shapes, each
    against its plain version."""
    import torch

    from mpc_code_tpu_torch.ops import sweep_cf_cuda, sweep_cuda, sweep_map_cuda

    def k1_ops(sw, nx, nu, nd, npx):
        return sweep_cuda.sweep_ops_per_lane(sw.f, nx, nu, sw.Mx, sw.clip_lo, sw.clip_hi,
                                             nd, npx)

    failures = []
    for key, inputs, tol, special, nan in (
            ("rk4_stage_jac_elem", elem_kernel_inputs, TOL_F32["rk4_stage_jac"], (0, 1, 2, 3),
             ELEM_NAN_LANES),
            ("rk4_stage_jac_cartpole", cartpole_kernel_inputs, TOL_F32["rk4_stage_jac"], (),
             ())):
        sw, dims = sweeps[key]
        failures += lane_sweep_check(dev, key, sw, inputs, dims, sweep_cuda.sweep_bytes,
                                     k1_ops(sw, *dims), tol, results, special, nan)
    sw, dims = sweeps["map_stage_jac_tanh"]
    failures += lane_sweep_check(
        dev, "map_stage_jac_tanh", sw, tanh_map_inputs, dims, sweep_map_cuda.map_bytes,
        sweep_map_cuda.map_ops_per_lane(sw.f, *dims), TOL_F32["map_stage_jac"], results)
    sw, dims = sweeps["rk4_quad_stage_hess_tanh"]
    failures += lane_sweep_check(
        dev, "rk4_quad_stage_hess_tanh", sw, lambda dt, d: cf_inputs(dt, d, eprob.cfg.N),
        dims, sweep_cf_cuda.cf_bytes, sw.ops_per_lane(*dims), TOL_F32["rk4_quad_stage_hess"],
        results)
    for dtype in (torch.float64, torch.float32):
        failures += riccati_check(dev, dtype, cp_socp.N, cp_socp.nxa, cp_socp.nu,
                                  results["riccati_kkt_cartpole"])
    return failures


def elem_sweep_inputs(dtype, device, socp, cfg=None, seed=13):
    """Kernel 5's elem inputs (the elem OCP at ELEM_N stages): x, u in
    [-1, 1] (scaled), multipliers of the size the solves meet, small
    parameters; lanes 0-3 on the ODE's special points as in
    ``elem_kernel_inputs`` (px_1 = 0 there), lane 4 on the cost's clamp
    tie (x_2 = 0.5) and lane 5 on its sign at 0 (x_0 = 0)."""
    import torch

    rng = np.random.default_rng(seed)
    N = socp.N
    X = rng.uniform(-1.0, 1.0, (B, N, 3))
    U = rng.uniform(-1.0, 1.0, (B, N, 2))
    px = rng.normal(0.0, 0.1, (B, N, cfg.npx))
    px[0, :, 1], X[0, :, 1] = 0.0, -0.5
    U[1, :, 0] = 0.0
    U[2, :, 1] = 0.0
    X[3, :, 2], U[3, :, 0] = 0.0, 0.5
    X[4, :, 2] = 0.5
    X[5, :, 0] = 0.0
    arrs = [X / socp.sxa, U / socp.su, rng.normal(size=(B, N, 3)),
            np.zeros((B, N, socp.ni)), px, rng.normal(0.0, 0.1, (B, N, cfg.npy)),
            np.zeros((B, N, 0)), rng.uniform(0.0, 1.0, B), rng.uniform(0.5, 1.0, B),
            rng.normal(0.0, 0.3, (B, 3)), rng.normal(0.0, 0.3, (B, 2)), np.zeros((B, 0)),
            rng.normal(0.0, 0.3, (B, 2)), rng.normal(0.0, 0.01, (B, cfg.ny * 2))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], [0, 1, 2, 3, 4, 5]


def cartpole_sweep_inputs(dtype, device, socp, cfg=None, seed=14):
    """Kernel 5's cart-pole inputs: states over CARTPOLE_BOX, |F| <= 80
    (scaled), multipliers of the size the solves meet, no parameters."""
    import torch

    rng = np.random.default_rng(seed)
    N = socp.N
    lo, hi = CARTPOLE_BOX
    arrs = [rng.uniform(lo, hi, (B, N, 4)) / socp.sxa,
            rng.uniform(-CARTPOLE_FMAX, CARTPOLE_FMAX, (B, N, 1)) / socp.su,
            rng.normal(size=(B, N, 4)), rng.normal(0.0, 0.1, (B, N, socp.ni)),
            np.zeros((B, N, cfg.npx)), np.zeros((B, N, cfg.npy)), np.zeros((B, N, 0)),
            np.zeros(B), rng.uniform(0.5, 1.0, B), np.zeros((B, 4)), np.zeros((B, 1)),
            np.zeros((B, 0)), np.zeros((B, 1)), np.zeros((B, cfg.ny))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], []


def mhe_sweep_inputs(dtype, device, socp, cfg=None, seed=15):
    """Kernel 5's inputs at an MHE window's shapes (Ex_ENMPC's: N_mhe + 1 =
    11 structured stages, n = n_w = 4), in the launcher's order: states x
    over [0.1, 0.9] and d over [-0.1, 0.1] (unit scales), the arrival
    stage's input near its state and the noises within 0.05, multipliers of
    the size the solves meet, the window's measured inputs over [0, 2],
    outputs over [0, 1], times on the sampling grid, small px and py, a
    mask, sf, x_bar near the first state, P_inv symmetric positive
    definite.  In a maskable window scenario 1's first three window stages
    and a third of scenario 2's are pads (mask 0), as in the warmup.
    Every scenario's stage 0 is the arrival stage.  Returns (inputs, the
    scenarios with pad stages)."""
    import torch

    rng = np.random.default_rng(seed)
    N, n = socp.N, socp.nxa
    low = socp.lowering
    Nw, nx = N - 1, low.step.nx
    x = np.concatenate([rng.uniform(0.1, 0.9, (B, N, nx)),
                        rng.uniform(-0.1, 0.1, (B, N, n - nx))], -1)
    U = rng.normal(0.0, 0.05, (B, N, n))
    U[:, 0] += x[:, 1]
    mask = np.ones((B, Nw, 1))
    pads = []
    if low.maskable:
        mask[1, :3] = 0.0
        mask[2] = rng.uniform(size=(Nw, 1)) > 2.0 / 3.0
        pads = [1, 2]
    M = rng.normal(size=(B, n, n))
    arrs = [x / socp.sxa, U / socp.su, rng.normal(size=(B, N, n)),
            rng.normal(0.0, 0.1, (B, N, socp.ni)), rng.uniform(0.0, 2.0, (B, Nw, low.m)),
            rng.uniform(0.0, 1.0, (B, Nw, low.p)),
            (np.arange(Nw)[None, :, None] + rng.integers(0, 20, (B, 1, 1))) * float(cfg.h),
            rng.normal(0.0, 1e-3, (B, Nw, low.npx)), rng.normal(0.0, 1e-3, (B, Nw, low.npy)),
            mask, rng.uniform(0.5, 1.0, B), x[:, 1] + rng.normal(0.0, 0.01, (B, n)),
            (M @ np.swapaxes(M, 1, 2) + n * np.eye(n)).reshape(B, n * n),
            np.zeros((B, low.n_corr * n)), np.zeros((B, low.n_corr)),
            np.zeros((B, low.n_corr ** 2))]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs], pads


# Kernel 5's builds: the exact-Hessian CSTR (the continuous map), the
# quadruple tank's discrete map with the u_prev augmentation, ENMPC's
# ContForm, the CSTR with DUForm, the LMPC loop's affine model with u_prev,
# the bench port's linear CSTR, the CSTR's shared output slacks, the CSTR
# with TermCons, H_eq and one G_ineq row, the collocated CSTR, the
# cart-pole, Ex_ENMPC's MHE window in the batched MHE (maskable) and in the
# host MHE, each at its path's shapes; and check builds on no path:
# the collocated CSTR at two Newton steps with a coolant term whose
# u-curvature depends on the state (``colloc_newton2_ocp``) and the
# elem OCP (every elementary function, on second-order numbers).  Each in
# its exact build (results key ``<build>``) and, but EXACT_ONLY_BUILDS, its
# Gauss-Newton build (``<build>_gn``).  build -> (problem key, inputs, the paths its exact
# build serves, the paths its Gauss-Newton build serves); a path's
# launches are ``launches["stage_sweep_<path>"]`` (the cstr_exact path's
# ``launches["stage_sweep"]``)
STAGE_BUILDS = {"stage_sweep": ("cstr_exact", stage_sweep_inputs, ("cstr_exact",), ()),
                "stage_sweep_nmpc_dis": ("nmpc_dis", nmpc_dis_sweep_inputs,
                                         ("options_nmpc_dis_exact",), ()),
                "stage_sweep_enmpc": ("enmpc", enmpc_sweep_inputs,
                                      ("options_enmpc_exact", "dryrun_enmpc"), ()),
                "stage_sweep_cstr_du": ("cstr_du", stage_sweep_inputs,
                                        ("options_cstr_du_exact",), ()),
                "stage_sweep_lmpc": ("lmpc", lin_sweep_inputs, (), ("lmpc_loop",)),
                "stage_sweep_clb": ("clb", lin_sweep_inputs, (),
                                    ("clb", "mesh_unsharded", "mesh_mesh", "dryrun_lin",
                                     "aot")),
                "stage_sweep_soft": ("soft", stage_sweep_inputs, ("options_soft_exact",), ()),
                "stage_sweep_rows": ("rows", stage_sweep_inputs, ("options_rows_exact",), ()),
                "stage_sweep_colloc": ("colloc", stage_sweep_inputs, (), ("colloc",)),
                "stage_sweep_colloc_newton2": ("colloc_newton2", stage_sweep_inputs, (), ()),
                "stage_sweep_elem": ("elem", elem_sweep_inputs, (), ()),
                "stage_sweep_cartpole": ("cartpole", cartpole_sweep_inputs,
                                         ("cartpole_exact",), ()),
                "stage_sweep_mhe": ("mhe", mhe_sweep_inputs,
                                    ("enmpc_loop_mhe", "enmpc_handoff_mhe", "dryrun_mhe"),
                                    ()),
                "stage_sweep_host_mhe": ("host_mhe", mhe_sweep_inputs,
                                         ("host_loop", "host_loop_cli",
                                          "enmpc_handoff_warmup"), ())}
# builds checked in their exact build alone: the elementary functions',
# whose Gauss-Newton builds no path launches (the cart-pole's Gauss-Newton
# run takes kernel 1), and the host MHE's (its Gauss-Newton build is the
# batched window's but for the mask), while every build costs minutes of nvcc
EXACT_ONLY_BUILDS = ("stage_sweep_elem", "stage_sweep_cartpole", "stage_sweep_host_mhe")
# the builds' lanes whose outputs are nan on both sides (elem: atan2 at the
# origin, as JAX's)
NONFINITE_LANES = {"stage_sweep_elem": ELEM_NAN_LANES}


def build_hessians(build):
    """(hessian, results key) of each of ``build``'s checked builds."""
    return (("exact", build),) + (() if build in EXACT_ONLY_BUILDS
                                  else (("gauss_newton", build + "_gn"),))


def colloc_newton2_ocp(cfg, dev):
    """The collocated CSTR ``cfg`` with the term 0.05 T u_2^2 added to the
    reactor temperature's rate and two Newton steps: the root's residual
    stays, and the ODE's third derivative d3f/ds du du is not zero (the
    CSTR's ODE is affine in u), so kernel 5's implicit step is held to
    the plain version's exact derivative of S* - J^-1 r."""
    import dataclasses

    import torch

    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    fx0 = cfg.model.fx

    def fx(x, u, d, t, px):
        return fx0(x, u, d, t, px) + torch.stack([0.0 * x[0], 0.05 * x[1] * u[1] * u[1],
                                                  0.0 * x[2]])

    cfg = cfg.replace(model=dataclasses.replace(cfg.model, fx=fx))
    return cfg, build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                     build_terminal_cost(cfg), device=dev,
                                     n_colloc_newton=2)


# Kernel 5's builds whose f32 plain version lies farther than the f32 bar
# from the f64 plain version, so that the kernel is held in f32 to the f64
# plain version at the bar: the LMPC loop's (its gc, by the plain version's
# f32 rounding: 4.8e-3 from f64 against the kernel's 3.8e-4 on an H100 80GB
# HBM3 at 700 W).  Any other build that drifts so fails.
F32_HELD_TO_F64 = ("stage_sweep_lmpc", "stage_sweep_lmpc_gn")


def k5_dims(sweep, cfg, socp):
    """The build key of kernel 5's build ``sweep`` of ``socp``."""
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    if isinstance(sweep, sk.WindowSweep):
        return sweep.window_dims()
    return (socp.nxa, socp.nu, socp.ni, cfg.nd, cfg.npx, cfg.npy)


def build_launches(launches, path):
    """Kernel 5's launches on one of STAGE_BUILDS' paths."""
    return launches.get("stage_sweep" if path == "cstr_exact" else f"stage_sweep_{path}", 0)


def stage_sweep_kernel_phase(dev, xprobs, results):
    """Kernel 5 (the fused stage sweep) against its plain version at each
    build's path's shapes (STAGE_BUILDS): the exact build the path
    launches, then the Gauss-Newton build (``"gauss_newton"``), which the
    solver launches for a Gauss-Newton OCP with ``impl="fused"``.
    ``xprobs``: problem key -> (cfg, socp)."""
    import torch

    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    failures = []
    for build, (pkey, inputs, _, _) in STAGE_BUILDS.items():
        cfg, socp = xprobs[pkey]
        for hessian, key in build_hessians(build):
            sweep = sk.make_stage_sweep(socp, hessian)
            ptx = results[key].get("ptxas_summary", {})
            for dtype in (torch.float64, torch.float32):
                failures += stage_sweep_check(dev, sweep, key, dtype, cfg, socp, ptx,
                                              results[key], inputs)
    return failures


def stage_sweep_check(dev, sweep, key, dtype, cfg, socp, ptx, out, inputs):
    """One build of kernel 5 against its plain version in one dtype, on
    ``inputs(dtype, dev, socp, cfg)``; the numbers go into ``out[dtype
    name]``.  Returns the failures."""
    import torch

    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    tname = str(dtype).replace("torch.", "")
    arrs, tie = inputs(dtype, dev, socp, cfg)
    got = sweep(*arrs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()            # host-bound: seconds per call
    ref = card_plain(sweep, *arrs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # over the entries finite on both sides; non-finite entries only on the
    # build's NONFINITE_LANES, in the same places on both sides
    errs = [nonfinite_err([g], [r])[0] for g, r in zip(got, ref)]
    err, same, nf_lanes = nonfinite_err(got, ref)
    err_tie = nonfinite_err([g[tie] for g in got], [r[tie] for r in ref])[0] if tie else 0.0
    # the stage-0 lanes: the u_prev and slack slots' and an MHE window's
    # arrival stage
    err_k0 = nonfinite_err([g[:, 0] for g in got], [r[:, 0] for r in ref])[0]
    abs_err = max(float((g - r)[g.isfinite() & r.isfinite()].abs().max())
                  for g, r in zip(got, ref) if g.numel())
    # the scenarios with a non-finite entry are the same on both sides;
    # which entries are nan follows the derivative's mode (the kernel's
    # forward mode spreads atan2's nan at the origin to every tangent, the
    # plain version's reverse mode to the rows' cotangents)
    nf_got = nonfinite_err(ref, got)[2]
    finite = nf_got == nf_lanes and set(nf_lanes) <= set(NONFINITE_LANES.get(key, ()))
    asym = got[0] - got[0].transpose(-1, -2)
    sym = float(asym[asym.isfinite()].abs().max())
    # each f32 result against the plain version in f64 on the same inputs
    err64 = [0.0, 0.0]
    if dtype == torch.float32:
        ref64 = card_plain(sweep, *[a.double() for a in arrs])
        err64 = [nonfinite_err(res, ref64)[0] for res in (got, ref)]
        del ref64
    planes = sweep.pack(*arrs)
    ms = cuda_ms(lambda: sweep.launch_planes(planes), 20)
    wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
    extra = ""
    if isinstance(sweep, sk.WindowSweep):
        # an MHE window with every window stage a pad: no lane steps, so
        # the difference is the step's time, of which the arrival lanes (1
        # in N) idle through their warps' share
        im = sweep.input_names().index("mask")
        padded = sweep.pack(*arrs[:im], torch.zeros_like(arrs[im]), *arrs[im + 1:])
        out[f"{tname}_no_step_ms"] = cuda_ms(lambda: sweep.launch_planes(padded), 20)
        extra = f"no_step_ms={out[f'{tname}_no_step_ms']:.4f} "
    # what these inputs need: an MHE window's arrival and pad lanes skip
    # the step
    ops = sweep.ops(*arrs)
    ops_lane = ops / (B * socp.N)
    t_b = sweep.moved_bytes(*arrs) / H100_BYTES_PER_S * 1e3
    t_o = ops / H100_FLOPS[tname] * 1e3
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32["stage_sweep"]
    log(f"# kernel {key} ({sweep.hessian}) {tname}: max_norm_err={err:.3e} per output "
        f"(H, gc, A, B, E, ival, dval, Cz, hval) {['%.2e' % e for e in errs]} "
        f"tie_lanes={err_tie:.3e} stage0_lanes={err_k0:.3e} max_abs_err={abs_err:.3e} "
        f"(tol {tol:g}) "
        f"vs_plain_f64: kernel {err64[0]:.3e} plain {err64[1]:.3e} "
        f"H_asym={sym:.1e} finite={finite} nonfinite_lanes={nf_lanes} "
        f"nonfinite_entries_equal={same} "
        f"kernel_ms={ms:.4f} {extra}wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
        f"{ops_lane:g} operations per lane) ptxas: {ptx.get(tname)}")
    # in f32 the kernel also lies no farther from the f64 plain version
    # than twice the f32 plain version does
    closer = err64[0] <= 2 * err64[1] + TOL_F64
    # in f32 it is held to the f32 plain version at the bar, or, for the
    # builds of F32_HELD_TO_F64 where that plain version itself lies
    # farther than the bar from the f64 plain version, to the f64 plain
    # version at the bar
    near = err <= tol or (dtype == torch.float32 and key in F32_HELD_TO_F64
                          and err64[1] > tol and err64[0] <= tol)
    out[tname] = dict(
        max_norm_err=err, tie_norm_err=err_tie, stage0_norm_err=err_k0, max_abs_err=abs_err,
        err_vs_f64=err64, ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms,
        bytes_ms=t_b, ops_ms=t_o)
    if not (near and err_tie <= tol and sym == 0.0 and finite and closer):
        return [f"{key} {tname} error {err:.3e} > {tol:g}, asymmetry {sym:.1e}, "
                f"finite {finite}, against f64 {err64[0]:.3e} vs plain {err64[1]:.3e}"]
    return []


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def profile_pass1(cfg, model, solve, x0s):
    """One pass-1 solve of the whole CSTR batch under torch.profiler."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        MAXIT1, U_SS, bench_params, warm_start,
    )

    nb = x0s.shape[0]
    us_b = torch.as_tensor(U_SS, dtype=x0s.dtype, device=x0s.device).expand(nb, cfg.nu)
    X0, U0 = warm_start(cfg, model, x0s, us_b)
    par = bench_params(cfg, x0s)
    return profile_solve(lambda: solve(par, X0, U0, max_iter=MAXIT1))


def profile_solve(run):
    """``run()`` (a structured solve) under torch.profiler (CUDA activity
    only, its raw device events read as ``HostWindow`` reads them): device
    busy share (summed device time over the profiled wall time), device
    launches (kernels, copies and fills) per IPM iteration and the kernels
    that take the most time.  Raises when the profiler sees no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_it = int(r.iters.max())
    by_name, n_launch = {}, 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            n_launch += 1
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    busy = sum(by_name.values()) / 1e9
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    return {"wall_s": wall, "iterations": n_it, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "kernel_launches_per_iteration": n_launch / max(n_it, 1),
            "top_kernels_ms": {k[:60]: ns / 1e6 for k, ns in top}}


def cross_check(name, run, ref, f32, u_box, tol, tol_moved):
    """Hold one run of the check lanes against the CPU f64 run.  ``run``
    and ``ref`` hold per-lane ``status``, ``iters``, ``kkt`` and ``U`` (and
    on the ENMPC path the targets' ``target_status`` and ``xs``).  At most
    one lane may differ in converged status; converged ``U`` must agree to
    ``tol`` of the input box ``u_box``, or, in an f32 run on a lane that
    stopped on another iteration than the reference, to ``tol_moved``.
    Returns (failures, report)."""
    conv_x, conv_c = run["status"] != 2, ref["status"] != 2
    it_x, it_c = run["iters"], ref["iters"]
    n_diff = int((conv_x != conv_c).sum())
    both = conv_x & conv_c
    du = (np.abs(run["U"] - ref["U"]) / u_box).max(axis=(1, 2))
    moved = both & (it_x != it_c) if f32 else np.zeros_like(both)
    du_same = float(du[both & ~moved].max()) if (both & ~moved).any() else 0.0
    du_moved = float(du[moved].max()) if moved.any() else 0.0
    report = dict(status_differ=n_diff, max_dU_over_box=du_same,
                  max_dU_over_box_moved=du_moved, lanes_moved=int(moved.sum()))
    target = ""
    if "xs" in run:
        report["max_dxs"] = float(np.abs(run["xs"] - ref["xs"]).max())
        n_t = int((run["target_status"] != ref["target_status"]).sum())
        target = f"target status differ={n_t}, max |dxs|={report['max_dxs']:.3e}; "
    log(f"# cpu f64 cross-check, {name} ({len(du)} lanes): converged "
        f"{int(conv_x.sum())} vs cpu {int(conv_c.sum())}, differ={n_diff}; {target}"
        f"max |dU|/box: {du_same:.3e} over {int((both & ~moved).sum())} lanes "
        f"({int((both & (it_x == it_c)).sum())} stopped on the same iteration, "
        f"tol {tol:g}), {du_moved:.3e} over {int(moved.sum())} that stopped on "
        f"another (tol {tol_moved:g})")
    for i in np.where(both & (du > tol))[0]:
        log(f"#   {name}, lane {i}: |dU|/box {du[i]:.3e}, iterations {it_x[i]} vs cpu "
            f"{it_c[i]}, kkt {run['kkt'][i]:.4e} vs cpu {ref['kkt'][i]:.4e}")
    failures = []
    if n_diff > 1 or not (du_same <= tol and du_moved <= tol_moved):
        failures.append(f"cpu cross-check, {name}: {n_diff} status differences, "
                        f"max dU/box {du_same:.3e} (tol {tol:g}), on lanes that "
                        f"stopped elsewhere {du_moved:.3e} (tol {tol_moved:g})")
    return failures, report


def delta_lanes(cfg, model, solve, x0s):
    """One pass-1 solve of the batch with the Riccati ``ok`` flags of every
    loop pass recorded: the lanes on which the solver raised its
    regularisation delta (a pass, before the lane stopped, whose KKT
    solve was not ok), and the passes with any such lane."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        MAXIT1, U_SS, bench_params, warm_start,
    )

    nb = x0s.shape[0]
    us_b = torch.as_tensor(U_SS, dtype=x0s.dtype, device=x0s.device).expand(nb, cfg.nu)
    X0, U0 = warm_start(cfg, model, x0s, us_b)
    flags = []
    undo = record_ok_flags([flags])
    try:
        r = solve(bench_params(cfg, x0s), X0, U0, max_iter=MAXIT1)
    finally:
        undo()
    it = r.iters.cpu().numpy()
    F = np.array(flags)
    rose = (~F) & (np.arange(len(F))[:, None] < it[None, :])
    return [int(i) for i in np.where(rose.any(0))[0]], int(rose.any(1).sum())


def slice_phase(dev, problem, launches, cpu_refs, exact=False):
    """The CSTR bench workload at B lanes in f32, with the Gauss-Newton
    Hessian (phase ``slice``: kernels 1 and 2) or the exact one (phase
    ``cstr_exact``: kernels 5 and 2, kernel 1 idle)."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        MX, N, U_BOX, draw_x0, make_problem, run_pipeline,
    )
    from mpc_code_tpu_torch.ops import sweep_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    name = "cstr_exact" if exact else "slice"
    sweep_mod, sweep_key = (sk, "stage_sweep") if exact else (sweep_cuda, "rk4_stage_jac")
    rk_key = "riccati_kkt_cstr_exact" if exact else "riccati_kkt"
    hessian = "exact" if exact else "gauss_newton"
    failures = []
    cfg, model, socp, solve = problem
    x0s = draw_x0(B, dev)

    t0 = time.perf_counter()
    run_pipeline(cfg, model, solve, x0s)      # warm-up run
    log(f"# {name} warm-up run: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    sweep_cuda.LAUNCHES = 0
    sk.LAUNCHES = 0
    rk.LAUNCHES = 0
    status, iters, feas, kkt, U, times = run_pipeline(cfg, model, solve, x0s)
    launches[sweep_key] = sweep_mod.LAUNCHES
    launches[rk_key] = rk.LAUNCHES
    k1_launches = sweep_cuda.LAUNCHES
    ok = status != 2
    n_ok = int(ok.sum())
    ok_fraction = n_ok / B
    report = dict(
        batch=B, N=N, Mx=MX, hessian=hessian, ok=n_ok, ok_fraction=ok_fraction,
        solves_per_s=n_ok / times["total_s"],
        median_iters=float(np.median(iters)),
        max_feas_ok=float(feas[ok].max()) if n_ok else float("inf"),
        kkt_ok_p50=float(np.percentile(kkt[ok], 50)) if n_ok else float("inf"),
        launches={sweep_key: launches[sweep_key], rk_key: launches[rk_key]},
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in times.items()})
    if exact:
        report["launches"]["rk4_stage_jac"] = k1_launches
    log(f"# {name} " + json.dumps(report))
    if ok_fraction < OK_FRACTION_MIN:
        failures.append(f"{name} ok_fraction {ok_fraction:.5f} < {OK_FRACTION_MIN}")
    if min(launches[sweep_key], launches[rk_key]) <= 0:
        failures.append(f"a kernel was not launched on the {name} path: {report['launches']}")
    if exact and not (launches[sweep_key] == launches[rk_key] and k1_launches == 0):
        # one fused sweep and one KKT solve per pass of the solver loop,
        # and no split dynamics sweep
        failures.append(f"{name} launches {report['launches']}: kernels 5 and 2 "
                        "not once per loop pass, or kernel 1 launched")

    report["profile"] = profile_pass1(cfg, model, solve, x0s)
    log(f"# {name} profile " + json.dumps(report["profile"]))
    if exact:
        rose, n_pass = delta_lanes(cfg, model, solve, x0s)
        report["delta_rose_lanes"] = len(rose)
        log(f"# {name} pass 1: delta rose on {len(rose)} lanes ({rose[:32]}...), "
            f"on {n_pass} loop passes")

    # the failing lanes against the classified tail (bench.py:397-429); on
    # the exact path each unclassified one must also fail in f64 on the CPU
    tv_path = os.path.join(ROOT, "fixtures", "tail_verdict.json")
    bad_now = {int(i) for i in np.where(~ok)[0]}
    classified = set()
    if os.path.exists(tv_path):
        with open(tv_path) as f:
            classified = {int(lane["idx"]) for lane in json.load(f).get("lanes", [])}
    log(f"# {name} tail: failed {sorted(bad_now)}; classified physically "
        f"infeasible {sorted(classified)}; unclassified {sorted(bad_now - classified)}")
    if exact:
        other = sorted(bad_now - classified)
        report["unclassified_failing"] = other
        if len(other) > RESOLVE_MAX:
            failures.append(f"{name}: {len(other)} unclassified failing lanes")
        elif other:
            cpu = torch.device("cpu")
            ccfg, cmodel, _, csolve = make_problem(cpu, hessian=hessian)
            x64 = draw_x0(B, cpu, dtype=torch.float64)[other]
            st64 = run_pipeline(ccfg, cmodel, csolve, x64, rescue_cap=len(other))[0]
            f32_only = [i for i, s64 in zip(other, st64) if s64 != 2]
            log(f"# {name} unclassified failing lanes re-solved in f64 on the CPU: "
                f"status {dict(zip(other, st64.tolist()))}")
            if f32_only:
                failures.append(f"{name}: failures not shared by f64: {f32_only}")

    # the first N_CHECK lanes against the port's plain path on the CPU in
    # f64: the card's path run in f64 (both kernels in f64), the main run's
    # f32 answers, and the plain path in f32 on the CPU (the CPU runs come
    # from the worker processes)
    t0 = time.perf_counter()
    keys = ("status", "iters", "kkt", "U")
    st, it, _, kk, Ux, _ = run_pipeline(cfg, model, solve,
                                        draw_x0(N_CHECK, dev, dtype=torch.float64),
                                        rescue_cap=8)
    runs = {"gpu f64": dict(zip(keys, (st, it, kk, Ux))),
            "gpu f32": dict(zip(keys, (a[:N_CHECK] for a in (status, iters, kkt, U))))}
    for dt in ("float64", "float32"):
        runs[f"cpu {dt.replace('float', 'f')}"] = cpu_refs[(name, dt)].result()[0]
    for rname in ("gpu f64", "gpu f32", "cpu f32"):
        fails, report[f"xcheck_{rname.replace(' ', '_')}"] = cross_check(
            f"{name}, {rname}" if exact else rname, runs[rname], runs["cpu f64"],
            rname.endswith("f32"), U_BOX, U_TOL,
            EXACT_U_TOL_MOVED if exact else U_TOL_MOVED)
        failures += fails
    log(f"# {name} cpu f64 cross-check: {time.perf_counter() - t0:.1f} s")
    return failures, report


def record_ok_flags(runs):
    """Wrap the Riccati KKT solve the structured solver calls so that every
    call's ``ok`` flags (one per lane) are appended to ``runs[-1]``; returns
    the function that undoes the wrap."""
    from mpc_code_tpu_torch.solver import riccati

    inner = riccati.riccati_kkt

    def recording(*a, **k):
        out = inner(*a, **k)
        runs[-1].append(out[0].cpu().numpy().copy())
        return out

    riccati.riccati_kkt = recording
    return lambda: setattr(riccati, "riccati_kkt", inner)


def cpu_reference(path, dtype_name, carry=None, t0=0.0, k0=0):
    """The reference side of a phase's cross-check: the port's plain path
    on the CPU over the first N_CHECK lanes of ``path`` ("slice",
    "enmpc", "nmpc_dis", "cstr_exact", "cstr_loop", "lmpc_loop",
    "enmpc_loop", "enmpc_handoff", "constrained", "solver_options:<run>", "debug") in one
    dtype, with the Riccati ``ok`` flags of every call (for the loops: the
    closed loop's history; "enmpc_handoff" continues from ``carry``, numpy
    arrays, at time ``t0`` and step ``k0``).  "enmpc_handoff_warmup" is the
    hand-off's host warmup through ``ClosedLoop`` on the CPU: (history,
    per-step stats).  "constrained" gives, per run of the constrained
    phase, the check lanes' structured solve and their dense
    transcription's; "solver_options:<run>", that run's check lanes'
    solve; "debug", the debug phase's lines (``debug_runs``).  Returns (results, flags).  It runs
    in a worker process while the card's phases run (``main``), so it
    imports what it needs itself."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(CPU_REF_THREADS)
    cpu = torch.device("cpu")
    dtype = getattr(torch, dtype_name)
    flags = []
    undo = record_ok_flags([flags])
    try:
        if path == "constrained":
            # small one-lane solves: one thread does as well and leaves the
            # cores to the card's host-bound phases and the other workers
            torch.set_num_threads(1)
            return {name: dict(struct=constrained_check_solve(name, cpu),
                               dense=constrained_dense(name))
                    for name in constrained_runs()}, flags
        if path.startswith("solver_options:"):
            torch.set_num_threads(1)
            return options_check_solve(path.split(":")[1], cpu), flags
        if path == "debug":
            return debug_runs(cpu), flags
        if path.startswith("cartpole:"):
            torch.set_num_threads(1)
            return cartpole_check_solve(path.split(":")[1], cpu), flags
        if path.startswith("enmpc_handoff"):
            from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
            from mpc_code_tpu_torch.loop import ClosedLoop
            from mpc_code_tpu_torch.loop.batched import cast_carry, map_carry

            cfg = mw.make_config(warm_handoff=True)
            if path == "enmpc_handoff_warmup":
                loop = ClosedLoop(cfg.replace(Nsim=mw.handoff_steps(cfg)), device=cpu,
                                  dtype=dtype)
                return (loop.run(), loop.step_stats), flags
            torch.set_num_threads(HANDOFF_REF_THREADS)
            c = cast_carry(map_carry(torch.as_tensor, carry), dtype)
            H, _ = mw.run_loop(cfg, None, Nsim=HANDOFF_T, device=cpu,
                               step=mw.make_step(cfg, cpu), carry=c, t0=t0, k0=k0)
            return H, flags
        if path in ("cstr_loop", "lmpc_loop", "enmpc_loop"):
            from mpc_code_tpu_torch.examples import closed_loop_workload as cw
            from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
            from mpc_code_tpu_torch.examples import lmpc_loop_workload as lw

            wl, nsim = {"cstr_loop": (cw, LOOP_NSIM), "lmpc_loop": (lw, LOOP_NSIM),
                        "enmpc_loop": (mw, ENMPC_NSIM)}[path]
            cfg = wl.make_config()
            H, _ = wl.run_loop(cfg, wl.draw_x0(N_CHECK, cpu, dtype=dtype),
                               Nsim=nsim, device=cpu, step=wl.make_step(cfg, cpu))
            return H, flags
        if path in ("slice", "cstr_exact"):
            from mpc_code_tpu_torch.examples.bench_workload import (
                draw_x0, make_problem, run_pipeline,
            )

            cfg, model, _, solve = make_problem(
                cpu, hessian="exact" if path == "cstr_exact" else "gauss_newton")
            st, it, _, kk, U, _ = run_pipeline(cfg, model, solve,
                                               draw_x0(N_CHECK, cpu, dtype=dtype),
                                               rescue_cap=8)
            run = dict(status=st, iters=it, kkt=kk, U=U)
        else:
            from mpc_code_tpu_torch.examples import enmpc_workload, nmpc_dis_workload

            wl = {"enmpc": enmpc_workload, "nmpc_dis": nmpc_dis_workload}[path]
            run = wl.run_pipeline(wl.make_problem(cpu), wl.draw_lanes(N_CHECK, cpu,
                                                                       dtype=dtype))
    finally:
        undo()
    return run, flags


class Path(NamedTuple):
    """One controller-solve path (per lane a target by the dense IPM, then
    a cold OCP solve at it) as the smoke drives it, through its workload
    module's ``draw_lanes``, ``run_pipeline``, ``solve_targets`` and
    ``solve_ocps``."""
    name: str
    wl: Any                # the workload module
    prob: Any              # its Problem on the card
    sweep_mod: Any         # the module that counts the sweep's launches
    sweep_key: str         # the sweep kernel's key in results and launches
    rk_key: str            # kernel 2's key on this path
    u_tol: float           # converged U against the CPU f64 path, over the box


def record_nonfinite(sweep, seen: set):
    """Wrap a sweep kernel's launch so that the scenarios whose outputs hold
    a non-finite value (a square root's derivative at an empty tank) are
    added to ``seen``; returns the function that undoes the wrap."""
    inner = sweep.launch

    def launch(*a):
        out = inner(*a)
        bad = sum((~o.flatten(1).isfinite()).any(1).int() for o in out)
        seen.update(int(i) for i in bad.nonzero().flatten())
        return out

    sweep.launch = launch
    return lambda: delattr(sweep, "launch")


def controller_phase(dev, path: Path, launches, cpu_refs):
    """A controller path at B lanes in f32: timed run with the launch
    counters around it, a profiled OCP solve, the failing lanes re-solved
    in f64 on the CPU, and the 64-lane cross-check."""
    import torch

    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    name, wl, prob = path.name, path.wl, path.prob
    failures = []
    lanes = wl.draw_lanes(B, dev, dtype=torch.float32)
    nonfinite = set()
    undo = record_nonfinite(prob.socp.sweep, nonfinite)
    t0 = time.perf_counter()
    try:
        wl.run_pipeline(prob, lanes)               # warm-up run
    finally:
        undo()
    log(f"# {name} warm-up run: {time.perf_counter() - t0:.2f} s; scenarios whose "
        f"sweep gave a non-finite derivative on some iteration: {sorted(nonfinite)}")

    torch.cuda.reset_peak_memory_stats(dev)
    path.sweep_mod.LAUNCHES = 0
    rk.LAUNCHES = 0
    out = wl.run_pipeline(prob, lanes)
    launches[path.sweep_key] = path.sweep_mod.LAUNCHES
    launches[path.rk_key] = rk.LAUNCHES
    it, tit = out["iters"], out["target_iters"]
    ok_t, ok = out["target_status"] != 2, out["status"] != 2
    # a solve counts when the target and the OCP both reached the tolerance
    # (status 0); ok_fraction also counts status 1 (stopped short of it)
    solved = (out["target_status"] == 0) & (out["status"] == 0)
    n_iter = int(it.max())
    # passes of the batched OCP loop: a lane that stops by converging takes
    # one pass more than its iterations (that pass finds the KKT error under
    # tol and takes no step); a lane stopped by the cap takes its iterations
    n_pass = int((it + (out["status"] == 0)).max())
    times = out["times"]
    report = dict(
        batch=B, N=prob.cfg.N,
        target_ok_fraction=float(ok_t.mean()), ok_fraction=float(ok.mean()),
        solved_fraction=float(solved.mean()),
        target_status_counts=np.bincount(out["target_status"], minlength=3).tolist(),
        ocp_status_counts=np.bincount(out["status"], minlength=3).tolist(),
        target_iters_median=float(np.median(tit)), target_iters_p90=float(np.percentile(tit, 90)),
        target_iters_max=int(tit.max()),
        ocp_iters_median=float(np.median(it)), ocp_iters_p90=float(np.percentile(it, 90)),
        ocp_iters_max=n_iter,
        target_ms_per_iteration=times["target_s"] * 1e3 / max(int(tit.max()), 1),
        ocp_ms_per_iteration=times["ocp_s"] * 1e3 / max(n_iter, 1),
        solves_per_s=int(solved.sum()) / times["total_s"],
        launches={k: launches[k] for k in (path.sweep_key, path.rk_key)},
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        us_range=[float(out["us"].min()), float(out["us"].max())],
        **times)
    log(f"# {name} " + json.dumps(report))
    # one sweep and one KKT solve per pass of the batched OCP loop
    report["ocp_loop_passes"] = n_pass
    if not (launches[path.sweep_key] == n_pass == launches[path.rk_key]):
        failures.append(f"{name} launches {report['launches']} != {n_pass} loop passes")
    if min(report["target_ok_fraction"], report["ok_fraction"]) < CONTROLLER_OK_FRACTION_MIN:
        failures.append(f"{name} ok fractions {report['target_ok_fraction']:.5f} / "
                        f"{report['ok_fraction']:.5f} < {CONTROLLER_OK_FRACTION_MIN}")

    xs, us = (torch.as_tensor(out[k], device=dev) for k in ("xs", "us"))
    report["profile"] = profile_solve(lambda: wl.solve_ocps(prob, lanes, xs, us))
    log(f"# {name} profile, OCP " + json.dumps(report["profile"]))
    # two target iterations: the profiler's summary of a whole dense-IPM
    # solve (~18k launches an iteration on the ENMPC path) takes minutes
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.ipm import make_solver

    short = prob._replace(target_solve=make_solver(
        prob.tspec.nlp, SolverOptions.for_f32(max_iter=2)))
    report["profile_target"] = profile_solve(lambda: wl.solve_targets(short, lanes)[2])
    log(f"# {name} profile, target (2 iterations) " + json.dumps(report["profile_target"]))

    # failing lanes (status 2), then lanes that stopped short of the
    # tolerance (status 1): re-solve each on the CPU in f64 at the same options
    cpu = torch.device("cpu")
    cprob = wl.make_problem(cpu)
    bad = np.where(~ok | ~ok_t)[0]
    loose = np.where(ok & ok_t & ((out["status"] == 1) | (out["target_status"] == 1)))[0]
    classes = {}
    if len(bad) or len(loose):
        sel = np.concatenate([bad, loose])[:RESOLVE_MAX]
        idx = torch.as_tensor(sel, device=dev)
        r64 = wl.run_pipeline(cprob, lanes._make(a[idx].to(cpu, torch.float64)
                                                 for a in lanes))
        for k, i in enumerate(sel):
            f64_fails = r64["status"][k] == 2 or r64["target_status"][k] == 2
            if i in bad:
                classes[int(i)] = "fails in f64 too" if f64_fails else "f32 only"
            else:
                classes[int(i)] = (f"status 1 in f32, {r64['target_status'][k]}/"
                                   f"{r64['status'][k]} in f64")
            log(f"#   {name} lane {i}: target {out['target_status'][i]}/"
                f"{r64['target_status'][k]}, OCP {out['status'][i]}/{r64['status'][k]} "
                f"(f32 card / f64 cpu), iterations {it[i]}/{r64['iters'][k]}, "
                f"kkt {out['kkt'][i]:.3e}/{r64['kkt'][k]:.3e}, "
                f"feas {out['feas'][i]:.3e}/{r64['feas'][k]:.3e}")
        f32_only = [i for i, c in classes.items() if c == "f32 only"]
        log(f"# {name} failing lanes: {len(bad)}, short of tol: {len(loose)}; "
            f"re-solved in f64 on the CPU: {len(sel)}; classes {classes}")
        if f32_only or len(bad) > RESOLVE_MAX:
            failures.append(f"{name}: failures not shared by f64: {f32_only} "
                            f"({max(len(bad) - RESOLVE_MAX, 0)} lanes not re-solved)")
    else:
        log(f"# {name} failing lanes: none")
    report["failing_lanes"] = classes

    # the first N_CHECK lanes against the CPU f64 plain path, with every
    # Riccati ok flag recorded
    t0 = time.perf_counter()
    flags = {"gpu f64": []}
    runs = {"gpu f32": {k: v[:N_CHECK] for k, v in out.items() if k != "times"}}
    undo = record_ok_flags([flags["gpu f64"]])
    try:
        runs["gpu f64"] = wl.run_pipeline(prob, wl.draw_lanes(N_CHECK, dev,
                                                              dtype=torch.float64))
    finally:
        undo()
    for dt in ("float64", "float32"):
        rname = f"cpu {dt.replace('float', 'f')}"
        runs[rname], flags[rname] = cpu_refs[(name, dt)].result()
    for rname in ("gpu f64", "gpu f32", "cpu f32"):
        fails, report[f"xcheck_{rname.replace(' ', '_')}"] = cross_check(
            f"{name}, {rname}", runs[rname], runs["cpu f64"], rname.endswith("f32"),
            wl.U_BOX, path.u_tol, CONTROLLER_U_TOL_MOVED)
        failures += fails
    not_ok = {rname: [(k, [int(i) for i in np.where(~f)[0]]) for k, f in enumerate(fl)
                      if (~f).any()] for rname, fl in flags.items()}
    log(f"# {name} riccati ok flags: (iteration, lanes not ok) per run: {not_ok}")
    report["riccati_not_ok"] = not_ok
    log(f"# {name} cpu f64 cross-check: {time.perf_counter() - t0:.1f} s")
    return failures, report


class Loop(NamedTuple):
    """One closed-loop phase as the smoke drives it."""
    name: str              # "cstr_loop", "lmpc_loop" or "enmpc_loop"
    wl: Any                # its workload module (make_config, make_step, draw_x0, run_loop)
    u_box: Any             # width of the input bounds
    counters: dict         # kernel name -> the module whose LAUNCHES counts it
    profile: tuple         # phases replayed under torch.profiler ("estimate", "ocp")
    cap_apart: bool        # put apart the lane-steps both precisions stop at the cap
    nsim: int = LOOP_NSIM
    mhe: bool = False      # the estimator is the MHE: its solver's passes are counted
    profile_steps: Any = None   # the steps replayed (None: every step)
    start: Any = None      # start(dev, cfg) -> dict(carry, t0, k0, ref, failures,
                           # report): the run starts from that carry (None: step 0)
    warmup: bool = True    # a 2-step run of 256 lanes first (the card warmed)
    ocp_kernels: Any = None     # the counters' kernels launched once a pass of the
                                # OCP solver (None: all of them)
    mhe_kernels: tuple = ()     # those launched once a pass of the MHE solver


def solver_passes(iters, status):
    """Passes of a solver's loop in a step: a lane that converged (status
    0) stopped after ``iters + 1`` passes, the last one finding it
    converged; any other lane ran ``iters`` passes, to the cap.  Kernel 2
    (and the path's derivative kernel) launches once a pass."""
    return int((iters + (status == 0).to(iters.dtype)).max())


def ocp_passes(out):
    return solver_passes(out.ocp_iters, out.status_dyn)


def mhe_passes(out):
    return solver_passes(out.mhe_iters, out.mhe_status)


# the marks that open and close each phase a replay profiles (None: the
# step's start)
PROFILE_WINDOWS = {"estimate": (None, "estimate"), "ocp": ("target", "ocp")}


def profile_steps(step, carries, inputs, phases):
    """Replay each step ``k`` from its input carry ``carries[k]`` with the
    ``phases`` (the MHE's "estimate", the "ocp") under torch.profiler (CUDA
    activity only, its raw device events read as ``HostWindow`` reads them:
    the host-side op records and ``key_averages`` took ~50 s a step): per
    step and phase the solver's passes, its device launches (kernels,
    copies and fills) per pass, its device busy share and its wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpc_code_tpu_torch.loop.schedules import StepInput

    rows = []
    for k, c in carries.items():
        profs = {ph: profile(activities=[ProfilerActivity.CUDA]) for ph in phases}
        clock = {}

        def begin(ph):
            profs[ph].start()
            clock[ph] = time.perf_counter()

        def mark(name):
            torch.cuda.synchronize()
            for ph in phases:
                opens, closes = PROFILE_WINDOWS[ph]
                if name == closes:
                    clock[ph] = time.perf_counter() - clock[ph]
                    profs[ph].stop()
                if name == opens:
                    begin(ph)

        torch.cuda.synchronize()
        for ph in phases:
            if PROFILE_WINDOWS[ph][0] is None:
                begin(ph)
        _, out = step(c, StepInput(*(a[k] for a in inputs)), mark=mark)
        for ph in phases:
            kern = [e for e in profs[ph].profiler.kineto_results.events()
                    if str(e.device_type()).endswith("CUDA")]
            busy = sum(e.duration_ns() for e in kern) / 1e9
            if busy <= 0:
                raise RuntimeError("torch.profiler recorded no device time")
            n = mhe_passes(out) if ph == "estimate" else ocp_passes(out)
            rows.append(dict(step=k, phase=ph, passes=n,
                             launches_per_pass=len(kern) / max(n, 1),
                             busy_share=busy / clock[ph], ms=1e3 * clock[ph],
                             ms_per_pass=1e3 * clock[ph] / max(n, 1)))
    return rows


def against_f64(h32, H64, u_box, cap=None):
    """|dU|/box of an f32 history against the f64 one over three kinds of
    lane-step (the OCP stopped on the same iteration; converged on another;
    stopped at the cap short of the tolerance, status 1, on another) as
    (max, count) each, the lanes differing in OCP infeasibility at each
    step, and the largest |dU|/box of each step.  With ``cap`` (lmpc_loop)
    the lane-steps on which both runs stopped at the cap unconverged, whose
    label (1, feasible, or 2, not) rests on the feasibility error at the
    cap, are put apart and returned as a fourth kind (max, count, their
    infeasibility differences), and a lane-step differing in infeasibility
    (counted against the limit) is not held to a U tolerance: its input is
    the previous one on one side."""
    du = (np.abs(h32["U"] - H64["U"]) / u_box).max(axis=2)          # (Nsim, lanes)
    same = h32["OCP_ITERS"] == H64["OCP_ITERS"]
    short = ~same & (h32["STATUS_DYN"] == 1)
    diff = (h32["STATUS_DYN"] == 2) != (H64["STATUS_DYN"] == 2)
    held = np.ones_like(same)
    apart = None
    if cap is not None:
        capped = ((h32["OCP_ITERS"] == cap) & (H64["OCP_ITERS"] == cap)
                  & (h32["STATUS_DYN"] != 0) & (H64["STATUS_DYN"] != 0))
        apart = (float(du[capped].max()) if capped.any() else 0.0, int(capped.sum()),
                 (diff & capped).sum(1).tolist())
        diff = diff & ~capped
        held = ~capped & ~diff
    kinds = [(float(du[m].max()) if m.any() else 0.0, int(m.sum()))
             for m in (same & held, ~same & ~short & held, short & held)]
    return kinds, diff.sum(1), du.max(axis=1), apart


def describe(kinds, st, apart=None):
    (s, ns), (m, nm), (sh, nsh) = kinds
    out = (f"max |dU|/box {s:.3e} over {ns} lane-steps on the same OCP iteration "
           f"(tol {U_TOL:g}), {m:.3e} over {nm} converged on another (tol "
           f"{U_TOL_MOVED:g}), {sh:.3e} over {nsh} stopped at the cap short of "
           f"the tolerance (reported); OCP infeasibility differences per step "
           f"{st.tolist()} (at most {LOOP_STATUS_DIFF_MAX})")
    if apart is not None:
        out += (f"; both runs stopped at the cap unconverged (reported): {apart[1]} "
                f"lane-steps, max |dU|/box {apart[0]:.3e}, infeasibility "
                f"differences per step {apart[2]}")
    return out


LOOP_WORKLOADS = {"cstr_loop": "closed_loop_workload", "lmpc_loop": "lmpc_loop_workload",
                  "enmpc_loop": "enmpc_loop_workload"}


def check_lanes(step, cfg, c64, nsim, t0=0.0, k0=0):
    """A closed loop's check lanes from the f64 carry ``c64``: the f64 run
    of ``nsim`` steps and, from each of its steps' states, one f32 step.
    Returns their histories (H64, R32) as numpy."""
    import torch

    from mpc_code_tpu_torch.loop.batched import (
        cast_carry, history_from_outputs, stack_outputs,
    )
    from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

    inputs = make_step_inputs(cfg, nsim, t0=t0, k0=k0)
    outs64, outs32 = [], []
    for k in range(nsim):
        inp = StepInput(*(a[k] for a in inputs))
        outs32.append(step(cast_carry(c64, torch.float32), inp)[1])
        c64, out = step(c64, inp)
        outs64.append(out)
    return (history_from_outputs(stack_outputs(outs64)),
            history_from_outputs(stack_outputs(outs32)))


def loop_phase(dev, loop: Loop, launches, cpu_refs, card_jobs):
    """A warm batched closed loop (``examples/closed_loop_workload.py``, the
    CSTR NMPC; ``examples/lmpc_loop_workload.py``, the LMPC on the
    nonlinear CSTR plant; ``examples/enmpc_loop_workload.py``, the ENMPC
    flagship with the MHE) at B lanes in f32 for ``loop.nsim`` steps: per
    step the wall time and each phase's, MHE, target and OCP iterations,
    infeasible shares, the launches of the path's kernels (in the OCP each
    of ``loop.ocp_kernels`` once per pass of the OCP solver, and in the MHE
    each of ``loop.mhe_kernels``, kernels 2 and 5, once per pass of the MHE
    solver, on every step) and the share of non-finite lanes;
    the steps of ``loop.profile_steps`` replayed with the phases of
    ``loop.profile`` under the profiler for their launches per pass; then
    the first N_CHECK lanes run on the card in f64 against the CPU f64 run,
    with one f32 step from each of their steps' states held against the
    f64 step."""
    import torch

    from mpc_code_tpu_torch.loop.batched import cast_carry, init_carry, map_carry
    from mpc_code_tpu_torch.loop.schedules import make_step_inputs

    failures = []
    name, wl, U_BOX, nsim = loop.name, loop.wl, loop.u_box, loop.nsim
    cfg = wl.make_config()
    cap = cfg.sol_opts_dyn.max_iter
    step = wl.make_step(cfg, device=dev)
    if loop.warmup:
        t0 = time.perf_counter()
        wl.run_loop(cfg, wl.draw_x0(256, dev), Nsim=2, step=step)     # warm-up run
        log(f"# {name} warm-up run (256 lanes, 2 steps): {time.perf_counter() - t0:.2f} s")
    # a phase that starts from a handed-off carry (enmpc_handoff) instead of
    # step 0
    begin = loop.start(dev, cfg) if loop.start is not None else {}
    failures += begin.get("failures", [])
    t_start, k_start = begin.get("t0", 0.0), begin.get("k0", 0)

    # the launch counts at the end of the estimate phase (the MHE's share)
    at_estimate = {}

    def counted_step(c, inp, mark=None):
        def mk(phase):
            if phase == "estimate":
                at_estimate.update({k: m.LAUNCHES for k, m in loop.counters.items()})
            if mark is not None:
                mark(phase)

        return step(c, inp, mark=mk)

    prof_steps = range(nsim) if loop.profile_steps is None else loop.profile_steps
    per_step, carries = [], {}

    def on_step(k, carry, out):
        counts = {}
        for kname, mod in loop.counters.items():
            counts[kname] = mod.LAUNCHES
            counts[f"{kname}_mhe"] = at_estimate[kname]
            mod.LAUNCHES = 0
        est = carry.mhe if loop.mhe else carry
        finite = lambda a: torch.isfinite(a).flatten(1).all(1)  # noqa: E731
        bad = ~(finite(est.P) & finite(carry.xhat) & finite(carry.x))
        q = lambda a: [float(np.median(a)), float(np.percentile(a, 90)), int(a.max())]  # noqa: E731
        row = dict(
            step=k, target_iters=q(out.ss_iters.cpu().numpy()),
            ocp_iters=q(out.ocp_iters.cpu().numpy()), ocp_passes=ocp_passes(out),
            target_infeasible=float((out.status_ss == 2).float().mean()),
            ocp_infeasible=float((out.status_dyn == 2).float().mean()),
            **counts,
            nonfinite=float(bad.float().mean()),
            nonfinite_P=float((~finite(est.P)).float().mean()),
            nonfinite_xhat=float((~finite(carry.xhat)).float().mean()),
            nonfinite_check_lanes=int(bad[:N_CHECK].sum()))
        if loop.mhe:
            row.update(
                mhe_iters=q(out.mhe_iters.cpu().numpy()), mhe_passes=mhe_passes(out),
                mhe_status_counts=np.bincount(out.mhe_status.cpu().numpy(),
                                              minlength=3).tolist(),
                nonfinite_x_bar=float((~finite(est.x_bar)).float().mean()),
                nonfinite_Pycondx_inv=float((~finite(est.sm.Pycondx_inv)).float().mean()))
        per_step.append(row)
        if k + 1 in prof_steps and loop.profile:
            carries[k + 1] = carry

    torch.cuda.reset_peak_memory_stats(dev)
    x0s = None if begin else wl.draw_x0(B, dev)
    if 0 in prof_steps and loop.profile:
        carries[0] = begin.get("carry") or init_carry(cfg, x0s, device=dev, dtype=x0s.dtype)
    for mod in loop.counters.values():
        mod.LAUNCHES = 0
    H32, times = wl.run_loop(cfg, x0s, Nsim=nsim, step=counted_step, on_step=on_step,
                             carry=begin.get("carry"), t0=t_start, k0=k_start)
    for kname in loop.counters:
        launches[f"{kname}_{name}"] = sum(r[kname] for r in per_step)
        launches[f"{kname}_{name}_mhe"] = sum(r[f"{kname}_mhe"] for r in per_step)
    for r, tm in zip(per_step, times):
        r.update(wall_ms=1e3 * tm["wall_s"],
                 **{f"{ph}_ms": 1e3 * tm[ph] for ph in wl.PHASES})
        log(f"# {name} step " + json.dumps(r))
    wall = sum(tm["wall_s"] for tm in times)
    warm = times[1:]
    split = {ph: float(np.mean([tm[ph] for tm in warm])) * 1e3 for ph in wl.PHASES}
    it = H32["OCP_ITERS"]
    report = dict(
        batch=B, N=wl.N, Mx=getattr(wl, "MX", None), steps=nsim, wall_s=wall,
        lane_steps_per_s=B * nsim / wall,
        step0_ms=1e3 * times[0]["wall_s"],
        warm_step_ms=float(np.mean([tm["wall_s"] for tm in warm])) * 1e3,
        warm_split_ms=split,
        ocp_iters_cold_median=float(np.median(it[0])),
        ocp_iters_warm_median=float(np.median(it[1:])),
        ocp_iters_cold_mean=float(it[0].mean()), ocp_iters_warm_mean=float(it[1:].mean()),
        target_iters_median=float(np.median(H32["SS_ITERS"])),
        ocp_ok_share=float((H32["STATUS_DYN"] != 2).mean()),
        target_ok_share=float((H32["STATUS_SS"] != 2).mean()),
        ocp_status_counts=[np.bincount(r, minlength=3).tolist() for r in H32["STATUS_DYN"]],
        launches={k: launches[f"{k}_{name}"] for k in loop.counters},
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        **begin.get("report", {}))
    if loop.mhe:
        report.update(
            step_ms=[1e3 * tm["wall_s"] for tm in times],
            estimate_ms=[1e3 * tm["estimate"] for tm in times],
            mhe_iters_median_by_step=np.median(H32["MHE_ITERS"], 1).tolist(),
            mhe_ok_share=float((H32["MHE_STATUS"] != 2).mean()),
            launches_mhe={k: launches[f"{k}_{name}_mhe"] for k in loop.counters})
    log(f"# {name} " + json.dumps(report))
    # in the OCP each of its kernels launches once a pass of the OCP solver;
    # in the MHE each of its kernels (kernels 2 and 5) once a pass of the
    # MHE solver, and no other kernel
    ocp_kernels = loop.counters if loop.ocp_kernels is None else loop.ocp_kernels
    for r in per_step:
        for k in loop.counters:
            in_mhe = r.get("mhe_passes", 0) if k in loop.mhe_kernels else 0
            in_ocp = r["ocp_passes"] if k in ocp_kernels else 0
            if r[k] - r[f"{k}_mhe"] != in_ocp or r[f"{k}_mhe"] != in_mhe:
                failures.append(f"{name}: {k}'s launches on step {r['step']} "
                                f"({r[f'{k}_mhe']} in the estimator, {r[k]} in all) "
                                f"differ from the solvers' passes")
    if any(r["nonfinite_check_lanes"] for r in per_step):
        failures.append(f"{name}: a non-finite lane among the check lanes")

    if loop.profile:
        # the chosen steps again from their input carries, under the profiler
        t0 = time.perf_counter()
        rows = profile_steps(step, carries,
                             make_step_inputs(cfg, nsim, t0=t_start, k0=k_start),
                             loop.profile)
        for r in rows:
            log(f"# {name} profile, {r['phase']} " + json.dumps(r))
        for ph, key in (("ocp", "ocp"), ("estimate", "mhe")):
            sel = [r for r in rows if r["phase"] == ph]
            if sel:
                report[f"{key}_launches_per_pass"] = [r["launches_per_pass"] for r in sel]
                report[f"{key}_busy_share"] = [r["busy_share"] for r in sel]
                report[f"{key}_ms_per_pass"] = [r["ms_per_pass"] for r in sel]
        log(f"# {name} profiled replay: {time.perf_counter() - t0:.1f} s")
        del carries

    # the first N_CHECK lanes: the card's f64 run against the CPU f64 run
    # (worker process); from each of its steps' states one f32 step on the
    # card; the main run's free-running f32 lanes, reported.  From step 0
    # the card's side runs in a process of its own (``card_job``
    # "loop_check", started with the phases beside the kernel phases)
    t0 = time.perf_counter()
    if begin:
        # the handed-off carry's first lanes, cast to f64
        c64 = cast_carry(map_carry(lambda a: a[:N_CHECK], begin["carry"]), torch.float64)
        H64, R32 = check_lanes(step, cfg, c64, nsim, t_start, k_start)
    elif ("loop_check", name) in card_jobs:
        H64, R32, check_s = card_jobs[("loop_check", name)].result()
        log(f"# {name} check lanes on the card, in a process of their own: {check_s:.1f} s")
    else:
        c64 = init_carry(cfg, wl.draw_x0(N_CHECK, dev, dtype=torch.float64), device=dev)
        H64, R32 = check_lanes(step, cfg, c64, nsim, t_start, k_start)
    ref = (begin["ref"] if begin else cpu_refs[(name, "float64")]).result()[0]
    equal_keys = ("STATUS_SS", "STATUS_DYN", "OCP_ITERS")
    err_keys = ("U", "Xp")
    if loop.mhe:
        equal_keys += ("SS_ITERS", "MHE_STATUS", "MHE_ITERS")
        err_keys += ("X_HAT_CORR", "D_HAT")
    f64_st = all((H64[k] == ref[k]).all() for k in equal_keys)
    f64_err = max(nerr(torch.as_tensor(H64[k]), torch.as_tensor(ref[k])) for k in err_keys)
    it64 = H64["OCP_ITERS"]
    log(f"# {name} cross-check, gpu f64 ({N_CHECK} lanes x {nsim} steps): "
        f"{', '.join(equal_keys)} equal {f64_st}, max norm err {'/'.join(err_keys)} "
        f"{f64_err:.3e} (tol {LOOP_F64_TOL:g}); f64 OCP iterations median / mean cold "
        f"{np.median(it64[0]):g} / {it64[0].mean():.2f}, warm {np.median(it64[1:]):g} / "
        f"{it64[1:].mean():.2f}")
    report.update(f64_ocp_iters_cold_mean=float(it64[0].mean()),
                  f64_ocp_iters_warm_mean=float(it64[1:].mean()))
    if not (f64_st and f64_err <= LOOP_F64_TOL):
        failures.append(f"{name}: gpu f64 against cpu f64: statuses equal {f64_st}, "
                        f"err {f64_err:.3e}")

    kcap = cap if loop.cap_apart else None
    kinds, st_diff, _, apart = against_f64(R32, H64, U_BOX, kcap)
    log(f"# {name} cross-check, gpu f32 step by step from the f64 states: "
        + describe(kinds, st_diff, apart))
    (du_s, _), (du_m, _), (du_short, n_short) = kinds
    if not (du_s <= U_TOL and du_m <= U_TOL_MOVED and st_diff.max() <= LOOP_STATUS_DIFF_MAX):
        failures.append(f"{name}: f32 steps against f64: dU/box {du_s:.3e} / {du_m:.3e}, "
                        f"infeasibility differences {st_diff.tolist()}")
    if loop.mhe:
        # the f32 step's MHE estimate against the f64 step's, reported
        est_err = max(nerr(torch.as_tensor(R32[k]), torch.as_tensor(H64[k]))
                      for k in ("X_HAT_CORR", "D_HAT"))
        mhe_same = float((R32["MHE_ITERS"] == H64["MHE_ITERS"]).mean())
        st32 = np.bincount(R32["MHE_STATUS"].ravel(), minlength=3).tolist()
        log(f"# {name} f32 step's MHE against f64 (reported): max norm err of the "
            f"estimate {est_err:.3e}, share of lane-steps on the same MHE iteration "
            f"{mhe_same:.4f}, f32 MHE statuses {st32}")
        report.update(xcheck_f32_step_estimate_err=est_err,
                      xcheck_f32_step_mhe_same_iter_share=mhe_same)
    free = {k: v[:, :N_CHECK] for k, v in H32.items()}
    fr_kinds, fr_st, fr_step, fr_apart = against_f64(free, H64, U_BOX, kcap)
    log(f"# {name} free-running f32 lanes against the f64 run (reported, not held): "
        f"max |dU|/box per step {np.round(fr_step, 4).tolist()}; "
        + describe(fr_kinds, fr_st, fr_apart))
    report.update(xcheck_gpu_f64_err=f64_err, xcheck_f32_step_du_same=du_s,
                  xcheck_f32_step_du_moved=du_m, xcheck_f32_step_du_short=du_short,
                  xcheck_f32_step_short=n_short,
                  xcheck_f32_step_status_diff_max=int(st_diff.max()),
                  free_f32_du_max=float(fr_step.max()),
                  free_f32_status_diff_max=int(fr_st.max()))
    if apart is not None:
        report.update(xcheck_f32_step_capped=apart[1], xcheck_f32_step_capped_du=apart[0])
    log(f"# {name} cpu f64 cross-check: {time.perf_counter() - t0:.1f} s")
    return failures, report


def kernel_counters():
    """Every kernel's launch counter: name -> the module whose LAUNCHES
    counts it."""
    from mpc_code_tpu_torch.ops import sweep_cf_cuda, sweep_cuda, sweep_map_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    return {"rk4_stage_jac": sweep_cuda, "riccati_kkt": rk,
            "rk4_quad_stage_hess": sweep_cf_cuda, "map_stage_jac": sweep_map_cuda,
            "stage_sweep": sk}


class HostWindow:
    """Device launches and host synchronisations of one stretch of host
    code under torch.profiler (CUDA activity only): the kernels, and the
    device-to-host copies, each of which the host waits for (every
    ``np.asarray`` of a result, every ``bool()`` of a solver's loop test)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.result = None

    def start(self):
        import torch

        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        # the raw device events: a host step has ~380,000 kernels, and the
        # profiler's own aggregation (key_averages) of them takes ~70 s
        launches = syncs = busy_ns = 0
        for e in self.prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            name = e.name()
            busy_ns += e.duration_ns()
            if name.startswith("Memcpy DtoH"):
                syncs += 1
            elif not name.startswith(("Memcpy", "Memset")):
                launches += 1
        self.result = dict(wall_ms=1e3 * wall, launches=launches, host_syncs=syncs,
                           busy_share=busy_ns / 1e9 / wall)


def host_fixture(name, nsim, n, n_mhe, profile_step, device):
    """One reduced fixture through ``ClosedLoop`` on ``device`` in f64: (the
    history, the per-step stats, the launches of every kernel, the MHE's
    kernel-2 and kernel-5 launches and passes per step, the profiled step,
    the wall seconds)."""
    import dataclasses

    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    mod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    cfg = mod.make_config(Nsim=nsim).replace(N=n)
    if n_mhe is not None:
        cfg.estimator = dataclasses.replace(cfg.estimator, N_mhe=n_mhe)
    loop = ClosedLoop(cfg, device=device)
    mhe_rows, window = [], HostWindow()
    if cfg.estimator.kind == "mhe":
        rt, inner = loop.mhe_rt, loop.mhe_rt.step

        def counted(ksim, *a):
            # the profiled window: from this step's MHE to the next one's
            if ksim == profile_step:
                window.start()
            elif profile_step is not None and ksim == profile_step + 1:
                window.stop()
            before = rk.LAUNCHES, sk.LAUNCHES
            out = inner(ksim, *a)
            mhe_rows.append(dict(launches=rk.LAUNCHES - before[0],
                                 stage_sweep=sk.LAUNCHES - before[1],
                                 passes=rt.last_iters + int(rt.last_status == 0)))
            return out

        rt.step = counted
    mods = kernel_counters()
    for m in mods.values():
        m.LAUNCHES = 0
    t0 = time.perf_counter()
    H = loop.run()
    wall = time.perf_counter() - t0
    return (H, loop.step_stats, {k: m.LAUNCHES for k, m in mods.items()}, mhe_rows,
            window.result, wall)


def card_job(job, *args):
    """A run on the card in a process of its own (spawned, so it imports
    what it needs itself), beside the main process's phases:
    "fixture" (``host_fixture``'s tuple), "cli" (the command line's exit
    code, seconds and kernel-2 and kernel-5 launches; its prints go to
    stderr) or "handoff_warmup" (``host_warmup``: the one-lane carry as
    numpy, the loop's step stats and final state, its history, its seconds
    and kernel-2 and kernel-5 launches) or "loop_check" (a closed loop's check lanes from
    step 0, ``check_lanes``, and its seconds).  The kernels load from the
    builds of ``main``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import contextlib

    import torch

    from mpc_code_tpu_torch.device import pin_fp32_precision
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    torch.set_num_threads(CPU_REF_THREADS)
    pin_fp32_precision()
    dev = torch.device("cuda")
    if job == "fixture":
        return host_fixture(*args, dev)
    rk.LAUNCHES = sk.LAUNCHES = 0
    t0 = time.perf_counter()
    if job == "cli":
        from mpc_code_tpu_torch.examples import __main__ as cli

        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(["enmpc", "--nsim", str(CLI_NSIM), "--save", args[0]])
        return rc, time.perf_counter() - t0, rk.LAUNCHES, sk.LAUNCHES
    if job == "loop_check":
        import importlib

        from mpc_code_tpu_torch.loop.batched import init_carry

        name, nsim = args
        wl = importlib.import_module(f"mpc_code_tpu_torch.examples.{LOOP_WORKLOADS[name]}")
        cfg = wl.make_config()
        c64 = init_carry(cfg, wl.draw_x0(N_CHECK, dev, dtype=torch.float64), device=dev)
        H64, R32 = check_lanes(wl.make_step(cfg, device=dev), cfg, c64, nsim)
        return H64, R32, time.perf_counter() - t0
    from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
    from mpc_code_tpu_torch.loop.batched import map_carry

    carry, loop, H, warm_s = mw.host_warmup(mw.make_config(warm_handoff=True), dev)
    return (map_carry(lambda a: a.cpu().numpy(), carry), loop.step_stats,
            loop.final_state, H, warm_s, rk.LAUNCHES, sk.LAUNCHES)


def host_loop_phase(dev, launches, card_pool):
    """The host loop ``ClosedLoop`` on the card in f64: the reduced fixtures
    ``fixtures/enmpc.npz`` (the MHE, 'smooth', its window by the structured
    IPM: kernels 5 and 2 at (N_w+1, 4, 4), one lane) and ``fixtures/nmpc.npz``
    (the EKF) within FIXTURE_BAR on every recorded key; per step the phase
    ms, the iterations and statuses; kernels 2's and 5's launches in the MHE
    equal to its solver's passes on every step and no other launch (the target and
    the OCP are dense IPMs); one ENMPC step (HOST_PROFILE_STEP) under the
    profiler for its launches and host synchronisations; the command line
    ``python -m mpc_code_tpu_torch.examples enmpc --nsim CLI_NSIM --save``
    at the example's size (N=25, N_mhe=10), read back by ``utils/io``.
    The nmpc fixture and the command line run in ``card_pool``'s processes
    beside the ENMPC fixture."""
    import tempfile

    from mpc_code_tpu_torch import native
    from mpc_code_tpu_torch.utils.io import load_history

    failures, report = [], {}
    beside = {name: card_pool.submit(card_job, "fixture", name, nsim, n, n_mhe, None)
              for name, nsim, n, n_mhe in HOST_FIXTURES if n_mhe is None}
    path = os.path.join(tempfile.mkdtemp(), "enmpc.npz")
    cli_job = card_pool.submit(card_job, "cli", path)
    # the native host core (native/hostcore.cpp by g++): the host MHE's
    # 'smooth' update runs its backward smoother
    report["native_available"] = native.available()
    log(f"# host_loop native host core available: {report['native_available']} "
        f"({native.library_path()})")
    if not report["native_available"]:
        failures.append("host_loop: the native host core did not build or load")
    for name, nsim, n, n_mhe in HOST_FIXTURES:
        H, stats, counts, mhe_rows, window, wall = (
            beside[name].result() if name in beside else
            host_fixture(name, nsim, n, n_mhe, HOST_PROFILE_STEP, dev))
        ref = np.load(os.path.join(ROOT, "fixtures", f"{name}.npz"))
        devs = {k: float(np.abs(H[k] - ref["H_" + k]).max())
                for k in FIXTURE_KEYS if "H_" + k in ref.files and len(H[k])}
        for k, st in enumerate(stats):
            row = dict(config=name, step=k, **{f"{ph}_ms": 1e3 * st[f"{ph}_s"]
                                       for ph in ("estimate", "target", "ocp", "plant")},
                       **{f: st[f] for f in ("mhe_iters", "mhe_status", "ss_iters",
                                             "status_ss", "dyn_iters", "status_dyn")
                          if f in st})
            if mhe_rows:
                row.update(riccati_kkt_mhe=mhe_rows[k]["launches"],
                           stage_sweep_mhe=mhe_rows[k]["stage_sweep"],
                           mhe_passes=mhe_rows[k]["passes"])
            log("# host_loop step " + json.dumps(row))
        r = dict(steps=nsim, N=n, wall_s=wall, step_ms=1e3 * wall / nsim,
                 max_dev=devs, launches=counts, profiled_step=window)
        report[name] = r
        log(f"# host_loop {name} " + json.dumps(r))
        launches["riccati_kkt_host_loop"] += counts["riccati_kkt"]
        launches["stage_sweep_host_loop"] = (launches.get("stage_sweep_host_loop", 0)
                                             + counts["stage_sweep"])
        bad = [k for k, v in devs.items() if not v <= FIXTURE_BAR]
        if bad or not devs:
            failures.append(f"host_loop {name}: {bad} beyond {FIXTURE_BAR:g} of the "
                            f"fixture ({devs})")
        # kernels 2 and 5 once a pass of the MHE's window solve
        if any(row[k] != row["passes"] for row in mhe_rows
               for k in ("launches", "stage_sweep")):
            failures.append(f"host_loop {name}: kernel 2's and kernel 5's launches in the "
                            f"MHE {[(row['launches'], row['stage_sweep']) for row in mhe_rows]}"
                            f" differ from its passes {[row['passes'] for row in mhe_rows]}")
        others = {k: v for k, v in counts.items() if k not in ("riccati_kkt", "stage_sweep")}
        if any(others.values()) or any(counts[k] != sum(row[f] for row in mhe_rows) for k, f in
                                       (("riccati_kkt", "launches"),
                                        ("stage_sweep", "stage_sweep"))):
            failures.append(f"host_loop {name}: kernels launched outside the MHE {counts}")
    if report["enmpc"]["profiled_step"] is None:
        failures.append("host_loop: the profiled step did not run")

    # the command line at the example's own size
    rc, cli_s, cli_launches, cli_k5 = cli_job.result()
    launches["stage_sweep_host_loop_cli"] = cli_k5
    H, meta = load_history(path)
    need = ("Xp", "Yp", "U", "XS", "US", "X_HAT", "D_HAT", "STATUS_SS", "STATUS_DYN")
    ok = (rc == 0 and all(k in H and len(H[k]) == CLI_NSIM for k in need)
          and all(np.isfinite(H[k]).all() for k in need)
          and not (H["STATUS_DYN"] == 2).any() and float(meta["h"]) == 2.0
          and cli_k5 == cli_launches > 0)
    report["cli"] = dict(rc=rc, seconds=cli_s, keys=sorted(H), riccati_kkt=cli_launches,
                         stage_sweep=cli_k5,
                         status_dyn=H.get("STATUS_DYN", np.zeros(0)).tolist())
    log("# host_loop cli " + json.dumps(report["cli"]))
    if not ok:
        failures.append(f"host_loop: the command line's run or its history file "
                        f"({report['cli']})")
    return failures, report


def handoff_start(pool, cpu_refs, card_jobs, launches):
    """enmpc_handoff's start: the host warmup (``ClosedLoop``, K0 = N_mhe +
    2 steps, f32 on the card, one lane; ``card_jobs["handoff_warmup"]``, a
    ``card_job`` started with host_loop) held against the CPU's f64 run of
    the same steps (every status equal, U within U_TOL of the input box on
    every step, every value finite), then ``carry_from_runtime`` and
    ``init_carry`` tiled to B lanes; the CPU's f64 continuation of the
    first N_CHECK lanes goes to a worker."""
    def start(dev, cfg):
        import torch

        from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
        from mpc_code_tpu_torch.loop.batched import map_carry

        failures = []
        k0 = mw.handoff_steps(cfg)
        carry1, stats32, final, H32, warm_s, warm_launches, warm_k5 = card_jobs[
            "handoff_warmup"].result()
        carry = mw.tile_handoff(cfg, map_carry(lambda a: torch.as_tensor(a, device=dev),
                                               carry1), B)
        H64, stats64 = cpu_refs[("enmpc_handoff_warmup", "float64")].result()[0]
        du = (np.abs(H32["U"] - H64["U"]) / mw.U_BOX).max(axis=1)
        st32 = [(s["mhe_status"], s["status_ss"], s["status_dyn"]) for s in stats32]
        st64 = [(s["mhe_status"], s["status_ss"], s["status_dyn"]) for s in stats64]
        finite = all(np.isfinite(np.asarray(v, float)).all() for v in H32.values())
        for k, st in enumerate(stats32):
            log("# enmpc_handoff warmup step " + json.dumps(dict(
                step=k, **{f"{ph}_ms": 1e3 * st[f"{ph}_s"]
                           for ph in ("estimate", "target", "ocp", "plant")},
                mhe_iters=st["mhe_iters"], ss_iters=st["ss_iters"],
                dyn_iters=st["dyn_iters"], statuses=st32[k], statuses_f64=st64[k],
                iters_f64=[stats64[k][f] for f in ("mhe_iters", "ss_iters", "dyn_iters")],
                du_box=float(du[k]))))
        report = dict(warmup_steps=k0, warmup_s=warm_s, warmup_du_max=float(du.max()),
                      warmup_statuses_equal=st32 == st64, warmup_finite=finite,
                      warmup_riccati_kkt=warm_launches, warmup_stage_sweep=warm_k5)
        log("# enmpc_handoff warmup " + json.dumps(report))
        launches["stage_sweep_enmpc_handoff_warmup"] = warm_k5
        # the host MHE's window solves launch kernels 2 and 5 once a pass
        # each, and nothing else launches
        if not warm_k5 == warm_launches > 0:
            failures.append(f"enmpc_handoff: the warmup's kernel-5 launches {warm_k5} "
                            f"differ from its kernel-2 launches {warm_launches}")
        if not (st32 == st64 and du.max() <= U_TOL and finite):
            failures.append(f"enmpc_handoff: the f32 warmup against the CPU f64 run: "
                            f"statuses equal {st32 == st64}, max |dU|/box {du.max():.3e} "
                            f"(tol {U_TOL:g}), finite {finite}")
        lanes = map_carry(lambda a: a[:N_CHECK].cpu().numpy(), carry)
        ref = pool.submit(cpu_reference, "enmpc_handoff", "float64", lanes, final["t"], k0)
        return dict(carry=carry, t0=final["t"], k0=k0, ref=ref, failures=failures,
                    report=report)

    return start


def clb_phase(dev, launches):
    """The port of ``tools/closed_loop_bench.py``
    (``examples/closed_loop_bench.py``) at its defaults: B=1024, 20 steps,
    cap 10, f32 on the card; its two lines, with the Riccati kernel's and
    kernel 5's launches counted over its four runs (warm-up and three
    timed), equal to each other."""
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    rk.LAUNCHES = sk.LAUNCHES = 0
    lines, r = cb.run(CLB_BATCH, CLB_STEPS, 10, device=dev)
    launches["riccati_kkt_clb"] = rk.LAUNCHES
    launches["stage_sweep_clb"] = sk.LAUNCHES
    for line in lines:
        log(line)
    st = r["status"]
    report = dict(batch=CLB_BATCH, steps=CLB_STEPS, run_s=r["run_s"], reps_s=r["reps_s"],
                  compile_s=r["compile_s"], lane_steps_per_s=r["lane_steps_per_s"],
                  ocp_status_counts=np.bincount(st.ravel(), minlength=3).tolist(),
                  ocp_iters_median_by_step=np.median(r["iters"], 1).tolist(),
                  riccati_kkt=rk.LAUNCHES, stage_sweep=sk.LAUNCHES)
    log("# clb " + json.dumps(report))
    failures = []
    # kernel 5's Gauss-Newton build of the linear CSTR and kernel 2, once a
    # pass of the OCP solver each
    if rk.LAUNCHES <= 0 or sk.LAUNCHES != rk.LAUNCHES:
        failures.append(f"clb: kernel 2 launched {rk.LAUNCHES} times, kernel 5 "
                        f"{sk.LAUNCHES} (once a pass each)")
    if not np.isfinite(r["run_s"]):
        failures.append("clb: no run time")
    return failures, report


# ---------------------------------------------------------------------------
# constrained phase: collocation, soft output bounds, TermCons with H_eq
# ---------------------------------------------------------------------------

# The bench workload (B lanes in f32, pass-1 cap 12, the rescue at cap 40)
# through three transcriptions of the CSTR OCP: "colloc" (Gauss-Legendre
# collocation condensed within each stage; kernel 5's Gauss-Newton build
# of it and kernel 2 at (50, 3, 2), kernel 1 bypassed), "soft" (the shared
# output slacks, Ws = 10 I: kernels 1 and 2, kernel 2 at (50, 7, 6)) and
# "tc_heq" (the terminal equality and
# the stage equality of tests/test_riccati.py:425-430: kernel 1 and the
# plain bordered recursion, no kernel 2).  CONSTRAINED_CHECK lanes (the
# first of the same draws) are solved again in f64 to CONSTRAINED_TOL by
# the same structured solver on the card and on the CPU: equal statuses
# and iterations, X and U within CONSTRAINED_F64_TOL; and by the dense
# transcription (build_ocp_collocation or build_ocp through the dense IPM,
# lane by lane, on the CPU) to the same tolerance: U within
# CONSTRAINED_DENSE_TOL where both converged (normalised |a-b|/(1+|b|)).
# The two transcriptions' answers part by ~6e3 times the KKT tolerance on
# these lanes (a flat valley of the cost along the coolant temperature):
# 6.3e-5 of the box at 1e-8, 1.0e-6 at 1e-10 (CPU runs of these lanes), so the
# check solves to 1e-10.  Under TermCons, x_N = xs within
# CONSTRAINED_TC_TOL on every converged lane.  The check solves stop at
# CONSTRAINED_CHECK_CAP iterations (every converging check lane takes 37
# or fewer; the tc_heq draws that do not converge ran to 100 before, 28 s
# of the card's time) and the dense ones at CONSTRAINED_DENSE_CAP.  The
# runs take CONSTRAINED_B lanes, and the dense transcription the first
# CONSTRAINED_DENSE_LANES check lanes: at 16,384 lanes and 8 dense lanes
# (the dense IPM, ~7-15 s a lane on one core; a batch of lanes costs as
# much a lane-iteration on the CPU and runs to its slowest lane's count)
# the phase took 212 s on the H100 and the whole smoke ran past its
# limit; at 4,096 lanes and 4 dense lanes, 116 s of 1,331 s, within the
# phase's ~150 s, and 112 s of 1,117 s once the mesh, debug and aot
# phases were added, so the runs take 2,048 lanes since (the checks
# unchanged).  The iterations of the tc_heq run are reported, not held
# equal: there the merit test that quarters the step compares values that
# differ by less than the residuals' rounding near the optimum (c_norm
# weighted by a penalty of ~330), and a relative change of 1e-15 in x0
# moves a lane's count by one on the CPU, in the JAX solver as in the
# port's (tests/test_torch_structured_constrained.py::
# test_termcons_heq_iterations_follow_rounding).  Its statuses, X and U
# are held as the others'.  The bordered recursion itself is held on the
# card against its CPU run, with and without each kind of row
# (BORDERED_CASES), to CONSTRAINED_TOL in f64.
CONSTRAINED_ITERS_BY_ROUNDING = ("tc_heq",)
CONSTRAINED_B = 2048
CONSTRAINED_CHECK = 8
CONSTRAINED_DENSE_LANES = 4
CONSTRAINED_TOL = 1e-10
CONSTRAINED_CHECK_CAP = 50
CONSTRAINED_DENSE_CAP = 100
CONSTRAINED_OPTS = dict(max_iter=CONSTRAINED_CHECK_CAP, tol=CONSTRAINED_TOL,
                        constr_viol_tol=1e-8, hessian="gauss_newton")
BORDERED_CASES = ((1, 0), (0, 3), (1, 3), (0, 0))   # (n_eq, n_tc)
CONSTRAINED_F64_TOL = 1e-8
CONSTRAINED_DENSE_TOL = 1e-6
CONSTRAINED_TC_TOL = 1e-7


def heq_line(x, u, y, d, t, px, py):
    """The stage equality of tests/test_riccati.py:425-430: a control
    allocation line through the steady pair (us, xs), coupled to the
    temperature."""
    import torch

    return torch.atleast_1d(u[0] + 50.0 * u[1] - 305.157 - 0.1 * (x[1] - 325.0))


def gineq_line(x, u, y, d, t, px, py):
    """A stage inequality written as heq_line is: a floor on the coolant
    temperature that rises with the reactor's, which binds on part of the
    bench's lanes under TermCons and heq_line (4 of 16 on the CPU)."""
    import torch

    return torch.atleast_1d(297.5 - u[0] + 0.05 * (x[1] - 325.0))


def constrained_runs():
    """name -> the bench config's overrides of one run."""
    return {"colloc": dict(Collocation=True),
            "soft": dict(slacks=True, Ws=10.0 * np.eye(4)),
            "tc_heq": dict(TermCons=True, H_eq=heq_line)}


def constrained_check_solve(name, device):
    """The check lanes' structured solve in f64 to CONSTRAINED_TOL, from
    the bench's warm start: status, iters, X and U of the
    model's state and inputs, as numpy."""
    import torch

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, bench_params, draw_x0, make_problem, warm_start,
    )
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    cfg, model, socp, _ = make_problem(device, **constrained_runs()[name])
    solve = make_structured_solver(socp, SolverOptions(**CONSTRAINED_OPTS))
    kw = dict(dtype=torch.float64, device=device)
    x0 = draw_x0(CONSTRAINED_CHECK, device, dtype=torch.float64)
    X0, U0 = warm_start(cfg, model, x0, torch.as_tensor(U_SS, **kw).expand(len(x0), cfg.nu))
    pad = (0, socp.ns)
    r = solve(bench_params(cfg, x0), torch.nn.functional.pad(X0, pad),
              torch.nn.functional.pad(U0, pad))
    return dict(status=r.status.cpu().numpy(), iters=r.iters.cpu().numpy(),
                X=r.X[..., :cfg.nx].cpu().numpy(), U=r.U[..., :cfg.nu].cpu().numpy())


def constrained_dense(name):
    """The first CONSTRAINED_DENSE_LANES check lanes through the dense
    transcription on the CPU in f64, one lane at a time (a lane's line search does not hold up the others):
    the collocation OCP (ocp/collocation.py) or the shooting OCP
    (ocp/shooting.py) by the dense IPM, from the bench's warm start (s1, s2
    at the next state).  Returns status and U, as numpy."""
    import torch

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, bench_params, draw_x0, make_problem, warm_start,
    )
    from mpc_code_tpu_torch.models import build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.ocp.collocation import build_ocp_collocation
    from mpc_code_tpu_torch.ocp.shooting import build_ocp
    from mpc_code_tpu_torch.solver.ipm import make_solver

    cpu = torch.device("cpu")
    cfg, model, _, _ = make_problem(cpu, **constrained_runs()[name])
    N, nx, nu = cfg.N, cfg.nx, cfg.nu
    build = build_ocp_collocation if cfg.Collocation else build_ocp
    spec = build(cfg, model, build_stage_cost(cfg.stage_cost), build_terminal_cost(cfg))
    st = 3 * nx + nu if cfg.Collocation else nx + nu
    dense = make_solver(spec.nlp, SolverOptions(max_iter=CONSTRAINED_DENSE_CAP,
                                                tol=CONSTRAINED_TOL))
    x0s = draw_x0(CONSTRAINED_CHECK, cpu, dtype=torch.float64)[:CONSTRAINED_DENSE_LANES]
    status, U = [], []
    for i in range(len(x0s)):
        x0 = x0s[i:i + 1]
        X0, U0 = warm_start(cfg, model, x0, torch.as_tensor(U_SS)[None])
        w0 = torch.zeros((1, spec.nw), dtype=torch.float64)
        for k in range(N):
            w0[:, k * st:k * st + nx] = X0[:, k]
            if cfg.Collocation:
                w0[:, k * st + nx:k * st + 3 * nx] = X0[:, k + 1].repeat(1, 2)
            w0[:, (k + 1) * st - nu:(k + 1) * st] = U0[:, k]
        w0[:, N * st:N * st + nx] = X0[:, N]
        lbw = torch.as_tensor(spec.lbw)[None].clone()
        ubw = torch.as_tensor(spec.ubw)[None].clone()
        lbw[:, :nx] = ubw[:, :nx] = x0
        p = {k: torch.as_tensor(np.asarray(v, float))[None] if not torch.is_tensor(v) else v
             for k, v in bench_params(cfg, x0).items()}
        r = dense(w0, p, lbw, ubw, spec.lbg, spec.ubg)
        status.append(int(r.status[0]))
        U.append(torch.stack([r.w[0, (k + 1) * st - nu:(k + 1) * st] for k in range(N)]).numpy())
    return dict(status=np.array(status), U=np.stack(U))


def bordered_check(dev):
    """``riccati_bordered`` (the plain recursion for TermCons and H_eq) on
    the card against its CPU run in f64, for each (n_eq, n_tc) of
    BORDERED_CASES (a kind of row may be absent: its tensors are then
    empty, as the solver passes them) on seeded inputs at N=6, nxa=3,
    nu=2, 4 lanes: the ok flags equal and set, every output of the CPU's
    shape and within CONSTRAINED_TOL.  Returns (failures, {case: error})."""
    import torch

    from mpc_code_tpu_torch.solver.riccati import riccati_bordered

    cpu = torch.device("cpu")
    L, N, nxa, nu = 4, 6, 3, 2
    nz = nxa + nu
    failures, errs = [], {}
    for n_eq, n_tc in BORDERED_CASES:
        rng = np.random.default_rng(7)
        M = 0.5 * rng.normal(size=(L, N, nz, nz))
        MP = rng.normal(size=(L, nxa, nxa))
        arrs = (M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(nz), rng.normal(size=(L, N, nz)),
                0.9 * np.eye(nxa) + 0.1 * rng.normal(size=(L, N, nxa, nxa)),
                rng.normal(size=(L, N, nxa, nu)), 0.1 * rng.normal(size=(L, N, nxa)),
                MP @ np.swapaxes(MP, -1, -2) + np.eye(nxa), rng.normal(size=(L, nxa)),
                rng.normal(size=(L, N, n_eq, nz)), 0.1 * rng.normal(size=(L, N, n_eq)),
                0.1 * rng.normal(size=(L, n_tc)))
        got, ref = (riccati_bordered(*(torch.as_tensor(a, device=d) for a in arrs),
                                     nxa=nxa, nu=nu) for d in (dev, cpu))
        ok = bool(ref[0].all()) and bool((got[0].cpu() == ref[0]).all())
        shapes = all(g.shape == r.shape for g, r in zip(got, ref))
        err = max((nerr(g.cpu(), r) for g, r in zip(got[1:], ref[1:]) if r.numel()),
                  default=0.0)
        errs[f"{n_eq},{n_tc}"] = err
        if not (ok and shapes and err <= CONSTRAINED_TOL):
            failures.append(f"constrained: the bordered recursion at (n_eq, n_tc) = "
                            f"({n_eq}, {n_tc}) on the card: ok flags equal {ok}, shapes "
                            f"{shapes}, err {err:.3e}")
    log("# constrained bordered recursion, card against CPU, f64, max norm err by "
        f"(n_eq, n_tc): {json.dumps(errs)} (tol {CONSTRAINED_TOL:g})")
    return failures, errs


def constrained_phase(dev, launches, results, cpu_refs):
    """The three constrained runs of the bench workload at CONSTRAINED_B
    lanes in f32:
    per run the solves per second, the status histogram, the iterations,
    kernel 1's and kernel 2's launches against the solver's loop passes,
    then the f64 check lanes against the CPU; kernel 2 at (50, 7, 6)
    against its plain version first."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        X_SS, draw_x0, make_problem, run_pipeline,
    )
    from mpc_code_tpu_torch.ops import sweep_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    failures, bordered = bordered_check(dev)
    report = dict(bordered_err=bordered)
    refs = cpu_refs[("constrained", "float64")]
    for name, overrides in constrained_runs().items():
        cfg, model, socp, solve = make_problem(dev, **overrides)
        if name == "soft":
            for dtype in (torch.float64, torch.float32):
                failures += riccati_check(dev, dtype, socp.N, socp.nxa, socp.nu,
                                          results["riccati_kkt_soft"])
        passes = []

        def counted(*a, **k):
            r = solve(*a, **k)
            passes.append(solver_passes(r.iters, r.status))
            return r

        x0s = draw_x0(CONSTRAINED_B, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sweep_cuda.LAUNCHES = sk.LAUNCHES = rk.LAUNCHES = 0
        status, iters, feas, kkt, U, times = run_pipeline(cfg, model, counted, x0s,
                                                          ns=socp.ns)
        k1, k2, k5 = sweep_cuda.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES
        launches[f"riccati_kkt_{name}"] = k2
        launches[f"rk4_stage_jac_{name}"] = k1
        n_ok = int((status != 2).sum())
        r = dict(batch=CONSTRAINED_B, nxa=socp.nxa, nu=socp.nu, ni=socp.ni, ns=socp.ns,
                 n_tc=socp.n_tc, n_eq=socp.n_eq, ok=n_ok, ok_fraction=n_ok / CONSTRAINED_B,
                 solves_per_s=n_ok / times["total_s"],
                 status_counts=np.bincount(status, minlength=3).tolist(),
                 median_iters=float(np.median(iters)), max_iters=int(iters.max()),
                 passes=passes, launches=dict(rk4_stage_jac=k1, riccati_kkt=k2,
                                              stage_sweep=k5),
                 peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in times.items()})
        log(f"# constrained {name} " + json.dumps(r))
        # kernel 2 once a loop pass where the OCP has no equality rows, never
        # where it has (the plain recursions); kernel 1 once a pass on the
        # split route, kernel 5's Gauss-Newton build of the collocated CSTR
        # once a pass on the collocation route (no split sweep)
        want_k2 = 0 if (socp.n_tc or socp.n_eq) else sum(passes)
        want_k1, want_k5 = (0, sum(passes)) if cfg.Collocation else (sum(passes), 0)
        launches[f"stage_sweep_{name}"] = k5
        if (k2, k1, k5) != (want_k2, want_k1, want_k5):
            failures.append(f"constrained {name}: launches kernel 2 {k2}, kernel 1 {k1}, "
                            f"kernel 5 {k5}; expected {want_k2}, {want_k1}, {want_k5} "
                            f"over passes {passes}")

        # the check lanes in f64 on the card against the CPU
        gpu = constrained_check_solve(name, dev)
        ref = refs.result()[0][name]
        cpu, dense = ref["struct"], ref["dense"]
        same_iters = bool((gpu["iters"] == cpu["iters"]).all())
        same = bool((gpu["status"] == cpu["status"]).all()
                    and (same_iters or name in CONSTRAINED_ITERS_BY_ROUNDING))
        ex = max(nerr(torch.as_tensor(gpu[k]), torch.as_tensor(cpu[k])) for k in ("X", "U"))
        nd = CONSTRAINED_DENSE_LANES
        both = (gpu["status"][:nd] == 0) & (dense["status"] == 0)
        du_dense = (nerr(torch.as_tensor(gpu["U"][:nd][both]),
                         torch.as_tensor(dense["U"][both])) if both.any() else float("nan"))
        r.update(check_status=gpu["status"].tolist(), check_iters=gpu["iters"].tolist(),
                 cpu_iters=cpu["iters"].tolist(), cpu_equal=same, max_norm_err_vs_cpu=ex,
                 dense_status=dense["status"].tolist(),
                 max_norm_err_U_vs_dense=du_dense)
        line = (f"# constrained {name} f64 check ({CONSTRAINED_CHECK} lanes): status "
                f"{gpu['status'].tolist()} iters {gpu['iters'].tolist()} (cpu "
                f"{cpu['iters'].tolist()}), cpu equal {same}, max norm err X/U vs cpu "
                f"{ex:.3e} (tol {CONSTRAINED_F64_TOL:g}); "
                f"dense status {dense['status'].tolist()}, max norm err U vs dense "
                f"{du_dense:.3e} over {int(both.sum())} lanes (tol {CONSTRAINED_DENSE_TOL:g})")
        if not (same and ex <= CONSTRAINED_F64_TOL):
            failures.append(f"constrained {name}: f64 check lanes differ from the CPU")
        if not (both.sum() > 0 and du_dense <= CONSTRAINED_DENSE_TOL):
            failures.append(f"constrained {name}: U {du_dense:.3e} from the dense "
                            "transcription")
        if socp.n_tc:
            ok0 = gpu["status"] == 0
            dxn = float(np.abs(gpu["X"][ok0, -1] - X_SS).max()) if ok0.any() else float("nan")
            r["max_abs_xN_minus_xs"] = dxn
            line += f"; max |x_N - xs| {dxn:.3e} (tol {CONSTRAINED_TC_TOL:g})"
            if not (ok0.any() and dxn <= CONSTRAINED_TC_TOL):
                failures.append(f"constrained {name}: x_N - xs {dxn:.3e}")
        log(line)
        report[name] = r
    return failures, report


# The solver_options phase (ROADMAP item 21(b), (c)): the bench workload
# of the slice phase on its first OPTIONS_B lanes in f32 under each option
# of the structured solver (OPTION_RUNS, make_problem's arguments; "default"
# is the slice phase's settings at the same lanes, the yardstick), then
# three OCPs under the exact Hessian, whose stage derivatives come from
# kernel 5's builds of their forms (EXACT_RUNS: the nmpc_dis and ENMPC
# workloads with the examples' exact Hessian, the bench's CSTR with DUForm;
# the generic torch.func route before PR 14).  Kernel
# launches are held to the solver's own counts: kernel 2 once a pass (twice
# under Mehrotra, none under parallel=True, K a sweep under sweep_every=K),
# kernel 1 once a sweep (and once more a solve for costate duals); on the
# exact runs kernels 5 and 2 once a pass and no other kernel.  OPTIONS_CHECK
# lanes of every run but "default" (the slice phase checks it) are solved
# in f64 on the card to OPTIONS_CHECK_OPTS and held to the CPU's f64 run:
# statuses and iterations equal, X and U to OPTIONS_F64_TOL.  The exact
# runs take EXACT_B lanes (4,096 before the mesh, debug and aot phases
# pushed the whole smoke to 1,117 s; their checks unchanged).
OPTIONS_B = 4096
EXACT_B = 2048
OPTIONS_WARMUP, OPTIONS_WARMUP_ITERS = 64, 2
OPTIONS_CHECK = 8
OPTIONS_CHECK_OPTS = dict(max_iter=50, tol=1e-8, constr_viol_tol=1e-8)
OPTIONS_F64_TOL = 1e-8
# The autotune run: the sweep autotune's probe at AUTOTUNE_HINT lanes (the
# CSTR cell's batch; MPC_TPU_SWEEP_AUTOTUNE=1 and the hint, in a fresh
# cache directory), its times and winner printed, the second probe served
# from its cache, then the winner's Gauss-Newton route on OPTIONS_B lanes
# with the phase's checks (its f64 lanes held to the CPU's "split" route).
AUTOTUNE_HINT = 16384
OPTION_RUNS = {"default": {}, "parallel": dict(parallel=True),
               "adaptive": dict(mu_strategy="adaptive"),
               "mehrotra": dict(mu_strategy="mehrotra"),
               "backtrack": dict(ls_mode="backtrack"),
               "ls_parallel": dict(ls_mode="backtrack", ls_parallel=True),
               "sweep_every": dict(sweep_every=2), "costate": dict(dual_init="costate"),
               "autotune": dict(batch_hint=AUTOTUNE_HINT)}
EXACT_RUNS = {"nmpc_dis_exact": {}, "enmpc_exact": {},
              "cstr_du_exact": dict(hessian="exact", DUForm=True),
              "soft_exact": dict(hessian="exact", slacks=True, Ws=10.0 * np.eye(4)),
              "rows_exact": dict(hessian="exact", TermCons=True, H_eq=heq_line,
                                 G_ineq=gineq_line)}
SOLVER_FIELDS = ("hessian", "mu_strategy", "ls_mode", "ls_parallel", "sweep_every",
                 "dual_init")


def options_workload(name, device, ocp_opts=None):
    """The workload module and problem of an exact run on the nmpc_dis or
    ENMPC path, its OCP under the exact Hessian (``ocp_opts``, default the
    workload's own f32 options with hessian='exact')."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import enmpc_workload, nmpc_dis_workload

    wl = nmpc_dis_workload if name.startswith("nmpc_dis") else enmpc_workload
    if ocp_opts is None:
        ocp_opts = SolverOptions.for_f32(max_iter=30, hessian="exact")
    return wl, wl.make_problem(device, ocp_opts=ocp_opts)


def options_check_solve(name, device, impl=None):
    """The check lanes of a solver_options run in f64 to OPTIONS_CHECK_OPTS
    under the run's options: status, iters, X and U as numpy (for the
    bench runs from the bench's warm start, for the nmpc_dis and ENMPC runs
    through their workloads' pipelines).  ``impl``: the Gauss-Newton route
    (default the OCP's, 'split' without the autotune)."""
    import torch

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, bench_params, draw_x0, make_problem, warm_start,
    )
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    f64 = torch.float64
    if name in ("nmpc_dis_exact", "enmpc_exact"):
        wl, prob = options_workload(name, device, SolverOptions(hessian="exact",
                                                                **OPTIONS_CHECK_OPTS))
        out = wl.run_pipeline(prob, wl.draw_lanes(OPTIONS_CHECK, device, dtype=f64))
        return {k: out[k] for k in ("status", "iters", "X", "U")}
    run = dict(OPTION_RUNS, **EXACT_RUNS)[name]
    cfg, model, socp, _ = make_problem(device, **run)
    opts = dict(dict(hessian="gauss_newton"), **{k: v for k, v in run.items() if k in SOLVER_FIELDS})
    solve = make_structured_solver(socp, SolverOptions(**OPTIONS_CHECK_OPTS, **opts),
                                   parallel=run.get("parallel", False), impl=impl)
    x0 = draw_x0(OPTIONS_CHECK, device, dtype=f64)
    u_ws = torch.as_tensor(U_SS, dtype=f64, device=device).expand(len(x0), cfg.nu)
    X0, U0 = warm_start(cfg, model, x0, u_ws)
    if socp.nxa > cfg.nx + socp.ns:        # the u_prev slots, from the warm input
        X0 = torch.cat([X0, u_ws[:, None].expand(-1, X0.shape[1], -1)], -1)
    pad = (0, socp.ns)                      # the slack slots, at zero
    r = solve(bench_params(cfg, x0), torch.nn.functional.pad(X0, pad),
              torch.nn.functional.pad(U0, pad))
    return dict(status=r.status.cpu().numpy(), iters=r.iters.cpu().numpy(),
                X=r.X.cpu().numpy(), U=r.U.cpu().numpy())


def expected_option_launches(run, calls):
    """(kernel 1, kernel 2) launches by the solver's own counts over its
    solve calls, each (passes, pass-1 solver or not): sweeps =
    ceil(passes / sweep_every), kernel 1 once a sweep (one more a solve
    for costate duals), kernel 2 sweep_every times a sweep, twice that
    under Mehrotra (pass 1 only: the rescue is monotone), never under
    parallel=True."""
    k_sw = run.get("sweep_every", 1)
    k1 = k2 = 0
    for passes, pass1 in calls:
        sweeps = -(-passes // k_sw)
        k1 += sweeps + (run.get("dual_init") == "costate")
        if not run.get("parallel"):
            k2 += sweeps * k_sw * (2 if pass1 and run.get("mu_strategy") == "mehrotra" else 1)
    return k1, k2


def autotune_problem(dev):
    """The bench problem built as the autotune engages: under
    MPC_TPU_SWEEP_AUTOTUNE=1 with the AUTOTUNE_HINT batch hint, in a fresh
    cache directory (the script's own environment, restored after).
    Returns the problem and the probe's report (its times, the winner, and
    whether a second probe came from the cache)."""
    import shutil
    import tempfile

    from mpc_code_tpu_torch.examples.bench_workload import make_problem
    from mpc_code_tpu_torch.ops import sweep_autotune as sa

    tmp = tempfile.mkdtemp(prefix="mpc_autotune_smoke_")
    saved = {k: os.environ.get(k) for k in ("MPC_TPU_SWEEP_AUTOTUNE", "MPC_TPU_AOT_CACHE")}
    os.environ.update(MPC_TPU_SWEEP_AUTOTUNE="1", MPC_TPU_AOT_CACHE=tmp)
    try:
        n0 = sa.PROBES
        problem = make_problem(dev, **OPTION_RUNS["autotune"])
        times = {k: 1e3 * v for k, v in sa.LAST_TIMES.items()}
        again = sa.autotune_sweep_impl(problem[0], problem[2], AUTOTUNE_HINT)
        report = dict(hint=AUTOTUNE_HINT, ms=times, winner=problem[2].sweep_impl,
                      probes=sa.PROBES - n0, second_probe_cached=sa.PROBES == n0 + 1
                      and again == problem[2].sweep_impl)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    log("# solver_options autotune probe " + json.dumps(report))
    return problem, report


def options_phase(dev, launches, cpu_refs):
    """The solver_options phase's runs at OPTIONS_B lanes in f32: per run
    the solves per second, ok_fraction, the iterations' median and maximum
    and the launches of every kernel against the solver's counts; then the
    f64 check lanes on the card, held against the CPU's runs (one worker
    job a run) after the last run, so that the CPU's side finishes beside
    the card's runs."""
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, PipelineSolve, bench_params, draw_x0, make_problem, run_pipeline, warm_start,
    )
    from mpc_code_tpu_torch.ops import sweep_cf_cuda, sweep_cuda, sweep_map_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    mods = dict(rk4_stage_jac=sweep_cuda, riccati_kkt=rk, map_stage_jac=sweep_map_cuda,
                rk4_quad_stage_hess=sweep_cf_cuda, stage_sweep=sk)
    failures, report, checks = [], {}, {}
    for name, run in dict(OPTION_RUNS, **EXACT_RUNS).items():
        calls = []

        def counted(fn, pass1):
            def solve(*a, **k):
                r = fn(*a, **k)
                calls.append((solver_passes(r.iters, r.status), pass1))
                return r
            return solve

        # each run after an untimed short one at OPTIONS_WARMUP lanes: the
        # card's first use of what the run calls (cuBLAS and cuSOLVER
        # handles, the kernels' libraries) stays out of its time
        workload_run = name in ("nmpc_dis_exact", "enmpc_exact")
        run_b = EXACT_B if name in EXACT_RUNS else OPTIONS_B
        if workload_run:
            wl, prob = options_workload(name, dev)
            wl.run_pipeline(prob, wl.draw_lanes(OPTIONS_WARMUP, dev))
            prob = prob._replace(ocp_solve=counted(prob.ocp_solve, True))
            lanes = wl.draw_lanes(run_b, dev)
            nxa = prob.socp.nxa
        else:
            if name == "autotune":
                (cfg, model, socp, solve), probe = autotune_problem(dev)
                if not probe["second_probe_cached"] or probe["probes"] != 1:
                    failures.append(f"solver_options autotune: the probe {probe}")
            else:
                cfg, model, socp, solve = make_problem(dev, **run)
            nxa = socp.nxa
            x0s = draw_x0(run_b, dev)
            x0w = x0s[:OPTIONS_WARMUP]
            u_ws = torch.as_tensor(U_SS, dtype=x0w.dtype, device=dev).expand(len(x0w), cfg.nu)
            Xw, Uw = warm_start(cfg, model, x0w, u_ws)
            if nxa > cfg.nx + socp.ns:
                Xw = torch.cat([Xw, u_ws[:, None].expand(-1, Xw.shape[1], -1)], -1)
            pad = (0, socp.ns)
            Xw, Uw = torch.nn.functional.pad(Xw, pad), torch.nn.functional.pad(Uw, pad)
            for fn in {solve.solve, solve.rescue}:
                fn(bench_params(cfg, x0w), Xw, Uw, max_iter=OPTIONS_WARMUP_ITERS)
            solve = PipelineSolve(counted(solve.solve, True), counted(solve.rescue, False))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for m in mods.values():
            m.LAUNCHES = 0
        if workload_run:
            out = wl.run_pipeline(prob, lanes)
            status, iters, times = out["status"], out["iters"], out["times"]
        else:
            status, iters, _, _, _, times = run_pipeline(
                cfg, model, solve, x0s, ns=socp.ns, nup=nxa - cfg.nx - socp.ns)
        got = {k: m.LAUNCHES for k, m in mods.items()}
        for k, n in got.items():
            launches[f"{k}_options_{name}"] = n
        if name.endswith("_exact"):
            # kernel 5's build of the run's form and kernel 2, once a pass
            # each; kernel 2 none under TermCons or H_eq (the plain bordered
            # recursion)
            want = dict.fromkeys(mods, 0)
            want["stage_sweep"] = sum(p for p, _ in calls)
            bordered = not workload_run and (socp.n_tc or socp.n_eq)
            want["riccati_kkt"] = 0 if bordered else want["stage_sweep"]
        else:
            # the autotune's "fused" winner: kernel 5's Gauss-Newton build
            # where kernel 1 launched
            sweep_key = ("stage_sweep" if name == "autotune" and socp.sweep_impl == "fused"
                         else "rk4_stage_jac")
            want = dict(dict.fromkeys(mods, 0), **dict(zip(
                (sweep_key, "riccati_kkt"), expected_option_launches(run, calls))))
        n_ok = int((status != 2).sum())
        r = dict(batch=run_b, nxa=nxa, ok=n_ok, ok_fraction=n_ok / run_b,
                 solves_per_s=n_ok / times["total_s"],
                 status_counts=np.bincount(status, minlength=3).tolist(),
                 median_iters=float(np.median(iters)), max_iters=int(iters.max()),
                 passes=calls, launches=got, expected_launches=want,
                 **({"impl": socp.sweep_impl, "probe": probe} if name == "autotune" else {}),
                 peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in times.items()})
        log(f"# solver_options {name} " + json.dumps(r))
        if got != want:
            failures.append(f"solver_options {name}: launches {got}, expected {want}")
        if name != "default":
            checks[name] = options_check_solve(name, dev, impl=socp.sweep_impl
                                               if name == "autotune" else None)
        report[name] = r
    for name, gpu in checks.items():
        r = report[name]
        cpu = cpu_refs[(f"solver_options:{name}", "float64")].result()[0]
        same_status = bool((gpu["status"] == cpu["status"]).all())
        same_iters = bool((gpu["iters"] == cpu["iters"]).all())
        ex = max(nerr(torch.as_tensor(gpu[k]), torch.as_tensor(cpu[k])) for k in ("X", "U"))
        r.update(check_status=gpu["status"].tolist(), check_iters=gpu["iters"].tolist(),
                 cpu_status=cpu["status"].tolist(), cpu_iters=cpu["iters"].tolist(),
                 max_norm_err_vs_cpu=ex)
        log(f"# solver_options {name} f64 check ({OPTIONS_CHECK} lanes): status "
            f"{gpu['status'].tolist()} (cpu {cpu['status'].tolist()}) iters "
            f"{gpu['iters'].tolist()} (cpu {cpu['iters'].tolist()}), max norm err X/U "
            f"vs cpu {ex:.3e} (tol {OPTIONS_F64_TOL:g})")
        if not (same_status and same_iters and ex <= OPTIONS_F64_TOL):
            failures.append(f"solver_options {name}: f64 check lanes differ from the CPU")
    return failures, report


# ---------------------------------------------------------------------------
# scale-out, start-up and diagnostics: the mesh, the AOT artifact, debug
# ---------------------------------------------------------------------------

# The mesh phase: the bench port's configuration (``closed_loop_bench.py``)
# on MESH_B lanes for MESH_STEPS steps in f32 through
# ``make_closed_loop_runner`` on a one-rank NCCL mesh (``make_mesh(1)`` on
# 127.0.0.1) and without one, on the same lanes: statuses and OCP
# iterations equal and U bitwise equal (or within MESH_U_TOL of the input
# box, with the difference reported); kernel 2's launches in each run equal
# to the OCP solver's passes (the Kalman filter and the dense-IPM targets
# launch none); ``aggregate_metrics`` over NCCL equal to the host's count;
# then ``entry.dryrun_multichip(1)`` (the linear CSTR at N=4, then Ex_ENMPC
# at N=3 with the MHE at N_mhe=3), kernel 2's launches equal to its OCP
# and MHE solvers' passes, and kernel 5's to the OCP solver's (its ContForm
# build; kernel 4 idle: the example's ContForm OCP runs the exact Hessian)
# and the MHE solver's (its window build).  The card is one
# H100: only a one-rank mesh is checked here.
MESH_B, MESH_STEPS = 1024, 5
MESH_U_TOL = 1e-6
# The aot phase: two processes on the card, one after the other, each
# with a fresh kernel build directory and sharing one fresh artifact
# directory (MPC_TPU_AOT_CACHE), build the bench port's runner with
# aot_key="auto" and run AOT_STEPS steps of AOT_B lanes: the first builds
# its kernel library and saves the artifact, the second must load it and
# run no nvcc, with outputs bitwise equal to the first's.  They start with
# host_loop's one-lane card processes and run beside the main process.
AOT_B, AOT_STEPS = 1024, 2
AOT_WAIT_S = 600
# The debug phase: DEBUG_LANES lanes of the CSTR structured solve (the
# bench's pass-1 options at cap MAXIT_R) and one dense target solve
# (Ex_ENMPC's), in f64 with SolverOptions(debug=True), stdout captured:
# lanes x passes lines each, and lane 0's it, mu, kkt and feas equal to
# the CPU f64 run's to DEBUG_REL (a difference of rounding size, below
# DEBUG_FLOOR, counts as none; two printed numbers one unit apart in their
# last digit straddle a rounding boundary of the format).
DEBUG_LANES = 2
DEBUG_REL, DEBUG_FLOOR = 1e-8, 1e-14
def run_passes(out):
    """Kernel 2's launches a closed-loop run of the OCP makes: its
    solver's passes summed over the steps of stacked outputs."""
    return sum(solver_passes(out.ocp_iters[k], out.status_dyn[k])
               for k in range(out.ocp_iters.shape[0]))


def mesh_phase(dev, launches):
    """The bench port's runner on a one-rank NCCL mesh and without one, then
    the entry point's dry run, whose kernel-5 launches are told apart by the
    step kind and Hessian of the sweep that made them."""
    import torch
    import torch.distributed as dist

    from mpc_code_tpu_torch import entry
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb
    from mpc_code_tpu_torch.examples.enmpc import make_config as enmpc_config
    from mpc_code_tpu_torch.ops import sweep_cf_cuda
    from mpc_code_tpu_torch.parallel.mesh import (
        aggregate_metrics, make_closed_loop_runner, make_mesh,
    )
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    failures, report = [], {}
    mesh = make_mesh(1)
    try:
        report["backend"] = dist.get_backend()
        cfg = cb.make_config(10)
        x0s = cb.draw_x0(cfg, MESH_B)
        outs = {}
        for name, m in (("unsharded", None), ("mesh", mesh)):
            runner = make_closed_loop_runner(cfg, MESH_STEPS, MESH_B, mesh=m, ysp=cb.YSP,
                                             device=dev)
            torch.cuda.synchronize()
            rk.LAUNCHES = sk.LAUNCHES = 0
            t0 = time.perf_counter()
            _, out = runner(x0s)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            passes = run_passes(out)
            launches[f"riccati_kkt_mesh_{name}"] = rk.LAUNCHES
            launches[f"stage_sweep_mesh_{name}"] = sk.LAUNCHES
            report[name] = dict(seconds=dt, lane_steps_per_s=MESH_B * MESH_STEPS / dt,
                                riccati_kkt=rk.LAUNCHES, stage_sweep=sk.LAUNCHES,
                                passes=passes, ok=int((out.status_dyn != 2).sum()))
            # kernel 5's Gauss-Newton build of the linear CSTR and kernel 2
            if (rk.LAUNCHES, sk.LAUNCHES) != (passes, passes):
                failures.append(f"mesh {name}: kernels 2 and 5 launched {rk.LAUNCHES} and "
                                f"{sk.LAUNCHES} times, the OCP solver made {passes} passes")
            outs[name] = out
        a, b = outs["unsharded"], outs["mesh"]
        same = (torch.equal(a.status_dyn, b.status_dyn) and torch.equal(a.ocp_iters, b.ocp_iters))
        bitwise = torch.equal(a.u, b.u)
        box = torch.as_tensor(np.asarray(cfg.bounds.umax) - np.asarray(cfg.bounds.umin),
                              dtype=a.u.dtype, device=a.u.device)
        du = float(((a.u - b.u).abs() / box).max())
        report.update(same_status_iters=same, u_bitwise=bitwise, max_du_over_box=du)
        if not (same and (bitwise or du <= MESH_U_TOL)):
            failures.append(f"mesh: the sharded run differs from the unsharded one "
                            f"(status/iters equal {same}, max |du|/box {du:.3e})")
        agg = aggregate_metrics(b.status_dyn, b.ocp_iters, mesh)
        st, it = b.status_dyn.cpu().numpy(), b.ocp_iters.cpu().numpy()
        host = dict(n_ok=int((st != 2).sum()), n_total=int(st.size),
                    max_iters=int(it.max()), sum_iters=int(it.sum()))
        report.update(aggregate=agg, host=host)
        if agg != host:
            failures.append(f"mesh: aggregate_metrics {agg} against the host's {host}")
        # the one-rank dry run of the entry point
        rk.LAUNCHES = sweep_cf_cuda.LAUNCHES = sk.LAUNCHES = 0
        # kernel 5's launches by (step kind, Hessian) of the sweep that made
        # them: the linear CSTR's Gauss-Newton build ("map"), the ContForm
        # one ("cf") and the MHE window's ("mhe")
        by_build = {}
        real_count = sk.StageSweep._count

        def count(sweep):
            key = f"{sweep.low.kind}_{sweep.hessian}"
            by_build[key] = by_build.get(key, 0) + 1
            real_count(sweep)

        sk.StageSweep._count = count
        try:
            t0 = time.perf_counter()
            (_, lin), (_, mhe) = entry.dryrun_multichip(1)
            torch.cuda.synchronize()
        finally:
            sk.StageSweep._count = real_count
        launches["stage_sweep_dryrun_lin"] = by_build.get("map_gauss_newton", 0)
        launches["stage_sweep_dryrun_enmpc"] = by_build.get("cf_exact", 0)
        launches["stage_sweep_dryrun_mhe"] = by_build.get("mhe_exact", 0)
        mhe_passes_ = sum(solver_passes(mhe.mhe_iters[k], mhe.mhe_status[k])
                          for k in range(mhe.mhe_iters.shape[0]))
        want_k2 = run_passes(lin) + run_passes(mhe) + mhe_passes_
        # the ContForm OCP's sweep: kernel 4 under Gauss-Newton, kernel 5's
        # ContForm build under the example's exact Hessian, once a pass;
        # the linear CSTR's: kernel 5's linear build, once a pass; the
        # MHE's: kernel 5's window build, once a pass
        exact = enmpc_config().sol_opts_dyn.hessian == "exact"
        want_k4, want_k5 = (0, run_passes(mhe)) if exact else (run_passes(mhe), 0)
        want_k5 += run_passes(lin) + mhe_passes_
        report["dryrun"] = dict(seconds=time.perf_counter() - t0, riccati_kkt=rk.LAUNCHES,
                                expected_riccati_kkt=want_k2,
                                rk4_quad_stage_hess=sweep_cf_cuda.LAUNCHES,
                                expected_rk4_quad_stage_hess=want_k4,
                                stage_sweep=sk.LAUNCHES, expected_stage_sweep=want_k5,
                                stage_sweep_by_build=by_build,
                                u_lin=lin.u.cpu().numpy().tolist(),
                                u_enmpc=mhe.u.cpu().numpy().tolist())
        launches["riccati_kkt_dryrun"] = rk.LAUNCHES
        launches["rk4_quad_stage_hess_dryrun"] = sweep_cf_cuda.LAUNCHES
        launches["stage_sweep_dryrun"] = sk.LAUNCHES
        got = (rk.LAUNCHES, sweep_cf_cuda.LAUNCHES, sk.LAUNCHES)
        if (got != (want_k2, want_k4, want_k5)
                or launches["stage_sweep_dryrun_lin"] != run_passes(lin)
                or launches["stage_sweep_dryrun_mhe"] != mhe_passes_):
            failures.append(f"mesh dryrun: launches of kernels 2, 4, 5 {got}, expected "
                            f"{(want_k2, want_k4, want_k5)}; kernel 5's by build "
                            f"{by_build}")
        for o in (lin, mhe):
            if not (torch.isfinite(o.u).all() and (o.status_dyn != 2).all()):
                failures.append("mesh dryrun: a non-finite or infeasible lane")
    finally:
        dist.destroy_process_group()
    log("# mesh " + json.dumps(report))
    return failures, report


def aot_child(build_dir, out_path, t_spawn):
    """One process of the aot phase (run by ``aot_jobs`` with a fresh
    MPC_TPU_AOT_CACHE in its environment): the bench port's runner with
    aot_key="auto" from a fresh kernel build directory, AOT_STEPS steps of
    AOT_B lanes; its U to ``out_path`` and one JSON line: nvcc's runs, the
    libraries loaded, the seconds from the parent's spawn to the first
    result."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from mpc_code_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = build_dir
    from mpc_code_tpu_torch.device import pin_fp32_precision
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb
    from mpc_code_tpu_torch.parallel.mesh import make_closed_loop_runner

    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    pin_fp32_precision()
    dev = torch.device("cuda")
    cfg = cb.make_config(10)
    runner = make_closed_loop_runner(cfg, AOT_STEPS, AOT_B, ysp=cb.YSP, aot_key="auto",
                                     device=dev, dtype=torch.float32)
    _, out = runner(cb.draw_x0(cfg, AOT_B))
    u = out.u.cpu().numpy()
    first_s = time.time() - t_spawn
    np.save(out_path, u)
    print(json.dumps(dict(nvcc_runs=cuda_build.NVCC_RUNS, loaded=sorted(
        os.path.basename(os.path.dirname(b.path)) for b in cuda_build._LOADED.values()),
        first_result_s=first_s, ok=int((out.status_dyn != 2).sum()),
        riccati_kkt=rk.LAUNCHES, stage_sweep=sk.LAUNCHES)), flush=True)


def aot_jobs():
    """The aot phase's two processes, one after the other, in fresh
    directories (removed after): (their JSON lines, their U, the
    artifact's manifests)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="mpc_aot_smoke_")
    env = dict(os.environ, MPC_TPU_AOT_CACHE=os.path.join(tmp, "cache"))
    rows, us = [], []
    try:
        for i in range(2):
            out_path = os.path.join(tmp, f"u{i}.npy")
            code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                    f"chip_smoke.aot_child({os.path.join(tmp, f'build{i}')!r}, "
                    f"{out_path!r}, {time.time()!r})")
            proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                  env=env, timeout=AOT_WAIT_S, cwd=ROOT)
            if proc.returncode != 0:
                raise RuntimeError(f"aot process {i} failed:\n{proc.stderr[-4000:]}")
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            us.append(np.load(out_path))
        cache = env["MPC_TPU_AOT_CACHE"]
        manifests = [json.load(open(os.path.join(cache, d, "manifest.json")))
                     for d in sorted(os.listdir(cache)) if not d.endswith(".json")]
        return rows, us, manifests
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def aot_phase(job, launches):
    failures = []
    rows, us, manifests = job.result()
    report = dict(first=rows[0], second=rows[1], artifacts=len(manifests),
                  libraries=[m["libraries"] for m in manifests])
    log("# aot " + json.dumps(report))
    log(f"# aot seconds from start to first result: first process "
        f"{rows[0]['first_result_s']:.1f} s (nvcc {rows[0]['nvcc_runs']}), second "
        f"{rows[1]['first_result_s']:.1f} s (nvcc {rows[1]['nvcc_runs']})")
    if len(manifests) != 1 or not manifests[0]["libraries"]:
        failures.append(f"aot: expected one artifact with its libraries, got {manifests}")
    if rows[0]["nvcc_runs"] < 1 or rows[1]["nvcc_runs"] != 0:
        failures.append(f"aot: nvcc ran {rows[0]['nvcc_runs']} then {rows[1]['nvcc_runs']} "
                        "times (the second process must load the artifact)")
    if manifests and not set(manifests[0]["libraries"]) <= set(rows[1]["loaded"]):
        failures.append("aot: the second process did not load the artifact's libraries")
    if not np.array_equal(us[0], us[1]):
        failures.append("aot: the two processes' outputs differ")
    # kernel 5's Gauss-Newton build of the linear CSTR and kernel 2 once a
    # pass of the OCP solver, in each process (the first also runs the
    # export's pass)
    launches["stage_sweep_aot"] = sum(r["stage_sweep"] for r in rows)
    if any(r["stage_sweep"] != r["riccati_kkt"] or r["stage_sweep"] <= 0 for r in rows):
        failures.append("aot: kernels 5 and 2 launched "
                        f"{[(r['stage_sweep'], r['riccati_kkt']) for r in rows]} times")
    return failures, report


def debug_fields(text):
    """(it, mu, kkt, feas) strings of every debug line of ``text``."""
    out = []
    for line in text.splitlines():
        if line.startswith("it="):
            kv = dict(tok.split("=", 1) for tok in line.split())
            out.append((int(kv["it"]), kv["mu"], kv["kkt"], kv["feas"]))
    return out


def printed_close(a, b):
    """Two printed numbers equal to DEBUG_REL (below DEBUG_FLOOR apart
    counts as equal), or one unit apart in their last printed digit."""
    x, y = float(a), float(b)
    if abs(x - y) <= DEBUG_REL * max(abs(x), abs(y)) + DEBUG_FLOOR:
        return True
    mant, ex = b.split("e")
    digits = len(mant.split(".")[1]) if "." in mant else 0
    return abs(x - y) <= 10.0 ** (int(ex) - digits) * (1 + 1e-6)


def debug_runs(device):
    """The debug phase's two solves on ``device`` in f64 with debug=True,
    their stdout captured: {name: (lines, lanes, passes)}."""
    import contextlib
    import io

    import torch

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.bench_workload import (
        MAXIT_R, U_SS, bench_params, draw_x0, make_problem, warm_start,
    )
    from mpc_code_tpu_torch.examples.enmpc import make_config as enmpc_config
    from mpc_code_tpu_torch.models import build_model, build_ss_cost
    from mpc_code_tpu_torch.ocp.target import build_target
    from mpc_code_tpu_torch.solver.ipm import make_solver
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    f64 = dict(dtype=torch.float64, device=device)
    cfg, model, socp, _ = make_problem(device)
    solve = make_structured_solver(socp, SolverOptions(
        max_iter=MAXIT_R, tol=1e-3, constr_viol_tol=1e-3, mu_init=1e-1,
        hessian="gauss_newton", track_best=True, debug=True))
    x0 = draw_x0(DEBUG_LANES, device, dtype=torch.float64)
    X0, U0 = warm_start(cfg, model, x0, torch.as_tensor(U_SS, **f64).expand(DEBUG_LANES, 2))
    ecfg = enmpc_config()
    emodel = build_model(ecfg)
    ts = build_target(ecfg, emodel, build_ss_cost(ecfg.ss_cost))
    tsolve = make_solver(ts.nlp, SolverOptions(max_iter=100, tol=1e-8, debug=True))
    d = torch.tensor([[0.01, -0.02]], **f64)
    x0_m, u0 = (torch.as_tensor(v, **f64)[None] for v in (ecfg.x0_m, ecfg.u0))
    z = torch.zeros(1, 2, **f64)
    par = dict(usp=torch.zeros(1, 1, **f64), ysp=z, xsp=z, d=d, us_prev=u0,
               lam=torch.zeros(1, 2, 1, **f64), t=torch.zeros(1, **f64), px=z, py=z)
    w0 = torch.cat([x0_m, u0, torch.func.vmap(emodel.fy)(x0_m, u0, d, par["t"], z)], -1)
    out = {}
    for name, run in (("structured", lambda: solve(bench_params(cfg, x0), X0, U0)),
                      ("dense", lambda: tsolve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = run()
        st = r.status.cpu()
        it = r.iters.cpu()
        passes = (solver_passes(it, st) if name == "structured" else int(it.max()))
        out[name] = (debug_fields(buf.getvalue()), len(st), passes)
    return out


def debug_phase(dev, cpu_refs):
    failures, report = [], {}
    got = debug_runs(dev)
    ref = cpu_refs[("debug", "float64")].result()[0]
    for name, (lines, lanes, passes) in got.items():
        lane0 = lines[::lanes]
        want = ref[name][0][::ref[name][1]]
        close = (len(lane0) == len(want) and all(
            g[0] == w[0] and all(printed_close(a, b) for a, b in zip(g[1:], w[1:]))
            for g, w in zip(lane0, want)))
        report[name] = dict(lines=len(lines), lanes=lanes, passes=passes,
                            lane0_first=lane0[:1], lane0_last=lane0[-1:],
                            cpu_lane0_last=want[-1:], lane0_matches_cpu=close)
        if len(lines) != lanes * passes:
            failures.append(f"debug {name}: {len(lines)} lines for {lanes} lanes x "
                            f"{passes} passes")
        if not close:
            failures.append(f"debug {name}: lane 0's lines differ from the CPU's")
    log("# debug " + json.dumps(report))
    return failures, report


# The cart-pole phase: CARTPOLE_B lanes from ``cartpole_x0`` in f32,
# the upright setpoint, a cold start (x0 along the horizon, F = 0), one call
# of the structured solver under each Hessian: Gauss-Newton (kernel 1 of
# the cart-pole's ODE, the cost by torch.func, kernel 2 at (20, 4, 1)) and
# exact (kernel 5's cart-pole build and kernel 2), each launching once a
# pass; solves/s over the lanes that did not fail, ok_fraction,
# iterations; then OPTIONS_CHECK lanes in f64 on the card against the
# CPU's f64 run: statuses and iterations equal, X and U within
# OPTIONS_F64_TOL.  The exact check solves to OPTIONS_CHECK_OPTS' tol 1e-8,
# as solver_options' exact runs do (its lane 6's KKT solve fails on pass 1:
# F17).  The Gauss-Newton check holds the iterate after
# CARTPOLE_GN_CHECK_PASSES passes (tol 0: no lane stops early): this OCP's
# Gauss-Newton iterations to a tolerance follow rounding, a relative change
# of 1e-15 in x0 moving a lane's count on the CPU
# (``tests/test_torch_cartpole.py``), while its iterate after 8 passes is
# held to 7.7e-12 between the card and the CPU (PERF.md, the cart-pole).
CARTPOLE_B = EXACT_B
CARTPOLE_MAXIT = 30
CARTPOLE_RUNS = ("gauss_newton", "exact")
CARTPOLE_GN_CHECK_PASSES = 8
CARTPOLE_CHECK_OPTS = {
    "gauss_newton": dict(max_iter=CARTPOLE_GN_CHECK_PASSES, tol=0.0, constr_viol_tol=0.0),
    "exact": OPTIONS_CHECK_OPTS}


def cartpole_solve(cfg, socp, x0, opts):
    """One cold solve of the cart-pole from ``x0`` (B, 4) under ``opts``."""
    import torch

    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    X0 = x0[:, None].expand(-1, cfg.N + 1, -1).contiguous()
    U0 = torch.zeros((len(x0), cfg.N, 1), dtype=x0.dtype, device=x0.device)
    return make_structured_solver(socp, opts)(cartpole_params(cfg, x0, cfg.N), X0, U0)


def cartpole_check_solve(hessian, device):
    """The check lanes in f64 under ``hessian``: status, iters, X, U."""
    import torch

    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.config import SolverOptions

    cfg = cartpole_config(pconfig, torch_fns())
    x0 = torch.as_tensor(cartpole_x0(CARTPOLE_B)[:OPTIONS_CHECK], dtype=torch.float64,
                         device=device)
    r = cartpole_solve(cfg, structured(cfg, device), x0,
                       SolverOptions(hessian=hessian, **CARTPOLE_CHECK_OPTS[hessian]))
    return dict(status=r.status.cpu().numpy(), iters=r.iters.cpu().numpy(),
                X=r.X.cpu().numpy(), U=r.U.cpu().numpy())


def cartpole_phase(dev, cfg, socp, launches, cpu_refs):
    import torch

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.ops import sweep_cf_cuda, sweep_cuda, sweep_map_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    mods = dict(rk4_stage_jac=sweep_cuda, riccati_kkt=rk, map_stage_jac=sweep_map_cuda,
                rk4_quad_stage_hess=sweep_cf_cuda, stage_sweep=sk)
    failures, report = [], {}
    x0 = torch.as_tensor(cartpole_x0(CARTPOLE_B), dtype=torch.float32, device=dev)
    for hessian in CARTPOLE_RUNS:
        opts = SolverOptions.for_f32(max_iter=CARTPOLE_MAXIT, hessian=hessian)
        # an untimed short run first: the card's first use of what it calls
        cartpole_solve(cfg, socp, x0[:OPTIONS_WARMUP],
                       SolverOptions.for_f32(max_iter=OPTIONS_WARMUP_ITERS, hessian=hessian))
        torch.cuda.synchronize()
        for m in mods.values():
            m.LAUNCHES = 0
        t0 = time.perf_counter()
        r = cartpole_solve(cfg, socp, x0, opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: m.LAUNCHES for k, m in mods.items()}
        run = "gn" if hessian == "gauss_newton" else "exact"
        for k, n in got.items():
            launches[f"{k}_cartpole_{run}"] = n
        passes = solver_passes(r.iters, r.status)
        want = dict.fromkeys(mods, 0)
        want["rk4_stage_jac" if run == "gn" else "stage_sweep"] = passes
        want["riccati_kkt"] = passes
        status, iters = r.status.cpu().numpy(), r.iters.cpu().numpy()
        n_ok = int((status != 2).sum())
        finite = bool(torch.isfinite(r.U).all())
        gpu = cartpole_check_solve(hessian, dev)
        cpu = cpu_refs[(f"cartpole:{hessian}", "float64")].result()[0]
        same = bool((gpu["status"] == cpu["status"]).all()
                    and (gpu["iters"] == cpu["iters"]).all())
        ex = max(nerr(torch.as_tensor(gpu[k]), torch.as_tensor(cpu[k])) for k in ("X", "U"))
        report[run] = rr = dict(
            batch=CARTPOLE_B, hessian=hessian, ok=n_ok, ok_fraction=n_ok / CARTPOLE_B,
            solves_per_s=n_ok / secs, seconds=round(secs, 6),
            status_counts=np.bincount(status, minlength=3).tolist(),
            median_iters=float(np.median(iters)), max_iters=int(iters.max()), passes=passes,
            launches=got, expected_launches=want, finite=finite,
            check_status=gpu["status"].tolist(), check_iters=gpu["iters"].tolist(),
            cpu_status=cpu["status"].tolist(), cpu_iters=cpu["iters"].tolist(),
            max_norm_err_vs_cpu=ex)
        log(f"# cartpole {run} " + json.dumps(rr))
        if got != want:
            failures.append(f"cartpole {run}: launches {got}, expected {want}")
        if not (same and ex <= OPTIONS_F64_TOL and finite):
            failures.append(f"cartpole {run}: finite {finite}, f64 check lanes equal to the "
                            f"CPU's {same}, X/U {ex:.3e}")
    return failures, report


PHASES = ("kernel", "enmpc kernel", "nmpc_dis kernel", "lmpc kernel",
          "enmpc_mhe kernel", "elementary kernel", "stage_sweep kernel", "slice", "enmpc",
          "nmpc_dis", "cstr_exact", "cstr_loop", "lmpc_loop", "clb", "mesh", "constrained",
          "solver_options", "debug", "cartpole", "host_loop", "enmpc_loop", "enmpc_handoff",
          "aot")


# The phases after ALONE (the kernel phases and the CSTR slice) run in three
# processes on the card at once: this one and one for each of PARTS, which
# it starts itself (``python3 chip_smoke.py --part OUT GO phase...``) once
# its kernels are built.  A part builds its problems and starts its CPU
# workers at once, and its phases when this process has finished ALONE
# (the file GO appears), so that the kernel times and the main path's
# solves/s are taken on a card and a host of their own; it writes its
# failures, launch counts and kernel results to OUT, which this process
# folds into its own.  Every phase is bound by its host (the card busy
# 5-66% of the time, PERF.md section 5), and one after another they took
# 1,051-1,117 s of the 1,200 s limit on the H100 (PERF.md section 4).
ALONE = ("kernel", "enmpc kernel", "nmpc_dis kernel", "lmpc kernel", "enmpc_mhe kernel",
         "elementary kernel", "stage_sweep kernel", "slice")
# clb and mesh went to the solver_options part in PR 14, when kernel 5's
# new builds lengthened the build and the kernel phases before the parts
PARTS = (("clb", "mesh", "solver_options"),
         ("host_loop", "enmpc_loop", "enmpc_handoff", "aot"))
PART_WAIT_S = 1100             # a part's run, from this process's start, at most
# the closed loops whose check lanes (from step 0) run on the card in a
# process of their own from the end of the kernel phases
LOOP_CHECK_JOBS = ("cstr_loop", "enmpc_loop")


def start_parts(selected, run_dir):
    """Start a process for each of PARTS that holds a selected phase:
    [(its phases, its result file, the process)].  Each runs in a session
    of its own, so that ``stop_parts`` ends it with its workers."""
    parts = []
    for i, phases in enumerate(PARTS):
        mine = [p for p in phases if p in selected]
        if mine:
            out = os.path.join(run_dir, f"part{i}.json")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--part", out,
                 os.path.join(run_dir, "go"), *mine], cwd=ROOT, start_new_session=True)
            parts.append((mine, out, proc))
    return parts


def cpu_seconds():
    """CPU seconds of this process and of every process it has waited for
    (its workers, the parts and theirs)."""
    import resource

    return sum(r.ru_utime + r.ru_stime for r in (
        resource.getrusage(resource.RUSAGE_SELF),
        resource.getrusage(resource.RUSAGE_CHILDREN)))


def wait_for(path, timeout):
    """Wait until ``path`` exists (at most ``timeout`` seconds)."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            return False
        time.sleep(0.5)
    return True


def stop_parts(parts):
    import signal

    for _, _, proc in parts:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def join_parts(parts, t_start, failures, launches, results):
    """Wait for each part (until PART_WAIT_S from ``t_start``) and fold its
    failures, launch counts and kernel results into this process's."""
    for phases, out, proc in parts:
        try:
            rc = proc.wait(timeout=max(1.0, PART_WAIT_S - (time.time() - t_start)))
        except subprocess.TimeoutExpired:
            stop_parts([(phases, out, proc)])
            failures.append(f"the part {phases} ran past {PART_WAIT_S} s")
            continue
        if not os.path.exists(out):
            failures.append(f"the part {phases} exited {rc} without its result")
            continue
        with open(out) as f:
            got = json.load(f)
        failures += got["failures"]
        if rc != 0 and not got["failures"]:
            failures.append(f"the part {phases} exited {rc}")
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, res in got["results"].items():
            for kk, v in res.items():
                results.setdefault(k, {}).setdefault(kk, v)


def main() -> int:
    # with no arguments every phase runs; arguments name the phases to run
    # (for trying one on the card), as PHASES spells them
    args = sys.argv[1:]
    part = None
    if args[:1] == ["--part"]:
        # one of PARTS, started by the main process: where to write its
        # result, the file whose appearance starts its phases
        part, args = dict(out=args[1], go=args[2]), args[3:]
        try:
            # ended with the main process, should that one be killed
            import ctypes
            import signal

            ctypes.CDLL(None).prctl(1, signal.SIGKILL)        # PR_SET_PDEATHSIG
        except (OSError, AttributeError):
            pass
    selected = args or list(PHASES)
    if not set(selected) <= set(PHASES):
        print(f"chip_smoke: unknown phase in {selected}; phases: {PHASES}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mpc_code_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mpc_code_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    t_start = float(os.environ.setdefault("CHIP_SMOKE_T0", repr(time.time())))
    if part is None:
        log(card)
        log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    from mpc_code_tpu_torch.device import pin_fp32_precision
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb
    from mpc_code_tpu_torch.examples import closed_loop_workload as cw
    from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
    from mpc_code_tpu_torch.examples import enmpc_workload as ew
    from mpc_code_tpu_torch.examples import lmpc_loop_workload as lw
    from mpc_code_tpu_torch.examples import nmpc_dis_workload as dw
    from mpc_code_tpu_torch.examples.bench_workload import U_BOX, make_problem
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.ops import sweep_cf_cuda, sweep_cuda, sweep_map_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk
    from mpc_code_tpu_torch.solver import sweep_kernel as sk
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    def linear_ocp(cfg):
        return build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                    build_terminal_cost(cfg), device=dev)

    pin_fp32_precision()       # as bench.py:40-42 pins the matmul precision
    dev = torch.device("cuda")
    failures = []
    keys = ("rk4_stage_jac", "riccati_kkt", "riccati_kkt_enmpc", "rk4_quad_stage_hess",
            "map_stage_jac", "riccati_kkt_nmpc_dis",
            *(key for build in STAGE_BUILDS for _, key in build_hessians(build)),
            "riccati_kkt_cstr_exact", "riccati_kkt_lmpc", "riccati_kkt_clb",
            "riccati_kkt_enmpc_mhe", "riccati_kkt_host_mhe", "riccati_kkt_soft",
            "rk4_stage_jac_elem", "rk4_stage_jac_cartpole", "map_stage_jac_tanh",
            "rk4_quad_stage_hess_tanh", "riccati_kkt_cartpole")
    results = {k: {} for k in keys}
    launches = dict.fromkeys(keys + ("rk4_stage_jac_cstr_loop", "riccati_kkt_cstr_loop",
                                     "riccati_kkt_lmpc_loop", "riccati_kkt_enmpc_loop",
                                     "riccati_kkt_enmpc_loop_mhe",
                                     "rk4_quad_stage_hess_enmpc_loop",
                                     "riccati_kkt_host_loop", "riccati_kkt_colloc",
                                     "riccati_kkt_tc_heq", "rk4_stage_jac_colloc",
                                     "rk4_stage_jac_soft", "rk4_stage_jac_tc_heq",
                                     "rk4_stage_jac_cartpole_gn", "riccati_kkt_cartpole_gn",
                                     "riccati_kkt_cartpole_exact"), 0)
    try:
        problem = make_problem(dev)
        cfg, model, socp, _ = problem
        eprob = ew.make_problem(dev)
        dprob = dw.make_problem(dev)
        xprob = make_problem(dev, hessian="exact")
        ec, dc, xsocp = eprob.cfg, dprob.cfg, xprob[2]
        duprob = make_problem(dev, **EXACT_RUNS["cstr_du_exact"])
        lcfg, ccfg = lw.make_config(), cb.make_config()
        lsocp, csocp = linear_ocp(lcfg), linear_ocp(ccfg)
        mcfg = mw.make_config()
        msocp = mw.mhe_ocp(mcfg, dev)
        sprob = make_problem(dev, **constrained_runs()["soft"])
        ssocp = sprob[2]
        rprob = make_problem(dev, **EXACT_RUNS["rows_exact"])
        cprob = make_problem(dev, **constrained_runs()["colloc"])
        from mpc_code_tpu_torch import config as pconfig

        elem_cfg = elem_config(pconfig, torch_fns(), N=ELEM_N, Mx=ELEM_K5_MX)
        cp_cfg = cartpole_config(pconfig, torch_fns())
        cp_socp = structured(cp_cfg, dev)
        esweeps = elementary_sweeps(eprob, cp_socp)
        # kernel 5's builds' OCPs (STAGE_BUILDS): each path's own
        xprobs = {"cstr_exact": (cfg, xsocp), "nmpc_dis": (dc, dprob.socp),
                  "enmpc": (ec, eprob.socp), "cstr_du": (duprob[0], duprob[2]),
                  "lmpc": (lcfg, lsocp), "clb": (ccfg, csocp), "soft": (sprob[0], ssocp),
                  "rows": (rprob[0], rprob[2]), "colloc": (cprob[0], cprob[2]),
                  "colloc_newton2": colloc_newton2_ocp(cprob[0], dev),
                  "elem": (elem_cfg, structured(elem_cfg, dev)), "cartpole": (cp_cfg, cp_socp),
                  "mhe": (mcfg, msocp), "host_mhe": (mcfg, mw.mhe_ocp(mcfg, dev, maskable=False))}
        sweep = socp.sweep
        # kernel 5's builds, exact and Gauss-Newton, and their dimensions
        k5, k5_build = {}, {}
        for build, (pkey, _, _, _) in STAGE_BUILDS.items():
            kcfg, ksocp = xprobs[pkey]
            for hessian, key in build_hessians(build):
                k5[key] = sk.make_stage_sweep(ksocp, hessian)
                k5_build[key] = k5_dims(k5[key], kcfg, ksocp)
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(10 + len(esweeps) + len(k5)) as ex:
            jobs = {
                "rk4_stage_jac": ex.submit(sweep.build, cfg.nx, cfg.nu, cfg.nd, cfg.npx),
                "riccati_kkt": ex.submit(rk.build_kernel, socp.nxa, socp.nu),
                "rk4_quad_stage_hess": ex.submit(eprob.socp.sweep.build, ec.nx, ec.nu,
                                                 ec.nd, ec.npx, ec.npy),
                "riccati_kkt_enmpc": ex.submit(rk.build_kernel, eprob.socp.nxa,
                                               eprob.socp.nu),
                "map_stage_jac": ex.submit(dprob.socp.sweep.build, dc.nx, dc.nu, dc.nd,
                                           dc.npx),
                "riccati_kkt_nmpc_dis": ex.submit(rk.build_kernel, dprob.socp.nxa,
                                                  dprob.socp.nu),
                "riccati_kkt_lmpc": ex.submit(rk.build_kernel, lsocp.nxa, lsocp.nu),
                "riccati_kkt_enmpc_mhe": ex.submit(rk.build_kernel, msocp.nxa, msocp.nu),
                "riccati_kkt_soft": ex.submit(rk.build_kernel, ssocp.nxa, ssocp.nu),
                "riccati_kkt_cartpole": ex.submit(rk.build_kernel, cp_socp.nxa, cp_socp.nu),
                **{name: ex.submit(sw.build, *dims) for name, (sw, dims) in esweeps.items()},
                **{name: ex.submit(sw.build, *k5_build[name]) for name, sw in k5.items()}}
            built = {name: j.result() for name, j in jobs.items()}
        if part is None:
            log(f"# build: {len(built)} kernel libraries in {time.perf_counter() - t0:.1f} s")
        for name, b in built.items():
            for dtype, line in ptxas_lines(b.log):
                if part is None:
                    log(f"#   ptxas {name} {dtype}: {line}")
                results[name].setdefault("ptxas", []).append(f"{dtype}: {line}")
            results[name]["ptxas_summary"] = ptxas_summary(b.log)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED in set-up/build", file=sys.stderr)
        return 1

    import shutil
    import tempfile

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    parts = [] if part is not None else start_parts(selected, run_dir)
    go = part["go"] if part is not None else os.path.join(run_dir, "go")
    # this process's own phases
    selected = [p for p in selected if not any(p in phases for phases, _, _ in parts)]

    # the CPU side of every cross-check, in worker processes beside the
    # card's phases
    pool = cf.ProcessPoolExecutor(CPU_REF_WORKERS, mp_context=mp.get_context("spawn"))
    # the constrained phase's and the closed loops' CPU runs are the
    # longest: they start first, and the others keep their order
    cpu_refs = {(p, "float64"): pool.submit(cpu_reference, p, "float64")
                for p in ("constrained", "enmpc_loop", "cstr_loop", "lmpc_loop")
                if p in selected}
    cpu_refs.update({(p, dt): pool.submit(cpu_reference, p, dt)
                     for p in ("slice", "enmpc", "nmpc_dis", "cstr_exact") if p in selected
                     for dt in ("float64", "float32")})
    # the solver_options phase's check lanes: needed after the constrained
    # phase, so queued after the controller phases' runs
    if "solver_options" in selected:
        cpu_refs.update({(f"solver_options:{name}", "float64"): pool.submit(
            cpu_reference, f"solver_options:{name}", "float64")
            for name in dict(OPTION_RUNS, **EXACT_RUNS) if name != "default"})
    if "debug" in selected:
        cpu_refs[("debug", "float64")] = pool.submit(cpu_reference, "debug", "float64")
    if "cartpole" in selected:
        cpu_refs.update({(f"cartpole:{h}", "float64"): pool.submit(
            cpu_reference, f"cartpole:{h}", "float64") for h in CARTPOLE_RUNS})
    # the one-lane host runs and the loops' check lanes on the card in
    # processes of their own (card_job)
    card_pool = cf.ProcessPoolExecutor(CARD_WORKERS, mp_context=mp.get_context("spawn"))
    card_jobs = {}
    # the aot phase's two processes, started with host_loop's card jobs
    aot_pool = cf.ThreadPoolExecutor(1)
    enmpc = Path("enmpc", ew, eprob, sweep_cf_cuda, "rk4_quad_stage_hess",
                 "riccati_kkt_enmpc", ENMPC_U_TOL)
    nmpc_dis = Path("nmpc_dis", dw, dprob, sweep_map_cuda, "map_stage_jac",
                    "riccati_kkt_nmpc_dis", NMPC_DIS_U_TOL)
    cstr_loop = Loop("cstr_loop", cw, U_BOX, {"rk4_stage_jac": sweep_cuda, "riccati_kkt": rk},
                     profile=(), cap_apart=False)
    lmpc_loop = Loop("lmpc_loop", lw, lw.U_BOX, {"riccati_kkt": rk, "stage_sweep": sk},
                     profile=("ocp",), cap_apart=True, profile_steps=(0, 1))
    # the ENMPC loops: kernels 4 and 2 in the OCP, kernels 5 (the window's
    # build) and 2 in the MHE
    enmpc_kernels = dict(ocp_kernels=("rk4_quad_stage_hess", "riccati_kkt"),
                         mhe_kernels=("riccati_kkt", "stage_sweep"))
    enmpc_loop = Loop("enmpc_loop", mw, mw.U_BOX,
                      {"rk4_quad_stage_hess": sweep_cf_cuda, "riccati_kkt": rk,
                       "stage_sweep": sk},
                      profile=("estimate", "ocp"), cap_apart=False, nsim=ENMPC_NSIM,
                      mhe=True, profile_steps=ENMPC_PROFILE_STEPS, **enmpc_kernels)
    enmpc_handoff = Loop("enmpc_handoff", mw, mw.U_BOX,
                         {"rk4_quad_stage_hess": sweep_cf_cuda, "riccati_kkt": rk,
                          "stage_sweep": sk},
                         profile=(), cap_apart=False, nsim=HANDOFF_T, mhe=True,
                         start=handoff_start(pool, cpu_refs, card_jobs, launches), warmup=False,
                         **enmpc_kernels)
    phases = (("kernel", lambda: kernel_phase(dev, socp, results)),
              ("enmpc kernel", lambda: enmpc_kernel_phase(dev, eprob, results)),
              ("nmpc_dis kernel", lambda: nmpc_dis_kernel_phase(dev, dprob, results)),
              ("lmpc kernel", lambda: lmpc_kernel_phase(dev, lsocp, csocp, results)),
              ("enmpc_mhe kernel", lambda: enmpc_mhe_kernel_phase(dev, msocp, results)),
              ("elementary kernel", lambda: elementary_kernel_phase(
                  dev, esweeps, eprob, cp_socp, results)),
              ("stage_sweep kernel", lambda: stage_sweep_kernel_phase(dev, xprobs, results)),
              ("slice", lambda: slice_phase(dev, problem, launches, cpu_refs)),
              ("enmpc", lambda: controller_phase(dev, enmpc, launches, cpu_refs)),
              ("nmpc_dis", lambda: controller_phase(dev, nmpc_dis, launches, cpu_refs)),
              ("cstr_exact", lambda: slice_phase(dev, xprob, launches, cpu_refs,
                                                 exact=True)),
              ("cstr_loop", lambda: loop_phase(dev, cstr_loop, launches, cpu_refs, card_jobs)),
              ("lmpc_loop", lambda: loop_phase(dev, lmpc_loop, launches, cpu_refs, card_jobs)),
              ("clb", lambda: clb_phase(dev, launches)),
              ("mesh", lambda: mesh_phase(dev, launches)),
              ("constrained", lambda: constrained_phase(dev, launches, results, cpu_refs)),
              ("solver_options", lambda: options_phase(dev, launches, cpu_refs)),
              ("debug", lambda: debug_phase(dev, cpu_refs)),
              ("cartpole", lambda: cartpole_phase(dev, cp_cfg, cp_socp, launches, cpu_refs)),
              # host_loop before enmpc_loop: enmpc_loop's CPU reference (64
              # lanes) and the hand-off's warmup reference finish beside it
              # instead of being waited for (119 s and 39 s on the H100
              # in the other order)
              ("host_loop", lambda: host_loop_phase(dev, launches, card_pool)),
              ("enmpc_loop", lambda: loop_phase(dev, enmpc_loop, launches, cpu_refs, card_jobs)),
              ("enmpc_handoff", lambda: loop_phase(dev, enmpc_handoff, launches, cpu_refs,
                                                     card_jobs)),
              ("aot", lambda: aot_phase(card_jobs["aot"], launches)))
    started = False
    try:
        for name, phase in phases:
            if name not in selected:
                continue
            if not started and name not in ALONE:
                # the phases that run alone are over: the parts start theirs
                started = True
                if part is None:
                    open(go, "w").close()
                elif not wait_for(go, PART_WAIT_S):
                    failures.append("the main process's kernel phases did not end")
                    break
                log(f"# phases {name}..{selected[-1]} start at {time.time() - t_start:.1f} s")
                for n in LOOP_CHECK_JOBS:
                    if n in selected:
                        card_jobs[("loop_check", n)] = card_pool.submit(
                            card_job, "loop_check", n, {"cstr_loop": LOOP_NSIM,
                                                        "enmpc_loop": ENMPC_NSIM}[n])
            if "aot" in selected and "aot" not in card_jobs and name in ("host_loop", "aot"):
                card_jobs["aot"] = aot_pool.submit(aot_jobs)
            if ("enmpc_handoff" in selected and name in ("host_loop", "enmpc_handoff")
                    and ("enmpc_handoff_warmup", "float64") not in cpu_refs):
                # the hand-off's host warmup, on the card (f32, a process of
                # its own) and in f64 on the CPU, submitted late so that it
                # does not slow the earlier phases (its continuation's
                # reference is submitted by the phase, from the handed-off carry)
                card_jobs["handoff_warmup"] = card_pool.submit(card_job, "handoff_warmup")
                cpu_refs[("enmpc_handoff_warmup", "float64")] = pool.submit(
                    cpu_reference, "enmpc_handoff_warmup", "float64")
            t0 = time.perf_counter()
            try:
                out = phase()
                failures += out if name.endswith("kernel") else out[0]
            except Exception:
                traceback.print_exc()
                failures.append(f"{name} phase raised")
            log(f"# phase {name}: {time.perf_counter() - t0:.1f} s (ends at "
                f"{time.time() - t_start:.1f} s)")
        if part is None:
            open(go, "w").close()
            join_parts(parts, t_start, failures, launches, results)
    finally:
        stop_parts(parts)
        shutil.rmtree(run_dir, ignore_errors=True)
        pool.shutdown(cancel_futures=True)
        card_pool.shutdown(cancel_futures=True)
        aot_pool.shutdown(cancel_futures=True)
    if part is not None:
        tmp = part["out"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(failures=failures, launches=launches, results=results), f,
                      default=lambda o: o.item() if hasattr(o, "item") else str(o))
        os.rename(tmp, part["out"])
        return 1 if failures else 0
    log(f"# the smoke's processes: {cpu_seconds():.1f} s of CPU in "
        f"{time.time() - t_start:.1f} s of wall")

    def entry(name, res, n_launch):
        r32, r64 = res.get("float32", {}), res.get("float64", {})
        tb, to = r32.get("bytes_ms"), r32.get("ops_ms")
        return dict(
            launches=n_launch, max_abs_err=r32.get("max_abs_err"),
            ms=r32.get("ms"), plain_ms=r32.get("plain_ms"),
            bound_ms=None if tb is None else max(tb, to),
            bound_by=None if tb is None else ("bytes" if tb >= to else "operations"),
            library_ms=None, dtype="float32",
            wrapper_ms=r32.get("wrapper_ms"), call_ms=r32.get("wrapper_ms"),
            call_ms_f64=r64.get("wrapper_ms"),
            max_norm_err_f32=r32.get("max_norm_err"),
            max_norm_err_f64=r64.get("max_norm_err"),
            ms_f64=r64.get("ms"), plain_ms_f64=r64.get("plain_ms"),
            ptxas=res.get("ptxas_summary"))

    kernels = []
    meta = {"rk4_stage_jac": ("mpc_code_tpu_torch/csrc/rk4_stage_jac.cu",
                              "mpc_code_tpu/ops/sweep_pallas.py:241", "cstr"),
            "riccati_kkt": ("mpc_code_tpu_torch/csrc/riccati_kkt.cu",
                            "mpc_code_tpu/solver/riccati_kernel.py:92", "cstr"),
            "rk4_quad_stage_hess": ("mpc_code_tpu_torch/csrc/rk4_quad_stage_hess.cu",
                                    "mpc_code_tpu/ops/sweep_pallas.py:407", "enmpc"),
            "map_stage_jac": ("mpc_code_tpu_torch/csrc/map_stage_jac.cu",
                              "mpc_code_tpu/ops/sweep_pallas.py:342", "nmpc_dis"),
            "stage_sweep": ("mpc_code_tpu_torch/csrc/stage_sweep.cu",
                            "mpc_code_tpu/solver/sweep_kernel.py:107", "cstr_exact")}
    for name, (src, repl, path) in meta.items():
        k = dict(name=name, route="cuda", source=src, replaces=repl, path=path,
                 **entry(name, results[name], launches[name]))
        if name == "riccati_kkt":
            # the same kernel on the ENMPC path, at (N, nxa, nu) = (25, 2, 1),
            # on the nmpc_dis path, at (50, 8, 2), and on the exact-Hessian
            # CSTR path, at the CSTR path's shapes
            k["launches_by_path"] = {"cstr": launches["riccati_kkt"],
                                     "mesh": launches.get("riccati_kkt_mesh_mesh", 0),
                                     "mesh_unsharded": launches.get(
                                         "riccati_kkt_mesh_unsharded", 0),
                                     "dryrun": launches.get("riccati_kkt_dryrun", 0),
                                     "enmpc": launches["riccati_kkt_enmpc"],
                                     "nmpc_dis": launches["riccati_kkt_nmpc_dis"],
                                     "cstr_exact": launches["riccati_kkt_cstr_exact"],
                                     "cstr_loop": launches["riccati_kkt_cstr_loop"],
                                     "lmpc_loop": launches["riccati_kkt_lmpc_loop"],
                                     "clb": launches["riccati_kkt_clb"],
                                     "enmpc_loop": launches["riccati_kkt_enmpc_loop"],
                                     "host_loop": launches["riccati_kkt_host_loop"],
                                     "enmpc_handoff": launches.get(
                                         "riccati_kkt_enmpc_handoff", 0)}
            k["at_enmpc_shapes"] = entry(name, results["riccati_kkt_enmpc"],
                                         launches["riccati_kkt_enmpc"])
            k["at_nmpc_dis_shapes"] = entry(name, results["riccati_kkt_nmpc_dis"],
                                            launches["riccati_kkt_nmpc_dis"])
            # the linear-model paths: the LMPC loop at (50, 5, 2) and the
            # bench port at (20, 3, 2) on CLB_BATCH lanes
            k["at_lmpc_loop_shapes"] = entry(name, results["riccati_kkt_lmpc"],
                                             launches["riccati_kkt_lmpc_loop"])
            k["at_clb_shapes"] = entry(name, results["riccati_kkt_clb"],
                                       launches["riccati_kkt_clb"])
            # the ENMPC flagship loop's structured MHE at (11, 4, 4): its
            # launches are the MHE's share of the loop's (the rest are its
            # OCP's, at the ENMPC path's shapes)
            k["at_enmpc_mhe_shapes"] = entry(name, results["riccati_kkt_enmpc_mhe"],
                                             launches["riccati_kkt_enmpc_loop_mhe"])
            # the host MHE's window solves (ClosedLoop, host_loop): one lane;
            # the launches are the ENMPC fixture's MHE (the nmpc fixture has
            # no kernel)
            k["at_host_mhe_shapes"] = entry(name, results["riccati_kkt_host_mhe"],
                                            launches["riccati_kkt_host_loop"])
            k["launches_in_mhe"] = {p: launches.get(f"riccati_kkt_{p}_mhe", 0)
                                    for p in ("enmpc_loop", "enmpc_handoff")}
            # the constrained phase: collocation at the CSTR path's shapes,
            # the soft output bounds at (50, 7, 6); TermCons with H_eq
            # takes the plain recursions (0 launches)
            for p in ("colloc", "soft", "tc_heq"):
                k["launches_by_path"][f"constrained_{p}"] = launches[f"riccati_kkt_{p}"]
            # the solver_options phase: the CSTR path's shapes under each
            # option, then the exact routes at (50, 8, 2), (25, 2, 1) and
            # (50, 5, 2)
            for p in dict(OPTION_RUNS, **EXACT_RUNS):
                k["launches_by_path"][f"solver_options_{p}"] = launches.get(
                    f"riccati_kkt_options_{p}", 0)
            k["at_soft_shapes"] = entry(name, results["riccati_kkt_soft"],
                                        launches["riccati_kkt_soft"])
            for run in ("gn", "exact"):
                k["launches_by_path"][f"cartpole_{run}"] = launches[
                    f"riccati_kkt_cartpole_{run}"]
            k["at_cartpole_shapes"] = entry(name, results["riccati_kkt_cartpole"],
                                            launches["riccati_kkt_cartpole_gn"]
                                            + launches["riccati_kkt_cartpole_exact"])
        # the builds of the elementary functions' models, each
        # checked against its plain version: kernel 1's elem (no path) and
        # cart-pole (the cartpole phase's Gauss-Newton run), kernel 3's tanh
        # map and kernel 4's tanh quadrature (no path), kernel 2 at the
        # cart-pole's (20, 4, 1)
        builds = {b.removeprefix(name + "_"): entry(b, results[b], launches.get(
            f"{name}_cartpole_gn", 0) if b == "rk4_stage_jac_cartpole" else 0)
            for b in ("rk4_stage_jac_elem", "rk4_stage_jac_cartpole", "map_stage_jac_tanh",
                      "rk4_quad_stage_hess_tanh") if b.startswith(name + "_")}
        if builds or name == "stage_sweep":
            k["builds"] = builds
        if name == "rk4_stage_jac":
            # kernel 1 on the closed loop's OCP solves too
            k["launches_by_path"] = {"cstr": launches["rk4_stage_jac"],
                                     "cartpole_gn": launches["rk4_stage_jac_cartpole_gn"],
                                     "cstr_loop": launches["rk4_stage_jac_cstr_loop"],
                                     **{f"constrained_{p}": launches[f"rk4_stage_jac_{p}"]
                                        for p in ("colloc", "soft", "tc_heq")},
                                     **{f"solver_options_{p}": launches.get(
                                         f"rk4_stage_jac_options_{p}", 0)
                                        for p in OPTION_RUNS}}
        if name == "rk4_quad_stage_hess":
            # kernel 4 on the ENMPC flagship loop's OCP solves too
            k["launches_by_path"] = {"enmpc": launches["rk4_quad_stage_hess"],
                                     "dryrun": launches.get("rk4_quad_stage_hess_dryrun", 0),
                                     "enmpc_loop": launches["rk4_quad_stage_hess_enmpc_loop"],
                                     "enmpc_handoff": launches.get(
                                         "rk4_quad_stage_hess_enmpc_handoff", 0)}
        if name == "stage_sweep":
            # every build of kernel 5 at its paths' shapes, each checked
            # against its plain version: the exact build's and the
            # Gauss-Newton build's launches on the paths each serves
            # (STAGE_BUILDS); the solver_options phase's autotune run
            # launches the CSTR's Gauss-Newton build when "fused" wins the
            # probe
            for build, (_, _, ex_paths, gn_paths) in STAGE_BUILDS.items():
                gn_paths = gn_paths + (("options_autotune",) if build == "stage_sweep" else ())
                ex_by = {p: build_launches(launches, p) for p in ex_paths}
                gn_by = {p: build_launches(launches, p) for p in gn_paths}
                gn = (None if build in EXACT_ONLY_BUILDS else
                      dict(entry(name, results[build + "_gn"], sum(gn_by.values())),
                           launches_by_path=gn_by))
                if build == "stage_sweep":
                    k["gauss_newton_build"] = gn
                    continue
                k["builds"][build] = dict(entry(name, results[build], sum(ex_by.values())),
                                          launches_by_path=ex_by, gauss_newton_build=gn)
            by_path = {"cstr_exact": build_launches(launches, "cstr_exact"),
                       **k["gauss_newton_build"]["launches_by_path"]}
            for b in k["builds"].values():
                by_path.update(b["launches_by_path"])
                by_path.update((b["gauss_newton_build"] or {}).get("launches_by_path", {}))
            k["launches_by_path"] = by_path
            k["launches"] = sum(k["launches_by_path"].values())
        kernels.append(k)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
