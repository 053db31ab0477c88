"""The warm batched CSTR NMPC closed loop through the port's entry points.

``examples/nmpc.py`` (Ex_NMPC) at its full width: nx=3, nu=2, ny=nd=2,
N=50, h=0.2, RK4 with Mx=10, ``offree='nl'``, the EKF, the non-nominal
``ContinuousPlant`` with its scheduled feed flow, output noise ``R_wn`` and
the ``defSP`` setpoint; with the bench's saturation guard on the model
(``bench_workload.py``: CLIP_LO/CLIP_HI, as ``bench.py:81-84``) and on the
plant, and the solver options of ``tools/closed_loop_bench.py:48-51``: the
OCP by the structured IPM under Gauss-Newton, the target by the dense IPM,
both ``SolverOptions.for_f32(max_iter=10)``.  The OCP runs in the lanes'
dtype; the target is solved in TARGET_DTYPE = float64 whatever the lanes'
dtype, as in ``nmpc_dis_workload.py``: in float32 the dense IPM (the JAX
package's too) stops at the cap of 10 short of the target on a share of
the lanes from step 0 (status 1 or 2 where float64 converges in 5
iterations), which moves their targets and inputs by up to the whole
input box.  B scenarios step together and
share the step inputs (``make_step_inputs(cfg, Nsim)``); each lane's plant
starts from its own state, drawn from the bench's operating box
(``bench_workload.draw_x0(B, seed=0)``, ``bench.py:301-302``), and its
estimate from the example's ``x0_m``.  Every step after the first is
warm-started from the shifted previous primal and dual solution.

    cfg = make_config()
    hist, times = run_loop(cfg, draw_x0(16384, device), Nsim=10)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpc_code_tpu_torch.config import SolverOptions
from mpc_code_tpu_torch.examples.bench_workload import CLIP_HI, CLIP_LO, draw_x0  # noqa: F401
from mpc_code_tpu_torch.examples.nmpc import make_config as make_nmpc
from mpc_code_tpu_torch.loop.batched import (
    history_from_outputs, init_carry, make_mpc_step, stack_outputs,
)
from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

N, MX, NSIM, MAX_ITER = 50, 10, 10, 10
TARGET_DTYPE = torch.float64
PHASES = ("estimate", "target", "ocp", "plant")


def make_config(N=N, Mx=MX, max_iter=MAX_ITER):
    """The closed-loop configuration at horizon ``N`` with ``Mx`` RK4
    sub-steps in the model and the plant."""
    cfg = make_nmpc().replace(
        N=N,
        sol_opts_dyn=SolverOptions.for_f32(max_iter=max_iter, hessian="gauss_newton"),
        sol_opts_ss=SolverOptions.for_f32(max_iter=max_iter))
    lo, hi = CLIP_LO.astype(np.float32), CLIP_HI.astype(np.float32)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, Mx=Mx, clip_lo=lo, clip_hi=hi),
        plant=dataclasses.replace(cfg.plant, Mx=Mx, clip_lo=lo, clip_hi=hi))


def make_step(cfg, device=None):
    """The closed loop's ``make_mpc_step``: structured OCP, targets in
    TARGET_DTYPE, on ``device`` (default the card)."""
    return make_mpc_step(cfg, device=device, target_dtype=TARGET_DTYPE)


def run_loop(cfg, x0s, Nsim=NSIM, device=None, step=None, on_step=None,
             carry=None, t0=0.0, k0=0):
    """Run ``Nsim`` closed-loop steps for the lanes ``x0s`` (B, nx), in
    their dtype on ``device`` (default: theirs).  ``step`` reuses a
    ``make_step(cfg, ...)``; ``on_step(k, carry, out)`` is called
    after each step.  ``carry`` (with ``x0s`` None) continues a run from
    that carry, at time ``t0`` and step index ``k0`` (the schedules' and
    the noise stream's).  Returns ``(history, times)``: the history arrays
    (Nsim, B, ...) and, per step, the wall seconds and the seconds of each
    phase (the card synchronised at each phase's end)."""
    lanes = x0s if carry is None else carry.x
    dev = lanes.device if device is None else torch.device(device)
    if step is None:
        step = make_step(cfg, device=dev)
    if carry is None:
        carry = init_carry(cfg, x0s, device=dev, dtype=x0s.dtype)
    inputs = make_step_inputs(cfg, Nsim, t0=t0, k0=k0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times, outs = [], []
    for k in range(Nsim):
        marks = {}
        sync()
        start = last = time.perf_counter()

        def mark(name):
            nonlocal last
            sync()
            now = time.perf_counter()
            marks[name] = now - last
            last = now

        carry, out = step(carry, StepInput(*(a[k] for a in inputs)), mark=mark)
        sync()
        times.append(dict(wall_s=time.perf_counter() - start, **marks))
        outs.append(out)
        if on_step is not None:
            on_step(k, carry, out)
    return history_from_outputs(stack_outputs(outs)), times
