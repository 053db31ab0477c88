"""The ENMPC flagship closed loop: economic NMPC with the moving-horizon estimator.

A port of ``tools/enmpc_onchip_bench.py`` in its default mode, resident on
the card from step 0 with the growing-horizon MHE warmup in the step.
``examples/enmpc.py`` (Ex_ENMPC) at its full width: nx=2, nu=1, ny=nd=2,
N=25, h=2.0, RK4 with Mx=10, the output-disturbance model, the ContForm
economic OCP by the structured IPM under Gauss-Newton (kernel 4 and the
Riccati KKT kernel once a pass), the economic target by the dense IPM, the
MHE with N_mhe=10 and the 'smooth' arrival-cost update, its window solved
by the structured IPM (the fused stage sweep, kernel 5, and the Riccati
KKT kernel once a pass at (N, nxa, nu) = (11, 4, 4), the stage derivatives
through the MHE model's RK4 at Mx_mhe=10), and the RK4 plant.  The solver options are the
tool's on a chip (``tools/enmpc_onchip_bench.py:50-59``):
``SolverOptions.for_f32()`` for the target and the MHE,
``for_f32(hessian="gauss_newton")`` for the OCP; every solve runs in the
lanes' dtype.  B lanes start from the example's initial carry with their
plant states perturbed by ``1e-3 * normal`` (seed 0, ``:82-90``).

    cfg = make_config()
    hist, times = run_loop(cfg, draw_x0(16384, device), Nsim=16,
                           step=make_step(cfg, device))

The tool's ``ENMPC_WARM_HANDOFF=1`` mode (``:62-71,86-89``) is
:func:`warm_handoff`: the host loop ``ClosedLoop`` runs the growing-horizon
warmup for K0 = N_mhe + 2 steps on one lane (on the card in f32 with the
same solver options, as the JAX tool on its chip), then
``carry_from_runtime`` and ``init_carry(cfg, mhe=..., state=
loop.final_state)`` hand it to the batched step, tiled to B lanes with the
plant states perturbed by ``1e-3 * normal`` (seed 0); the steady steps
continue from there with ``run_loop(..., carry=carry, t0=st["t"],
k0=K0)``.

    cfg = make_config(warm_handoff=True)
    carry, loop, _, warmup_s = warm_handoff(cfg, 16384, device)
    hist, times = run_loop(cfg, None, Nsim=8, step=make_step(cfg, device),
                           carry=carry, t0=loop.final_state["t"], k0=handoff_steps(cfg))
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpc_code_tpu_torch.config import SolverOptions
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.examples.closed_loop_workload import PHASES, run_loop  # noqa: F401
from mpc_code_tpu_torch.examples.enmpc import make_config as make_enmpc
from mpc_code_tpu_torch.loop.batched import make_mpc_step

N, N_MHE, NSIM = 25, 10, 16
U_BOX = np.array([2.0])           # width of the input bounds [0, 2]


def make_config(N=N, N_mhe=N_MHE, Nsim=NSIM, warm_handoff=False):
    """The flagship loop's configuration at horizon ``N`` and MHE window
    ``N_mhe``.  Both modes share it (the JAX tool's ``mk``): with
    ``warm_handoff`` the run starts from :func:`warm_handoff`'s carry
    instead of ``init_carry``'s cold window."""
    cfg = make_enmpc(Nsim=Nsim).replace(
        N=N, sol_opts_ss=SolverOptions.for_f32(),
        sol_opts_dyn=SolverOptions.for_f32(hessian="gauss_newton"),
        sol_opts_mhe=SolverOptions.for_f32())
    cfg.estimator.N_mhe = N_mhe
    return cfg


def draw_x0(batch, device=None, seed=0, dtype=torch.float32):
    """``batch`` initial plant states: the example's ``x0_p`` plus
    ``1e-3 * normal`` with ``seed``, rounded to f32."""
    cfg = make_enmpc()
    dx = 1e-3 * np.random.default_rng(seed).standard_normal((batch, cfg.nxp))
    x0 = np.asarray(cfg.x0_p, float)[None] + dx
    return torch.as_tensor(x0.astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def make_step(cfg, device=None):
    """The loop's ``make_mpc_step`` (MHE, target, structured OCP) on
    ``device`` (default the card)."""
    return make_mpc_step(cfg, device=device)


def mhe_ocp(cfg, device=None, maskable=True):
    """The structured MHE problem of the loop's estimator (its shapes: N
    = N_mhe + 1, nxa = nu = nx + nd), as ``make_mhe_traced`` builds it;
    with ``maskable`` False the host MHE's full window (``MHERuntime``)."""
    from mpc_code_tpu_torch.estimators.linear import build_augmented
    from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    model = build_model(cfg)
    N = cfg.estimator.N_mhe
    socp, _ = build_structured_mhe(cfg, build_mhe_model(cfg, model),
                                   build_augmented(cfg, model).fy,
                                   build_mhe_cost(cfg.estimator.mhe_cost), N, N,
                                   maskable=maskable, device=device)
    return socp


def handoff_steps(cfg):
    """K0, the host warmup's length: N_mhe + 2 steps, so that the window is
    full and its prior updated before the hand-off."""
    return cfg.estimator.N_mhe + 2


def host_warmup(cfg, device=None, dtype=torch.float32):
    """The hand-off mode's host part (``tools/enmpc_onchip_bench.py:62-71``):
    ``ClosedLoop`` for K0 steps on ``device`` (default the card) in
    ``dtype``, then ``carry_from_runtime`` and ``init_carry(state=...)``.
    Returns ``(carry, loop, H, warmup_s)``: the batched carry of one lane,
    the warmed host loop, its history and the wall seconds."""
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced
    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.loop.batched import init_carry

    dev = resolve_device(device)
    t0 = time.perf_counter()
    loop = ClosedLoop(cfg.replace(Nsim=handoff_steps(cfg)), device=dev, dtype=dtype)
    H = loop.run()
    st = loop.final_state
    _, from_rt = make_mhe_traced(cfg, loop.model, device=dev)
    carry = init_carry(cfg, mhe=from_rt(loop.mhe_rt, st["P"]), state=st, device=dev,
                       dtype=dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return carry, loop, H, time.perf_counter() - t0


def tile_handoff(cfg, carry, batch, seed=0):
    """A host warmup's carry of one lane tiled to ``batch`` lanes whose
    plant states get ``1e-3 * normal`` (``seed``; rounded to f32 as the
    tool's, ``tools/enmpc_onchip_bench.py:86-89``)."""
    from mpc_code_tpu_torch.loop.batched import tile_carry

    dx = 1e-3 * np.random.default_rng(seed).standard_normal((batch, cfg.nxp))
    carry = tile_carry(carry, batch)
    return carry._replace(x=carry.x + torch.as_tensor(dx.astype(np.float32),
                                                      dtype=carry.x.dtype,
                                                      device=carry.x.device))


def warm_handoff(cfg, batch, device=None, dtype=torch.float32, seed=0):
    """The hand-off mode's start: :func:`host_warmup`, then
    :func:`tile_handoff` to ``batch`` lanes.  Returns ``(carry, loop, H,
    warmup_s)``: the batched carry, the warmed host loop, its history and
    the warmup's wall seconds."""
    carry, loop, H, warmup_s = host_warmup(cfg, device, dtype)
    return tile_handoff(cfg, carry, batch, seed), loop, H, warmup_s
