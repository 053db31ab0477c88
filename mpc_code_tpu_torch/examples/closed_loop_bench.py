"""Batched closed-loop throughput on one card: full MPC steps (estimate +
target NLP + OCP NLP + plant) per second for a batch of scenarios.

Port of ``tools/closed_loop_bench.py``.  The configuration is the port's
copy of ``__graft_entry__._small_cfg(N=20)``: a linearised CSTR
(``LinearModel``, nx=3, nu=2, ny=nd=3, ``offree='lin'`` with ``Bd = I``),
the time-varying Kalman filter, a QP target and OCP, input bounds, with
the tool's solver options (the OCP by the structured IPM under
Gauss-Newton, both ``SolverOptions.for_f32(max_iter=max_it)``) and the
tool's lanes: ``x0_p`` plus normal(0.2) draws with seed 0, in f32, setpoint
``ysp = [0.2, 0, 0]``.  Every step after the first is warm-started by the
shifted previous solution.  One warm-up run, then the median of three timed
runs, each from the lanes perturbed by ``1e-4 (r+1)`` as the tool does.
It prints the tool's two lines.  The runner is
``parallel/mesh.py::make_closed_loop_runner``, built once, with the
tool's AOT key (``clb-small-cstr-N20-mi<max_it>``): a second process
loads the kernel library from the artifact (``utils/aot.py``) instead of
building it.  ``run(..., mesh=)`` splits the batch over a mesh's ranks
(without the AOT key, as in JAX); each rank reports its own block.

Usage: python -m mpc_code_tpu_torch.examples.closed_loop_bench [batch] [steps] [max_it]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import scipy.linalg as scla
import torch

from mpc_code_tpu_torch.config import (
    Bounds, DisturbanceModel, EstimatorConfig, LinearModel, LinearPlant,
    MPCConfig, SolverOptions, SSCost, StageCost,
)
from mpc_code_tpu_torch.device import pin_fp32_precision, resolve_device

YSP = np.array([0.2, 0.0, 0.0])


def small_cfg(N=8):
    """Small linear-CSTR MPC config with the Kalman filter (the port's copy
    of ``__graft_entry__._small_cfg``)."""
    nx, nu, ny, nd = 3, 2, 3, 3
    Ap = np.array([[0.2511, -3.368e-03, -7.056e-04],
                   [11.06, 0.3296, -2.545],
                   [0.0, 0.0, 1.0]])
    Bp = np.array([[-5.426e-03, 1.53e-05], [1.297, 0.1218], [0.0, -6.592e-02]])
    Cp = np.eye(3)
    return MPCConfig(
        nx=nx, nxp=3, nu=nu, ny=ny, nd=nd,
        Nsim=10, N=N, h=1.0,
        model=LinearModel(A=Ap, B=Bp, C=Cp),
        plant=LinearPlant(Ap=Ap, Bp=Bp, Cp=Cp),
        dist=DisturbanceModel(offree="lin", Bd=np.eye(nd), Cd=np.zeros((ny, nd))),
        x0_p=3 * np.ones(3), x0_m=3 * np.ones(3), u0=np.zeros(2),
        ss_cost=SSCost(Qss=np.diag([20.0, 0.0, 1.0]), Rss=np.zeros((nu, nu))),
        stage_cost=StageCost(Q=np.diag([1.0, 0.0, 1.0]), R=0.1 * np.eye(nu)),
        estimator=EstimatorConfig(
            kind="kal",
            Q_kf=scla.block_diag(1e-7 * np.eye(nx), np.eye(nd)),
            R_kf=1e-7 * np.eye(ny),
            P0=1e-8 * np.eye(nx + nd),
        ),
        bounds=Bounds(umin=-10 * np.ones(nu), umax=10 * np.ones(nu)),
        sol_opts_ss=SolverOptions.for_f32(),
        sol_opts_dyn=SolverOptions.for_f32(hessian="gauss_newton"),
    )


def make_config(max_it=10, N=20):
    """The bench's configuration: ``small_cfg(N)`` with the tool's options."""
    return small_cfg(N=N).replace(
        sol_opts_dyn=SolverOptions.for_f32(max_iter=max_it, hessian="gauss_newton"),
        sol_opts_ss=SolverOptions.for_f32(max_iter=max_it))


def draw_x0(cfg, batch, seed=0):
    """The tool's lanes: ``x0_p`` plus normal(0.2) draws, as f32."""
    rng = np.random.default_rng(seed)
    return (np.tile(np.asarray(cfg.x0_p, float), (batch, 1))
            + rng.normal(scale=0.2, size=(batch, cfg.nx))).astype(np.float32)


def aot_key(max_it):
    """The tool's AOT key (``tools/closed_loop_bench.py:61-63``)."""
    return f"clb-small-cstr-N20-mi{max_it}"


def run(batch=1024, steps=20, max_it=10, device=None, mesh=None):
    """The bench: returns its two lines and its numbers (``status`` and
    ``iters`` of the last timed run, (steps, B) numpy)."""
    from mpc_code_tpu_torch.parallel.mesh import make_closed_loop_runner, mesh_device

    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    cfg = make_config(max_it)
    x0s = draw_x0(cfg, batch)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(x0):
        sync()
        t0 = time.perf_counter()
        _, out = runner(x0)
        st, iters = out.status_dyn.cpu().numpy(), out.ocp_iters.cpu().numpy()
        return time.perf_counter() - t0, st, iters

    # the runner is built once (with its kernel library, from the AOT
    # artifact where one exists); the timed calls then measure the runs
    t0 = time.perf_counter()
    runner = make_closed_loop_runner(cfg, steps, batch, mesh=mesh, ysp=YSP, device=dev,
                                     aot_key=None if mesh is not None else aot_key(max_it),
                                     dtype=torch.float32)
    timed(x0s)
    compile_s = time.perf_counter() - t0
    reps = []
    for r in range(3):
        dt, st, iters = timed(x0s + np.float32(1e-4 * (r + 1)))
        reps.append(dt)
    run_s = float(np.median(reps))
    lane_steps = st.size                # this rank's block under a mesh
    max_it_steps = iters.max(axis=1)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = (
        f"# compile={compile_s:.1f}s run={run_s:.2f}s batch={batch} steps={steps} "
        f"ok={(st != 2).sum()}/{st.size} warm med_iters={np.median(iters[1:]):.0f} "
        f"max_iters/step={np.median(max_it_steps[1:]):.0f} "
        f"(p90 {np.percentile(max_it_steps[1:], 90):.0f}) "
        f"platform={dev.type} device={name}",
        f"closed-loop MPC steps/s/chip: {lane_steps / run_s:,.0f} "
        f"(each = KF estimate + target NLP + OCP NLP + plant step)")
    return lines, dict(compile_s=compile_s, run_s=run_s, reps_s=reps,
                       lane_steps_per_s=lane_steps / run_s, status=st, iters=iters)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 1024
    steps = int(argv[1]) if len(argv) > 1 else 20
    # the batched solver loop runs to the slowest lane; warm-started steps
    # converge in a few iterations, so a tight cap bounds the batch tail
    # (non-converged lanes fall back per lane exactly like the host loop)
    max_it = int(argv[2]) if len(argv) > 2 else 10
    pin_fp32_precision()
    for line in run(batch, steps, max_it)[0]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
