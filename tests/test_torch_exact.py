"""The port's exact-Hessian structured solve against the JAX package, CPU, f64.

- The bench's CSTR OCP at N=5, RK4 Mx=2 with the saturation guard, from
  the bench's forward-simulated warm start: JAX's
  ``make_structured_solver(s, SolverOptions(hessian="exact", tol=1e-8))``
  jitted and vmapped once over the lanes, the port's solver with the same
  options on CPU tensors (its fused stage sweep's plain version).  Status
  and iterations per lane equal, X and U to 1e-8.  On one lane the exact
  Lagrangian Hessian is indefinite on some iteration: the Riccati solve
  reports the lane unsolvable, the solver raises its regularisation delta
  and the lane still converges, in the iterations JAX takes.
- With no JAX: the port's target and exact-Hessian OCP at the example's own
  solver options on the 10 recorded steps of ``fixtures/nmpc.npz`` (N=10,
  the example's Mx=10) as 10 lanes of one batched call, against the
  recorded XS and US at the fixtures' 1e-4 bar, and U[0] at that bar on
  step 0, which the recording also solved from a cold start.  From step 1
  on the recording's host loop (``loop/simulator.py``) solves each OCP
  with the dense IPM from the previous step's shifted solution, and lands
  up to 1.1e-2 away in the second input (steps 4-5); JAX's structured
  solver from the port's cold start gives the port's U[0] (CPU, steps
  1-3).  Those steps need the closed loop's warm start (ROADMAP Queue 1
  item 13).
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N = 5
# bench draws with seed 1: 0 and 1 converge with delta at 0 throughout; on
# draw 289 (DELTA_LANE) the exact Hessian is indefinite on some iteration
SEED, LANES, DELTA_LANE = 1, [0, 1, 289], 2
OPTS = dict(hessian="exact", tol=1e-8)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "fixtures", "nmpc.npz")


@pytest.fixture(scope="module")
def solves():
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import bench_workload as bw
    from mpc_code_tpu_torch.solver import riccati

    cfg, model, socp, _ = bw.make_problem("cpu", Nh=N, Mx=2)
    x0s = bw.draw_x0(max(LANES) + 1, "cpu", seed=SEED, dtype=torch.float64)[LANES]
    nb = len(LANES)
    X0, U0 = bw.warm_start(cfg, model, x0s, torch.as_tensor(bw.U_SS).expand(nb, 2), N)
    par = bw.bench_params(cfg, x0s, N)

    # the Riccati solve's ok flags of every iteration, one per lane
    flags = []
    inner = riccati.riccati_kkt

    def recording(*a, **k):
        out = inner(*a, **k)
        flags.append(out[0].numpy().copy())
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(riccati, "riccati_kkt", recording)
    try:
        pres = riccati.make_structured_solver(socp, SolverOptions(**OPTS))(par, X0, U0)
    finally:
        mp.undo()

    jcfg = make_jax().replace(N=N, R_wn=None)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=2,
                                         clip_lo=bw.CLIP_LO.astype(np.float32),
                                         clip_hi=bw.CLIP_HI.astype(np.float32)))
    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    jsolve = make_structured_solver(js, JOpts(**OPTS))
    jpar = {k: jnp.asarray(np.asarray(v, float)) for k, v in par.items()}

    def lane(x0, Xw, Uw):
        return jsolve(dict(jpar, x0=x0), Xw, Uw)

    jres = jax.device_get(jax.jit(jax.vmap(lane))(
        jnp.asarray(x0s.numpy()), jnp.asarray(X0.numpy()), jnp.asarray(U0.numpy())))
    return pres, jres, np.array(flags)


def test_exact_solve_matches_jax(solves):
    pres, jres, _ = solves
    np.testing.assert_array_equal(pres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(pres.iters.numpy(), np.asarray(jres.iters))
    assert (pres.status.numpy() == 0).all()
    for name in ("X", "U"):
        got, ref = getattr(pres, name).numpy(), np.asarray(getattr(jres, name))
        assert (np.abs(got - ref) / (1 + np.abs(ref))).max() <= 1e-8, name


def test_indefinite_hessian_raises_delta(solves):
    """The iterations on which each lane's Riccati solve failed (delta rises
    by 10x, at least to 1e-5, and the step is not taken): on DELTA_LANE
    only."""
    pres, _, flags = solves
    it = pres.iters.numpy()
    rose = [int((~flags[:it[i], i]).sum()) for i in range(len(LANES))]
    assert rose[DELTA_LANE] >= 1
    assert sum(rose) == rose[DELTA_LANE], rose


def test_fixture_steps_reproduced():
    """The port's CSTR target and exact-Hessian OCP (N=10, the example's
    Mx=10 and its default SolverOptions, f64, cold starts) on the 10
    recorded closed-loop steps as 10 lanes: every solve converges; XS and
    US on every step, U[0] on the cold step 0, within the fixtures' 1e-4 of
    ``tests/test_fixtures.py``."""
    from torch.func import vmap

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.models import (
        build_model, build_ss_cost, build_stage_cost, build_terminal_cost,
    )
    from mpc_code_tpu_torch.ocp.target import build_target
    from mpc_code_tpu_torch.solver.ipm import make_solver
    from mpc_code_tpu_torch.solver.riccati import (
        build_structured_ocp, make_structured_solver,
    )

    z = np.load(FIXTURE)
    K, Nh = len(z["H_U"]), int(z["meta_N"])
    cfg = make_config().replace(N=Nh)
    model = build_model(cfg)
    T = lambda a: torch.tensor(np.asarray(a, float))  # noqa: E731
    prev = lambda a, a0: np.concatenate([np.asarray(a0, float)[None], a[:-1]])  # noqa: E731
    d, ts = T(z["H_D_HAT"]), T(np.arange(K) * cfg.h)
    sp = [cfg.defSP(float(t)) for t in ts]
    ysp, usp, xsp = (T(np.stack([s[i] for s in sp])) for i in range(3))

    tspec = build_target(cfg, model, build_ss_cost(cfg.ss_cost))
    tsolve = make_solver(tspec.nlp, SolverOptions())
    zeros = lambda *s: torch.zeros((K,) + s, dtype=torch.float64)  # noqa: E731
    x0_m, u0 = T(cfg.x0_m), T(cfg.u0)
    y0 = vmap(lambda dd: model.fy(x0_m, u0, dd, 0.0, torch.zeros(cfg.npy,
                                                                dtype=torch.float64)))(d)
    w0 = torch.cat([x0_m.expand(K, -1), u0.expand(K, -1), y0], 1)
    rt = tsolve(w0, dict(usp=usp, ysp=ysp, xsp=xsp, d=d, us_prev=T(prev(z["H_US"], cfg.u0)),
                         lam=zeros(cfg.ny, cfg.nu), t=ts, px=zeros(cfg.npx),
                         py=zeros(cfg.npy)),
                tspec.lbw, tspec.ubw, tspec.lbg, tspec.ubg)
    assert (rt.status.numpy() == 0).all()
    xs, us = rt.w[:, :cfg.nx], rt.w[:, cfg.nx:cfg.nx + cfg.nu]

    socp = build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device="cpu")
    solve = make_structured_solver(socp, SolverOptions())
    x0 = T(z["H_X_HAT"])
    r = solve(dict(x0=x0, xs=xs, us=us, d=d, um1=T(prev(z["H_U"], cfg.u0)), t=ts,
                   lam=np.zeros((cfg.ny, cfg.nu)), px=np.zeros((Nh, cfg.npx)),
                   py=np.zeros((Nh, cfg.npy))),
              x0[:, None].expand(-1, Nh + 1, -1), us[:, None].expand(-1, Nh, -1))
    assert (r.status.numpy() == 0).all()
    assert np.abs(xs.numpy() - z["H_XS"]).max() <= 1e-4
    assert np.abs(us.numpy() - z["H_US"]).max() <= 1e-4
    assert np.abs(r.U[0, 0].numpy() - z["H_U"][0]).max() <= 1e-4
