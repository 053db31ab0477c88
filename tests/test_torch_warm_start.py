"""The structured solver's cross-solve dual/barrier warm start (``solve(..., ws=)``) against the JAX package, CPU, f64.

The bench's CSTR OCP (``examples/bench_workload.py``: N=5, RK4 Mx=2, the
saturation guard, tol 1e-8), 3 seeded lanes, under Gauss-Newton and under
the exact Hessian.  A cold solve from the bench's warm start converges;
its result shifted one stage, as the closed loop shifts it
(``loop/batched.py``: the last stage repeated), is the next problem's
primal guess and ``ws`` (zl, zu, lam, nus shifted; mu and sf carried),
with the initial state moved to the solved stage-1 state and lane 1's
``ok`` False.  The port's warm solve against JAX's ``make_structured_solver``
with the same ``ws`` (jitted, vmapped over the lanes): status and
iterations equal, X and U within 1e-8 (measured 1.7e-14 Gauss-Newton,
7.8e-15 exact).  Against a cold solve of the same shifted problem: fewer
iterations on the lanes with ``ok`` True (7 and 5 against 21 and 9
under Gauss-Newton, 5 and 3 against 17 and 9 exact), the same solve on
lane 1.

About 32 s in one process (builder's CPU run).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, SEED, LANES = 5, 1, [0, 1, 2]
WS_OK = np.array([True, False, True])


def _shift(a):
    return np.concatenate([a[:, 1:], a[:, -1:]], axis=1)


@pytest.fixture(scope="module", params=["gauss_newton", "exact"])
def solves(request):
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import bench_workload as bw
    from mpc_code_tpu_torch.solver import riccati

    opts = dict(hessian=request.param, tol=1e-8)
    cfg, model, socp, _ = bw.make_problem("cpu", Nh=N, Mx=2, hessian=request.param)
    solve = riccati.make_structured_solver(socp, SolverOptions(**opts))
    x0s = bw.draw_x0(max(LANES) + 1, "cpu", seed=SEED, dtype=torch.float64)[LANES]
    nb = len(LANES)
    X0, U0 = bw.warm_start(cfg, model, x0s, torch.as_tensor(bw.U_SS).expand(nb, 2), N)
    r0 = solve(bw.bench_params(cfg, x0s, N), X0, U0)
    assert (r0.status.numpy() == 0).all()

    # the next problem: x0 at the solved stage-1 state, the shifted primal
    # and duals as the guess
    x1 = r0.X[:, 1].clone()
    X1, U1 = _shift(r0.X.numpy()), _shift(r0.U.numpy())
    ws = dict(zl=_shift(r0.zl.numpy()), zu=_shift(r0.zu.numpy()),
              lam=_shift(r0.lam.numpy()), nus=_shift(r0.nus.numpy()),
              mu=r0.mu.numpy(), sf=r0.sf.numpy(), ok=WS_OK)
    par1 = bw.bench_params(cfg, x1, N)
    warm = solve(par1, torch.as_tensor(X1), torch.as_tensor(U1),
                 ws={k: torch.as_tensor(v) for k, v in ws.items()})
    cold = solve(par1, torch.as_tensor(X1), torch.as_tensor(U1))

    jcfg = make_jax().replace(N=N, R_wn=None)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=2,
                                         clip_lo=bw.CLIP_LO.astype(np.float32),
                                         clip_hi=bw.CLIP_HI.astype(np.float32)))
    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    jsolve = make_structured_solver(js, JOpts(**opts))
    jpar = {k: jnp.asarray(np.asarray(v, float)) for k, v in par1.items()}

    def lane(x0, Xw, Uw, w):
        return jsolve(dict(jpar, x0=x0), Xw, Uw, ws=w)

    jres = jax.device_get(jax.jit(jax.vmap(lane))(
        jnp.asarray(x1.numpy()), jnp.asarray(X1), jnp.asarray(U1),
        {k: jnp.asarray(v) for k, v in ws.items()}))
    return warm, cold, jres


def test_warm_solve_matches_jax(solves):
    warm, _, jres = solves
    np.testing.assert_array_equal(warm.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(warm.iters.numpy(), np.asarray(jres.iters))
    assert (warm.status.numpy() == 0).all()
    for name in ("X", "U"):
        got, ref = getattr(warm, name).numpy(), np.asarray(getattr(jres, name))
        assert (np.abs(got - ref) / (1 + np.abs(ref))).max() <= 1e-8, name


def test_warm_start_saves_iterations(solves):
    warm, cold, _ = solves
    it_w, it_c = warm.iters.numpy(), cold.iters.numpy()
    assert (it_w[WS_OK] < it_c[WS_OK]).all(), (it_w, it_c)
    # a lane with ok False starts cold
    assert it_w[~WS_OK].tolist() == it_c[~WS_OK].tolist()
    np.testing.assert_array_equal(warm.U.numpy()[~WS_OK], cold.U.numpy()[~WS_OK])
