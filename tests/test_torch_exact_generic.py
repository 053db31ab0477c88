"""The exact Lagrangian Hessian of the discrete map, ContForm and the
u_prev augmentation in the port's structured solver against the JAX
package's, CPU, f64, and the examples' own solver options in the batched
step.

Each OCP has the scaled one-interval map ``dyn`` and, since the fused
stage sweep lowers these forms, a lowering: the exact Hessian takes every
stage derivative from kernel 5's wrapper, whose plain version on CPU
tensors is ``make_stage_derivs`` by ``torch.func``, vmapped over the B*N
points: JAX's default route (``mpc_code_tpu/solver/riccati.py:973-1070``,
``:1396-1398``).  Three
lanes, tol 1e-8, JAX jitted once per case for one lane and run lane by
lane; statuses and iterations equal, X and U within 1e-8 (normalised
``|a-b|/(1+|b|)``):

- nmpc_dis: ``examples/nmpc_dis.py`` (nx=6, nu=2, the u_prev
  augmentation for its Delta-u rows and Delta-u cost) at N=8, its tank
  map's RK4 cut from 5 sub-steps to 2 (JAX's trace grows with them),
  lanes from ``nmpc_dis_workload.draw_lanes`` at their setpoints;
- enmpc: ``examples/enmpc.py`` (ContForm) at N=8, Mx=2, lanes from
  ``enmpc_workload.draw_lanes`` at the port's economic targets;
- cstr_du: the bench's CSTR (N=10, Mx=2, its guard) with ``DUForm=True``.

Costate duals on the ContForm route (no ``stage_dyn_jac``: the
recursion's Jacobian is the map's, by ``jacrev``) against JAX in f64, and
in f32, where the solve stays in f32.  Then the ENMPC and nmpc_dis
configurations build ``make_mpc_step`` with their own ``sol_opts_dyn``
(the exact Hessian) and take one step on the CPU, N and the RK4 sub-steps
cut.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, MX, LANES = 8, 2, 3
OPTS = dict(max_iter=60, tol=1e-8)
XS = np.array([0.874317, 325.0, 0.6528])
US = np.array([300.157, 0.1])


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _tank_map(ex, lib):
    """The example's model map with its RK4 cut to MX sub-steps."""
    cat = jnp.concatenate if lib is jnp else torch.cat

    def Fx(x, u, d, t, px):
        return cat([u, ex._rk4_tanks(x[2:6], u, Mx=MX)])

    return Fx


def _cfgs(case):
    """(JAX config, port config) of a case."""
    from mpc_code_tpu_torch.convert import config_from_numpy

    if case == "nmpc_dis":
        import mpc_code_tpu.examples.nmpc_dis as jex
        import mpc_code_tpu_torch.examples.nmpc_dis as pex

        jcfg = jex.make_config().replace(N=N)
        pcfg = pex.make_config().replace(N=N)
        return (jcfg.replace(model=dc.replace(jcfg.model, Fx=_tank_map(jex, jnp))),
                pcfg.replace(model=dc.replace(pcfg.model, Fx=_tank_map(pex, torch))))
    if case == "enmpc":
        from mpc_code_tpu.examples.enmpc import make_config as make_jax
        from mpc_code_tpu_torch.examples.enmpc import make_config as make_port

        jcfg = make_jax().replace(N=N)
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX))
        return jcfg, config_from_numpy(jcfg, make_port())
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port

    guard = dict(Mx=MX, clip_lo=np.array([0.0, 280.0, 0.4]),
                 clip_hi=np.array([2.0, 420.0, 1.0]))
    jcfg = make_jax().replace(N=10, R_wn=None, DUForm=True)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, **guard))
    return jcfg, config_from_numpy(jcfg, make_port().replace(N=10, R_wn=None))


def _lanes(case, pcfg):
    """The case's parameters (numpy, a leading lane axis on x0, xs, us, d,
    um1, t) and cold guesses X0 (B, N+1, nxa), U0 (B, N, nu)."""
    Nh = pcfg.N
    zeros = dict(lam=np.zeros((pcfg.ny, pcfg.nu)), px=np.zeros((Nh, pcfg.npx)),
                 py=np.zeros((Nh, pcfg.npy)))
    if case == "nmpc_dis":
        from mpc_code_tpu_torch.examples.nmpc_dis_workload import draw_lanes

        ln = {k: v.numpy() for k, v in draw_lanes(LANES, "cpu", seed=1,
                                                  dtype=torch.float64)._asdict().items()}
        par = dict(x0=ln["x0"], xs=ln["xsp"], us=ln["usp"], d=ln["d"], um1=ln["um1"],
                   t=ln["t"], **zeros)
        xa0 = np.concatenate([ln["x0"], ln["um1"]], 1)
    elif case == "enmpc":
        from mpc_code_tpu_torch.config import SolverOptions
        from mpc_code_tpu_torch.examples import enmpc_workload as ew

        prob = ew.make_problem("cpu", Nh=Nh, Mx=MX,
                               target_opts=SolverOptions(max_iter=100, tol=1e-8))
        lanes = ew.draw_lanes(LANES, "cpu", seed=1, dtype=torch.float64)
        xs, us, _ = ew.solve_targets(prob, lanes)
        par = dict(x0=lanes.x0.numpy(), xs=xs.numpy(), us=us.numpy(), d=lanes.d.numpy(),
                   um1=np.asarray(pcfg.u0, float), t=0.0, **zeros)
        xa0 = par["x0"]
    else:
        x0 = np.random.default_rng(5).uniform([0.4, 320, 0.56], [0.9, 334, 0.67], (LANES, 3))
        par = dict(x0=x0, xs=XS, us=US, d=np.array([0.0, 0.1]), um1=US, t=0.0, **zeros)
        xa0 = np.concatenate([x0, np.tile(US, (LANES, 1))], 1)
    for k in LANE_KEYS:
        v = np.asarray(par[k], float)
        par[k] = np.broadcast_to(v, (LANES,) + v.shape[v.ndim - PER_LANE_NDIM[k]:]).copy()
    return (par, np.tile(xa0[:, None], (1, Nh + 1, 1)),
            np.tile(par["us"][:, None], (1, Nh, 1)))


LANE_KEYS = ("x0", "xs", "us", "d", "um1", "t")
PER_LANE_NDIM = dict(x0=1, xs=1, us=1, d=1, um1=1, t=0)


def _per_lane(par, i):
    return {k: jnp.asarray(v[i] if k in LANE_KEYS else v) for k, v in par.items()}


def _both(case, **opts):
    """The port's batched result and JAX's per-lane results of a case."""
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.models import build_model as pbm
    from mpc_code_tpu_torch.models import build_stage_cost as pbs
    from mpc_code_tpu_torch.models import build_terminal_cost as pbt
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp as pbso
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver as pmss

    jcfg, pcfg = _cfgs(case)
    ps = pbso(pcfg, pbm(pcfg), pbs(pcfg.stage_cost), pbt(pcfg), device="cpu")
    par, X0, U0 = _lanes(case, pcfg)
    r = pmss(ps, SolverOptions(**dict(OPTS, **opts)))(par, torch.as_tensor(X0),
                                                     torch.as_tensor(U0))
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                                  build_terminal_cost(jcfg))
    finally:
        mp.undo()
    jsolve = jax.jit(make_structured_solver(js, JOpts(**dict(OPTS, **opts))))
    jr = [jax.device_get(jsolve(_per_lane(par, i), jnp.asarray(X0[i]), jnp.asarray(U0[i])))
          for i in range(LANES)]
    return ps, js, r, jr


@pytest.mark.parametrize("case", ["nmpc_dis", "enmpc", "cstr_du"])
def test_exact_generic_route_matches_jax(case):
    ps, js, r, jr = _both(case)
    # the fused stage sweep's route: a map and a lowering of the form
    assert ps.dyn is not None and ps.lowering is not None
    assert (ps.nxa, ps.nu, ps.ni) == (js.nxa, js.nu, js.ni)
    for i, j in enumerate(jr):
        assert int(r.status[i]) == int(j.status) == 0, (case, i)
        assert int(r.iters[i]) == int(j.iters), (case, i)
        for got, ref in ((r.X[i], j.X), (r.U[i], j.U)):
            assert _nerr(got.numpy(), ref) <= 1e-8, (case, i)


def test_costate_on_the_contform_route():
    """dual_init='costate' where the OCP has no stage_dyn_jac (ContForm
    under Gauss-Newton: the joint sweep gives no Jacobian of the map
    alone): equal to JAX in f64; in f32 the recursion's Jacobian (by
    reverse mode, F9) keeps the solve in f32."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    opts = dict(hessian="gauss_newton", dual_init="costate")
    ps, js, r, jr = _both("enmpc", **opts)
    assert ps.stage_dyn_jac is None and ps.stage_cf is not None
    for i, j in enumerate(jr):
        assert int(r.status[i]) == int(j.status) == 0
        assert int(r.iters[i]) == int(j.iters)
        assert _nerr(r.U[i].numpy(), j.U) <= 1e-8
    _, pcfg = _cfgs("enmpc")
    par, X0, U0 = _lanes("enmpc", pcfg)
    solve = make_structured_solver(ps, SolverOptions.for_f32(max_iter=30, **opts))
    r32 = solve(par, torch.as_tensor(X0, dtype=torch.float32),
                torch.as_tensor(U0, dtype=torch.float32))
    assert r32.U.dtype == r32.lam.dtype == torch.float32
    assert (r32.status != 2).all()


@pytest.mark.parametrize("example", ["enmpc", "nmpc_dis"])
def test_example_options_take_a_batched_step(example):
    """The example's configuration with its own ``sol_opts_dyn`` (the
    exact Hessian: ENMPC's ``SolverOptions(max_iter=200)``, nmpc_dis's
    default) builds the batched step and takes one step of two lanes on
    the CPU; N (and ENMPC's RK4 sub-steps) cut."""
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step
    from mpc_code_tpu_torch.loop.schedules import make_step_inputs

    if example == "enmpc":
        from mpc_code_tpu_torch.examples.enmpc import make_config

        cfg = make_config().replace(N=6)
        cfg = cfg.replace(model=dc.replace(cfg.model, Mx=MX))
    else:
        from mpc_code_tpu_torch.examples.nmpc_dis import make_config

        cfg = make_config().replace(N=6)
    assert cfg.sol_opts_dyn.hessian == "exact"
    step = make_mpc_step(cfg, device="cpu")
    x0 = torch.as_tensor(np.asarray(cfg.x0_p, float))
    carry = init_carry(cfg, torch.stack([x0, 1.01 * x0]), device="cpu")
    inp = make_step_inputs(cfg, 1)
    carry, out = step(carry, type(inp)(*(v[0] for v in inp)))
    assert (out.status_dyn == 0).all(), out.status_dyn
    assert torch.isfinite(carry.x).all() and torch.isfinite(out.u).all()
