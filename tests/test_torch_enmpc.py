"""The port's economic NMPC slice (Ex_ENMPC) against the JAX package, CPU, f64.

At a small size (N=8, RK4 Mx=2, 4 lanes drawn by
``enmpc_workload.draw_lanes``; the JAX trace of the ContForm solver grows
with Mx): the StateFeedback / offree='lin' model, the steady-state target
by the dense IPM, and the ContForm OCP at those targets by the structured
IPM.  The JAX solver builds its ContForm joint sweep (``stage_cf``, with
MPC_TPU_FAST_SWEEP=1) and so takes the ``fast_cf`` branch; the port runs
its plain versions.  Both build the same problem from the same numbers
(``convert``).  The port's side runs through the workload's own
``run_pipeline`` (targets, then OCPs at them); the JAX side chains the same
two solves, one jitted solve per lane: the lanes-minor rule of JAX's sweep
costs several times the trace of its per-stage form, and
``tests/test_torch_contform.py`` holds the port's sweep against that rule.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, MX, LANES = 8, 2, 4
TARGET_OPTS = dict(max_iter=100, tol=1e-8)
OCP_OPTS = dict(max_iter=40, tol=1e-8, hessian="gauss_newton")


def _cfgs(**replace):
    from mpc_code_tpu.examples.enmpc import make_config as make_jax
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as make_port

    jcfg = make_jax().replace(N=N, **replace)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX))
    return jcfg, config_from_numpy(jcfg, make_port())


def _lanes():
    from mpc_code_tpu_torch.examples.enmpc_workload import draw_lanes

    x0, d = draw_lanes(LANES, "cpu", seed=1, dtype=torch.float64)
    return x0.numpy(), d.numpy()


def _stack(results):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *jax.device_get(results))


@pytest.fixture(scope="module")
def jax_results():
    """The JAX targets of the 4 lanes, then the JAX OCP solves at them,
    lane by lane."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    try:
        from mpc_code_tpu.config import SolverOptions
        from mpc_code_tpu.models import (
            build_model, build_ss_cost, build_stage_cost, build_terminal_cost,
        )
        from mpc_code_tpu.ocp.target import build_target
        from mpc_code_tpu.solver.ipm import make_solver
        from mpc_code_tpu.solver.riccati import (
            build_structured_ocp, make_structured_solver,
        )

        jcfg, _ = _cfgs()
        x0s, ds = _lanes()
        model = build_model(jcfg)
        ts = build_target(jcfg, model, build_ss_cost(jcfg.ss_cost))
        tsolve = make_solver(ts.nlp, SolverOptions(**TARGET_OPTS))
        x0_m, u0 = jnp.asarray(jcfg.x0_m, float), jnp.asarray(jcfg.u0, float)

        def target(d):
            par = dict(usp=jnp.zeros(1), ysp=jnp.zeros(2), xsp=jnp.zeros(2), d=d,
                       us_prev=u0, lam=jnp.zeros((2, 1)), t=jnp.asarray(0.0),
                       px=jnp.zeros(2), py=jnp.zeros(2))
            w0 = jnp.concatenate([x0_m, u0, model.fy(x0_m, u0, d, 0.0, jnp.zeros(2))])
            return tsolve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)

        target = jax.jit(target)
        rt = _stack([target(jnp.asarray(d)) for d in ds])
        socp = build_structured_ocp(jcfg, model, build_stage_cost(jcfg.stage_cost),
                                    build_terminal_cost(jcfg))
        assert socp.stage_cf is not None
        osolve = make_structured_solver(socp, SolverOptions(**OCP_OPTS))

        def ocp(x0, xs, us, d):
            par = dict(x0=x0, xs=xs, us=us, d=d, um1=u0, t=jnp.asarray(0.0),
                       lam=jnp.zeros((2, 1)), px=jnp.zeros((N, 2)),
                       py=jnp.zeros((N, 2)))
            return osolve(par, jnp.tile(x0[None], (N + 1, 1)), jnp.tile(us[None], (N, 1)))

        w = np.asarray(rt.w)
        ocp = jax.jit(ocp)
        ro = _stack([ocp(*[jnp.asarray(a) for a in (x0, wk[:2], wk[2:3], d)])
                     for x0, wk, d in zip(x0s, w, ds)])
        assert (np.asarray(rt.status) == 0).all()
    finally:
        mp.undo()
    return rt, ro


@pytest.fixture(scope="module")
def port_results():
    """``run_pipeline`` on the same lanes at the same options."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.enmpc_workload import Lanes, make_problem, run_pipeline

    prob = make_problem("cpu", Nh=N, Mx=MX, target_opts=SolverOptions(**TARGET_OPTS),
                        ocp_opts=SolverOptions(**OCP_OPTS))
    x0s, ds = _lanes()
    return run_pipeline(prob, Lanes(torch.tensor(x0s), torch.tensor(ds)))


@pytest.mark.parametrize("Bd", ["zero", "random"])
def test_model_matches_jax(Bd):
    """StateFeedback output x + Cd d + py and the state map with + Bd d + px."""
    from mpc_code_tpu.models import build_model as j_build
    from mpc_code_tpu_torch.models import build_model as p_build

    rng = np.random.default_rng(6)
    dist = {}
    if Bd == "random":
        from mpc_code_tpu.config import DisturbanceModel

        dist = dict(dist=DisturbanceModel(offree="lin", Bd=rng.normal(size=(2, 2)),
                                          Cd=rng.normal(size=(2, 2))))
    jcfg, pcfg = _cfgs(**dist)
    jm, pm = j_build(jcfg), p_build(pcfg)
    x, u, d, px, py = (rng.uniform(0.1, 0.9, 2), rng.uniform(0, 2, 1),
                       rng.normal(size=2) * 0.05, rng.normal(size=2) * 1e-2,
                       rng.normal(size=2) * 1e-2)
    J = [jnp.asarray(a) for a in (x, u, d, px, py)]
    P = [torch.tensor(a) for a in (x, u, d, px, py)]
    np.testing.assert_allclose(pm.fx(P[0], P[1], 2.0, P[2], 0.5, P[3]).numpy(),
                               np.asarray(jm.fx(J[0], J[1], 2.0, J[2], 0.5, J[3])),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(pm.fy(P[0], P[1], P[2], 0.5, P[4]).numpy(),
                               np.asarray(jm.fy(J[0], J[1], J[2], 0.5, J[4])),
                               rtol=0, atol=1e-15)


def test_target_matches_jax(jax_results, port_results):
    """Status and iterations per lane; w = [xs, us, ys] to 1e-8."""
    jt, out = jax_results[0], port_results
    np.testing.assert_array_equal(out["target_status"], np.asarray(jt.status))
    np.testing.assert_array_equal(out["target_iters"], np.asarray(jt.iters))
    w = np.asarray(jt.w)
    assert np.abs(out["xs"] - w[:, :2]).max() <= 1e-8
    assert np.abs(out["us"] - w[:, 2:3]).max() <= 1e-8


def test_contform_ocp_matches_jax(jax_results, port_results):
    """Status and iterations per lane; U and X to 1e-8."""
    jo, out = jax_results[1], port_results
    np.testing.assert_array_equal(out["status"], np.asarray(jo.status))
    np.testing.assert_array_equal(out["iters"], np.asarray(jo.iters))
    assert (out["status"] != 2).all()
    assert np.abs(out["U"] - np.asarray(jo.U)).max() <= 1e-8
    assert np.abs(out["X"] - np.asarray(jo.X)).max() <= 1e-8


def test_pipeline_output(port_results):
    """``run_pipeline``'s per-lane output: shapes, the input box, economic
    target inputs inside the input box, and the phase times."""
    out = port_results
    assert out["U"].shape == (LANES, N, 1) and out["X"].shape == (LANES, N + 1, 2)
    assert (out["U"] >= -1e-6).all() and (out["U"] <= 2.0 + 1e-6).all()
    assert (out["us"] > 0.0).all() and (out["us"] < 2.0).all()
    assert set(out["times"]) == {"target_s", "ocp_s", "total_s"}


def test_target_solves_in_f32():
    """The dense IPM's Lagrangian Hessian stays in f32: torch.func's
    forward-over-reverse of ``y @ g(w)`` gives f64 when g mixes in Python
    scalars, as the ENMPC model does (ROADMAP Queue 3, F4)."""
    from mpc_code_tpu_torch.examples.enmpc_workload import (
        draw_lanes, make_problem, solve_targets,
    )

    prob = make_problem("cpu", Nh=2, Mx=1)
    xs, us, r = solve_targets(prob, draw_lanes(2, "cpu"))
    assert r.w.dtype == xs.dtype == torch.float32
    assert (r.status.numpy() == 0).all() and (r.iters.numpy() > 1).all()


def test_workload_entry_points_default_to_the_card():
    from mpc_code_tpu_torch.examples.enmpc_workload import draw_lanes, make_problem

    if torch.cuda.is_available():
        assert draw_lanes(2)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_problem(Nh=N, Mx=MX)
    x0, d = draw_lanes(5, "cpu")
    assert x0.shape == d.shape == (5, 2)
    assert (x0 >= torch.tensor([0.5, 0.1])).all() and (x0 <= torch.tensor([1.2, 0.6])).all()
    assert d.abs().max() <= 0.05
