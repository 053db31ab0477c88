"""The port's structured solver against the JAX package, CPU, f64.

The CSTR NMPC slice of the bench at a small size (N=8, Mx=2, the
saturation guard, 4 lanes, seed 5): the JAX solver runs its split sweep in
the lanes-minor XLA layout (MPC_TPU_FAST_SWEEP=1, MPC_TPU_SWEEP_IMPL=lanes)
and its Riccati reference under vmap; the port runs its plain versions.
Both build the same problem from the same numbers (``convert``).  Two RK4
sub-steps already carry the state and its tangents across a sub-step
boundary, which is all the sub-step loop does; each further sub-step adds
about 2 s of JAX tracing.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N = 8
XS = np.array([0.874317, 325.0, 0.6528])
US = np.array([300.157, 0.1])
OPTS = dict(max_iter=60, tol=1e-8, hessian="gauss_newton",
            mu_strategy="monotone", ls_mode="adaptive", track_best=True)


def _cfgs():
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port

    guard = dict(Mx=2, clip_lo=np.array([0.0, 280.0, 0.4]),
                 clip_hi=np.array([2.0, 420.0, 1.0]))
    jcfg = make_jax().replace(N=N, R_wn=None)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, **guard))
    base = make_port().replace(N=N, R_wn=None)
    return jcfg, config_from_numpy(jcfg, base)


def _x0s():
    rng = np.random.default_rng(5)
    return rng.uniform([0.4, 320, 0.56], [0.9, 334, 0.67], size=(4, 3))


@pytest.fixture(scope="module")
def results():
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        from mpc_code_tpu.config import SolverOptions as JOpts
        from mpc_code_tpu.models import (
            build_model, build_stage_cost, build_terminal_cost,
        )
        from mpc_code_tpu.solver.riccati import (
            build_structured_ocp, make_structured_solver,
        )
        from mpc_code_tpu_torch.config import SolverOptions as POpts
        from mpc_code_tpu_torch.models import build_model as p_model
        from mpc_code_tpu_torch.models import build_stage_cost as p_stage
        from mpc_code_tpu_torch.models import build_terminal_cost as p_term
        from mpc_code_tpu_torch.solver.riccati import (
            build_structured_ocp as p_ocp, make_structured_solver as p_solver,
        )

        jcfg, pcfg = _cfgs()
        x0s = _x0s()
        socp = build_structured_ocp(jcfg, build_model(jcfg),
                                    build_stage_cost(jcfg.stage_cost),
                                    build_terminal_cost(jcfg))
        assert socp.stage_dyn_jac is not None
        jsolve = make_structured_solver(socp, JOpts(**OPTS))

        def lane(x0, max_it):
            par = dict(x0=x0, xs=jnp.asarray(XS), us=jnp.asarray(US),
                       d=jnp.asarray([0.0, 0.1]), um1=jnp.asarray(US),
                       t=jnp.asarray(0.0), lam=jnp.zeros((2, 2)),
                       px=jnp.zeros((N, 3)), py=jnp.zeros((N, 2)))
            X0 = jnp.tile(x0[None], (N + 1, 1))
            U0 = jnp.tile(jnp.asarray(US), (N, 1))
            return jsolve(par, X0, U0, max_iter=max_it)

        run = jax.jit(jax.vmap(lane, in_axes=(0, None)))
        jres = {m: jax.device_get(run(jnp.asarray(x0s), jnp.asarray(m, jnp.int32)))
                for m in (60, 3)}

        ocp = p_ocp(pcfg, p_model(pcfg), p_stage(pcfg.stage_cost),
                    p_term(pcfg), device="cpu")
        assert (ocp.nxa, ocp.nu, ocp.ni) == (socp.nxa, socp.nu, socp.ni)
        psolve = p_solver(ocp, POpts(**OPTS))
        par = dict(x0=x0s, xs=XS, us=US, d=np.array([0.0, 0.1]), um1=US,
                   t=0.0, lam=np.zeros((2, 2)), px=np.zeros((N, 3)),
                   py=np.zeros((N, 2)))
        X0 = torch.tensor(np.repeat(x0s[:, None], N + 1, 1))
        U0 = torch.tensor(np.tile(US, (4, N, 1)))
        pres = {m: psolve(par, X0, U0, max_iter=m) for m in (60, 3)}
    finally:
        mp.undo()
    return jres, pres


@pytest.mark.parametrize("max_iter", [60, 3])
def test_status_and_iters_match_jax(results, max_iter):
    jres, pres = results
    js, ps = jres[max_iter], pres[max_iter]
    np.testing.assert_array_equal(ps.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ps.iters.numpy(), np.asarray(js.iters))
    if max_iter == 60:
        assert (ps.status.numpy() != 2).all()


@pytest.mark.parametrize("max_iter", [60, 3])
def test_inputs_match_jax(results, max_iter):
    """U agrees to 1e-6 of the input box; X and the duals ride along."""
    jres, pres = results
    js, ps = jres[max_iter], pres[max_iter]
    box = np.array([305.0 - 295.0, 0.25])
    dU = np.abs(ps.U.numpy() - np.asarray(js.U)) / box
    assert dU.max() <= 1e-6, dU.max()
    tol = 1e-8 if max_iter == 60 else 1e-6
    dX = np.abs(ps.X.numpy() - np.asarray(js.X)) / (1 + np.abs(np.asarray(js.X)))
    assert dX.max() <= tol, dX.max()


def test_result_carries_across(results):
    """``convert.result_from_numpy`` carries a JAX result into the port's
    result type field for field."""
    from mpc_code_tpu_torch.convert import result_from_numpy, result_to_numpy

    jres, _ = results
    r = result_from_numpy(jres[60])
    back = result_to_numpy(r)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jres[60], k)))
