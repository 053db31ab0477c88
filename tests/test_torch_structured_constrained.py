"""The port's structured solver (``solver/riccati.py``) on the constrained
and soft configurations against the JAX package's, CPU, f64: status and
iterations equal, X, U and f within 1e-8 (normalised ``|a-b|/(1+|b|)``),
and under TermCons x_N = xs within 1e-7.

- the CSTR (``examples/nmpc.py``, N=12) with ``TermCons``
  (``tests/test_riccati.py:275-305``): the terminal-multiplier recursion;
- the CSTR with ``TermCons`` and the ``H_eq`` line of
  ``tests/test_riccati.py:420-470``: the bordered-stage recursion with the
  terminal multiplier, under the Gauss-Newton Hessian and under the exact
  one (the default of ``tests/test_riccati.py:440``).  Under the exact
  Hessian the iterations are held within one: both solvers reach the
  residuals' rounding floor near the optimum, where the merit test's
  outcome follows the rounding, and a relative change of 1e-15 in x0
  moves the JAX solver's own count by one, as it moves the port's
  (``test_termcons_heq_iterations_follow_rounding``, which prints both);
- ``H_eq`` alone and ``G_ineq`` on ``tests/test_features.py::_base`` (a
  linear model): the bordered-stage recursion, and user rows in ``ineq``;
- the CSTR with soft output bounds (``slacks=True``, ``Ws = 10 I``): the
  shared slack folded into (nxa, nu) = (7, 6);
- ``slacksG`` and ``slacksH`` on ``_base``
  (``tests/test_features.py:135-170, 331-365``);
- user rows written with Python floats keep an f32 solve in f32 (F12).

About 100 s in one process on the CPU, most of it JAX compiling its
solvers and the rounding test's ten solves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

XS = np.array([0.874317, 325.0, 0.6528])
US = np.array([300.157, 0.1])


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _heq_line(lib):
    def H_eq(x, u, y, d, t, px, py):
        return lib.atleast_1d(u[0] + 50.0 * u[1] - 305.157 - 0.1 * (x[1] - 325.0))
    return H_eq


def _base_rows(lib, which):
    if which == "heq":
        return dict(H_eq=lambda x, u, y, d, t, px, py: lib.atleast_1d(u[0] + 0.5 * x[1] - 0.2))
    if which == "gineq":
        return dict(G_ineq=lambda x, u, y, d, t, px, py: lib.atleast_1d(x[0] + x[1] - 1.0))
    bounds = dict(umin=np.array([-3.0]), umax=np.array([3.0]),
                  ymin=np.array([-0.5, -0.5]), ymax=np.array([2.0, 2.0]))
    if which == "slacksg":
        return dict(G_ineq=lambda x, u, y, d, t, px, py: lib.atleast_1d(x[0] + x[1] - 0.9),
                    slacks=True, slacksG=True, Ws=10.0 * np.eye(5), _bounds=bounds,
                    _x0=np.array([0.8, 0.6]))
    return dict(H_eq=lambda x, u, y, d, t, px, py: lib.atleast_1d(u[0] - 0.05 - 0.2 * x[1]),
                slacks=True, slacksH=True, Ws=10.0 * np.eye(5), _bounds=bounds,
                _x0=np.array([0.6, 0.5]))


def _base_cfg(pkg, lib, which):
    """``tests/test_features.py::_base`` in the JAX package or the port."""
    cfgm = __import__(f"{pkg}.config", fromlist=["MPCConfig"])
    A = np.array([[0.85, 0.1], [0.0, 0.9]])
    B = np.array([[0.2], [1.0]])
    C = np.eye(2)
    kw = _base_rows(lib, which)
    bounds = kw.pop("_bounds", dict(umin=np.array([-3.0]), umax=np.array([3.0])))
    x0 = kw.pop("_x0", np.zeros(2))
    return cfgm.MPCConfig(
        nx=2, nu=1, ny=2, nd=2, Nsim=20, N=10, h=1.0,
        model=cfgm.LinearModel(A=A, B=B, C=C), plant=cfgm.LinearPlant(Ap=A, Bp=B, Cp=C),
        dist=cfgm.DisturbanceModel(offree="lin", Bd=np.zeros((2, 2)), Cd=np.eye(2)),
        x0_p=x0, x0_m=x0, u0=np.zeros(1),
        ss_cost=cfgm.SSCost(Qss=np.eye(2), Rss=np.zeros((1, 1))),
        stage_cost=cfgm.StageCost(Q=np.eye(2), R=0.1 * np.eye(1)),
        estimator=cfgm.EstimatorConfig(kind="lue", K=np.vstack([np.zeros((2, 2)), np.eye(2)])),
        bounds=cfgm.Bounds(**bounds), **kw)


def _cstr_cfg(pkg, lib, which):
    ex = __import__(f"{pkg}.examples.nmpc", fromlist=["make_config"])
    cfg = ex.make_config().replace(N=12, R_wn=None)
    if which == "termcons":
        return cfg.replace(TermCons=True)
    if which == "termcons_heq":
        return cfg.replace(TermCons=True, H_eq=_heq_line(lib))
    return cfg.replace(slacks=True, Ws=10.0 * np.eye(4))


TCH_X0 = np.array([0.8, 327.0, 0.64])
# name -> (config maker, its rows, x0, Hessian, the iterations' slack)
CASES = {
    "termcons": (_cstr_cfg, "termcons", np.array([0.7, 328.0, 0.62]), "exact", 0),
    "termcons_heq": (_cstr_cfg, "termcons_heq", TCH_X0, "gauss_newton", 0),
    "termcons_heq_exact": (_cstr_cfg, "termcons_heq", TCH_X0, "exact", 1),
    "heq": (_base_cfg, "heq", None, "exact", 0),
    "gineq": (_base_cfg, "gineq", None, "exact", 0),
    "cstr_slacks": (_cstr_cfg, "slacks", np.array([0.6, 330.0, 0.60]), "exact", 0),
    "slacksg": (_base_cfg, "slacksg", None, "exact", 0),
    "slacksh": (_base_cfg, "slacksh", None, "exact", 0),
}
# the relative changes of x0 under which both solvers' iterations are
# counted (test_termcons_heq_iterations_follow_rounding)
X0_NUDGES = (-2e-15, -1e-15, 0.0, 1e-15, 2e-15)


def _problem(name):
    """Both packages' structured OCPs, solvers, parameters and guesses."""
    from mpc_code_tpu.config import SolverOptions as JSO
    from mpc_code_tpu.models import build_model as jbm, build_stage_cost as jbs
    from mpc_code_tpu.models import build_terminal_cost as jbt
    from mpc_code_tpu.solver.riccati import build_structured_ocp as jbso
    from mpc_code_tpu.solver.riccati import make_structured_solver as jmss
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp, make_structured_solver

    make_cfg, key, x0, hess, _ = CASES[name]
    jcfg = make_cfg("mpc_code_tpu", jnp, key)
    pcfg = config_from_numpy(jcfg, make_cfg("mpc_code_tpu_torch", torch, key))
    js = jbso(jcfg, jbm(jcfg), jbs(jcfg.stage_cost), jbt(jcfg))
    ps = build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                              build_terminal_cost(pcfg), device="cpu")
    opts = dict(max_iter=200, hessian=hess)
    N, nx, nu = jcfg.N, jcfg.nx, jcfg.nu
    if x0 is None:
        x0 = np.asarray(jcfg.x0_m, float)
        xs, us, d = np.array([0.8, 0.4]), np.zeros(1), np.zeros(jcfg.nd)
    else:
        xs, us, d = XS, US, np.array([0.0, 0.1])
    par = dict(x0=x0, xs=xs, us=us, d=d, um1=us, t=0.0, lam=np.zeros((jcfg.ny, nu)),
               px=np.zeros((N, jcfg.npx)), py=np.zeros((N, jcfg.npy)))
    X0 = np.zeros((N + 1, ps.nxa))
    X0[:, :nx] = x0
    U0 = np.zeros((N, ps.nu))
    U0[:, :nu] = us
    return (ps, make_structured_solver(ps, SolverOptions(**opts)),
            js, jmss(js, JSO(**opts)), par, X0, U0)


def _solve_both(solve, jsolve, par, X0, U0):
    """The port's and JAX's solves of one lane: (port result, JAX result)."""
    r = solve({k: np.asarray(v)[None] for k, v in par.items()},
              torch.as_tensor(X0)[None], torch.as_tensor(U0)[None])
    jr = jsolve({k: jnp.asarray(v) for k, v in par.items()},
                jnp.asarray(X0), jnp.asarray(U0))
    return r, jr


def _assert_same_answer(r, jr, slack):
    assert int(r.status[0]) == int(jr.status) == 0
    assert abs(int(r.iters[0]) - int(jr.iters)) <= slack
    for got, ref in ((r.X[0], jr.X), (r.U[0], jr.U), (r.f[0], jr.f)):
        assert _nerr(got.numpy(), np.asarray(ref)) <= 1e-8


@pytest.mark.parametrize("name", list(CASES))
def test_structured_matches_jax(name):
    ps, solve, js, jsolve, par, X0, U0 = _problem(name)
    assert (ps.nxa, ps.nu, ps.ni, ps.ns, ps.n_tc, ps.n_eq) == (
        js.nxa, js.nu, js.ni, js.ns, js.n_tc, js.n_eq)
    for k in ("lbx", "ubx", "lbu", "ubu", "lbi", "ubi", "sxa", "su", "si"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k), err_msg=k)
    r, jr = _solve_both(solve, jax.jit(jsolve), par, X0, U0)
    _assert_same_answer(r, jr, CASES[name][4])
    if ps.n_tc:
        assert np.abs(r.X[0, -1, :ps.n_tc].numpy() - par["xs"]).max() <= 1e-7
    if ps.ns:
        assert (r.U[0, 0, ps.nu_ctrl:] >= 0).all()


def test_termcons_heq_iterations_follow_rounding():
    """TermCons with H_eq under the exact Hessian from x0 (1 + d), d in
    X0_NUDGES: at every d the two solvers' statuses are 0, their X, U and
    f within 1e-8 and their iterations within one; and the JAX solver's
    own count moves with d, as the port's does (the merit test near the
    optimum compares values that differ by less than the residuals'
    rounding).  Prints both counts."""
    ps, solve, js, jsolve, par, X0, U0 = _problem("termcons_heq_exact")
    jsolve = jax.jit(jsolve)
    counts = []
    for d in X0_NUDGES:
        r, jr = _solve_both(solve, jsolve, dict(par, x0=par["x0"] * (1.0 + d)), X0, U0)
        _assert_same_answer(r, jr, 1)
        counts.append((d, int(r.iters[0]), int(jr.iters)))
    print("x0 relative change, port iterations, JAX iterations:", counts)
    assert len({j for _, _, j in counts}) > 1


def test_user_rows_stay_in_f32():
    """A stage equality written with Python floats (``u[0] + 0.5 * x[1] -
    0.2``): its Jacobian by forward mode came out in f64 for f32 inputs;
    the rows are differentiated in reverse mode (F12)."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    ps, _, *_, par, X0, U0 = _problem("heq")
    r = make_structured_solver(ps, SolverOptions.for_f32())(
        {k: np.asarray(v)[None] for k, v in par.items()},
        torch.as_tensor(X0, dtype=torch.float32)[None],
        torch.as_tensor(U0, dtype=torch.float32)[None])
    assert r.X.dtype == r.U.dtype == torch.float32
    assert int(r.status[0]) == 0
