"""The port's discrete-map / Delta-u slice (Ex_NMPC_dis) against the JAX package, CPU, f64.

- ``build_model`` for a ``DiscreteModel`` (the quadruple tank, with its
  LinPar ``+ px`` and ``offree='lin'``) against JAX's.
- The structured OCP with the u_prev augmentation against JAX's structured
  solver (MPC_TPU_FAST_SWEEP=1), jitted once and run lane by lane, so its
  discrete sweep takes its per-stage form (``tests/test_torch_map.py``
  holds the port's sweep against the lanes-minor rule, which JAX traces
  longer inside the solver): a small discrete map
  with an input disturbance (Bd != 0), Delta-u bounds, a Delta-u stage
  cost (``S``, so DUForm), output bounds and a user terminal weight, N=6,
  4 lanes.  Status and iterations per lane, ``U``, and the stage
  derivatives at stage 0, where u_{k-1} is the parameter and not the
  carried slot, and at stage 1.
- With no JAX: the port's nmpc_dis target and OCP on the 8 recorded steps
  of ``fixtures/nmpc_dis.npz`` as 8 lanes of one batched call, against
  the recorded XS, US and U at the fixtures' 1e-4 bar.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, LANES = 6, 4
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "fixtures", "nmpc_dis.npz")
OPTS = dict(max_iter=40, tol=1e-8, hessian="gauss_newton")


def _map(np_):
    """The small discrete map in ``np_`` (jnp or torch): a damped
    oscillator with a quadratic drag."""
    def Fx(x, u, d, t, px):
        return np_.stack([x[0] + 0.2 * x[1],
                          x[1] + 0.2 * (u[0] - x[0] - 0.3 * x[1] * x[1])])

    def fy(x, u, d, t, py):
        return np_.stack([x[0]])

    def vfin(dx, xs):
        return 5.0 * (dx @ dx)

    return Fx, fy, vfin


def _small_cfg(config):
    """The small Delta-u OCP as a config of ``config`` (the JAX or the
    port's module)."""
    Fx, fy, vfin = _map(jnp if config.__name__.startswith("mpc_code_tpu.") else torch)
    return config.MPCConfig(
        nx=2, nxp=2, nu=1, ny=1, nd=1, N=N, h=1.0,
        model=config.DiscreteModel(Fx=Fx, fy=fy),
        plant=config.DiscretePlant(Fx=lambda x, t, u, p, q: x),
        dist=config.DisturbanceModel(offree="lin", Bd=np.array([[0.05], [0.1]]),
                                     Cd=np.eye(1)),
        x0_p=np.zeros(2), x0_m=np.zeros(2), u0=np.zeros(1),
        ss_cost=config.SSCost(Qss=np.eye(1), Sss=np.zeros((1, 1))),
        stage_cost=config.StageCost(Q=np.diag([4.0, 0.5]), S=np.array([[2.0]])),
        terminal=config.TerminalCost(vfin=vfin),
        bounds=config.Bounds(umin=np.array([-1.5]), umax=np.array([1.5]),
                             xmin=np.array([-3.0, -3.0]), xmax=np.array([3.0, 3.0]),
                             ymin=np.array([-0.6]), ymax=np.array([2.0]),
                             Dumin=np.array([-0.4]), Dumax=np.array([0.4])))


def _lanes():
    rng = np.random.default_rng(7)
    return dict(x0=rng.uniform([-0.55, -0.5], [-0.3, 0.2], (LANES, 2)),
                um1=rng.uniform(-0.5, 0.5, (LANES, 1)),
                d=rng.uniform(-0.2, 0.2, (LANES, 1)))


def _par(lanes, i, np_):
    return dict(x0=lanes["x0"][i], xs=np_.asarray([0.5, 0.0]), us=np_.asarray([0.5]),
                d=lanes["d"][i], um1=lanes["um1"][i], t=np_.asarray(0.0),
                lam=np_.zeros((1, 1)), px=np_.zeros((N, 2)), py=np_.zeros((N, 1)))


@pytest.fixture(scope="module")
def jax_ocp():
    """JAX's structured OCP and solver for the 4 lanes, jitted once and
    run lane by lane; its stage derivatives at stages 0 and 1 of each
    lane's cold start."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    try:
        import mpc_code_tpu.config as jc
        from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
        from mpc_code_tpu.solver.riccati import (
            build_structured_ocp, make_stage_derivs, make_structured_solver,
        )

        cfg = _small_cfg(jc)
        socp = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                    build_terminal_cost(cfg))
        assert socp.stage_dyn_jac is not None and (socp.nxa, socp.ni) == (3, 2)
        solve = make_structured_solver(socp, jc.SolverOptions(**OPTS))
        derivs = make_stage_derivs(socp, "gauss_newton", skip_dyn=True)
        lanes = {k: jnp.asarray(v) for k, v in _lanes().items()}

        def lane(x0, um1, d):
            par = _par(dict(x0=x0, um1=um1, d=d), slice(None), jnp)
            xa0 = jnp.concatenate([x0, um1 + 0.3])
            X0 = jnp.tile(xa0[None], (N + 1, 1))
            U0 = jnp.tile(par["us"][None], (N, 1))
            res = solve(par, X0, U0)
            sp = dict(par, _sf=jnp.asarray(0.7))
            xa_s, u_s = xa0 / socp.sxa, (um1 - 0.2) / socp.su
            zeros = jnp.zeros(socp.ni)
            der = [derivs(xa_s, u_s, k, sp, jnp.zeros(socp.nxa), zeros)[:3]
                   for k in (0, 1)]
            return res, der

        F = jax.jit(lane)
        out = [jax.device_get(F(lanes["x0"][i], lanes["um1"][i], lanes["d"][i]))
               for i in range(LANES)]
    finally:
        mp.undo()
    res, der = jax.tree_util.tree_map(lambda *a: np.stack(a), *out)
    return socp, res, der


@pytest.fixture(scope="module")
def port_ocp():
    import mpc_code_tpu_torch.config as pc
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    cfg = _small_cfg(pc)
    return build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device="cpu")


def test_du_ocp_structure_matches_jax(jax_ocp, port_ocp):
    """xa = [x; u_prev]: the u_prev slots are unbounded with scale 1; the
    rows are [y; u - u_prev] with the Delta-u bounds, scaled by si."""
    js, p = jax_ocp[0], port_ocp
    assert (p.nxa, p.nu, p.ni, p.N) == (js.nxa, js.nu, js.ni, js.N) == (3, 1, 2, N)
    for k in ("lbx", "ubx", "lbu", "ubu", "lbi", "ubi", "sxa", "su", "si"):
        np.testing.assert_array_equal(getattr(p, k), np.asarray(getattr(js, k)), err_msg=k)
    assert np.isinf(p.lbx[2]) and p.sxa[2] == 1.0
    par = {k: torch.tensor(v) for k, v in _par(_lanes(), slice(None), np).items()}
    np.testing.assert_array_equal(p.x0_of_p(par)[:, 2].numpy(), _lanes()["um1"][:, 0])


def test_du_ocp_matches_jax(jax_ocp, port_ocp):
    """Status and iterations per lane; U (and X) to 1e-8."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    jres = jax_ocp[1]
    lanes = _lanes()
    par = _par(lanes, slice(None), np)
    X0 = np.concatenate([lanes["x0"], lanes["um1"] + 0.3], 1)[:, None].repeat(N + 1, 1)
    U0 = np.tile(par["us"], (LANES, N, 1))
    r = make_structured_solver(port_ocp, SolverOptions(**OPTS))(
        par, torch.tensor(X0), torch.tensor(U0))
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(r.iters.numpy(), np.asarray(jres.iters))
    assert (r.status.numpy() == 0).all()
    assert np.abs(r.U.numpy() - np.asarray(jres.U)).max() <= 1e-8
    assert np.abs(r.X.numpy() - np.asarray(jres.X)).max() <= 1e-8
    # the Delta-u rows hold: the first move from um1, then from U[k-1]
    du = np.diff(np.concatenate([lanes["um1"][:, None], r.U.numpy()], 1), axis=1)
    assert np.abs(du).max() <= 0.4 + 1e-6


def test_stage_derivatives_match_jax(jax_ocp, port_ocp):
    """H, gc and E of ``make_stage_derivs`` at stages 0 and 1 to 1e-10: at
    stage 0 the Delta-u cost and row read the parameter um1, so their
    derivative in the u_prev slot is zero there and not at stage 1."""
    from torch.func import vmap

    from mpc_code_tpu_torch.solver.riccati import (
        batch_params, make_stage_derivs, stage_params,
    )

    socp, _, jder = jax_ocp
    lanes = _lanes()
    p = batch_params(_par(lanes, slice(None), np), LANES, torch.float64, "cpu")
    pk = stage_params(p, N)
    pk["_sf"] = torch.full((LANES * N,), 0.7, dtype=torch.float64)
    xa = torch.tensor(np.concatenate([lanes["x0"], lanes["um1"] + 0.3], 1) / socp.sxa)
    u = torch.tensor((lanes["um1"] - 0.2) / socp.su)
    z = torch.cat([xa, u], 1).repeat_interleave(N, 0)
    H, gc, E, _ = vmap(make_stage_derivs(port_ocp, "gauss_newton", skip_dyn=True))(z, pk)
    for k in (0, 1):
        idx = torch.arange(LANES) * N + k
        for got, ref in zip((H[idx], gc[idx], E[idx]), jder[k]):
            assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-10
    assert (H[::N, 2] == 0).all() and (E[::N, 1, 2] == 0).all()
    assert (H[1::N, 2, 2] != 0).all() and (E[1::N, 1, 2] == -1).all()


@pytest.mark.parametrize("form", ["discrete", "continuous"])
def test_stage_dyn_jac_adds_input_disturbance(form, port_ocp):
    """The dynamics rows are the model's step ``Fx_model`` (with + Bd d
    under offree='lin', as the JAX stage_dyn_jac adds it) and the carried
    input: for the discrete map and, through the RK4 sweep, for a
    continuous model (ROADMAP Queue 3, F5)."""
    import mpc_code_tpu_torch.config as pc
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import batch_params, build_structured_ocp

    cfg = _small_cfg(pc)
    if form == "continuous":
        Fx = cfg.model.Fx
        cfg = cfg.replace(model=pc.ContinuousModel(
            fx=lambda x, u, d, t, px: Fx(x, u, d, t, px) - x, Mx=2, fy=cfg.model.fy))
    model = build_model(cfg)
    socp = (port_ocp if form == "discrete" else
            build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                 build_terminal_cost(cfg), device="cpu"))
    lanes = _lanes()
    p = batch_params(_par(lanes, slice(None), np), LANES, torch.float64, "cpu")
    rng = np.random.default_rng(8)
    X = torch.tensor(rng.normal(size=(LANES, N, 3)))
    U = torch.tensor(rng.normal(size=(LANES, N, 1)))
    dval, A, Bm = socp.stage_dyn_jac(X, U, p)
    sx, su = torch.tensor(socp.sxa), torch.tensor(socp.su)
    for b in range(LANES):
        for k in range(N):
            x, u = (X[b, k] * sx)[:2], U[b, k] * su
            ref = torch.cat([model.fx(x, u, cfg.h, p["d"][b], 0.0, p["px"][b, k]), u])
            torch.testing.assert_close(dval[b, k] * sx, ref, rtol=0, atol=1e-12)
    # the carried input: no state dependence, identity in user units
    assert (A[..., 2, :] == 0).all() and (Bm[..., 2, 0] * sx[2] / su[0] == 1).all()


@pytest.mark.parametrize("Bd", ["zero", "random"])
def test_discrete_model_matches_jax(Bd):
    """The tank map with LinPar's + px, the output map with Cd d + py."""
    from mpc_code_tpu.examples.nmpc_dis import make_config as j_make
    from mpc_code_tpu.models import build_model as j_build
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc_dis import make_config as p_make
    from mpc_code_tpu_torch.models import build_model as p_build

    rng = np.random.default_rng(6)
    jcfg = j_make(8)
    if Bd == "random":
        import dataclasses

        jcfg = jcfg.replace(dist=dataclasses.replace(jcfg.dist, Bd=rng.normal(size=(6, 2))))
    pcfg = config_from_numpy(jcfg, p_make())
    assert pcfg.LinPar and pcfg.dist.offree == "lin" and pcfg.estimator.kind == "lue"
    # StageCost(Q, S) selects QForm and DUForm, SSCost(Qss, Sss) DUssForm
    assert pcfg.QForm and pcfg.DUForm and pcfg.DUssForm and not pcfg.DUFormEcon
    np.testing.assert_array_equal(pcfg.estimator.K, np.asarray(jcfg.estimator.K))
    jm, pm = j_build(jcfg), p_build(pcfg)
    x = np.array([40.0, 38.0, 12.0, 20.0, 21.0, 1.4])
    u, d = np.array([41.0, 37.0]), rng.normal(size=2)
    px, py = rng.normal(size=6) * 1e-2, rng.normal(size=2) * 1e-2
    J = [jnp.asarray(a) for a in (x, u, d, px, py)]
    P = [torch.tensor(a) for a in (x, u, d, px, py)]
    np.testing.assert_allclose(pm.fx(P[0], P[1], 5.0, P[2], 0.5, P[3]).numpy(),
                               np.asarray(jm.fx(J[0], J[1], 5.0, J[2], 0.5, J[3])),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm.fy(P[0], P[1], P[2], 0.5, P[4]).numpy(),
                               np.asarray(jm.fy(J[0], J[1], J[2], 0.5, J[4])),
                               rtol=0, atol=1e-15)


def test_fixture_steps_reproduced():
    """The port's nmpc_dis target and OCP (N=10, f64, cold starts) on the
    8 recorded closed-loop steps as 8 lanes: XS, US and U[0] within the
    fixtures' 1e-4 of ``tests/test_fixtures.py``."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import nmpc_dis_workload as w

    z = np.load(FIXTURE)
    K = len(z["H_U"])
    prob = w.make_problem("cpu", Nh=int(z["meta_N"]), target_opts=SolverOptions(),
                          ocp_opts=SolverOptions(hessian="gauss_newton"))
    u0 = np.asarray(prob.cfg.u0, float)
    prev = lambda a: np.concatenate([u0[None], a[:-1]])  # noqa: E731
    ts = np.arange(K) * prob.cfg.h
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    lanes = w.Lanes(T(z["H_X_HAT"]), T(z["H_D_HAT"]), T(prev(z["H_U"])), T(prev(z["H_US"])),
                    T(ts), *w.setpoints(ts))
    out = w.run_pipeline(prob, lanes)
    assert (out["target_status"] == 0).all() and (out["status"] == 0).all()
    assert np.abs(out["xs"] - z["H_XS"]).max() <= 1e-4
    assert np.abs(out["us"] - z["H_US"]).max() <= 1e-4
    assert np.abs(out["U"][:, 0] - z["H_U"]).max() <= 1e-4


def test_workload_lanes_and_entry_points():
    """The lane boxes, one row per lane; the setpoint program's 7 entries in
    turn; the workload's entry points run on the card unless asked not to."""
    from mpc_code_tpu_torch.examples import nmpc_dis_workload as w

    if torch.cuda.is_available():
        assert w.draw_lanes(2).x0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            w.make_problem(Nh=4)
    ln = w.draw_lanes(9, "cpu")
    assert ln.x0.dtype == torch.float32 and ln.x0.shape == (9, 6)
    assert torch.equal(ln.x0[:, :2], ln.um1) and torch.equal(ln.um1, ln.us_prev)
    lv = ln.x0[:, 2:].numpy()
    assert (lv[:, :2] >= 6).all() and (lv[:, :2] <= 14).all()
    assert (lv[:, 2:] >= 0.5).all() and (lv[:, 2:] <= 3).all()
    assert (ln.um1.numpy() >= 30).all() and (ln.um1.numpy() <= 50).all()
    assert ln.d.abs().max() <= 0.5
    np.testing.assert_array_equal(ln.ysp[7].numpy(), ln.ysp[0].numpy())
    assert len({tuple(r) for r in ln.ysp[:7].numpy()}) == 6   # two pieces share [8, 12]
    assert torch.equal(w.draw_lanes(4, "cpu").x0, ln.x0[:4])
