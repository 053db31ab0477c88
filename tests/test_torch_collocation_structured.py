"""The collocation branch of the port's structured OCP (``solver/riccati.py
::build_structured_ocp``: the exact within-stage condensation of the
Gauss-Legendre step, Newton on detached values and one differentiable
step) against the JAX package, CPU, f64.

- The condensed stage map ``dyn`` (scaled), its value and its Jacobians
  (A, B) by ``jacrev`` and by ``jacfwd``, against JAX's ``dyn`` with
  ``jax.jacfwd``, at seeded points on the ENMPC tracking config of
  ``tests/test_collocation.py:17-36`` (N=4), every stage, both px
  rules: 1e-10 (normalised ``|a-b|/(1+|b|)``).  ``make_stage_derivs``'s H
  (the Lagrangian Hessian, second derivatives through the one
  differentiable step, as JAX takes them), gc, A, B, E, ival and the
  map's value against JAX's: 1e-10.
- A structured solve (exact Hessian) against JAX's, 2 lanes: status and
  iterations equal, X and U within 1e-8.
- The structured solve against the port's dense collocation transcription
  (``ocp/collocation.py`` through the dense IPM): U within 1e-6
  (``tests/test_collocation.py``'s claim of the two transcriptions).
- ContForm x Collocation is ContForm shooting: the structured OCP built
  from the ENMPC config with ``Collocation=True`` solves to exactly the U
  of the one without (``tests/test_collocation.py:50-101``), here with
  two RK4 sub-steps a stage.

About 40 s in one process (on the CPU).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev, vmap

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
N = 4
LANES = 2


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _configs():
    from mpc_code_tpu.config import StageCost as JSC
    from mpc_code_tpu.examples import enmpc as jex
    from mpc_code_tpu.models.costs import xQx as jxqx
    from mpc_code_tpu_torch.config import StageCost
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples import enmpc as pex
    from mpc_code_tpu_torch.models.costs import xQx

    Q, R = np.eye(2), np.eye(1)

    def jcost(x, u, y, xs, us, ys, s):
        return 0.5 * (jxqx(x - xs, Q) + jxqx(u - us, R))

    def pcost(x, u, y, xs, us, ys, s):
        return 0.5 * (xQx(x - xs, Q) + xQx(u - us, R))

    kw = dict(N=N, ContForm=False, Collocation=True)
    jcfg = jex.make_config(Nsim=3).replace(stage_cost=JSC(f_coll=jcost), **kw)
    pcfg = pex.make_config(Nsim=3).replace(stage_cost=StageCost(f_coll=pcost), **kw)
    return jcfg, config_from_numpy(jcfg, pcfg)


def _socps(jcfg, pcfg, stagewise_px=False):
    from mpc_code_tpu.models import build_model as jbm, build_stage_cost as jbs
    from mpc_code_tpu.models import build_terminal_cost as jbt
    from mpc_code_tpu.solver.riccati import build_structured_ocp as jbso
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    ps = build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                              build_terminal_cost(pcfg), device="cpu",
                              stagewise_px=stagewise_px)
    js = jbso(jcfg, jbm(jcfg), jbs(jcfg.stage_cost), jbt(jcfg), stagewise_px=stagewise_px)
    return ps, js


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    return dict(x0=np.array([0.9, 0.2]) + 0.02 * rng.standard_normal((LANES, 2)),
                xs=np.tile([0.5, 0.3], (LANES, 1)), us=np.tile([0.6], (LANES, 1)),
                d=0.01 * rng.standard_normal((LANES, cfg.nd)),
                um1=np.tile([0.6], (LANES, 1)), t=rng.uniform(0.0, 4.0, LANES),
                lam=np.zeros((LANES, cfg.ny, cfg.nu)),
                px=1e-2 * rng.standard_normal((LANES, N, cfg.npx)),
                py=1e-2 * rng.standard_normal((LANES, N, cfg.npy)))


@pytest.fixture(scope="module")
def setup():
    return _configs()


@pytest.mark.parametrize("stagewise_px", [False, True])
def test_condensed_stage_map_matches_jax(setup, stagewise_px):
    from mpc_code_tpu_torch.solver.riccati import batch_params, stage_params

    jcfg, pcfg = setup
    ps, js = _socps(jcfg, pcfg, stagewise_px)
    assert (ps.nxa, ps.nu, ps.ni) == (js.nxa, js.nu, js.ni) == (2, 1, 4)
    np.testing.assert_array_equal(ps.lbi, js.lbi)
    np.testing.assert_array_equal(ps.ubi, js.ubi)
    assert ps.stage_dyn_jac is None and ps.sweep is None
    assert ps.lowering.kind == "coll" and ps.lowering.stagewise_px == stagewise_px
    p = _params(jcfg, 5)
    rng = np.random.default_rng(6)
    z = np.concatenate([rng.uniform(0.2, 0.8, (LANES, N, 2)),
                        rng.uniform(0.3, 1.5, (LANES, N, 1))], -1)
    pk = stage_params(batch_params(p, LANES, torch.float64, torch.device("cpu")), N)
    zt = torch.as_tensor(z.reshape(LANES * N, 3))

    def dyn_z(zz, q):
        return ps.dyn(zz[:2], zz[2:], q)

    got = [vmap(f)(zt, pk).reshape(LANES, N, *f_shape) for f, f_shape in
           ((dyn_z, (2,)), (jacrev(dyn_z), (2, 3)), (jacfwd(dyn_z), (2, 3)))]
    pj = {k: jnp.asarray(v) for k, v in p.items()}

    def jdyn(zz, k, q):
        return js.dyn(zz[:2], zz[2:], k, q)

    @jax.jit
    def ref(zz, q):
        ks = jnp.arange(N)
        return (jax.vmap(lambda z1, k: jdyn(z1, k, q))(zz, ks),
                jax.vmap(lambda z1, k: jax.jacfwd(jdyn)(z1, k, q))(zz, ks))

    for lane in range(LANES):
        val, jac = ref(jnp.asarray(z[lane]), {k: v[lane] for k, v in pj.items()})
        assert _nerr(got[0][lane].numpy(), val) <= TOL
        assert _nerr(got[1][lane].numpy(), jac) <= TOL
        assert _nerr(got[2][lane].numpy(), jac) <= TOL


def test_stage_derivs_match_jax(setup):
    """H of the exact Lagrangian (second derivatives through the one
    differentiable Newton step), gc, A, B, E and ival."""
    from mpc_code_tpu.solver.riccati import make_stage_derivs as jmsd
    from mpc_code_tpu_torch.solver.riccati import (
        batch_params, make_stage_derivs, stage_params,
    )

    jcfg, pcfg = setup
    ps, js = _socps(jcfg, pcfg)
    p = _params(jcfg, 7)
    rng = np.random.default_rng(8)
    z = np.concatenate([rng.uniform(0.2, 0.8, (LANES, N, 2)),
                        rng.uniform(0.3, 1.5, (LANES, N, 1))], -1)
    lam = rng.standard_normal((LANES, N, 2))
    nus = rng.standard_normal((LANES, N, 4))
    pb = batch_params(p, LANES, torch.float64, torch.device("cpu"))
    pb["_sf"] = torch.full((LANES,), 0.7, dtype=torch.float64)
    pk = stage_params(pb, N)
    got = vmap(make_stage_derivs(ps, "exact"))(
        torch.as_tensor(z.reshape(-1, 3)), pk, torch.as_tensor(lam.reshape(-1, 2)),
        torch.as_tensor(nus.reshape(-1, 4)))
    jd = jmsd(js, "exact")

    @jax.jit
    def jref(zz, q, lk, nk):
        return jax.vmap(lambda z1, k, l1, n1: jd(z1[:2], z1[2:], k, q, l1, n1, None))(
            zz, jnp.arange(N), lk, nk)

    for lane in range(LANES):
        q = {k: jnp.asarray(v[lane]) for k, v in p.items()}
        q["_sf"] = jnp.asarray(0.7)
        ref = jref(jnp.asarray(z[lane]), q, jnp.asarray(lam[lane]), jnp.asarray(nus[lane]))
        # JAX: (H, gc, A, B, E, ival, Cz, hval, dval); port: (H, gc, A, B, E, ival, dval)
        for g, r in zip(got, [ref[i] for i in (0, 1, 2, 3, 4, 5, 8)]):
            gl = g.reshape((LANES, N) + tuple(g.shape[1:]))[lane].numpy()
            assert _nerr(gl, r) <= TOL


@pytest.fixture(scope="module")
def solves(setup):
    """The structured solve of both packages from the tiled (x0, us) guess."""
    from mpc_code_tpu.config import SolverOptions as JSO
    from mpc_code_tpu.solver.riccati import make_structured_solver as jmss
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    jcfg, pcfg = setup
    ps, js = _socps(jcfg, pcfg)
    p = _params(jcfg, 9)
    X0 = np.repeat(p["x0"][:, None], N + 1, 1)
    U0 = np.repeat(p["us"][:, None], N, 1)
    r = make_structured_solver(ps, SolverOptions(max_iter=100))(
        p, torch.as_tensor(X0), torch.as_tensor(U0))
    jsolve = jmss(js, JSO(max_iter=100))
    jr = jax.jit(jax.vmap(jsolve))({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(X0), jnp.asarray(U0))
    return p, r, jr


def test_structured_solve_matches_jax(solves):
    _, r, jr = solves
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(r.iters.numpy(), np.asarray(jr.iters))
    assert (r.status.numpy() == 0).all()
    assert _nerr(r.X.numpy(), np.asarray(jr.X)) <= 1e-8
    assert _nerr(r.U.numpy(), np.asarray(jr.U)) <= 1e-8


def test_structured_matches_dense_collocation(setup, solves):
    from mpc_code_tpu_torch.models import build_model, build_terminal_cost
    from mpc_code_tpu_torch.ocp.collocation import build_ocp_collocation
    from mpc_code_tpu_torch.solver.ipm import make_solver

    _, pcfg = setup
    p, r, _ = solves
    spec = build_ocp_collocation(pcfg, build_model(pcfg), pcfg.stage_cost.f_coll,
                                 build_terminal_cost(pcfg))
    nx, nu, st = 2, 1, 7
    w0 = np.zeros((LANES, spec.nw))
    for k in range(N):
        w0[:, k * st:k * st + 3 * nx] = np.tile(p["x0"], 3)
        w0[:, k * st + 3 * nx:(k + 1) * st] = p["us"]
    w0[:, N * st:] = p["x0"]
    lbw = np.tile(spec.lbw, (LANES, 1))
    ubw = np.tile(spec.ubw, (LANES, 1))
    lbw[:, :nx] = ubw[:, :nx] = p["x0"]
    rd = make_solver(spec.nlp, pcfg.sol_opts_dyn)(
        torch.as_tensor(w0), {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(lbw), torch.as_tensor(ubw), spec.lbg, spec.ubg)
    assert (rd.status.numpy() == 0).all()
    Ud = np.stack([rd.w[:, k * st + 3 * nx:(k + 1) * st].numpy() for k in range(N)], 1)
    assert np.abs(Ud - r.U.numpy()).max() <= 1e-6


def test_contform_wins_over_collocation():
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import enmpc as pex
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp, make_structured_solver

    outs = []
    for colloc in (True, False):
        cfg = pex.make_config(Nsim=3).replace(N=N, Collocation=colloc)
        # two RK4 sub-steps keep the quadrature cheap; the claim holds for any
        cfg = cfg.replace(model=dc.replace(cfg.model, Mx=2))
        assert cfg.ContForm
        socp = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                    build_terminal_cost(cfg), device="cpu")
        x0, us0 = np.asarray(cfg.x0_m, float), np.asarray(cfg.u0, float)
        par = dict(x0=x0, xs=x0, us=us0, d=np.zeros(cfg.nd), um1=us0, t=0.0,
                   lam=np.zeros((cfg.ny, cfg.nu)), px=np.zeros((N, cfg.npx)),
                   py=np.zeros((N, cfg.npy)))
        # Gauss-Newton, the Hessian of the ContForm joint sweep
        r = make_structured_solver(socp, SolverOptions(max_iter=120, hessian="gauss_newton"))(
            par, torch.as_tensor(np.tile(x0, (1, N + 1, 1))),
            torch.as_tensor(np.tile(us0, (1, N, 1))))
        outs.append(r)
    assert int(outs[0].status[0]) == 0
    assert (outs[0].U - outs[1].U).abs().max() == 0.0
