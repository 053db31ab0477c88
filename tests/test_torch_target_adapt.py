"""Modifier adaptation's NLPs and the steady-state identification of the port against the JAX package, CPU, f64.

The modifier-adaptation configuration of ``tests/test_adaptation.py:49-67``
(the reactor with a kinetic mismatch between model and plant, RK4 at
Mx=2 here):

- ``build_ssp``, ``build_ssp2`` and ``build_ss_id``: f and g at fixed
  seeded points and parameters within 1e-12 of JAX's, and each solved by
  the port's dense IPM (one lane) against JAX's jitted solve: the same
  status and iterations, w within 1e-8.  ``build_ss_id``'s steady states
  form a manifold along u (every input has one, and the cost is zero on
  all of them), so each solver may stop anywhere on it: the solve is held
  with u pinned by its bounds (lbw = ubw), which leaves one optimum;
- ``make_lambda_update`` against JAX's within 1e-10 at three points;
- ``ident.ss_p_jac_id`` (the steady-state hunt by the dense IPM, then the
  Jacobians) on ``examples/lmpc_nlplant.py`` (its affine model, the tank
  level's box shrunk to its initial level: the level is an integrator, so
  every level is a steady state) and on the nonlinear reactor above with its input box shrunk to u = 0.5 (the
  steady state unique, as above): (A, B, C, D, xlin, ulin, ylin) within
  1e-8 of JAX's.

About 40 s in one process on the CPU, most of it JAX's compiles.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_adaptation import make_adaptation_config

torch.set_num_threads(1)

CA0, V = 1.0, 1.0
K1M, K2M = 1.0, 0.05
K1P, K2P = 1.3, 0.05


def _rhs(x, u, k1, k2):
    return torch.stack([u[0] * (CA0 - x[0]) / V - k1 * x[0],
                        -u[0] * x[1] / V + k1 * x[0] - k2 * x[1]])


def port_adaptation_config(Nsim=25, Mx=2):
    """``test_adaptation.make_adaptation_config`` in the port's config
    classes, its maps in torch."""
    from mpc_code_tpu_torch.config import (
        Bounds, ContinuousModel, ContinuousPlant, DisturbanceModel, EstimatorConfig,
        MPCConfig, SSCost, StageCost, TerminalCost,
    )

    return MPCConfig(
        nx=2, nxp=2, nu=1, ny=2, nd=2, Nsim=Nsim, N=10, h=2.0, StateFeedback=True,
        model=ContinuousModel(fx=lambda x, u, d, t, px: _rhs(x, u, K1M, K2M), Mx=Mx),
        plant=ContinuousPlant(fx=lambda x, t, u, pxp, pxmp: _rhs(x, u, K1P, K2P), Mx=Mx),
        dist=DisturbanceModel(offree="lin", Bd=np.zeros((2, 2)), Cd=np.eye(2)),
        x0_p=np.array([0.9, 0.1]), x0_m=np.array([0.9, 0.1]), u0=np.array([0.5]),
        ss_cost=SSCost(f_obj=lambda x, u, y, xsp, usp, ysp: u[0] * (CA0 - 4.0 * y[1])),
        stage_cost=StageCost(f_dis=lambda x, u, y, xs, us, ys: 0.5 * (
            (x - xs) @ (x - xs) + 10.0 * (u - us) @ (u - us))),
        terminal=TerminalCost(vfin=lambda dx, xs: 100.0 * (dx @ dx)),
        estimator=EstimatorConfig(kind="lue", K=np.vstack([np.zeros((2, 2)), np.eye(2)])),
        bounds=Bounds(umin=np.array([0.05]), umax=np.array([2.0]),
                      xmin=np.zeros(2), xmax=np.ones(2)),
        Adaptation=True)


def jax_adaptation_config(Nsim=25, Mx=2):
    cfg = make_adaptation_config(Nsim)
    return cfg.replace(model=dc.replace(cfg.model, Mx=Mx), plant=dc.replace(cfg.plant, Mx=Mx))


def _specs(side):
    if side == "jax":
        from mpc_code_tpu.models import build_model, build_plant, build_ss_cost
        from mpc_code_tpu.ocp import target
        cfg = jax_adaptation_config()
    else:
        from mpc_code_tpu_torch.models import build_model, build_plant, build_ss_cost
        from mpc_code_tpu_torch.ocp import target
        cfg = port_adaptation_config()
    model = build_model(cfg)
    plant = build_plant(cfg, model)
    return dict(ssp=target.build_ssp(cfg, plant),
                ssp2=target.build_ssp2(cfg, plant, build_ss_cost(cfg.ss_cost)),
                ss_id=target.build_ss_id(cfg, model),
                lam=target.make_lambda_update(cfg, model, plant), cfg=cfg)


def _points(name, seed=0):
    """(w, par) of each NLP at a seeded point."""
    rng = np.random.default_rng(seed)
    t = np.asarray(4.0)
    z2 = np.zeros(2)
    if name == "ssp":
        return (rng.uniform(0.1, 0.9, 2),
                dict(t=t, us=np.array([0.8]), pxp=z2, pxmp=z2, d=np.array([0.01, -0.02])))
    w = np.concatenate([rng.uniform(0.1, 0.9, 2), [0.7], rng.uniform(0.1, 0.9, 2)])
    if name == "ssp2":
        return w, dict(usp=np.zeros(1), ysp=np.zeros(2), xsp=z2, pyp=z2, t=t, pxp=z2,
                       pxmp=z2, pymp=z2)
    return w, dict(d=z2, t=t, px=z2, py=z2)


@pytest.fixture(scope="module")
def sides():
    return _specs("jax"), _specs("port")


@pytest.mark.parametrize("name", ["ssp", "ssp2", "ss_id"])
def test_nlp_functions_match_jax(sides, name):
    J, P = (s[name] for s in sides)
    assert (J.nlp.nw, J.nlp.ng) == (P.nlp.nw, P.nlp.ng)
    for a, b in zip((J.lbw, J.ubw, J.lbg, J.ubg), (P.lbw, P.ubw, P.lbg, P.ubg)):
        np.testing.assert_array_equal(a, b)
    for seed in range(3):
        w, par = _points(name, seed)
        jp = {k: jnp.asarray(v) for k, v in par.items()}
        tp = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in par.items()}
        tw = torch.as_tensor(w)
        assert abs(float(J.nlp.f(jnp.asarray(w), jp)) - float(P.nlp.f(tw, tp))) <= 1e-12
        np.testing.assert_allclose(P.nlp.g(tw, tp).numpy(), np.asarray(J.nlp.g(jnp.asarray(w), jp)),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["ssp", "ssp2", "ss_id"])
def test_nlp_solves_match_jax(sides, name):
    from mpc_code_tpu.solver.ipm import make_solver as jsolver
    from mpc_code_tpu_torch.solver.ipm import make_solver

    J, P = (s[name] for s in sides)
    opts_j, opts_p = sides[0]["cfg"].sol_opts_ss, sides[1]["cfg"].sol_opts_ss
    w0, par = _points(name, 7)
    lbw, ubw = J.lbw.copy(), J.ubw.copy()
    if name == "ss_id":
        lbw[2] = ubw[2] = w0[2]            # u pinned: one steady state
    rj = jax.jit(jsolver(J.nlp, opts_j))(jnp.asarray(w0), {k: jnp.asarray(v) for k, v in par.items()},
                                          lbw, ubw, J.lbg, J.ubg)
    rp = make_solver(P.nlp, opts_p)(torch.as_tensor(w0)[None],
                                    {k: torch.as_tensor(v, dtype=torch.float64)[None]
                                     for k, v in par.items()}, lbw, ubw, P.lbg, P.ubg)
    assert int(rp.status[0]) == int(rj.status) == 0
    assert int(rp.iters[0]) == int(rj.iters)
    assert np.abs(rp.w[0].numpy() - np.asarray(rj.w)).max() <= 1e-8


def test_lambda_update_matches_jax(sides):
    lj, lp = sides[0]["lam"], sides[1]["lam"]
    rng = np.random.default_rng(3)
    for _ in range(3):
        args = [rng.normal(size=(2, 1)) * 0.1, rng.uniform(0.2, 0.8, 2),
                rng.uniform(0.2, 0.8, 2), rng.uniform(0.5, 1.5, 1), rng.normal(size=2) * 0.01,
                np.asarray(2.0)] + [np.zeros(2)] * 6
        got = lp(*(torch.as_tensor(a, dtype=torch.float64) for a in args)).numpy()
        ref = np.asarray(lj(*(jnp.asarray(a) for a in args)))
        assert np.abs(got).max() > 1e-3
        assert np.abs(got - ref).max() <= 1e-10


@pytest.mark.parametrize("nonlinear", [False, True], ids=["lmpc_nlplant", "reactor"])
def test_ss_p_jac_id_matches_jax(nonlinear):
    from mpc_code_tpu.examples.lmpc_nlplant import make_config as jmake
    from mpc_code_tpu.ident import ss_p_jac_id as jid
    from mpc_code_tpu_torch.examples.lmpc_nlplant import make_config as pmake
    from mpc_code_tpu_torch.ident import ss_p_jac_id

    if nonlinear:
        # the reactor's steady state is unique once its input is pinned
        jcfg, pcfg = jax_adaptation_config(2), port_adaptation_config(2)
        pin = dict(umin=np.array([0.5]), umax=np.array([0.5]))
        jcfg = jcfg.replace(bounds=dc.replace(jcfg.bounds, **pin))
        pcfg = pcfg.replace(bounds=dc.replace(pcfg.bounds, **pin))
    else:
        # the tank level is an integrator (every level is a steady state
        # once in- and outflow match): its box shrunk to the initial level
        jcfg, pcfg = jmake(Nsim=2), pmake(Nsim=2)
        lo, hi = np.array(jcfg.bounds.xmin, float), np.array(jcfg.bounds.xmax, float)
        lo[2] = hi[2] = jcfg.x0_m[2]
        jcfg = jcfg.replace(bounds=dc.replace(jcfg.bounds, xmin=lo, xmax=hi))
        pcfg = pcfg.replace(bounds=dc.replace(pcfg.bounds, xmin=lo, xmax=hi))
    got, ref = ss_p_jac_id(pcfg, device="cpu"), jid(jcfg)
    for name, a, b in zip(("A", "B", "C", "D", "xlin", "ulin", "ylin"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-8 * max(1.0, np.abs(b).max()), name
