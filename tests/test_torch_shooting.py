"""The port's dense multiple-shooting OCP (``ocp/shooting.py``) against the JAX package, CPU, f64.

- ``build_ocp``'s ``f``, its gradient, ``g`` and the default bounds
  ``lbw/ubw/lbg/ubg`` on ``examples/nmpc.py`` (N=5, RK4 Mx=2, output
  bounds), ``examples/nmpc_dis.py`` (N=5: Delta-u rows, DUForm, the user
  terminal weight) and ``examples/enmpc.py`` (N=4: ContForm, the RK4
  quadrature of the economic cost), at seeded points and parameters
  (non-zero ``lam``, ``px`` and ``py``), 2 lanes: normalised error
  ``|a-b|/(1+|b|)`` at most 1e-10 (largest measured 1.0e-14), the bounds
  equal.
- One dense-IPM solve (``solver/ipm.py::make_solver``, the example's
  default ``SolverOptions``) of the nmpc OCP with the initial state pinned,
  against JAX's ``make_solver``: status and iterations equal, w within
  1e-8 (measured with the rest: 1.0e-14).

About 36 s in one process (builder's CPU run).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
LANES = 2
SIZES = {"nmpc": 5, "nmpc_dis": 5, "enmpc": 4}


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _configs(name):
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=5).replace(N=SIZES[name])
    if name == "nmpc":
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=2))
    return jcfg, config_from_numpy(jcfg, pmod.make_config(Nsim=5))


def _ocps(jcfg, pcfg):
    from mpc_code_tpu.models import build_model as jbm, build_stage_cost as jbs
    from mpc_code_tpu.models import build_terminal_cost as jbt
    from mpc_code_tpu.ocp.shooting import build_ocp as jocp
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.ocp.shooting import build_ocp

    po = build_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                   build_terminal_cost(pcfg))
    jo = jocp(jcfg, jbm(jcfg), jbs(jcfg.stage_cost), jbt(jcfg))
    return po, jo


def _point(cfg, seed):
    """Seeded decision vectors around (x0_m, u0) and parameters, per lane."""
    rng = np.random.default_rng(seed)
    N, nx, nu = cfg.N, cfg.nx, cfg.nu
    x0, u0 = np.asarray(cfg.x0_m, float), np.asarray(cfg.u0, float)
    body = np.tile(np.concatenate([x0, u0]), N)
    w = np.concatenate([body, x0, np.zeros(0)])[None] * (
        1 + 0.02 * rng.standard_normal((LANES, N * (nx + nu) + nx)))
    d0 = np.zeros(cfg.nd) if cfg.dhat0 is None else np.asarray(cfg.dhat0, float)
    p = dict(x0=x0 * (1 + 0.01 * rng.standard_normal((LANES, nx))),
             xs=np.tile(x0, (LANES, 1)), us=np.tile(u0, (LANES, 1)),
             d=d0 + 0.01 * rng.standard_normal((LANES, cfg.nd)),
             um1=u0 * (1 + 0.01 * rng.standard_normal((LANES, nu))),
             t=rng.uniform(0.0, 4.0, LANES),
             lam=0.01 * rng.standard_normal((LANES, cfg.ny, nu)),
             px=1e-3 * rng.standard_normal((LANES, N, cfg.npx)),
             py=1e-3 * rng.standard_normal((LANES, N, cfg.npy)))
    return w, p


@pytest.mark.parametrize("name", list(SIZES))
def test_build_ocp_matches_jax(name):
    jcfg, pcfg = _configs(name)
    po, jo = _ocps(jcfg, pcfg)
    assert (po.nw, po.ns, po.ng_user, po.nh_user) == (jo.nw, jo.ns, jo.ng_user, jo.nh_user)
    assert po.nlp.ng == jo.nlp.ng
    for k in ("lbw", "ubw", "lbg", "ubg"):
        np.testing.assert_array_equal(getattr(po, k), getattr(jo, k), err_msg=k)
    w, p = _point(jcfg, 3)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    wt, wj = torch.as_tensor(w), jnp.asarray(w)
    for pf, jf in ((po.nlp.f, jo.nlp.f), (po.nlp.g, jo.nlp.g),
                   (grad(po.nlp.f), jax.grad(jo.nlp.f))):
        got = vmap(pf)(wt, pt).numpy()
        ref = np.asarray(jax.vmap(jf)(wj, pj))
        assert got.shape == ref.shape
        assert _nerr(got, ref) <= TOL


def test_dense_solve_matches_jax():
    """The nmpc OCP (N=5, Mx=2) from the tiled (x0_m, u0) guess, x0 pinned
    through lbw = ubw on the first nx entries, as the closed loop does."""
    from mpc_code_tpu.solver.ipm import make_solver as jms
    from mpc_code_tpu_torch.solver.ipm import make_solver

    jcfg, pcfg = _configs("nmpc")
    po, jo = _ocps(jcfg, pcfg)
    w, p = _point(jcfg, 4)
    w0 = np.tile(np.concatenate([np.tile(np.r_[jcfg.x0_m, jcfg.u0], jcfg.N), jcfg.x0_m]),
                 (LANES, 1))
    lbw = np.tile(po.lbw, (LANES, 1))
    ubw = np.tile(po.ubw, (LANES, 1))
    lbw[:, :jcfg.nx] = p["x0"]
    ubw[:, :jcfg.nx] = p["x0"]
    r = make_solver(po.nlp, pcfg.sol_opts_dyn)(
        torch.as_tensor(w0), {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(lbw), torch.as_tensor(ubw), po.lbg, po.ubg)
    jsolve = jms(jo.nlp, jcfg.sol_opts_dyn)
    jr = jax.jit(jax.vmap(lambda w_, p_, lo, hi: jsolve(
        w_, p_, lo, hi, jnp.asarray(jo.lbg), jnp.asarray(jo.ubg))))(
        jnp.asarray(w0), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(lbw), jnp.asarray(ubw))
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(r.iters.numpy(), np.asarray(jr.iters))
    assert (r.status.numpy() == 0).all()
    assert _nerr(r.w.numpy(), np.asarray(jr.w)) <= 1e-8
