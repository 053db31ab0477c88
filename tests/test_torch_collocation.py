"""The port's Gauss-Legendre collocation transcription and its helpers
against the JAX package, CPU, f64.

- ``models/costs.py::xQx`` at seeded points; ``ops/smalllin.py::
  solve_lu_ad``, its value and its ``jacrev`` and ``jacfwd`` in both
  arguments under ``vmap``, against JAX's ``solve_lu_ad`` with
  ``jax.jacrev``, to 1e-10 (normalised ``|a-b|/(1+|b|)``; F13), and NaN
  on a singular lane only.
- ``ocp/collocation.py::build_ocp_collocation`` on the ENMPC tracking
  config of ``tests/test_collocation.py:17-36`` (N=4; the state box
  bounds s1 and s2): ``lbw/ubw/lbg/ubg`` equal, ``f``, ``g``, the
  gradient of ``f`` and the Jacobian of ``g`` at seeded points and
  parameters, 2 lanes, to 1e-10, with ``stagewise_px`` both ways; a
  variant with output bounds, soft slacks, Delta-u bounds, ``TermCons``,
  ``G_ineq`` and ``H_eq`` rows for every branch of ``g``.
- One dense-IPM solve of the collocation OCP with the initial state
  pinned, against JAX's ``make_solver``: status and iterations equal, w
  within 1e-8.

About 30 s in one process (on the CPU).
"""

import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd, jacrev, vmap

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
LANES = 2
N = 4


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _configs(variant="plain"):
    """The ENMPC tracking config with the collocation cost (JAX, port)."""
    from mpc_code_tpu.config import Bounds as JB, StageCost as JSC
    from mpc_code_tpu.examples import enmpc as jex
    from mpc_code_tpu.models.costs import xQx as jxqx
    from mpc_code_tpu_torch.config import StageCost
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples import enmpc as pex
    from mpc_code_tpu_torch.models.costs import xQx

    Q, R = np.eye(2), np.eye(1)

    def jcost(x, u, y, xs, us, ys, s):
        return 0.5 * (jxqx(x - xs, Q) + jxqx(u - us, R)) + 0.01 * jnp.sum(s * s)

    def pcost(x, u, y, xs, us, ys, s):
        return 0.5 * (xQx(x - xs, Q) + xQx(u - us, R)) + 0.01 * torch.sum(s * s)

    kw = dict(N=N, ContForm=False, Collocation=True)
    jcfg = jex.make_config(Nsim=3).replace(stage_cost=JSC(f_coll=jcost), **kw)
    pcfg = pex.make_config(Nsim=3).replace(stage_cost=StageCost(f_coll=pcost), **kw)
    if variant == "rows":
        def jrow(x, u, y, d, t, px, py):
            return jnp.atleast_1d(x[0] + x[1] - 1.5)

        def prow(x, u, y, d, t, px, py):
            return torch.atleast_1d(x[0] + x[1] - 1.5)

        b = dict(umin=np.array([0.0]), umax=np.array([2.0]), xmin=np.array([0.0, 0.0]),
                 xmax=np.array([1.0, 1.0]), ymin=np.array([0.0, 0.0]),
                 ymax=np.array([1.0, 0.9]), Dumin=np.array([-0.5]), Dumax=np.array([0.5]))
        extra = dict(slacks=True, slacksG=True, slacksH=True, Ws=np.eye(6),
                     TermCons=True, QForm=True)
        jcfg = jcfg.replace(bounds=JB(**b), G_ineq=jrow, H_eq=jrow, **extra)
        from mpc_code_tpu_torch.config import Bounds

        pcfg = pcfg.replace(bounds=Bounds(**b), G_ineq=prow, H_eq=prow, **extra)
    return jcfg, config_from_numpy(jcfg, pcfg)


def _ocps(jcfg, pcfg, stagewise_px=False):
    from mpc_code_tpu.models import build_model as jbm, build_terminal_cost as jbt
    from mpc_code_tpu.ocp.collocation import build_ocp_collocation as jocp
    from mpc_code_tpu_torch.models import build_model, build_terminal_cost
    from mpc_code_tpu_torch.ocp.collocation import build_ocp_collocation

    po = build_ocp_collocation(pcfg, build_model(pcfg), pcfg.stage_cost.f_coll,
                               build_terminal_cost(pcfg), stagewise_px=stagewise_px)
    jo = jocp(jcfg, jbm(jcfg), jcfg.stage_cost.f_coll, jbt(jcfg),
              stagewise_px=stagewise_px)
    return po, jo


def _point(cfg, nw, seed):
    """Seeded decision vectors around (x0_m, u0) and parameters, per lane."""
    rng = np.random.default_rng(seed)
    nx, nu = cfg.nx, cfg.nu
    x0, u0 = np.asarray(cfg.x0_m, float), np.asarray(cfg.u0, float) + 0.5
    stage = np.concatenate([x0, x0, x0, u0])
    base = np.concatenate([np.tile(stage, N), x0, np.full(nw - N * stage.size - nx, 0.1)])
    w = base[None] * (1 + 0.05 * rng.standard_normal((LANES, nw)))
    p = dict(x0=x0 * (1 + 0.01 * rng.standard_normal((LANES, nx))),
             xs=np.tile([0.5, 0.3], (LANES, 1)), us=np.tile(u0, (LANES, 1)),
             d=0.01 * rng.standard_normal((LANES, cfg.nd)),
             um1=u0 * (1 + 0.01 * rng.standard_normal((LANES, nu))),
             t=rng.uniform(0.0, 4.0, LANES),
             lam=0.01 * rng.standard_normal((LANES, cfg.ny, nu)),
             px=1e-2 * rng.standard_normal((LANES, N, cfg.npx)),
             py=1e-2 * rng.standard_normal((LANES, N, cfg.npy)))
    return w, p


def test_xqx_matches_jax():
    from mpc_code_tpu.models.costs import xQx as jxqx
    from mpc_code_tpu_torch.models.costs import xQx

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4))
    Q = rng.standard_normal((4, 4))
    got = vmap(lambda v: xQx(v, Q))(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax.vmap(lambda v: jxqx(v, Q))(jnp.asarray(x)))
    assert _nerr(got, ref) <= TOL


def test_solve_lu_ad_and_jacrev_match_jax():
    from mpc_code_tpu.ops.smalllin import solve_lu_ad as jsolve
    from mpc_code_tpu_torch.ops.smalllin import solve_lu_ad

    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 4, 4)) + 3 * np.eye(4)
    b = rng.standard_normal((3, 4))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    got = ([vmap(solve_lu_ad)(At, bt)]
           + list(vmap(jacrev(solve_lu_ad, argnums=(0, 1)))(At, bt))
           + list(vmap(jacfwd(solve_lu_ad, argnums=(0, 1)))(At, bt)))
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    ref = [jax.vmap(jsolve)(Aj, bj)] + 2 * list(
        jax.vmap(jax.jacrev(jsolve, argnums=(0, 1)))(Aj, bj))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _nerr(g.numpy(), np.asarray(r)) <= TOL
    # a singular lane gives NaN on that lane only
    A[1] = 0.0
    x = vmap(solve_lu_ad)(torch.as_tensor(A), bt).numpy()
    assert np.isnan(x[1]).all() and np.isfinite(x[[0, 2]]).all()


@pytest.mark.parametrize("variant,stagewise_px", [("plain", False), ("plain", True),
                                                  ("rows", False)])
def test_build_ocp_collocation_matches_jax(variant, stagewise_px):
    jcfg, pcfg = _configs(variant)
    po, jo = _ocps(jcfg, pcfg, stagewise_px)
    assert (po.nw, po.ns, po.ng_user, po.nh_user) == (jo.nw, jo.ns, jo.ng_user, jo.nh_user)
    assert po.nlp.ng == jo.nlp.ng
    for k in ("lbw", "ubw", "lbg", "ubg"):
        np.testing.assert_array_equal(getattr(po, k), getattr(jo, k), err_msg=k)
    w, p = _point(jcfg, po.nw, 3)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    wt, wj = torch.as_tensor(w), jnp.asarray(w)
    for pf, jf in ((po.nlp.f, jo.nlp.f), (po.nlp.g, jo.nlp.g),
                   (grad(po.nlp.f), jax.grad(jo.nlp.f)),
                   (jacrev(po.nlp.g), jax.jacrev(jo.nlp.g))):
        got = vmap(pf)(wt, pt).numpy()
        ref = np.asarray(jax.vmap(jf)(wj, pj))
        assert got.shape == ref.shape
        assert _nerr(got, ref) <= TOL


def test_dense_solve_matches_jax():
    """The collocation OCP from the reference's cold guess (x0_m on x and
    s1, s2, u0 on u), x0 pinned through lbw = ubw, as ``ClosedLoop`` does."""
    from mpc_code_tpu.solver.ipm import make_solver as jms
    from mpc_code_tpu_torch.solver.ipm import make_solver

    jcfg, pcfg = _configs()
    po, jo = _ocps(jcfg, pcfg)
    _, p = _point(jcfg, po.nw, 4)
    x0m, u0 = np.asarray(jcfg.x0_m, float), np.asarray(jcfg.u0, float)
    w0 = np.tile(np.concatenate([np.tile(np.r_[x0m, x0m, x0m, u0], N), x0m]), (LANES, 1))
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
