"""The sweeps' plain versions on models that need the elementary functions,
against the JAX package, CPU, f64.

The models are ``chip_smoke.py``'s, written once over a namespace of
functions (torch's for the port, JAX's here for the reference), B=2
scenarios, N=3 stages, RK4 at Mx=2 (kernel 5 at the card build's Mx=1):

- kernel 1: the ``elem`` ODE (nx=3, nu=2; every function the code
  generator lowers) by ``Rk4StageJac``'s plain version against
  ``integrators.rk4_stage_jac`` (JAX's lanes rule);
- kernel 3: the tanh map of ``tests/test_sweep_pallas.py:73`` against
  ``integrators.map_stage_jac``;
- kernel 4: Ex_ENMPC's ODE with a quadrature in tanh and sigmoid against
  ``integrators.rk4_quad_stage_hess``;
- kernel 5: the ``elem`` OCP (its ODE, a stage cost that calls every
  function again) under both Hessians against JAX's vmapped
  ``make_stage_derivs``, on the card check's 6 scenarios with lanes on
  JAX's special points (clamp's tie, sign at 0, pow's base 0, atan2's
  origin with nan on both sides, pow's exponent 0 in the cost).

Every output within 1e-10 (normalised ``|a-b|/(1+|b|)``).  Each wrapper's
code generator lowers the same functions (the CUDA header is emitted),
so what runs here is what a launch would build.  JAX's references are
jitted once each in a module fixture.
"""

import dataclasses as dc
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import erf as jerf

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

B, N, MX = 2, 3, 2
B5 = 6                  # kernel 5's scenarios: the card's special lanes
TOL = 1e-10
JF = types.SimpleNamespace(
    tanh=jnp.tanh, sigmoid=jax.nn.sigmoid, sin=jnp.sin, cos=jnp.cos, tan=jnp.tan,
    asin=jnp.arcsin, acos=jnp.arccos, atan=jnp.arctan, atan2=jnp.arctan2, sinh=jnp.sinh,
    cosh=jnp.cosh, log1p=jnp.log1p, expm1=jnp.expm1, rsqrt=jax.lax.rsqrt,
    reciprocal=lambda a: 1.0 / a, square=jnp.square, sign=jnp.sign,
    clamp=lambda a, min=None, max=None: jnp.clip(a, min, max), pow=jnp.power, erf=jerf,
    stack=jnp.stack)
PF = cs.torch_fns()


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0


def _bad_lanes(outs):
    return {int(b) for o in outs for b in np.nonzero(~np.isfinite(o).reshape(len(o), -1).all(1))[0]}


def _close_all(got, ref, nan_lanes=()):
    """Every output within TOL over the entries finite on both sides; the
    scenarios with a non-finite entry are ``nan_lanes`` on both sides.
    (Which entries of such a scenario are nan follows the derivative's
    mode: JAX's forward mode spreads atan2's nan at the origin to every
    tangent, the plain version's reverse mode to the rows' cotangents.)"""
    got = [g.numpy() if torch.is_tensor(g) else np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    assert len(got) == len(ref)
    assert _bad_lanes(got) == _bad_lanes(ref) == set(nan_lanes)
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        fin = np.isfinite(r) & np.isfinite(g)
        assert _nerr(g[fin], r[fin]) <= TOL, _nerr(g[fin], r[fin])


def _k1_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (B, N, 3)), rng.uniform(-1.0, 1.0, (B, N, 2)),
            rng.normal(0.0, 0.1, (B, N, 3)), rng.uniform(0.0, 1.0, B), np.full(B, 0.5),
            np.zeros((B, 0))]


def _k3_inputs(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, 2)), rng.normal(size=(B, N, 1)), rng.normal(size=(B, N, 1)),
            rng.normal(size=(B,)), rng.normal(size=(B, 1))]


def _k4_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform([0.3, 0.2], [0.9, 0.6], size=(B, N, 2)),
            rng.uniform(0.4, 1.6, size=(B, N, 1)), rng.normal(size=(B, N, 2)) * 1e-2,
            rng.normal(size=(B, N, 2)) * 1e-2, rng.uniform(0, 1, B), np.full(B, 2.0),
            rng.uniform(-0.05, 0.05, (B, 2)), rng.uniform([0.4, 0.4], [0.6, 0.5], (B, 2)),
            rng.uniform(0.8, 1.2, (B, 1))]


def _enmpc_odes():
    from mpc_code_tpu.examples.enmpc import make_config as make_jax
    from mpc_code_tpu_torch.examples.enmpc import make_config as make_port

    jfx, pfx = make_jax().model.fx, make_port().model.fx
    return (lambda x, t, u, d, px, xs, us, py: jfx(x, u, d, t, px) + px,
            lambda x, t, u, d, px, xs, us, py: pfx(x, u, d, t, px) + px)


def _elem_ocps():
    from mpc_code_tpu import config as jconfig
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp
    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.models import build_model as pbm
    from mpc_code_tpu_torch.models import build_stage_cost as pbs
    from mpc_code_tpu_torch.models import build_terminal_cost as pbt
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp as pbso

    jcfg = cs.elem_config(jconfig, JF, N=N, Mx=cs.ELEM_K5_MX)
    pcfg = cs.elem_config(pconfig, PF, N=N, Mx=cs.ELEM_K5_MX)
    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    ps = pbso(pcfg, pbm(pcfg), pbs(pcfg.stage_cost), pbt(pcfg), device="cpu")
    return jcfg, js, pcfg, ps


def _k5_inputs(ps, cfg):
    """The card's kernel-5 elem inputs (``chip_smoke.elem_sweep_inputs``)
    at B5 scenarios: lanes 0-5 on the special points of the ODE and the
    cost, lane 3 at atan2's origin (nan derivatives, as JAX's)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "B", B5)
    try:
        arrs, _ = cs.elem_sweep_inputs(torch.float64, "cpu", ps, cfg)
    finally:
        mp.undo()
    names = ("X", "U", "lam", "nus", "px", "py", "mu_h", "t", "sf", "xs", "us", "d", "um1",
             "lamy")
    return {k: v.numpy() for k, v in zip(names, arrs)}


@pytest.fixture(scope="module")
def refs():
    """JAX's outputs: the lanes rules of kernels 1, 3 and 4 (each jitted
    once) and the elem OCP's make_stage_derivs under both Hessians (one
    jit)."""
    from mpc_code_tpu.ops.integrators import map_stage_jac, rk4_quad_stage_hess, rk4_stage_jac
    from mpc_code_tpu.solver.riccati import make_stage_derivs

    jode = cs.elem_ode(JF)
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        F1 = jax.jit(jax.vmap(rk4_stage_jac(lambda x, t, u, d, px: jode(x, u, d, t, px), MX,
                                            impl="lanes")))
        out["k1"] = F1(*[jnp.asarray(a) for a in _k1_inputs()])
        F3 = jax.jit(jax.vmap(map_stage_jac(cs.tanh_map(JF))))
        out["k3"] = F3(*[jnp.asarray(a) for a in _k3_inputs()])
        F4 = jax.jit(jax.vmap(rk4_quad_stage_hess(_enmpc_odes()[0], cs.tanh_quad(JF), MX)))
        out["k4"] = F4(*[jnp.asarray(a) for a in _k4_inputs()])
    finally:
        mp.undo()
    jcfg, js, pcfg, ps = _elem_ocps()
    a = _k5_inputs(ps, pcfg)
    p = {k: jnp.asarray(a[k]) for k in ("xs", "us", "d", "um1", "t", "px", "py")}
    p["lam"] = jnp.asarray(a["lamy"].reshape(B5, jcfg.ny, jcfg.nu))
    p["_sf"] = jnp.asarray(a["sf"])
    p["x0"] = jnp.asarray(a["X"][:, 0, :jcfg.nx])
    ks = jnp.arange(N)
    v = {h: jax.vmap(make_stage_derivs(js, h), in_axes=(0, 0, 0, None, 0, 0, 0))
         for h in ("exact", "gauss_newton")}

    def k5(X, U, pp, lam, nus, muh):
        return {h: f(X, U, ks, pp, lam, nus, muh) for h, f in v.items()}

    res = jax.jit(jax.vmap(k5))(jnp.asarray(a["X"]), jnp.asarray(a["U"]), p,
                                jnp.asarray(a["lam"]), jnp.asarray(a["nus"]),
                                jnp.zeros((B5, N, 0)))
    out["k5"] = {h: [np.asarray(o[i]) for i in (0, 1, 2, 3, 4, 5, 8)] for h, o in res.items()}
    out = jax.device_get(out)
    out["k5_ocp"] = (ps, pcfg, a)
    return out


def test_kernel1_plain_on_elem(refs):
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac

    fx = cs.elem_ode(PF)
    sweep = Rk4StageJac(lambda x, t, u, d, px: fx(x, u, d, t, px), MX)
    args = [torch.tensor(a) for a in _k1_inputs()]
    assert "mpc_atan2(" in sweep.source(3, 2, 0, 3)
    _close_all(sweep(*args), refs["k1"])


def test_kernel3_plain_on_tanh_map(refs):
    from mpc_code_tpu_torch.ops.sweep_map_cuda import MapStageJac

    sweep = MapStageJac(cs.tanh_map(PF))
    assert "mpc_tanh(" in sweep.source(2, 1, 1, 1)
    _close_all(sweep(*[torch.tensor(a) for a in _k3_inputs()]), refs["k3"])


def test_kernel4_plain_with_tanh_quadrature(refs):
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import Rk4QuadStageHess

    sweep = Rk4QuadStageHess(_enmpc_odes()[1], cs.tanh_quad(PF), MX)
    src = sweep.source(2, 1, 2, 2, 2)
    assert "mpc_tanh(" in src and "mpc_sigmoid(" in src
    _close_all(sweep(*[torch.tensor(a) for a in _k4_inputs()]), refs["k4"])


@pytest.mark.parametrize("hessian", ("exact", "gauss_newton"))
def test_kernel5_plain_on_elem(refs, hessian):
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    ps, cfg, a = refs["k5_ocp"]
    assert ps.lowering is not None and ps.lowering.kind == "rk4"
    T = {k: torch.tensor(v) for k, v in a.items()}
    sweep = make_stage_sweep(ps, hessian)
    got = sweep(T["X"], T["U"], T["lam"], T["nus"], T["px"], T["py"], T["mu_h"], T["t"],
                T["sf"], T["xs"], T["us"], T["d"], T["um1"], T["lamy"])
    _close_all(got[:7], refs["k5"][hessian], nan_lanes=cs.ELEM_NAN_LANES)
    assert "mpc_pow(" in sweep.source(ps.nxa, ps.nu, ps.ni, cfg.nd, cfg.npx, cfg.npy)


def test_plain_versions_take_jax_rules_at_ties():
    """The plain version runs the user's clamp with JAX's tie rule (0.5),
    abs with +1 at 0, atan2 with nan at the origin and pow with finite
    second derivatives at a zero base, as the kernels do (torch's own: 1,
    0, 0 and nan in reverse mode)."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    cfg = cs.elem_config(pconfig, PF, N=2, Mx=1)

    def f_dis(x, u, y, xs, us, ys):
        return (torch.clamp(x[0], min=0.25) + torch.abs(x[1]) + torch.atan2(x[2], u[0])
                + u[1] * u[1] + torch.pow(u[1] * u[1], 2.5 + 0.1 * x[0]))

    cfg = cfg.replace(stage_cost=dc.replace(cfg.stage_cost, f_dis=f_dis))
    ps = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                              build_terminal_cost(cfg), device="cpu")
    X = torch.tensor([[[0.25, 0.0, 0.3], [0.25, 0.0, 0.0]]], dtype=torch.float64)
    U = torch.tensor([[[0.4, 0.0], [0.0, 0.1]]], dtype=torch.float64) / ps.su
    z = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
    H, gc = make_stage_sweep(ps, "gauss_newton")(
        X, U, z(1, 2, 3), z(1, 2, 0), z(1, 2, cfg.npx), z(1, 2, cfg.npy), z(1, 2, 0),
        z(1), torch.ones(1, dtype=torch.float64), z(1, 3), z(1, 2), z(1, 0), z(1, 2),
        z(1, 6))[:2]
    assert gc[0, 0, 0] == 0.5 and gc[0, 0, 1] == 1.0
    assert torch.isfinite(gc[0, 0, 2]) and torch.isnan(gc[0, 1, 2])
    assert torch.isfinite(H[0, 0]).all()
