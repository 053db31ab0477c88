"""The double inverted pendulum on a cart (``chip_smoke.py``'s, Bogdanov
2004), whose accelerations solve a traced 3x3 mass matrix against a traced
matrix times the rates, through the port against the JAX package, CPU,
f64.

- kernel 1's plain version (``Rk4StageJac``, the card build's lowering
  emitted too) against JAX's ``rk4_stage_jac`` (its batch-major rule: the
  lanes-minor one does not take a model with matrices), B=2 scenarios, N=3
  stages, RK4 at Mx=2;
- kernel 5's plain version (the OCP's ``StageSweep``) against JAX's
  vmapped ``make_stage_derivs`` under both Hessians on the card check's
  inputs (``chip_smoke.dipc_sweep_inputs``) at 3 scenarios;
- the OCP (N=5 intervals of 0.025 s, RK4 at Mx=2, 2 lanes from
  ``DIPC_BOX``, seed 0) under both Hessians against JAX's structured
  solver: statuses and iterations equal, X and U within 1e-8 (normalised
  ``|a-b|/(1+|b|)``), the exact route through kernel 5.

The parent port refused this model: under the exact Hessian its code
generator raised ``NotImplementedError`` (``ones_like``; stacking the mass
matrix's rows would have followed), and under Gauss-Newton kernel 1's
plain version, which ran the ODE lanes-minor, failed on ``C @ qd`` (a
shape ``RuntimeError``).
JAX's references are jitted once in a module fixture.  Behind
``MPC_TPU_SLOW=1``: JAX's own f64 solve of the card phase's box (2,048
lanes, N=40, cap 30 iterations) under both Hessians, which sets the box:
at most 3% of its lanes may fail (status 2).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

B, N, MX = 2, 3, 2
B5 = 3
N_OCP, LANES = 5, 2
TOL = 1e-10
OPTS = dict(max_iter=100, tol=1e-8)


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0


def _ocps(N_, Mx):
    from mpc_code_tpu import config as jconfig
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp
    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.models import build_model as pbm
    from mpc_code_tpu_torch.models import build_stage_cost as pbs
    from mpc_code_tpu_torch.models import build_terminal_cost as pbt
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp as pbso

    jcfg = cs.dipc_config(jconfig, jnp, N=N_, Mx=Mx)
    pcfg = cs.dipc_config(pconfig, torch, N=N_, Mx=Mx)
    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    ps = pbso(pcfg, pbm(pcfg), pbs(pcfg.stage_cost), pbt(pcfg), device="cpu")
    return jcfg, js, pcfg, ps


def _k1_inputs(seed=1):
    rng = np.random.default_rng(seed)
    lo, hi = cs.DIPC_BOX
    return [rng.uniform(2 * lo, 2 * hi, (B, N, 6)), rng.uniform(-50.0, 50.0, (B, N, 1)),
            np.zeros((B, N, 6)), rng.uniform(0.0, 1.0, B), np.full(B, cs.DIPC_H),
            np.zeros((B, 0))]


def _k5_inputs(ps, cfg):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "B", B5)
    try:
        arrs, _ = cs.dipc_sweep_inputs(torch.float64, "cpu", ps, cfg)
    finally:
        mp.undo()
    names = ("X", "U", "lam", "nus", "px", "py", "mu_h", "t", "sf", "xs", "us", "d", "um1",
             "lamy")
    return {k: v.numpy() for k, v in zip(names, arrs)}


@pytest.fixture(scope="module")
def refs():
    """JAX's kernel-1 rule, make_stage_derivs under both Hessians (one jit)
    and the structured solves under both Hessians."""
    from mpc_code_tpu.config import SolverOptions as JSO
    from mpc_code_tpu.ops.integrators import rk4_stage_jac
    from mpc_code_tpu.solver.riccati import make_stage_derivs, make_structured_solver

    jode = cs.dipc_ode(jnp)
    out = {}
    F1 = jax.jit(jax.vmap(rk4_stage_jac(lambda x, t, u, d, px: jode(x, u, d, t, px), MX,
                                        impl="jacfwd")))
    out["k1"] = F1(*[jnp.asarray(a) for a in _k1_inputs()])
    jcfg, js, pcfg, ps = _ocps(N, 1)
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
    out["k5_ocp"] = (ps, pcfg, a)
    jcfg, js, pcfg, ps = _ocps(N_OCP, MX)
    x0 = cs.dipc_x0(LANES)
    par = cs.upright_params(pcfg, x0, N_OCP)
    X0 = np.repeat(x0[:, None], N_OCP + 1, 1)
    U0 = np.zeros((LANES, N_OCP, 1))
    for h in ("gauss_newton", "exact"):
        jr = jax.jit(jax.vmap(make_structured_solver(js, JSO(hessian=h, **OPTS))))(
            {k: jnp.asarray(v) for k, v in par.items()}, jnp.asarray(X0), jnp.asarray(U0))
        out[h] = {k: np.asarray(getattr(jr, k)) for k in ("status", "iters", "X", "U")}
    out = jax.device_get(out)
    out["ocp"] = (ps, par, X0, U0)
    return out


def _close_all(got, ref):
    for g, r in zip(got, ref):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape, (g.shape, r.shape)
        assert np.isfinite(g).all() and np.isfinite(r).all()
        assert _nerr(g, r) <= TOL, _nerr(g, r)


def test_kernel1_plain_on_dipc(refs):
    """The ODE's lowering holds a pivoted solve; the plain version runs the
    model per lane, as written, against JAX's rule."""
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac

    fx = cs.dipc_ode(torch)
    sweep = Rk4StageJac(lambda x, t, u, d, px: fx(x, u, d, t, px), MX)
    src = sweep.source(6, 1, 0, 6)
    assert "mpc_absv(" in src and "mpc_where(" in src
    _close_all(sweep(*[torch.tensor(a) for a in _k1_inputs()]), refs["k1"])


@pytest.mark.parametrize("hessian", ("exact", "gauss_newton"))
def test_kernel5_plain_on_dipc(refs, hessian):
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    ps, cfg, a = refs["k5_ocp"]
    assert ps.lowering is not None and ps.lowering.kind == "rk4"
    T = {k: torch.tensor(v) for k, v in a.items()}
    sweep = make_stage_sweep(ps, hessian)
    got = sweep(T["X"], T["U"], T["lam"], T["nus"], T["px"], T["py"], T["mu_h"], T["t"],
                T["sf"], T["xs"], T["us"], T["d"], T["um1"], T["lamy"])
    _close_all(got[:7], refs["k5"][hessian])


@pytest.mark.parametrize("hessian", ("gauss_newton", "exact"))
def test_dipc_ocp_matches_jax(refs, hessian):
    """Statuses and iterations equal, X and U within 1e-8; the exact
    Hessian's derivatives from kernel 5 (its plain version here), the
    Gauss-Newton's from kernel 1's and torch.func."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import sweep_kernel
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    ps, par, X0, U0 = refs["ocp"]
    fused = []
    real = sweep_kernel.StageSweep.plain

    def counted(self, *a):
        fused.append(self.hessian)
        return real(self, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(sweep_kernel.StageSweep, "plain", counted)
    try:
        r = make_structured_solver(ps, SolverOptions(hessian=hessian, **OPTS))(
            par, torch.as_tensor(X0), torch.as_tensor(U0))
    finally:
        mp.undo()
    jr = refs[hessian]
    assert bool(fused) == (hessian == "exact")
    np.testing.assert_array_equal(r.status.numpy(), jr["status"])
    assert (jr["status"] == 0).all()
    np.testing.assert_array_equal(r.iters.numpy(), jr["iters"])
    assert _nerr(r.X.numpy(), jr["X"]) <= 1e-8 and _nerr(r.U.numpy(), jr["U"]) <= 1e-8


@pytest.mark.parametrize("hessian", ("gauss_newton", "exact"))
def test_jax_solves_the_card_box(hessian):
    """JAX's f64 structured solve on the card phase's 2,048 lanes from
    DIPC_BOX (seed 0), N=40, RK4 at one sub-step, cap UPRIGHT_MAXIT:
    fails (status 2) on at most 3% of them.  Prints the status counts."""
    if os.environ.get("MPC_TPU_SLOW") != "1":
        pytest.skip("JAX's solve of 2,048 lanes at N=40 takes minutes; set MPC_TPU_SLOW=1")
    from mpc_code_tpu import config as jconfig
    from mpc_code_tpu.config import SolverOptions as JSO
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver

    cfg = cs.dipc_config(jconfig, jnp)
    js = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                              build_terminal_cost(cfg))
    x0 = cs.dipc_x0(cs.DIPC_B)
    par = {k: jnp.asarray(v) for k, v in cs.upright_params(cfg, x0, cfg.N).items()}
    X0 = jnp.asarray(np.repeat(x0[:, None], cfg.N + 1, 1))
    r = jax.jit(jax.vmap(make_structured_solver(
        js, JSO(hessian=hessian, max_iter=cs.UPRIGHT_MAXIT))))(
        par, X0, jnp.zeros((cs.DIPC_B, cfg.N, 1)))
    status = np.asarray(r.status)
    counts = np.bincount(status, minlength=3)
    print(f"dipc box, JAX f64, {hessian}: status counts {counts.tolist()}, median "
          f"iterations {float(np.median(np.asarray(r.iters)))}")
    assert counts[2] <= 0.03 * cs.DIPC_B
