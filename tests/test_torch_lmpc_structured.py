"""The port's structured OCP of a linear model against the JAX package, CPU, f64.

A ``LinearModel`` has no split dynamics sweep (JAX ``riccati.py:604-606``):
``build_structured_ocp`` gives its generic scaled map ``dyn`` (with the
u_prev rows under DUForm) and a lowering of its affine step as a map, and
``make_structured_solver`` takes every stage derivative from the fused
stage sweep (kernel 5; its plain version here, ``make_stage_derivs``
vmapped over the B*N points), under either Hessian, as JAX's
``make_stage_sweep`` takes them, with the Riccati KKT solve (its plain
version here) once per iteration.

- Cold solves of ``lmpc_wb`` (DUForm, nxa=6), ``lmpc_cstr`` (state and
  output bounds, nxa=3, ni=3; its lane from the example's ``x0_p`` is
  infeasible and runs to the cap of 100, in JAX as here) and
  ``lmpc_nlplant`` (affine model, DUForm, nxa=5) at N=8, three lanes each,
  under Gauss-Newton and the exact Hessian: JAX's ``make_structured_solver``
  jitted and vmapped over the lanes, computed once per config and Hessian.
  Status and iterations equal per lane, the KKT point (X, U, lam, nus, zl,
  zu) within 1e-8 (normalised ``|a-b|/(1+|b|)``; measured up to 3.2e-12,
  in lmpc_nlplant's multipliers).  Both Hessians take the same iterations
  to the same point.
- Exact and Gauss-Newton give the same stage derivatives, H included, bit
  for bit on seeded points, on all four LMPC configs: the Lagrangian's
  ``lam.dyn`` and ``nu.ineq`` terms are linear, so their second
  derivatives are zeros.
- The route is chosen from the OCP's structure: a linear model builds the
  fused stage sweep under either Hessian, and so does the CSTR's
  continuous model under the exact Hessian.
- In f32, ``lmpc_nlplant``'s OCP at its nominal point stops at the cap of
  10 with status 1 (KKT error 6.3e-3 against the 1e-3 tolerance; f64:
  status 0 in 3 iterations), and JAX's f32 solver does too (4.1e-3).

About 45 s in one process on the CPU, most of it JAX compiling the six
reference solvers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N = 8
TOL = 1e-8
FIELDS = ("X", "U", "lam", "nus", "zl", "zu")
HESS = ("gauss_newton", "exact")


def _configs(name):
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=5).replace(N=N)
    return jcfg, config_from_numpy(jcfg, pmod.make_config(Nsim=5))


def _lanes(name, cfg):
    """Three initial states: the example's x0_p (model coordinates) and two
    seeded perturbations of x0_m (for lmpc_cstr, whose x0_m = x0_p is
    infeasible, of the origin)."""
    rng = np.random.default_rng(0)
    x0m = np.asarray(cfg.x0_m, float)
    xp = x0m.copy()
    xp[: cfg.nxp] = np.asarray(cfg.x0_p, float)
    c = np.zeros(cfg.nx) if name == "lmpc_cstr" else x0m
    scale = 0.02 * np.maximum(np.abs(c), 1.0)
    return np.stack([xp, c + scale * rng.normal(size=cfg.nx),
                     c + scale * rng.normal(size=cfg.nx)])


def _params(cfg, x0s):
    rng = np.random.default_rng(1)
    u0 = np.asarray(cfg.u0, float)
    return dict(x0=x0s, xs=np.asarray(cfg.x0_m, float), us=u0,
                d=0.01 * rng.normal(size=cfg.nd), um1=u0, t=0.0,
                lam=np.zeros((cfg.ny, cfg.nu)), px=np.zeros((N, cfg.npx)),
                py=np.zeros((N, cfg.npy)))


def _guess(socp, cfg, B):
    x0a = np.concatenate([np.asarray(cfg.x0_m, float),
                          np.asarray(cfg.u0, float)])[: socp.nxa]
    return (np.tile(x0a, (B, N + 1, 1)),
            np.tile(np.asarray(cfg.u0, float), (B, N, 1)))


def _port_ocp(pcfg):
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                                build_terminal_cost(pcfg), device="cpu")


@pytest.fixture(scope="module", params=[(n, h) for n in ("lmpc_wb", "lmpc_cstr",
                                                       "lmpc_nlplant") for h in HESS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def solves(request):
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver as port_solver

    name, hess = request.param
    jcfg, pcfg = _configs(name)
    x0s = _lanes(name, jcfg)
    par = _params(jcfg, x0s)
    socp = _port_ocp(pcfg)
    X0, U0 = _guess(socp, jcfg, len(x0s))
    pres = port_solver(socp, SolverOptions(hessian=hess))(
        {k: torch.as_tensor(v) for k, v in par.items()}, torch.as_tensor(X0),
        torch.as_tensor(U0))

    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    jsolve = make_structured_solver(js, JOpts(hessian=hess))
    axes = {k: (0 if k == "x0" else None) for k in par}
    jres = jax.jit(jax.vmap(jsolve, in_axes=(axes, 0, 0)))(
        {k: jnp.asarray(v) for k, v in par.items()}, jnp.asarray(X0), jnp.asarray(U0))
    return name, pres, jax.device_get(jres)


def test_status_and_iterations_match_jax(solves):
    name, pres, jres = solves
    np.testing.assert_array_equal(pres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(pres.iters.numpy(), np.asarray(jres.iters))
    if name == "lmpc_cstr":
        # x0_p = 3 lies outside what the output bounds let the horizon reach
        assert pres.status.tolist() == [2, 0, 0]
    else:
        assert (pres.status == 0).all()


def test_kkt_point_matches_jax(solves):
    _, pres, jres = solves
    for f in FIELDS:
        a, b = getattr(pres, f).numpy(), np.asarray(getattr(jres, f))
        assert a.shape == b.shape, f
        err = float((np.abs(a - b) / (1 + np.abs(b))).max()) if a.size else 0.0
        assert err <= TOL, f"{f}: {err:.3e}"


@pytest.mark.parametrize("name", ["lmpc_wb", "lmpc_cstr", "lmpc_nlplant", "lmpcxp_nlplant"])
def test_exact_and_gauss_newton_derivatives_agree(name):
    from torch.func import vmap

    from mpc_code_tpu_torch.solver.riccati import (
        batch_params, make_stage_derivs, stage_params,
    )

    jcfg, pcfg = _configs(name)
    socp = _port_ocp(pcfg)
    assert socp.stage_dyn_jac is None and socp.dyn is not None
    assert socp.lowering.kind == "map" and socp.lowering.lin_par is False
    B, nz = 2, socp.nxa + socp.nu
    p = batch_params({k: torch.as_tensor(v) for k, v in
                      _params(jcfg, np.asarray(jcfg.x0_m, float)).items()},
                     B, torch.float64, "cpu")
    pk = stage_params(p, N)
    pk["_sf"] = torch.full((B * N,), 0.37, dtype=torch.float64)
    g = torch.Generator().manual_seed(2)
    Z = torch.randn(B * N, nz, generator=g, dtype=torch.float64)
    lam = torch.randn(B * N, socp.nxa, generator=g, dtype=torch.float64)
    nus = torch.randn(B * N, socp.ni, generator=g, dtype=torch.float64)
    ex = vmap(make_stage_derivs(socp, "exact"))(Z, pk, lam, nus)
    gn = vmap(make_stage_derivs(socp, "gauss_newton"))(Z, pk, lam, nus)
    for a, b in zip(ex, gn):
        assert torch.equal(a, b)
    H = ex[0]
    assert H.shape == (B * N, nz, nz) and torch.equal(H, H.mT)


@pytest.mark.parametrize("hess", HESS)
def test_linear_model_takes_the_generic_route(hess, monkeypatch):
    """The generic stage-derivative sweep: the fused stage sweep (kernel
    5) of the Hessian asked for, as JAX's make_stage_sweep takes a
    LinearModel's stage derivatives."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import riccati, sweep_kernel

    built = []
    inner = sweep_kernel.make_stage_sweep
    monkeypatch.setattr(sweep_kernel, "make_stage_sweep",
                        lambda s, h="exact": built.append(h) or inner(s, h))
    _, pcfg = _configs("lmpc_nlplant")
    riccati.make_structured_solver(_port_ocp(pcfg), SolverOptions(hessian=hess))
    assert built == [hess]


def test_continuous_model_under_exact_still_builds_the_fused_sweep(monkeypatch):
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples import bench_workload as bw
    from mpc_code_tpu_torch.solver import riccati, sweep_kernel

    built = []
    inner = sweep_kernel.make_stage_sweep
    monkeypatch.setattr(sweep_kernel, "make_stage_sweep",
                        lambda *a, **k: built.append(1) or inner(*a, **k))
    _, _, socp, _ = bw.make_problem("cpu", Nh=5, Mx=2)
    riccati.make_structured_solver(socp, SolverOptions(hessian="exact"))
    assert built == [1]


def test_f32_solve_stops_short_as_in_jax():
    """``lmpc_nlplant`` at its nominal point (x0 = xs = x0_m), N=8, under
    ``SolverOptions.for_f32(max_iter=10)``: in f64 the port converges in a
    few iterations; in f32 it stops at the cap with status 1, its KKT error
    above the 1e-3 tolerance, and so does JAX's f32 solver (x64 off).  The
    temperature state (~350, scaled by 375) leaves f32 too few digits for
    the tolerance: a limit of the algorithm in f32, not of the port
    (PERF.md, section 6)."""
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver as port_solver

    jcfg, pcfg = _configs("lmpc_nlplant")
    x0m = np.asarray(jcfg.x0_m, float)
    par = _params(jcfg, x0m) | dict(d=np.zeros(jcfg.nd))
    socp = _port_ocp(pcfg)
    X0, U0 = _guess(socp, jcfg, 1)
    psolve = port_solver(socp, SolverOptions.for_f32(max_iter=10, hessian="gauss_newton"))
    res = {}
    for dt in (torch.float64, torch.float32):
        res[dt] = psolve({k: torch.as_tensor(v, dtype=dt) for k, v in par.items()},
                         torch.as_tensor(X0, dtype=dt), torch.as_tensor(U0, dtype=dt))
    assert int(res[torch.float64].status[0]) == 0 and int(res[torch.float64].iters[0]) < 10
    r32 = res[torch.float32]
    assert r32.U.dtype == torch.float32
    assert (int(r32.status[0]), int(r32.iters[0])) == (1, 10)
    assert float(r32.kkt_err[0]) > 1e-3

    with jax.enable_x64(False):
        f32 = jnp.float32
        js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                                  build_terminal_cost(jcfg))
        jsolve = make_structured_solver(js, JOpts.for_f32(max_iter=10, hessian="gauss_newton"))
        jres = jax.jit(jsolve)({k: jnp.asarray(v, f32) for k, v in par.items()},
                               jnp.asarray(X0[0], f32), jnp.asarray(U0[0], f32))
        assert jres.U.dtype == jnp.float32
        assert (int(jres.status), int(jres.iters)) == (1, 10)
        assert float(jres.kkt_err) > 1e-3
