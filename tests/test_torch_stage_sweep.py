"""The port's fused stage sweep (kernel 5's plain version) against the JAX package, CPU, f64.

- The plain full sweep ``make_stage_sweep(socp, hessian)`` on CPU tensors,
  exact and Gauss-Newton, against JAX's ``vmap(make_stage_derivs(s,
  hessian))``, and the exact one also against JAX's ``make_stage_sweep(sd,
  N)`` under vmap (the plain reference of the TPU kernel, as
  ``tests/test_sweep_kernel.py`` runs it, which holds it equal to the
  former under Gauss-Newton; tracing it costs as much again as the
  reference itself): the bench's CSTR OCP at N=7, RK4 Mx=2 with the saturation
  guard, B=5 scenarios with non-zero dynamics and row multipliers, px, py
  and output-correction matrix, and scenario 1 with its third state
  exactly on the guard's lower bound (F1's tie: the guard's derivative
  there is 0.5, its second derivative 0).  All seven outputs to 1e-10.
- The code generator's lowering of the stage cost and the inequality rows
  (``Program.execute``: value, gradient and Hessian against the torch
  functions), and an exact pin of the kernel's operation count at the
  bench's dimensions.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, B = 7, 5
CLIP_LO = np.array([0.0, 280.0, 0.4], np.float32)
CLIP_HI = np.array([2.0, 420.0, 1.0], np.float32)
TIE_LANE = 1


def _ocps(Mx=2, Nh=N):
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu.models import build_model as j_model
    from mpc_code_tpu.models import build_stage_cost as j_stage
    from mpc_code_tpu.models import build_terminal_cost as j_term
    from mpc_code_tpu.solver.riccati import build_structured_ocp as j_ocp
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port
    from mpc_code_tpu_torch.models import build_model as p_model
    from mpc_code_tpu_torch.models import build_stage_cost as p_stage
    from mpc_code_tpu_torch.models import build_terminal_cost as p_term
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp as p_ocp

    jcfg = make_jax().replace(N=Nh, R_wn=None)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=Mx, clip_lo=CLIP_LO,
                                         clip_hi=CLIP_HI))
    pcfg = config_from_numpy(jcfg, make_port().replace(N=Nh, R_wn=None))
    js = j_ocp(jcfg, j_model(jcfg), j_stage(jcfg.stage_cost), j_term(jcfg))
    ps = p_ocp(pcfg, p_model(pcfg), p_stage(pcfg.stage_cost), p_term(pcfg),
               device="cpu")
    return jcfg, js, ps


def _inputs(ps, cfg):
    """The port's sweep inputs (numpy), seed 0."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(0.3, 0.95, (B, N, 1)),
                        rng.uniform(318.0, 340.0, (B, N, 1)) / ps.sxa[1],
                        rng.uniform(0.55, 0.7, (B, N, 1))], -1)
    X[TIE_LANE, :, 2] = float(CLIP_LO[2]) / ps.sxa[2]
    U = np.concatenate([rng.uniform(295.0, 305.0, (B, N, 1)) / ps.su[0],
                        rng.uniform(0.0, 0.25, (B, N, 1))], -1)
    return dict(
        X=X, U=U, lam=rng.normal(0.0, 1.0, (B, N, ps.nxa)),
        nus=rng.normal(0.0, 0.1, (B, N, ps.ni)),
        px=rng.normal(0.0, 0.01, (B, N, cfg.npx)),
        py=rng.normal(0.0, 0.01, (B, N, cfg.npy)),
        t=rng.uniform(0.0, 1.0, B), sf=rng.uniform(0.5, 1.0, B),
        xs=np.array([0.874317, 325.0, 0.6528]) + rng.normal(0.0, 0.01, (B, 3)),
        us=np.array([300.157, 0.1]) + rng.normal(0.0, 0.01, (B, 2)),
        d=np.array([0.0, 0.1]) + rng.normal(0.0, 0.01, (B, 2)),
        um1=np.tile([300.157, 0.1], (B, 1)),
        lamy=rng.normal(0.0, 0.01, (B, cfg.ny * cfg.nu)))


@pytest.fixture(scope="module")
def sweeps():
    """Per Hessian mode: the JAX vmapped stage derivatives, JAX's
    make_stage_sweep under vmap (exact; Gauss-Newton repeats the former),
    and the port's plain sweep."""
    from mpc_code_tpu.solver.riccati import make_stage_derivs
    from mpc_code_tpu.solver.sweep_kernel import make_stage_sweep as j_sweep
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    jcfg, js, ps = _ocps()
    a = _inputs(ps, jcfg)
    p = {k: jnp.asarray(a[k]) for k in ("xs", "us", "d", "um1", "t", "px", "py")}
    p["lam"] = jnp.asarray(a["lamy"].reshape(B, jcfg.ny, jcfg.nu))
    p["_sf"] = jnp.asarray(a["sf"])
    p["x0"] = jnp.asarray(a["X"][:, 0])
    args = (jnp.asarray(a["X"]), jnp.asarray(a["U"]), p, jnp.asarray(a["lam"]),
            jnp.asarray(a["nus"]), jnp.zeros((B, N, 0)))
    ks = jnp.arange(N)
    out = {}
    for hess in ("exact", "gauss_newton"):
        sd = make_stage_derivs(js, hess)
        v_stage = jax.vmap(sd, in_axes=(0, 0, 0, None, 0, 0, 0))

        def ref(X, U, pp, lam, nus, muh, v_stage=v_stage):
            return v_stage(X, U, ks, pp, lam, nus, muh)

        if hess == "exact":
            run = jax.jit(lambda *q, ref=ref, sw=j_sweep(sd, N): (
                jax.vmap(ref)(*q), jax.vmap(sw)(*q)))
            jv, jk = jax.device_get(run(*args))
        else:
            jv = jk = jax.device_get(jax.jit(jax.vmap(ref))(*args))
        keep = (0, 1, 2, 3, 4, 5, 8)             # without Cz, hval
        T = {k: torch.tensor(v) for k, v in a.items()}
        got = make_stage_sweep(ps, hess)(
            T["X"], T["U"], T["lam"], T["nus"], T["px"], T["py"],
            torch.zeros((B, N, 0), dtype=torch.float64), T["t"],
            T["sf"], T["xs"], T["us"], T["d"], T["um1"], T["lamy"])
        out[hess] = ([np.asarray(jv[i]) for i in keep],
                     [np.asarray(jk[i]) for i in keep], [g.numpy() for g in got])
    return out


NAMES = ("H", "gc", "A", "B", "E", "ival", "dval")


def _nerr(a, b):
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


@pytest.mark.parametrize("hessian", ["exact", "gauss_newton"])
def test_plain_sweep_matches_jax(sweeps, hessian):
    jv, jk, got = sweeps[hessian]
    for name, r, k, g in zip(NAMES, jv, jk, got):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert np.isfinite(g).all(), name
        assert _nerr(g, r) <= 1e-10, (name, _nerr(g, r))
        assert _nerr(g, k) <= 1e-10, (name, _nerr(g, k))
    H = got[0]
    assert np.abs(H - np.swapaxes(H, -1, -2)).max() <= 1e-10 * (1 + np.abs(H).max())


def test_exact_hessian_adds_the_multiplier_terms(sweeps):
    """The exact and the Gauss-Newton H differ by the curvature of the
    dynamics and rows weighted with the multipliers; every other output is
    the same; on the tie lane the guard's second derivative adds nothing
    the references do not."""
    ex, gn = sweeps["exact"][2], sweeps["gauss_newton"][2]
    for name, a, b in zip(NAMES[1:], ex[1:], gn[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.abs(ex[0] - gn[0]).max() > 1e-3
    jv = sweeps["exact"][0][0]
    assert _nerr(ex[0][TIE_LANE], jv[TIE_LANE]) <= 1e-10


def _point(ps, cfg, lane=TIE_LANE, stage=2):
    """One point's inputs of the lowered cost and rows, in user units."""
    a = _inputs(ps, cfg)
    T = lambda v: torch.tensor(np.asarray(v, float))  # noqa: E731
    xa = T(a["X"][lane, stage] * ps.sxa)
    u = T(a["U"][lane, stage] * ps.su)
    rest = dict(t=T(a["t"][lane]), xs=T(a["xs"][lane]), us=T(a["us"][lane]),
                d=T(a["d"][lane]), um1=T(a["um1"][lane]), lam=T(a["lamy"][lane]),
                py=T(a["py"][lane, stage]), py0=T(a["py"][lane, 0]))
    return xa, u, rest


@pytest.mark.parametrize("which", ["cost", "ineq"])
def test_lowered_stage_functions_match_torch(which):
    """The generated statements of the stage cost and the rows, run in
    Python, against the torch functions they were lowered from: value,
    gradient and Hessian with respect to z = (xa, u)."""
    from mpc_code_tpu_torch.solver.riccati import POINT_ARGS
    from mpc_code_tpu_torch.solver.sweep_kernel import stage_programs

    jcfg, _, ps = _ocps()
    low = ps.lowering
    progs = dict(zip(("ode", "cost", "ineq"), stage_programs(
        low, ps.nxa, ps.nu, ps.ni, jcfg.nd, jcfg.npx, jcfg.npy)))
    prog, fn = progs[which], getattr(low, which)
    xa, u, rest = _point(ps, jcfg)
    nx = ps.nxa
    mat = dict(rest, lam=rest["lam"].reshape(jcfg.ny, jcfg.nu))

    def lowered(z):
        return torch.stack(prog.execute(xa=z[:nx], u=z[nx:], **rest)).reshape(-1)

    def direct(z):
        return fn(z[:nx], z[nx:], *[mat[k] for k in POINT_ARGS]).reshape(-1)

    z = torch.cat([xa, u])
    assert torch.allclose(lowered(z), direct(z), rtol=1e-14, atol=0)
    J_l, J_d = torch.func.jacrev(lowered)(z), torch.func.jacrev(direct)(z)
    assert torch.allclose(J_l, J_d, rtol=1e-12, atol=1e-14)
    H_l, H_d = torch.func.hessian(lowered)(z), torch.func.hessian(direct)(z)
    assert torch.allclose(H_l, H_d, rtol=1e-12, atol=1e-14)
    assert prog.ops > 0


def test_ops_per_lane_pinned_at_bench_dims():
    """What the generator emits for the bench OCP (N=50, Mx=10), exact and
    Gauss-Newton: the count behind kernel 5's bound.  The quadratic forms
    of the stage cost keep their products by the weights' zero entries
    (``inf * 0`` is nan, F8).  Under Gauss-Newton H is the cost's Hessian
    alone: the RK4 rollout and the rows carry first-order tangents only."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    jcfg, _, ps = _ocps(Mx=10, Nh=50)
    dims = (ps.nxa, ps.nu, ps.ni, jcfg.nd, jcfg.npx, jcfg.npy)
    assert dims == (3, 2, 2, 2, 3, 2)
    assert make_stage_sweep(ps, "exact").ops_per_lane(*dims) == 45486
    assert make_stage_sweep(ps, "gauss_newton").ops_per_lane(*dims) == 10491
