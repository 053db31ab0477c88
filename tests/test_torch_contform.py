"""The port's ContForm joint sweep against the JAX package, CPU, f64.

The plain ``rk4_quad_stage_hess`` against JAX's batched lanes rule
(``jax.vmap`` of ``integrators.rk4_quad_stage_hess`` with
MPC_TPU_SWEEP_IMPL=lanes): on the ODE and quadrature of
``tests/test_ops.py`` at Mx=2 sub-steps, which carries the derivatives
across a sub-step boundary, and on Ex_ENMPC's ContForm pair as the port's
``build_structured_ocp`` builds it, against the same pair built from the
JAX model as ``riccati.py:321-327`` builds it, at Mx=1 (the JAX trace
grows with Mx).  Then the scaling of the port's ``stage_cf``, the code generator that
feeds the CUDA kernel, and the wrapper's refusal to run the plain version
off the CPU.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, MX = 3, 2
MX_ENMPC = 1


def _jax_pair():
    def ode(x, t, u, d, px, xss, uss, py):
        return jnp.stack([x[1] - jnp.exp(-x[0]) + u[0] + px[0],
                          -x[0] * x[1] + d[0] + 0.1 * t])

    def quad(x, t, u, d, px, xss, uss, py):
        return u[0] * (0.3 - x[1]) + 0.5 * (x[0] - xss[0]) ** 2 + py[0] * u[0] ** 2

    return ode, quad


def _port_pair():
    def ode(x, t, u, d, px, xss, uss, py):
        return torch.stack([x[1] - torch.exp(-x[0]) + u[0] + px[0],
                            -x[0] * x[1] + d[0] + 0.1 * t])

    def quad(x, t, u, d, px, xss, uss, py):
        return u[0] * (0.3 - x[1]) + 0.5 * (x[0] - xss[0]) ** 2 + py[0] * u[0] ** 2

    return ode, quad


def _sweep_args(seed=2, B=4):
    rng = np.random.default_rng(seed)
    a = lambda *s: rng.normal(size=s) * 0.3  # noqa: E731
    return [a(B, N, 2), a(B, N, 1), a(B, N, 1), a(B, N, 1), a(B),
            np.full(B, 0.25), a(B, 1), a(B, 2), a(B, 1)]


def _enmpc_cfgs():
    from mpc_code_tpu.examples.enmpc import make_config as make_jax
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as make_port

    jcfg = make_jax().replace(N=N)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX_ENMPC))
    return jcfg, config_from_numpy(jcfg, make_port())


def _jax_enmpc_pair(jcfg):
    from mpc_code_tpu.models import build_model, build_stage_cost

    model = build_model(jcfg)
    user_fx, f_obj = jcfg.model.fx, build_stage_cost(jcfg.stage_cost)

    def ode(x, t, u, d, px, xs, us, py):
        return user_fx(x, u, d, t, px) + px

    def quad(x, t, u, d, px, xs, us, py):
        y = model.fy(x, u, d, t, py)
        return f_obj(x, u, y, xs, us, model.fy(xs, us, d, t, py))

    return ode, quad


def _enmpc_sweep_args(seed=4, B=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform([0.3, 0.2], [0.9, 0.6], size=(B, N, 2)),
            rng.uniform(0.4, 1.6, size=(B, N, 1)),
            rng.normal(size=(B, N, 2)) * 1e-2, rng.normal(size=(B, N, 2)) * 1e-2,
            rng.uniform(0, 1, B), np.full(B, 2.0), rng.uniform(-0.05, 0.05, (B, 2)),
            rng.uniform([0.4, 0.4], [0.6, 0.5], (B, 2)), rng.uniform(0.8, 1.2, (B, 1))]


def _port_ocp(pcfg):
    from mpc_code_tpu_torch.models import (
        build_model, build_stage_cost, build_terminal_cost,
    )
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(pcfg, build_model(pcfg),
                                build_stage_cost(pcfg.stage_cost),
                                build_terminal_cost(pcfg), device="cpu")


@pytest.fixture(scope="module")
def jax_refs():
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        from mpc_code_tpu.ops.integrators import rk4_quad_stage_hess

        out = {}
        for case, pair, args, mx in (
                ("pair", _jax_pair(), _sweep_args(), MX),
                ("enmpc", _jax_enmpc_pair(_enmpc_cfgs()[0]), _enmpc_sweep_args(),
                 MX_ENMPC)):
            F = jax.jit(jax.vmap(rk4_quad_stage_hess(*pair, mx)))
            out[case] = jax.device_get(F(*[jnp.asarray(a) for a in args]))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", ["pair", "enmpc"])
def test_plain_sweep_matches_jax(jax_refs, case):
    """All six outputs (xf, Jx, Ju, qv, gq, Hq) to 1e-10, normalised."""
    if case == "pair":
        from mpc_code_tpu_torch.ops.integrators import rk4_quad_stage_hess

        F, args = rk4_quad_stage_hess(*_port_pair(), MX), _sweep_args()
    else:
        F, args = _port_ocp(_enmpc_cfgs()[1]).sweep, _enmpc_sweep_args()
    got = F(*[torch.tensor(a) for a in args])
    ref = jax_refs[case]
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        err = np.abs(g.numpy() - r) / (1 + np.abs(r))
        assert err.max() <= 1e-10, err.max()


def test_stage_cf_scales_the_sweep():
    """``stage_cf`` works in scaled units x~ = x / sxa, u~ = u / su (here
    su = 2 from the input box [0, 2]), as JAX ``riccati.py:701-715``."""
    ocp = _port_ocp(_enmpc_cfgs()[1])
    xs, us, pxs, pys, t, h, d, x_ss, u_ss = [torch.tensor(a) for a in _enmpc_sweep_args()]
    p = dict(px=pxs, py=pys, t=t, d=d, xs=x_ss, us=u_ss)
    dval, A, Bm, qv, gq, Hq = ocp.stage_cf(xs, us / 2.0, p)
    xf, Jx, Ju, qv0, gq0, Hq0 = ocp.sweep(xs, us, pxs, pys, t, h, d, x_ss, u_ss)
    sz = torch.tensor([1.0, 1.0, 2.0], dtype=torch.float64)
    for got, want in ((dval, xf), (A, Jx), (Bm, 2.0 * Ju), (qv, qv0), (gq, gq0 * sz),
                      (Hq, Hq0 * sz[:, None] * sz[None, :])):
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)


def test_codegen_lowers_enmpc_contform():
    """Ex_ENMPC's ContForm functions take eight arguments, add ``px`` as a
    whole vector and read ``(x + Cd @ d + py)[1]``; the lowered statements
    run in Python and give the functions' values on lanes-minor inputs.
    Products and quotients by the model's unit constants (K1 = V = 1) are
    folded, the product by ``Cd``'s zero entry is kept (``inf * 0`` is nan,
    F8) and the unused ``y[0]`` is dropped, so the count per lane is 10
    sub-steps x (4 x (148 ODE + 67 quadrature operations) + 330 for the RK4
    combination), on numbers with 3 tangents and 6 second-order ones."""
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import (
        cf_bytes, cf_ops_per_lane, cf_programs, emit_cf_source,
    )

    sweep = _port_ocp(_enmpc_cfgs()[1]).sweep
    src = emit_cf_source(sweep.f, sweep.q, 2, 1, 2, 2, 2, 10)
    for frag in ("#define MPC_NPY 2", "#define MPC_MX 10", "mpc_quad(",
                 "(v_sub_2 + px[1]);", "auto v_add__1 = (x[1] + v_matmul__1__s1);",
                 "(v_add__1 + py[1]);", "out[1] ="):
        assert frag in src, frag
    ode, quad = cf_programs(sweep.f, sweep.q, 2, 1, 2, 2, 2)
    rng = np.random.default_rng(0)
    L = 5
    ins = {k: torch.tensor(rng.normal(size=(n, L))) for k, n in
           (("x", 2), ("u", 1), ("d", 2), ("px", 2), ("xs", 2), ("us", 1), ("py", 2))}
    ins["t"] = torch.tensor(rng.normal(size=L))
    args = [ins[k] for k in ("x", "t", "u", "d", "px", "xs", "us", "py")]
    torch.testing.assert_close(torch.stack(ode.execute(**ins)), sweep.f(*args),
                               rtol=0, atol=0)
    torch.testing.assert_close(quad.execute(**ins)[0], sweep.q(*args), rtol=0, atol=0)
    # Cd = I: row 1 of the mat-vec folds its product by 1 and keeps the
    # one by 0, which turns an infinite d[0] into nan as torch does (F8)
    assert "(S(0.0) * d[0])" in quad.body and "(v_matmul__1__m0 + d[1])" in quad.body
    assert "S(1.0) *" not in ode.body and "/ S(1.0)" not in ode.body
    assert "py[0]" not in quad.body
    assert (ode.ops, quad.ops) == (148, 67)
    assert cf_ops_per_lane(sweep.f, sweep.q, 2, 1, 2, 2, 2, 10) == 11900
    assert cf_bytes(4, 25, 2, 1, 2, 2, 2, 4) == 4 * (7 * 100 + 7 * 4 + 21 * 100)


def test_cf_codegen_rejects_unsupported_op():
    """An op outside the generator's list (``digamma``; the quadratures
    with ``tanh`` and ``fmod`` this test once refused are lowered now)
    raises, naming it."""
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import emit_cf_source

    ode, _ = _port_pair()

    def quad(x, t, u, d, px, xss, uss, py):
        return torch.digamma(x[0]) * u[0]

    with pytest.raises(NotImplementedError, match="digamma"):
        emit_cf_source(ode, quad, 2, 1, 1, 1, 1, 3)


def test_cf_wrapper_refuses_non_cpu_tensors(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    from mpc_code_tpu_torch.ops.sweep_cf_cuda import Rk4QuadStageHess

    F = Rk4QuadStageHess(*_port_pair(), MX)

    def no_plain(*a):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(F, "plain", no_plain)
    args = [torch.tensor(a).to("meta") for a in _sweep_args()]
    with pytest.raises(ValueError, match="CUDA"):
        F(*args)
    cpu = [torch.tensor(a) for a in _sweep_args()]
    monkeypatch.undo()
    for g, r in zip(F(*cpu), F.plain(*cpu)):
        assert torch.equal(g, r)
