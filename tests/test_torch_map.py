"""The port's discrete-map stage-Jacobian sweep against the JAX package, CPU, f64.

The plain version of ``integrators.map_stage_jac`` (one evaluation plus
nx+nu forward tangents on lanes-minor planes) against JAX's batched rule,
``jax.vmap(map_stage_jac(f))`` in the lanes-minor XLA layout
(MPC_TPU_SWEEP_IMPL=lanes), on two maps: the toy map of
``tests/test_ops.py::test_map_stage_jac_matches_jacfwd`` and the
quadruple tank's ``model_fxm`` (Ex_NMPC_dis) with its RK4 at MX_TANK = 2
sub-steps (the example takes 5; two carry the levels and their tangents
across a sub-step boundary, all the loop does, and JAX traces the lanes
rule of five sub-steps several times longer), whose levels include one
exactly on the clip bound 20 (JAX's derivative there is 0.5, F1), one
above it, and an empty tank with no inflow, where the square root's
tangent is not finite in JAX and must not be finite in the port either.
Then the code generator's lowering of the tank map, the operation count
behind kernel 3's bound, and the wrapper's refusal to run the plain
version for a tensor that is not on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
B, N = 2, 3
MX_TANK = 2


def _toy_jax(x, u, d, t, px):
    return jnp.stack([0.9 * x[0] + 0.1 * jnp.tanh(x[1]) + u[0],
                      x[1] - 0.2 * x[0] * u[0] + px[0] + d[0] * t])


def _toy_port(x, u, d, t, px):
    return torch.stack([0.9 * x[0] + 0.1 * torch.tanh(x[1]) + u[0],
                        x[1] - 0.2 * x[0] * u[0] + px[0] + d[0] * t])


def _toy_inputs():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(B, N, 2)), rng.normal(size=(B, N, 1)),
            rng.normal(size=(B, N, 1)), rng.normal(size=(B,)), rng.normal(size=(B, 1))]


def _tank_inputs():
    """Valve states and inputs around u0, levels over the workload's boxes;
    lane 0: tank 1 exactly on the clip bound 20 at stage 0, tank 2 above it
    at stage 1; lane 1: tank 3 empty with no inflow at stage 0."""
    rng = np.random.default_rng(2)
    xs = np.concatenate([rng.uniform(30, 50, (B, N, 2)), rng.uniform(6, 14, (B, N, 2)),
                         rng.uniform(0.5, 3, (B, N, 2))], -1)
    us = rng.uniform(30, 50, (B, N, 2))
    xs[0, 0, 2] = 20.0
    xs[0, 1, 3] = 21.0
    xs[1, 0, 4] = 0.0
    us[1, 0, 1] = 0.0
    return [xs, us, rng.normal(size=(B, N, 6)) * 1e-3, np.zeros(B),
            rng.uniform(-0.5, 0.5, (B, 2))]


def _maps():
    from mpc_code_tpu.examples import nmpc_dis as jd
    from mpc_code_tpu_torch.examples import nmpc_dis as pd

    def tank_jax(x, u, d, t, px):
        return jnp.concatenate([u, jd._rk4_tanks(x[2:6], u, Mx=MX_TANK)])

    def tank_port(x, u, d, t, px):
        return torch.cat([u, pd._rk4_tanks(x[2:6], u, Mx=MX_TANK)])

    return {"toy": (_toy_jax, _toy_port, _toy_inputs()),
            "tank": (tank_jax, tank_port, _tank_inputs())}


@pytest.fixture(scope="module")
def jax_refs():
    """``jax.vmap(map_stage_jac(f))`` of both maps, jitted, lanes layout."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        from mpc_code_tpu.ops.integrators import map_stage_jac

        out = {}
        for name, (fj, _, ins) in _maps().items():
            F = jax.jit(jax.vmap(map_stage_jac(fj)))
            out[name] = [np.asarray(a) for a in F(*[jnp.asarray(a) for a in ins])]
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", ["toy", "tank"])
def test_plain_map_sweep_matches_jax(jax_refs, case):
    """xf, Jx and Ju to 1e-10; the non-finite entries in the same places."""
    from mpc_code_tpu_torch.ops.integrators import map_stage_jac

    _, fp, ins = _maps()[case]
    got = map_stage_jac(fp)(*[torch.tensor(a) for a in ins])
    for g, r in zip(got, jax_refs[case]):
        g = g.numpy()
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r))
        fin = np.isfinite(r)
        assert np.abs(g[fin] - r[fin]).max() <= TOL
    if case == "tank":
        xf, Jx, Ju = (a.numpy() for a in got)
        # the valve rows copy u: exact identity and zero columns
        np.testing.assert_array_equal(Ju[..., :2, :],
                                      np.broadcast_to(np.eye(2), Ju[..., :2, :].shape))
        assert not Jx[..., :2, :].any()
        # the tie and the level above the bound give finite derivatives;
        # only the empty tank's stage has non-finite ones
        assert np.isfinite(Jx[0]).all() and not np.isfinite(Jx[1, 0]).all()
        assert np.isfinite(Jx[1, 1:]).all() and np.isfinite(xf).all()


def test_codegen_lowers_tank_map():
    """The tank map lowers, ``torch.cat`` and the slice ``x[2:6]``
    included; its statements run in Python and give the map's values and
    tangents on lanes-minor inputs; the clip against 0-d constants becomes
    literal bounds."""
    from mpc_code_tpu_torch.examples.nmpc_dis import model_fxm
    from mpc_code_tpu_torch.ops.sweep_map_cuda import emit_map_source, map_program

    src = emit_map_source(model_fxm, 6, 2, 2, 6)
    for frag in ("#define MPC_NX 6", "#define MPC_NPX 6", "mpc_map(",
                 "mpc_max(x[2], S(0.0))", "mpc_sqrt(", "out[0] = u[0];",
                 "out[1] = u[1];", "out[5] ="):
        assert frag in src, frag
    prog = map_program(model_fxm, 6, 2, 2, 6)
    rng = np.random.default_rng(3)
    L = 5
    x = torch.tensor(np.concatenate([rng.uniform(30, 50, (2, L)),
                                     rng.uniform(0.5, 21, (4, L))]))
    x[2, 0] = 20.0
    u = torch.tensor(rng.uniform(0, 100, (2, L)))
    rest = dict(d=torch.zeros(2, L, dtype=torch.float64), t=torch.zeros(L, dtype=torch.float64),
                px=torch.zeros(6, L, dtype=torch.float64))
    tx, tu = torch.tensor(rng.normal(size=(6, L))), torch.tensor(rng.normal(size=(2, L)))

    def run_prog(xx, uu):
        return torch.stack([torch.as_tensor(o).expand(L) for o in
                            prog.execute(x=xx, u=uu, **rest)])

    def run_map(xx, uu):
        return model_fxm(xx, uu, rest["d"], rest["t"], rest["px"])

    got = torch.func.jvp(run_prog, (x, u), (tx, tu))
    ref = torch.func.jvp(run_map, (x, u), (tx, tu))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-12)


def test_map_operation_count_is_pinned():
    """Kernel 3's bound counts one evaluation of the map on numbers with 8
    tangents: 20 right-hand sides (4 clipped levels, 4 square roots, the
    inflows) and the RK4 combination, 812 statements."""
    from mpc_code_tpu_torch.examples.nmpc_dis import model_fxm
    from mpc_code_tpu_torch.ops.sweep_map_cuda import map_bytes, map_ops_per_lane, map_program

    assert len(map_program(model_fxm, 6, 2, 2, 6).lines) == 812
    assert map_ops_per_lane(model_fxm, 6, 2, 2, 6) == 7316
    assert map_bytes(4, 50, 6, 2, 2, 6, 4) == 4 * (14 * 200 + 3 * 4 + 54 * 200)


def test_map_wrapper_refuses_non_cpu_tensors(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    from mpc_code_tpu_torch.ops.sweep_map_cuda import MapStageJac

    F = MapStageJac(_toy_port)

    def no_plain(*a):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(F, "plain", no_plain)
    args = [torch.tensor(a).to("meta") for a in _toy_inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        F(*args)
    monkeypatch.undo()
    cpu = [torch.tensor(a) for a in _toy_inputs()]
    for g, r in zip(F(*cpu), F.plain(*cpu)):
        assert torch.equal(g, r)
