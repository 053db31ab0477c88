"""The port's ops against the JAX package, CPU, f64: small linear algebra
with NaN per failing lane (F2), the RK4 stage-Jacobian sweep's plain
version including a state exactly on the clip bound (F1), and the CUDA
sweep's code generator."""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CLIP_LO = np.array([0.0, 280.0, 0.4])
CLIP_HI = np.array([2.0, 420.0, 1.0])


def _spd_batch(seed=0, n=3, B=4, bad=2):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(n)
    A[bad] = -A[bad]                       # indefinite lane
    return A


def test_chol_nan_on_indefinite_lane_only():
    from mpc_code_tpu_torch.ops.smalllin import chol, cho_solve

    A = _spd_batch()
    ref = np.asarray(jax.vmap(jnp.linalg.cholesky)(jnp.asarray(A)))
    got = chol(torch.tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(got).any((1, 2)), [False, False, True, False])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.abs(got[ok] - ref[ok]).max() < 1e-12
    b = np.random.default_rng(1).normal(size=(4, 3))
    x = cho_solve(torch.tensor(got), torch.tensor(b)).numpy()
    assert np.isnan(x[2]).all() and np.isfinite(x[[0, 1, 3]]).all()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A[0:1], x[0:1]), b[0:1],
                               atol=1e-10)


def test_solve_lu_nan_on_singular_lane_only():
    from mpc_code_tpu_torch.ops.smalllin import solve_lu

    A = _spd_batch(bad=1)
    A[3] = np.zeros((3, 3))                # singular lane
    b = np.random.default_rng(2).normal(size=(4, 3))
    x = solve_lu(torch.tensor(A), torch.tensor(b)).numpy()
    assert np.isnan(x[3]).all()
    ref = np.linalg.solve(A[:3], b[:3, :, None])[..., 0]
    assert np.abs(x[:3] - ref).max() < 1e-10


@pytest.mark.parametrize("name", ["sqrtm_psd", "solve_sym"])
def test_linalg_matches_jax(name):
    from mpc_code_tpu.ops import linalg as jl
    from mpc_code_tpu_torch.ops import linalg as pl

    rng = np.random.default_rng(4)
    M = rng.normal(size=(4, 4))
    M = M @ M.T + 0.1 * np.eye(4)
    b = rng.normal(size=4)
    if name == "sqrtm_psd":
        ref, got = jl.sqrtm_psd(jnp.asarray(M)), pl.sqrtm_psd(torch.tensor(M))
        np.testing.assert_allclose(got.numpy() @ got.numpy(), M, atol=1e-10)
    else:
        ref = jl.solve_sym(jnp.asarray(M), jnp.asarray(b), reg=1e-3)
        got = pl.solve_sym(torch.tensor(M), torch.tensor(b), reg=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10)


def test_saturate_tie_derivative_is_half():
    """F1: at an exact bound the guard's derivative is JAX's 0.5."""
    from mpc_code_tpu_torch.ops.integrators import saturate

    x = torch.tensor([0.0, 300.0, 1.0], dtype=torch.float64)
    _, t = torch.func.jvp(lambda z: saturate(z, CLIP_LO, CLIP_HI), (x,),
                          (torch.ones(3, dtype=torch.float64),))
    jt = jax.jvp(lambda z: jnp.clip(z, CLIP_LO, CLIP_HI), (jnp.asarray(x.numpy()),),
                 (jnp.ones(3),))[1]
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(t.numpy(), [0.5, 1.0, 0.5])


def _sweep_inputs(B, N, seed, on_bound):
    rng = np.random.default_rng(seed)
    xs = rng.uniform([0.3, 318.0, 0.55], [0.95, 340.0, 0.70], size=(B, N, 3))
    if on_bound:
        xs[0, :, 1] = CLIP_LO[1]
        xs[1, :, 0] = CLIP_HI[0]
        xs[2, :, 2] = CLIP_LO[2]
    us = rng.uniform([295.0, 0.0], [305.0, 0.25], size=(B, N, 2))
    pxs = rng.normal(size=(B, N, 3)) * 1e-3
    t = rng.uniform(0, 1, B)
    h = np.full(B, 0.2)
    d = np.stack([np.zeros(B), rng.uniform(0.08, 0.12, B)], 1)
    return xs, us, pxs, t, h, d


@pytest.fixture(scope="module")
def jax_rk4_sweep():
    """JAX's lanes-minor sweep of the CSTR ODE, jitted once for both cases."""
    from mpc_code_tpu.examples.nmpc import model_fxm as jfx
    from mpc_code_tpu.ops.integrators import rk4_stage_jac as j_rk4

    def jode(x, t, u, d, px):
        return jfx(x, u, d, t, px)

    return jax.jit(jax.vmap(j_rk4(jode, 4, clip_lo=CLIP_LO, clip_hi=CLIP_HI,
                                  impl="lanes")))


@pytest.mark.parametrize("on_bound", [False, True])
def test_rk4_stage_jac_plain_matches_jax(jax_rk4_sweep, on_bound):
    from mpc_code_tpu_torch.examples.nmpc import model_fxm as pfx
    from mpc_code_tpu_torch.ops.integrators import rk4_stage_jac as p_rk4

    def pode(x, t, u, d, px):
        return pfx(x, u, d, t, px)

    args = _sweep_inputs(3, 4, seed=7, on_bound=on_bound)
    ref = jax_rk4_sweep(*[jnp.asarray(a) for a in args])
    got = p_rk4(pode, 4, clip_lo=CLIP_LO, clip_hi=CLIP_HI)(
        *[torch.tensor(a) for a in args])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r) / (1 + np.abs(r))
        assert err.max() <= 1e-10, err.max()


def test_rk4_model_matches_jax():
    from mpc_code_tpu.examples.nmpc import make_config as j_make
    from mpc_code_tpu.models import build_model as j_build
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc import make_config as p_make
    from mpc_code_tpu_torch.models import build_model as p_build

    jcfg = j_make()
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=4, clip_lo=CLIP_LO,
                                         clip_hi=CLIP_HI))
    pcfg = config_from_numpy(jcfg, p_make())
    x = np.array([0.6, 330.0, 0.6])
    u = np.array([300.0, 0.12])
    d = np.array([0.0, 0.1])
    px = np.array([1e-3, 0.0, -1e-3])
    ref = np.asarray(j_build(jcfg).fx(jnp.asarray(x), jnp.asarray(u), 0.2,
                                      jnp.asarray(d), 0.0, jnp.asarray(px)))
    got = p_build(pcfg).fx(*[torch.tensor(a) for a in (x, u)], 0.2,
                           torch.tensor(d), 0.0, torch.tensor(px)).numpy()
    assert np.abs(got - ref).max() / (1 + np.abs(ref).max()) < 1e-12


def _ode(x, t, u, d, px):
    from mpc_code_tpu_torch.examples.nmpc import model_fxm

    return model_fxm(x, u, d, t, px)


def test_codegen_emits_cstr_source():
    """The CSTR ODE's ``Ar * x[2]`` appears twice and is computed once; the
    count per lane is 10 sub-steps x (4 x (139 ODE + 36 guard operations)
    + 234 for the RK4 combination), on numbers with 5 tangents."""
    from mpc_code_tpu_torch.ops.sweep_cuda import emit_rhs_source, sweep_ops_per_lane

    src = emit_rhs_source(_ode, 3, 2, 2, 3, 10, CLIP_LO, CLIP_HI)
    for frag in ("#define MPC_NX 3", "#define MPC_MX 10", "mpc_exp(",
                 "out[2] =", "xc[1] = mpc_min(mpc_max(x[1], S(280.0)), S(420.0));",
                 "auto v_getitem = d[1];"):
        assert frag in src, frag
    assert src.count("* v_getitem_4)") == 1
    assert sweep_ops_per_lane(_ode, 3, 2, 10, CLIP_LO, CLIP_HI) == 9340


def test_codegen_rejects_unsupported_op():
    """An op outside the generator's list (``erfinv``; ``tanh`` and the
    other elementary functions are lowered) raises, naming it."""
    from mpc_code_tpu_torch.ops.sweep_cuda import emit_rhs_source

    def ode(x, t, u, d, px):
        return torch.stack([torch.erfinv(x[0]), x[1] * u[0], x[2]])

    with pytest.raises(NotImplementedError, match="erfinv"):
        emit_rhs_source(ode, 3, 2, 2, 3, 4)


def test_sweep_wrapper_uses_plain_only_on_cpu():
    """CPU tensors run the plain version; the kernel path refuses them."""
    from mpc_code_tpu_torch.ops.sweep_cuda import Rk4StageJac

    F = Rk4StageJac(_ode, 3, clip_lo=CLIP_LO, clip_hi=CLIP_HI)
    args = [torch.tensor(a) for a in _sweep_inputs(2, 3, seed=3, on_bound=False)]
    for g, r in zip(F(*args), F.plain(*args)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="CUDA"):
        F.launch(*args)
