"""The port's DARE (``ops/dare.py``) and the DARE terminal cost against the JAX package, CPU, f64.

- ``solve_dare`` on seeded random stabilisable pairs (n=4, m=2; A with
  spectral radius 1.2, so open-loop unstable) against JAX's ``solve_dare``
  and ``scipy.linalg.solve_discrete_are``, normalised error
  ``|a-b|/(1+|b|)`` at most 1e-10 (measured, JAX and scipy together:
  1.8e-14), and its residual in the Riccati equation.
- ``solve_dare`` on a leading batch dimension equals it matrix by matrix
  (measured 1.5e-15).
- ``dare_gain`` (K and P) against JAX's at 1e-10 (measured 1.7e-15).
- The ``terminal.riccati`` branch of ``build_terminal_cost`` against JAX's
  on ``lmpc_cstr``'s linear model and QP stage cost, at seeded points, at
  1e-10 (measured 0.0).

About 7 s in one process (builder's CPU run).
"""

import numpy as np
import pytest
import scipy.linalg as scla
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
SEEDS = (0, 1, 2)


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _pair(seed, n=4, m=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A *= 1.2 / np.abs(np.linalg.eigvals(A)).max()
    B = rng.standard_normal((n, m))
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 0.1 * np.eye(n)
    W = rng.standard_normal((m, m))
    R = W @ W.T + np.eye(m)
    return A, B, Q, R


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_dare_matches_jax_and_scipy(seed):
    from mpc_code_tpu.ops.dare import solve_dare as jax_dare
    from mpc_code_tpu_torch.ops.dare import solve_dare

    A, B, Q, R = _pair(seed)
    P = solve_dare(*(torch.as_tensor(M) for M in (A, B, Q, R))).numpy()
    assert _nerr(P, np.asarray(jax_dare(*(jnp.asarray(M) for M in (A, B, Q, R))))) <= TOL
    assert _nerr(P, scla.solve_discrete_are(A, B, Q, R)) <= TOL
    res = (A.T @ P @ A - P - A.T @ P @ B @ np.linalg.solve(B.T @ P @ B + R, B.T @ P @ A) + Q)
    assert np.abs(res).max() <= TOL * (1 + np.abs(P).max())


def test_solve_dare_batched():
    from mpc_code_tpu_torch.ops.dare import solve_dare

    mats = [_pair(s) for s in SEEDS]
    stacked = [torch.as_tensor(np.stack([m[i] for m in mats])) for i in range(4)]
    Pb = solve_dare(*stacked).numpy()
    for k, m in enumerate(mats):
        Pk = solve_dare(*(torch.as_tensor(M) for M in m)).numpy()
        assert _nerr(Pb[k], Pk) <= TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_dare_gain_matches_jax(seed):
    from mpc_code_tpu.ops.dare import dare_gain as jax_gain
    from mpc_code_tpu_torch.ops.dare import dare_gain

    A, B, Q, R = _pair(seed)
    C = B.T          # an (m, n) output matrix
    Qe, Re = Q, R
    K, P = dare_gain(*(torch.as_tensor(M) for M in (A, C, Qe, Re)))
    Kj, Pj = jax_gain(*(jnp.asarray(M) for M in (A, C, Qe, Re)))
    assert _nerr(K.numpy(), np.asarray(Kj)) <= TOL
    assert _nerr(P.numpy(), np.asarray(Pj)) <= TOL


def test_riccati_terminal_cost_matches_jax():
    """``lmpc_cstr``: a LinearModel with a QP stage cost, so the config
    derives ``terminal.riccati`` and Vfin(dx) = 0.5 dx' P dx with P from
    DARE(A, B, Q, R)."""
    from mpc_code_tpu.examples.lmpc_cstr import make_config as make_jax
    from mpc_code_tpu.models import build_terminal_cost as jax_vfin
    from mpc_code_tpu_torch import config as pc
    from mpc_code_tpu_torch.models import build_terminal_cost

    jcfg = make_jax()
    assert jcfg.terminal.riccati
    m, sc = jcfg.model, jcfg.stage_cost
    pcfg = pc.MPCConfig(nx=jcfg.nx, nu=jcfg.nu, ny=jcfg.ny, nd=jcfg.nd,
                        model=pc.LinearModel(A=np.asarray(m.A), B=np.asarray(m.B),
                                             C=np.asarray(m.C)),
                        stage_cost=pc.StageCost(Q=np.asarray(sc.Q), R=np.asarray(sc.R)))
    assert pcfg.terminal.riccati
    vf, vj = build_terminal_cost(pcfg), jax_vfin(jcfg)
    rng = np.random.default_rng(3)
    for _ in range(4):
        dx, xs = rng.standard_normal(jcfg.nx), rng.standard_normal(jcfg.nx)
        got = float(vf(torch.as_tensor(dx), torch.as_tensor(xs)))
        ref = float(vj(jnp.asarray(dx), jnp.asarray(xs)))
        assert abs(got - ref) / (1 + abs(ref)) <= TOL
    with pytest.raises(ValueError, match="linear model"):
        build_terminal_cost(pcfg.replace(model=pc.ContinuousModel(fx=None),
                                         terminal=pc.TerminalCost(riccati=True)))
