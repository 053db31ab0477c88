"""The port's plain Riccati KKT solve against the JAX ``_riccati_ref``
under vmap, CPU, f64, including a lane whose Quu is indefinite."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

NXA, NU, B, N = 3, 2, 5, 6
BAD = 3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    nz = NXA + NU
    M = rng.normal(size=(B, N, nz, nz)) * 0.5
    Hs = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(nz)
    Hs[BAD, 2, NXA:, NXA:] = -50.0 * np.eye(NU)
    q = rng.normal(size=(B, N, nz))
    A = 0.9 * np.eye(NXA) + 0.1 * rng.normal(size=(B, N, NXA, NXA))
    Bm = rng.normal(size=(B, N, NXA, NU)) * 0.5
    rd = rng.normal(size=(B, N, NXA)) * 0.1
    MP = rng.normal(size=(B, NXA, NXA))
    PN = MP @ np.swapaxes(MP, -1, -2) + np.eye(NXA)
    pN = rng.normal(size=(B, NXA))
    delta = np.full(B, 1e-3)
    return Hs, q, A, Bm, rd, PN, pN, delta


@pytest.fixture(scope="module")
def both():
    from mpc_code_tpu.solver.riccati_kernel import _riccati_ref
    from mpc_code_tpu_torch.solver.riccati_kernel import riccati_kkt

    ins = _inputs()
    ref = jax.vmap(functools.partial(_riccati_ref, nxa=NXA, nu=NU))(
        *[jnp.asarray(a) for a in ins])
    got = riccati_kkt(*[torch.tensor(a) for a in ins], nxa=NXA, nu=NU)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_ok_flags_match(both):
    ref, got = both
    np.testing.assert_array_equal(got[0], ref[0])
    assert not got[0][BAD] and got[0].sum() == B - 1


@pytest.mark.parametrize("i,name", [(1, "Ks"), (2, "kf"), (3, "P_seq"),
                                    (4, "p_seq"), (5, "dX"), (6, "dU")])
def test_values_match_where_ok(both, i, name):
    ref, got = both
    ok = ref[0]
    assert got[i].shape == ref[i].shape, name
    err = np.abs(got[i][ok] - ref[i][ok]) / (1 + np.abs(ref[i][ok]))
    assert err.max() <= 1e-10, (name, err.max())


def test_kernel_path_refuses_cpu_tensors():
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    ins = [torch.tensor(a) for a in _inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        rk.riccati_kkt_cuda(*ins, nxa=NXA, nu=NU)
    assert rk.riccati_bytes(16384, 50, NXA, NU, 4) > 2e8
