"""The port's native host-core bindings (``native.py``) against the JAX package's and numpy.

Both bind the same C++ (``native/hostcore.cpp``); the port builds it into
``mpc_code_tpu_torch/_build/hostcore-<hash>/``.  On random well-posed
problems (seeded):

- ``dare`` against JAX's ``mpc_code_tpu.native.dare`` and against the
  DARE residual;
- ``kalman_gain`` against JAX's and against ``P C' (C P C' + R)^{-1}``
  from the filter DARE;
- ``riccati_smoother`` against JAX's and against the MHE's backward
  recursion in numpy (Estimator.py:654-664), as ``MHERuntime`` runs it
  without the library;

all to 1e-12; and ``MHERuntime``'s 'smooth' update with the library and
with its numpy recursion.  Skips without g++.  About 5 s on the CPU.
"""

import shutil

import numpy as np
import pytest
import scipy.linalg as scla

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")

TOL = 1e-12


def _libs():
    from mpc_code_tpu import native as jn
    from mpc_code_tpu_torch import native as pn

    assert pn.available()
    if not jn.available():
        pytest.skip("the JAX package's native library did not build")
    return pn, jn


def _system(seed, n=4, m=2):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.eye(n) + 0.1 * rng.normal(size=(n, n))
    B = rng.normal(size=(n, m))
    M = rng.normal(size=(n, n))
    return A, B, M @ M.T + np.eye(n), np.eye(m) * 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_dare(seed):
    pn, jn = _libs()
    A, B, Q, R = _system(seed)
    P = pn.dare(A, B, Q, R)
    assert np.abs(P - jn.dare(A, B, Q, R)).max() <= TOL
    res = A.T @ P @ A - P - A.T @ P @ B @ np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A) + Q
    assert np.abs(res).max() <= 1e-9 * np.abs(P).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_kalman_gain(seed):
    pn, jn = _libs()
    A, C, Q, _ = _system(seed, n=4, m=3)
    C = C.T
    R = 0.3 * np.eye(3)
    K = pn.kalman_gain(A, C, Q, R)
    assert np.abs(K - jn.kalman_gain(A, C, Q, R)).max() <= TOL
    P = scla.solve_discrete_are(A.T, C.T, Q, R)
    assert np.abs(K - P @ C.T @ np.linalg.inv(C @ P @ C.T + R)).max() <= 1e-9


def _numpy_smoother(bigP, bigPc, bigA):
    N = len(bigP)
    Pis = [None] * N
    Pis[N - 1] = bigPc[N - 1]
    for i in range(N - 2, -1, -1):
        Pim = scla.inv(bigP[i + 1])
        Pis[i] = bigPc[i] + bigPc[i] @ bigA[i].T @ Pim @ (
            Pis[i + 1] - bigP[i + 1]) @ Pim @ bigA[i] @ bigPc[i]
    return np.stack(Pis)


@pytest.mark.parametrize("N", [2, 5, 10])
def test_riccati_smoother(N):
    pn, jn = _libs()
    rng = np.random.default_rng(N)
    n = 4
    spd = [(lambda M: M @ M.T + np.eye(n))(rng.normal(size=(n, n))) for _ in range(2 * N)]
    bigP, bigPc = spd[:N], [0.5 * P for P in spd[N:]]
    bigA = [0.9 * np.eye(n) + 0.1 * rng.normal(size=(n, n)) for _ in range(N)]
    got = pn.riccati_smoother(bigP, bigPc, bigA)
    assert np.abs(got - jn.riccati_smoother(bigP, bigPc, bigA)).max() <= TOL
    ref = _numpy_smoother(bigP, bigPc, bigA)
    assert np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def test_library_is_built_outside_native_dir():
    from mpc_code_tpu_torch import native as pn

    path = pn.library_path()
    assert pn.available() and path.endswith("libhostcore.so")
    assert "/mpc_code_tpu_torch/_build/hostcore-" in path.replace("\\", "/")


def test_mhe_runtime_smoother_without_the_library(monkeypatch):
    """``MHERuntime``'s 'smooth' update through the library and through its
    numpy recursion (the library unavailable) gives the same arrival-cost
    covariances, to 1e-12."""
    import dataclasses as dc

    from test_torch_mhe_runtime import _data
    from test_torch_mhe_solve import _config

    from mpc_code_tpu_torch import native
    from mpc_code_tpu_torch.estimators.mhe import MHERuntime
    from mpc_code_tpu_torch.models import build_model

    cfg = _config("mpc_code_tpu_torch", False)
    cfg.estimator = dc.replace(cfg.estimator, mhe_up="smooth", structured_mhe=False)

    def run():
        rt = MHERuntime(cfg, build_model(cfg), device="cpu")
        P, out = np.eye(4), []
        for k, (y, u, xm, t, px, py) in enumerate(_data("linear")):
            _, P = rt.step(k, y, u, xm, t, px, py, P)
            out.append(P)
        return np.stack(out), rt.Pycondx_inv

    assert native.available()
    P_lib, S_lib = run()
    monkeypatch.setattr(native, "available", lambda: False)
    P_np, S_np = run()
    assert np.abs(P_lib - P_np).max() <= TOL and np.abs(S_lib - S_np).max() <= 1e-9
    assert np.abs(P_lib[-1] - P_lib[0]).max() > 1e-3
