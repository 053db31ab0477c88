"""The port's structured LMPC closed loop on the nonlinear CSTR plant against the JAX package, CPU, f64.

As ``test_torch_lmpc_loop.py``, on ``lmpc_nlplant`` (the affine model
around ``(xlin, ulin)``, ``Bd = B``, the Kalman filter ``kal``, DUForm so
nxa=5, the plant by RK4 with Mx=10) and ``lmpcxp_nlplant`` (a 4-state
model against the 3-state plant: the ``nx != nxp`` threading of plant,
estimator and warm start), 16 steps at N=10 each, the sizes of
``tests/test_traced_fidelity.py:66-82``.  Statuses and OCP iterations
equal at every step; the history keys within rtol 1e-7 / atol 1e-8
(that file's bars are 1e-4 / 1e-5); measured max |a-b| 2.9e-11
(lmpc_nlplant, in U) and 5.7e-13.

About 20 s in one process on the CPU.
"""

import pytest
import torch

from tests.test_torch_lmpc_loop import check_statuses, check_trajectories, traced_loops

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["lmpc_nlplant", "lmpcxp_nlplant"])
def loops(request):
    return request.param, traced_loops(request.param, 16, 10)


def test_statuses_match_jax(loops):
    name, (H, Hj) = loops
    check_statuses(H, Hj)
    assert (H["STATUS_DYN"] == 0).all()
    if name == "lmpcxp_nlplant":
        assert H["Xp"].shape == (16, 3) and H["X_HAT_CORR"].shape == (16, 4)


def test_trajectories_match_jax(loops):
    check_trajectories(*loops[1])
