"""The port's dense closed loop on the nonlinear-plant LMPC fixtures, CPU, f64, no JAX.

As ``test_torch_lmpc_fixtures.py``, on ``lmpc_nlplant`` and
``lmpcxp_nlplant`` (15 steps, N=12 each; ``tools/record_fixtures.py:28-36``):
the affine linear model, the Kalman filter, the nonlinear CSTR plant by RK4
with Mx=10, and for ``lmpcxp_nlplant`` a 4-state model against the 3-state
plant.  Every target and OCP solves; U, Yp and D_HAT within the 1e-4 bar
(measured 2.0e-12, 1.5e-12, 7.0e-13 and 3.4e-13, 6.2e-14, 2.3e-15).

About 10 s in one process on the CPU.
"""

import pytest
import torch

from tests.test_torch_lmpc_fixtures import run_fixture

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["lmpc_nlplant", "lmpcxp_nlplant"])
def test_nlplant_fixture(name):
    run_fixture(name, 15, 12)
