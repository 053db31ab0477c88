"""The port's dense closed loop on ``fixtures/nmpc_dis.npz``, CPU, f64, no JAX.

``loop/batched.py::run_traced(cfg, Nsim=8, use_structured=False)`` on
``examples/nmpc_dis.py`` at the recorded size (Nsim=8, N=10;
``tools/record_fixtures.py:28-36``): the Luenberger observer with the
example's gain, the discrete plant with the ``def_pxp`` schedule,
``offree='lin'``, the Delta-u rows, the dense-IPM target and the dense-IPM
shooting OCP warm-started from the shifted previous solution.  U, Yp and
D_HAT on all 8 recorded steps within the fixtures' 1e-4 bar
(``tests/test_fixtures.py:37``); measured 2.1e-13, 3.6e-15 and 3.6e-15.

About 18 s in one process (builder's CPU run).
"""

import torch

from tests.test_torch_closed_loop_fixtures import run_fixture

torch.set_num_threads(1)


def test_nmpc_dis_fixture():
    run_fixture("nmpc_dis", 8, 10)
