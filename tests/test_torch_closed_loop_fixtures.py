"""The port's dense closed loop on ``fixtures/nmpc.npz``, CPU, f64, no JAX.

``loop/batched.py::run_traced(cfg, Nsim=10, use_structured=False)`` on
``examples/nmpc.py`` at the recorded size (Nsim=10, N=10, the example's
Mx=10; ``tools/record_fixtures.py:28-36``): the EKF, the non-nominal plant
with its scheduled feed flow, output noise, the dense-IPM target and the
dense-IPM shooting OCP warm-started from the shifted previous solution,
which is the path the recording's host loop took.  U, Yp and D_HAT on all
10 recorded steps within the fixtures' 1e-4 bar (``tests/test_fixtures.py:37``);
measured 1.7e-13, 3.9e-14 and 7.8e-16 (1.3e-7 in U before F10, ROADMAP
Queue 3).  Every target and OCP solves (status
0).  This reaches steps 1-9 of the recording, which the port's cold solves
(``tests/test_torch_exact.py``) could not.

About 44 s in one process (builder's CPU run); the nmpc_dis fixture is in
``test_torch_closed_loop_fixtures_dis.py``.
"""

import os

import numpy as np
import torch

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fixtures")
BAR = 1e-4


def run_fixture(name, Nsim, N):
    from mpc_code_tpu_torch.loop.batched import run_traced

    mod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    cfg = mod.make_config(Nsim=Nsim).replace(N=N)
    _, H = run_traced(cfg, Nsim=Nsim, use_structured=False, device="cpu")
    ref = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    assert int(ref["meta_Nsim"]) == Nsim and int(ref["meta_N"]) == N
    assert (H["STATUS_SS"] == 0).all() and (H["STATUS_DYN"] == 0).all()
    for key in ("U", "Yp", "D_HAT"):
        got = H[key][:, 0]
        assert got.shape == ref["H_" + key].shape, key
        dev = np.abs(got - ref["H_" + key]).max()
        assert dev <= BAR, f"{name}: {key} deviates by {dev:.2e}"


def test_nmpc_fixture():
    run_fixture("nmpc", 10, 10)
