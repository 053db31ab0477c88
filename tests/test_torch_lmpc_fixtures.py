"""The port's dense closed loop on the LMPC fixtures, CPU, f64, no JAX.

``loop/batched.py::run_traced(cfg, Nsim, use_structured=False)`` at the
recorded sizes of ``tools/record_fixtures.py:28-36``: the dense-IPM target
and the dense-IPM shooting OCP warm-started from the shifted previous
solution, which is the path the recording's host loop took.  U, Yp and
D_HAT on every recorded step within the fixtures' 1e-4 bar
(``tests/test_fixtures.py:37``).

- ``lmpc_wb`` (25 steps, N=15): the Luenberger observer, the linear plant
  with model mismatch; measured 5.0e-16, 8.9e-16, 4.0e-15.
- ``lmpc_cstr`` (20 steps, N=12): the Kalman filter, the ``def_pxp`` and
  ``def_pyp`` schedules; its first three OCPs are infeasible and keep the
  previous input (the fixtures record no statuses: the test checks those
  three and that every later OCP and every target solves); measured
  3.8e-15, 5.8e-15, 3.8e-15.
- ``lmpc_wb_full`` (100 steps, N=50) behind ``MPC_TPU_SLOW=1``, as in
  ``tests/test_fixtures.py``.

The nonlinear-plant fixtures are in ``test_torch_lmpc_fixtures_nlplant.py``.
About 30 s in one process on the CPU.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fixtures")
BAR = 1e-4
# OCP statuses of the recorded runs, where not all 0 (JAX's dense loop on
# the same configs; tests/test_traced_fidelity.py::test_cstr_schedules)
INFEASIBLE_STEPS = {"lmpc_cstr": 3}


def run_fixture(name, Nsim, N, fixture=None):
    from mpc_code_tpu_torch.loop.batched import run_traced

    mod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    cfg = mod.make_config(Nsim=Nsim).replace(N=N)
    _, H = run_traced(cfg, Nsim=Nsim, use_structured=False, device="cpu")
    ref = np.load(os.path.join(FIXTURES, f"{fixture or name}.npz"))
    assert int(ref["meta_Nsim"]) == Nsim and int(ref["meta_N"]) == N
    n_bad = INFEASIBLE_STEPS.get(name, 0)
    assert (H["STATUS_SS"] == 0).all()
    assert (H["STATUS_DYN"][:n_bad] == 2).all() and (H["STATUS_DYN"][n_bad:] == 0).all()
    for key in ("U", "Yp", "D_HAT"):
        got = H[key][:, 0]
        assert got.shape == ref["H_" + key].shape, key
        dev = np.abs(got - ref["H_" + key]).max()
        assert dev <= BAR, f"{name}: {key} deviates by {dev:.2e}"


@pytest.mark.parametrize("name,Nsim,N", [("lmpc_wb", 25, 15), ("lmpc_cstr", 20, 12)],
                         ids=["lmpc_wb", "lmpc_cstr"])
def test_lmpc_fixture(name, Nsim, N):
    run_fixture(name, Nsim, N)


def test_lmpc_wb_full_fixture():
    if os.environ.get("MPC_TPU_SLOW") != "1":
        pytest.skip("full-size run takes minutes; set MPC_TPU_SLOW=1")
    run_fixture("lmpc_wb", 100, 50, fixture="lmpc_wb_full")
