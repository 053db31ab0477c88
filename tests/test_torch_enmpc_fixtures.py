"""The ENMPC closed loop with the MHE through the port, CPU, f64, no JAX.

``loop/batched.py::run_traced`` on ``examples/enmpc.py`` at the recorded
size of ``tools/record_fixtures.py:35`` (Nsim=8, N=8, N_mhe=5): the MHE
with the 'smooth' prior update, its window by the structured IPM, run from
the cold window (the growing-horizon warmup in the step), the economic
target by the dense IPM, the plant by RK4.

- The dense-IPM OCP (``use_structured=False``), the path of the recording's
  host loop: U, Yp and D_HAT within the fixtures' 1e-4 bar
  (``tests/test_fixtures.py:37``) on every recorded step; measured
  1.3e-10, 5.8e-11, 2.6e-10.
- The structured OCP (ContForm, kernel 4's plain version) within the
  structured-vs-dense tolerance of ``tests/test_traced_fidelity.py``
  (rtol 1e-4, atol 1e-5) of the recording, every status equal.  The
  port's structured ContForm OCP takes the Gauss-Newton Hessian, whose
  joint sweep the card runs as kernel 4.
- ``run_traced_checkpointed`` on an MHE loop (the linear configuration of
  ``test_torch_mhe_solve.py`` under 'smooth', 7 steps in segments of 3):
  equal to ``run_traced``, the checkpoint holding the MHE window field by
  field, and a resume from the first segment's checkpoint bit-equal to the
  run that was not stopped.
- ``enmpc_full.npz`` (Nsim=21, N=25, N_mhe=10) behind ``MPC_TPU_SLOW=1``.

About 100 s in one process on the CPU: the dense ContForm OCP and the
dense target take most of it.
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

from test_torch_mhe_solve import _config

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fixtures")
BAR = 1e-4


def _run(Nsim, N, N_mhe, **kw):
    from mpc_code_tpu_torch.examples.enmpc import make_config
    from mpc_code_tpu_torch.loop.batched import run_traced

    cfg = make_config(Nsim=Nsim).replace(N=N, **kw)
    cfg.estimator = dc.replace(cfg.estimator, N_mhe=N_mhe)
    return run_traced(cfg, Nsim=Nsim, use_structured=kw.get("sol_opts_dyn") is not None,
                      device="cpu")[1]


def _fixture(name, Nsim, N):
    ref = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    assert int(ref["meta_Nsim"]) == Nsim and int(ref["meta_N"]) == N
    return ref


def _hold_bar(H, ref, name):
    assert (H["STATUS_SS"] == 0).all() and (H["STATUS_DYN"] == 0).all()
    assert (H["MHE_STATUS"] == 0).all()
    for key in ("U", "Yp", "D_HAT"):
        got = H[key][:, 0]
        assert got.shape == ref["H_" + key].shape, key
        dev = np.abs(got - ref["H_" + key]).max()
        assert dev <= BAR, f"{name}: {key} deviates by {dev:.2e}"


def test_enmpc_fixture_dense():
    _hold_bar(_run(8, 8, 5), _fixture("enmpc", 8, 8), "enmpc")


def test_enmpc_fixture_structured():
    from mpc_code_tpu_torch.config import SolverOptions

    H = _run(8, 8, 5, sol_opts_dyn=SolverOptions(max_iter=200, hessian="gauss_newton"))
    ref = _fixture("enmpc", 8, 8)
    assert (H["STATUS_SS"] == 0).all() and (H["STATUS_DYN"] == 0).all()
    for key in ("U", "Xp", "XS", "US", "D_HAT", "Yp"):
        np.testing.assert_allclose(H[key][:, 0], ref["H_" + key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_mhe_loop_checkpoint_resumes(tmp_path):
    from mpc_code_tpu_torch.loop.batched import run_traced, run_traced_checkpointed

    cfg = _config("mpc_code_tpu_torch", False).replace(Nsim=7)
    cfg.estimator = dc.replace(cfg.estimator, mhe_up="smooth")
    path = str(tmp_path / "sweep.npz")
    _, H1 = run_traced(cfg, Nsim=7, device="cpu")
    _, H2 = run_traced_checkpointed(cfg, path, segment=3, Nsim=7, resume=False,
                                    device="cpu")
    assert set(H2) == set(H1) and "MHE_ITERS" in H1
    for key in H1:
        np.testing.assert_array_equal(H2[key], H1[key], err_msg=key)
    with np.load(path) as z:
        assert int(z["__k_done__"]) == 7
        assert z["__carry_mhe.sm.Pycondx_inv__"].shape == (1, 6, 6)
        assert z["__carry_mhe.duals.zl__"].shape == (1, 5, 8)
        assert z["__carry_mhe.steps__"].tolist() == [7]

    # a stop after the first segment: the file holds segment 1 only; resume
    run_traced_checkpointed(cfg, path, segment=3, Nsim=3, resume=False, device="cpu")
    _, H3 = run_traced_checkpointed(cfg, path, segment=3, Nsim=7, resume=True,
                                    device="cpu")
    for key in H1:
        np.testing.assert_array_equal(H3[key], H1[key], err_msg=key)


def test_enmpc_full_fixture():
    if os.environ.get("MPC_TPU_SLOW") != "1":
        pytest.skip("full-size run takes minutes; set MPC_TPU_SLOW=1")
    _hold_bar(_run(21, 25, 10), _fixture("enmpc_full", 21, 25), "enmpc_full")
