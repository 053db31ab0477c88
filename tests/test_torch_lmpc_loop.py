"""The port's structured closed loop of the LMPC examples against the JAX package, CPU, f64.

``loop/batched.py::run_traced(cfg, Nsim)`` on one lane against JAX's
``run_traced`` (its jitted ``lax.scan`` of the structured step), both on
the structured Riccati IPM with the dual warm start, at the configs and
sizes of ``tests/test_traced_fidelity.py:47-82``: ``lmpc_wb`` (20 steps,
N=10: the Luenberger observer, DUForm, the ``defSP`` step at t=10) and
``lmpc_cstr`` (25 steps, N=12: the Kalman filter ``kal``, the ``def_pxp``
and ``def_pyp`` schedules, state and output bounds, and the first three
OCPs infeasible, which keep the previous input in both).  The nonlinear
plant configs are in ``test_torch_lmpc_loop_nlplant.py``.

STATUS_SS, STATUS_DYN and OCP_ITERS equal at every step; U, Xp, XS, US,
D_HAT, Yp and X_HAT_CORR within rtol 1e-7 / atol 1e-8, tighter than that
file's structured-against-dense bars (1e-6 / 1e-7 for lmpc_wb, 1e-4 / 1e-5
for lmpc_cstr); measured max |a-b| 2.7e-15 (lmpc_wb) and 1.2e-10 (lmpc_cstr,
in U).

About 35 s in one process on the CPU.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KEYS = ("U", "Xp", "XS", "US", "D_HAT", "Yp", "X_HAT_CORR")
STATUS = ("STATUS_SS", "STATUS_DYN", "OCP_ITERS")
RTOL, ATOL = 1e-7, 1e-8


def traced_loops(name, steps, N):
    """(the port's history, JAX's history) of ``steps`` structured steps."""
    from mpc_code_tpu.loop.batched import run_traced as jax_run
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.loop.batched import run_traced

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=steps).replace(N=N)
    pcfg = config_from_numpy(jcfg, pmod.make_config(Nsim=steps))
    _, Hj = jax_run(jcfg, Nsim=steps)
    _, H = run_traced(pcfg, Nsim=steps, device="cpu")
    return {k: v[:, 0] for k, v in H.items()}, {k: np.asarray(v) for k, v in Hj.items()}


def check_statuses(H, Hj):
    for k in STATUS:
        np.testing.assert_array_equal(H[k], Hj[k], err_msg=k)


def check_trajectories(H, Hj):
    for k in KEYS:
        assert H[k].shape == Hj[k].shape, k
        np.testing.assert_allclose(H[k], Hj[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module", params=[("lmpc_wb", 20, 10), ("lmpc_cstr", 25, 12)],
                ids=lambda p: p[0])
def loops(request):
    return request.param[0], traced_loops(*request.param)


def test_statuses_match_jax(loops):
    name, (H, Hj) = loops
    check_statuses(H, Hj)
    if name == "lmpc_cstr":
        # the recorded infeasible early steps: the fallback keeps the input
        assert H["STATUS_DYN"][:3].tolist() == [2, 2, 2]
        assert (H["STATUS_DYN"][3:] == 0).all()
        assert (H["U"][:3] == 0).all()
    else:
        assert (H["STATUS_DYN"] == 0).all()


def test_trajectories_match_jax(loops):
    check_trajectories(*loops[1])
