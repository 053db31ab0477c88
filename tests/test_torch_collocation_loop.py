"""Collocation in the port's closed loops, CPU, f64.

- ``loop/simulator.py::ClosedLoop`` with ``Collocation=True`` (the dense
  Gauss-Legendre transcription, stride 3nx+nu, the reference's cold guess
  and shifted warm start) on the ENMPC tracking config of
  ``tests/test_collocation.py:17-36`` (N=8, the MHE with N_mhe=4), 3
  steps, against JAX's ``ClosedLoop``: STATUS_DYN equal, U within 1e-8.
- The port's traced step (``loop/batched.py::run_traced``: the structured
  OCP with the condensed collocation step) against the port's host loop
  (the dense transcription) on the config of
  ``tests/test_traced_fidelity.py:146-170`` (N=6, the EKF), 3 steps, one
  of them with an infeasible OCP (the fallback of MPC_code.py:804-805):
  statuses equal, U within 1e-5 (the two transcriptions' optima agree to
  the solvers' tolerance, not to rounding).

About 60 s in one process (on the CPU).
"""

import dataclasses as dc

import numpy as np
import torch

torch.set_num_threads(1)


def _configs(N, nsim, ekf=False):
    from mpc_code_tpu.config import StageCost as JSC
    from mpc_code_tpu.examples import enmpc as jex
    from mpc_code_tpu.models.costs import xQx as jxqx
    from mpc_code_tpu_torch.config import StageCost
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples import enmpc as pex
    from mpc_code_tpu_torch.models.costs import xQx

    Q, R = np.eye(2), np.eye(1)

    def jcost(x, u, y, xs, us, ys, s):
        return 0.5 * (jxqx(x - xs, Q) + jxqx(u - us, R))

    def pcost(x, u, y, xs, us, ys, s):
        return 0.5 * (xQx(x - xs, Q) + xQx(u - us, R))

    kw = dict(N=N, ContForm=False, Collocation=True)
    jcfg = jex.make_config(Nsim=nsim).replace(stage_cost=JSC(f_coll=jcost), **kw)
    pcfg = pex.make_config(Nsim=nsim).replace(stage_cost=StageCost(f_coll=pcost), **kw)
    if ekf:
        est = dict(kind="ekf", Q_kf=1e-5 * np.eye(4), R_kf=1e-4 * np.eye(2))
        jcfg.estimator = dc.replace(jcfg.estimator, **est)
        pcfg.estimator = dc.replace(pcfg.estimator, **est)
    else:
        jcfg.estimator = dc.replace(jcfg.estimator, N_mhe=4)
        pcfg.estimator = dc.replace(pcfg.estimator, N_mhe=4)
    return jcfg, config_from_numpy(jcfg, pcfg)


def test_closed_loop_matches_jax():
    from mpc_code_tpu.loop import ClosedLoop as JLoop
    from mpc_code_tpu_torch.loop import ClosedLoop

    jcfg, pcfg = _configs(8, 3)
    Hj = JLoop(jcfg).run()
    loop = ClosedLoop(pcfg, device="cpu")
    assert loop.stride == 3 * pcfg.nx + pcfg.nu
    H = loop.run()
    np.testing.assert_array_equal(H["STATUS_DYN"], np.asarray(Hj["STATUS_DYN"]))
    assert (H["STATUS_DYN"] != 2).all()
    assert np.abs(H["U"] - np.asarray(Hj["U"])).max() <= 1e-8


def test_traced_step_matches_host_loop():
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.loop.batched import run_traced

    _, pcfg = _configs(6, 3, ekf=True)
    # step 1's OCP is infeasible on both paths and runs to the cap: 60
    # iterations, not the config's 200, and the Gauss-Newton Hessian for
    # the structured OCP keep the test short
    pcfg = pcfg.replace(sol_opts_dyn=SolverOptions(max_iter=60, hessian="gauss_newton"))
    Hh = ClosedLoop(pcfg, device="cpu").run()
    assert (Hh["STATUS_DYN"] == 2).any() and (Hh["STATUS_DYN"] == 0).any()
    _, Ht = run_traced(pcfg, Nsim=3, device="cpu")
    np.testing.assert_array_equal(Ht["STATUS_DYN"][:, 0], Hh["STATUS_DYN"])
    assert np.abs(Ht["U"][:, 0] - Hh["U"]).max() < 1e-5
