"""The port's structured closed loop on ``examples/nmpc_dis.py`` against the JAX package, CPU, f64.

4 steps of ``make_mpc_step`` on 3 lanes (different tank levels, shared step
inputs) at N=5: the Luenberger observer with the example's gain, the
discrete plant with its ``def_pxp`` schedule, ``offree='lin'``, the Delta-u
rows and cost through the u_prev state augmentation, whose warm start
carries the applied input into the shifted guess, Gauss-Newton.  Against
JAX's ``make_mpc_step`` jitted once for one lane and called lane by lane
(vmapped, JAX takes ~125 s to trace and compile this step on a cold
cache, ~60 s for one lane): STATUS_SS,
STATUS_DYN and OCP_ITERS equal at every step (6 cold, 3 warm); U, Xp, XS,
US, D_HAT and X_HAT_CORR within rtol 1e-6 / atol 1e-8 (measured max
|a-b| 1.7e-13).

About 33 s in one process with the suite's JAX compilation cache warm,
80 s cold (builder's CPU runs).
"""

import pytest
import torch

from tests.test_torch_closed_loop import check_statuses, check_trajectories, structured_loops

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loops():
    return structured_loops("nmpc_dis", vmapped=False)


def test_structured_loop_statuses_match_jax(loops):
    check_statuses(*loops)


def test_structured_loop_trajectories_match_jax(loops):
    check_trajectories(*loops)
