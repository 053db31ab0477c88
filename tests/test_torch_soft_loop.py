"""The port's batched closed-loop step (``loop/batched.py::make_mpc_step``)
on soft and user-constrained configs against the JAX package's, CPU, f64.

On ``tests/test_features.py::_base`` (a linear model, a static-gain
observer), 5 steps of one lane through each package's batched step, whose
OCP is the structured solver: the shared output slacks from a start
outside the output bounds (``tests/test_features.py:71-95``), ``slacksG``
(``:135-170``) and the stage equality ``H_eq`` (``:300-330``).  Every
step's OCP status equal, U within 1e-8, and the flat layout's Sl tail of
the carried solution (the solved slack, carried into the next step's
guess) within 1e-8 of JAX's.

About 40 s in one process on the CPU, most of it JAX compiling its
steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

NSIM = 5
YSP = np.array([0.8, 0.4])
TOL = 1e-8


def _cfg(pkg, lib, name):
    cfgm = __import__(f"{pkg}.config", fromlist=["MPCConfig"])
    A = np.array([[0.85, 0.1], [0.0, 0.9]])
    B = np.array([[0.2], [1.0]])
    C = np.eye(2)
    kw, x0 = {}, np.zeros(2)
    bounds = dict(umin=np.array([-3.0]), umax=np.array([3.0]))
    if name == "slacks":
        bounds.update(ymin=np.array([-0.1, -0.1]), ymax=np.array([0.55, 0.45]))
        kw = dict(slacks=True, Ws=10.0 * np.eye(4))
        x0 = np.array([1.0, 0.8])
    elif name == "slacksg":
        bounds.update(ymin=np.array([-0.5, -0.5]), ymax=np.array([2.0, 2.0]))
        kw = dict(G_ineq=lambda x, u, y, d, t, px, py: lib.atleast_1d(x[0] + x[1] - 0.9),
                  slacks=True, slacksG=True, Ws=10.0 * np.eye(5))
        x0 = np.array([0.8, 0.6])
    else:
        kw = dict(H_eq=lambda x, u, y, d, t, px, py: lib.atleast_1d(u[0] + 0.5 * x[1] - 0.2))
    return cfgm.MPCConfig(
        nx=2, nu=1, ny=2, nd=2, Nsim=NSIM, N=10, h=1.0,
        model=cfgm.LinearModel(A=A, B=B, C=C), plant=cfgm.LinearPlant(Ap=A, Bp=B, Cp=C),
        dist=cfgm.DisturbanceModel(offree="lin", Bd=np.zeros((2, 2)), Cd=np.eye(2)),
        x0_p=x0, x0_m=x0, u0=np.zeros(1),
        ss_cost=cfgm.SSCost(Qss=np.eye(2), Rss=np.zeros((1, 1))),
        stage_cost=cfgm.StageCost(Q=np.eye(2), R=0.1 * np.eye(1)),
        estimator=cfgm.EstimatorConfig(kind="lue", K=np.vstack([np.zeros((2, 2)), np.eye(2)])),
        bounds=cfgm.Bounds(**bounds), **kw)


@pytest.mark.parametrize("name", ["slacks", "slacksg", "heq"])
def test_soft_step_matches_jax(name):
    from mpc_code_tpu.loop.batched import init_carry as jinit, make_mpc_step as jstep
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step

    jcfg = _cfg("mpc_code_tpu", jnp, name)
    pcfg = config_from_numpy(jcfg, _cfg("mpc_code_tpu_torch", torch, name))
    js = jax.jit(jstep(jcfg, ysp=YSP))
    jc = jinit(jcfg)
    step = make_mpc_step(pcfg, ysp=YSP, device="cpu")
    c = init_carry(pcfg, device="cpu")
    nw = c.w_prev.shape[1]
    ns = {"slacks": 4, "slacksg": 5, "heq": 0}[name]
    assert c.w_prev.shape == (1, np.asarray(jc.w_prev).shape[0])
    for k in range(NSIM):
        jc, jo = js(jc)
        c, o = step(c)
        assert int(o.status_dyn[0]) == int(jo.status_dyn) != 2, k
        assert np.abs(o.u[0].numpy() - np.asarray(jo.u)).max() <= TOL, k
        if ns:
            tail_p = c.w_prev[0, nw - ns:].numpy()
            tail_j = np.asarray(jc.w_prev)[nw - ns:]
            assert np.abs(tail_p - tail_j).max() <= TOL, k
            if k == 0 and name == "slacks":
                # the start outside the output bounds needs a positive slack
                assert tail_j.max() > 1e-3
