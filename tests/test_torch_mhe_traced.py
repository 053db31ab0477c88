"""The port's traced MHE step (``estimators/mhe.py``) against the JAX package, CPU, f64.

- The linear configuration of ``tests/test_mhe.py`` (N_mhe = 4, n = 4,
  p = 2; ``test_torch_mhe_solve.py``) under both prior updates, 'filter'
  and 'smooth': ``make_mhe_traced`` from ``make_mhe_cold_carry``, B = 3
  lanes of different noise in one batched call, N_mhe + 3 = 7 steps (the
  growing-horizon warmup, the first full window with the first prior
  update, and steady steps with the dual warm start).  Each lane against
  JAX's jitted step from its own cold carry: x_corr within 1e-8, P within
  1e-7, ``steps`` equal, and for 'smooth' Hbig, Obig and Pycondx_inv
  within 1e-7.
- The dense engine (``structured_mhe=False``) against the structured one
  within 1e-7 on the linear configuration.
- ENMPC's nonlinear MHE (the reactor's RK4 map at Mx_mhe = 2, N_mhe = 4,
  'smooth'), two lanes over 7 fed steps, held the same way.
- One port step from JAX's window state after step N_mhe (carried across
  by ``convert.mhe_carry_from_numpy``) against JAX's next step.
- One f32 run of ENMPC's MHE through its first full window: every carry
  tensor stays f32 and finite (the prior update's Jacobians by reverse
  mode; ROADMAP Queue 3, F9).

JAX's steps are jitted once per module.  About 30 s in one process on the
CPU, most of it JAX's compiles.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_mhe_solve import A, Bm, _config

torch.set_num_threads(1)

N = 4
STEPS = N + 3


def _enmpc_configs():
    from mpc_code_tpu.examples.enmpc import make_config as jmake
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as pmake

    jcfg = jmake(Nsim=4)
    jcfg.estimator = dc.replace(jcfg.estimator, N_mhe=N, Mx_mhe=2)
    return jcfg, config_from_numpy(jcfg, pmake(Nsim=4))


def _linear_data(lanes):
    """Per step (y, u, xhat_min, t, px, py) for ``lanes`` lanes of the
    linear plant, each with its own noise."""
    rng = np.random.default_rng(3)
    x = np.tile([0.5, -0.2], (lanes, 1))
    out = []
    for k in range(STEPS):
        u = np.sin(0.3 * k + np.arange(lanes))[:, None]
        x = x @ A.T + u @ Bm.T + 0.01 * rng.normal(size=(lanes, 2))
        y = x + 0.005 * rng.normal(size=(lanes, 2))
        xm = np.concatenate([x, np.zeros((lanes, 2))], 1)
        out.append((y, u, xm, np.full(lanes, float(k)), np.zeros((lanes, 2)),
                    np.zeros((lanes, 2))))
    return out


def _enmpc_data(lanes):
    rng = np.random.default_rng(4)
    out = []
    for k in range(STEPS):
        x = np.array([0.45, 0.35]) + 0.02 * rng.normal(size=(lanes, 2))
        y = x + 0.01 * rng.normal(size=(lanes, 2))
        u = 0.9 + 0.3 * rng.uniform(size=(lanes, 1))
        xm = np.concatenate([x, np.zeros((lanes, 2))], 1)
        out.append((y, u, xm, np.full(lanes, 2.0 * k), np.zeros((lanes, 2)),
                    np.zeros((lanes, 2))))
    return out


def _jax_runs(jcfg, data, lanes):
    """Each lane through JAX's jitted step from its own cold carry: per
    step the x_corr and the carry, as numpy."""
    from mpc_code_tpu.estimators.mhe import make_mhe_cold_carry, make_mhe_traced
    from mpc_code_tpu.models import build_model

    step, _ = make_mhe_traced(jcfg, build_model(jcfg))
    step = jax.jit(step)
    runs = []
    for lane in range(lanes):
        c = make_mhe_cold_carry(jcfg)
        rows = []
        for inp in data:
            c, xc = step(c, *(jnp.asarray(a[lane]) for a in inp))
            rows.append((np.asarray(xc), jax.tree_util.tree_map(np.asarray, c)))
        runs.append(rows)
    return runs


def _port_run(pcfg, data, lanes, dtype=torch.float64):
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_cold_carry, make_mhe_traced
    from mpc_code_tpu_torch.models import build_model

    step, _ = make_mhe_traced(pcfg, build_model(pcfg), device="cpu")
    c = make_mhe_cold_carry(pcfg, batch=lanes, device="cpu", dtype=dtype)
    rows = []
    for inp in data:
        c, xc = step(c, *(torch.as_tensor(a, dtype=dtype) for a in inp))
        rows.append((xc, c))
    return rows


def _hold(rows, runs, smooth):
    for k, (xc, c) in enumerate(rows):
        for lane, run in enumerate(runs):
            jxc, jc = run[k]
            assert np.abs(xc[lane].numpy() - jxc).max() <= 1e-8, (k, lane)
            assert np.abs(c.P[lane].numpy() - jc.P).max() <= 1e-7, (k, lane)
            assert int(c.steps[lane]) == int(jc.steps) == k + 1
            if smooth:
                for f in ("Hbig", "Obig", "Pycondx_inv"):
                    got, ref = getattr(c.sm, f)[lane].numpy(), getattr(jc.sm, f)
                    assert np.abs(got - ref).max() <= 1e-7, (f, k, lane)


@pytest.fixture(scope="module", params=["filter", "smooth"])
def linear(request):
    jcfg = _config("mpc_code_tpu", False)
    jcfg.estimator = dc.replace(jcfg.estimator, mhe_up=request.param)
    data = _linear_data(3)
    return request.param, data, _jax_runs(jcfg, data, 3)


def test_traced_step_linear(linear):
    up, data, runs = linear
    pcfg = _config("mpc_code_tpu_torch", False)
    pcfg.estimator = dc.replace(pcfg.estimator, mhe_up=up)
    rows = _port_run(pcfg, data, 3)
    _hold(rows, runs, up == "smooth")
    # the prior update engaged from the first full window (step N-1) on
    P = np.stack([c.P[0].numpy() for _, c in rows])
    assert np.abs(P[: N - 2] - np.eye(4)).max() == 0.0
    assert np.abs(P[N - 1] - np.eye(4)).max() > 1e-3


def test_step_from_a_jax_window_state(linear):
    """One port step from JAX's window state after step N (the steady
    window, carried across by ``convert.mhe_carry_from_numpy``), against
    JAX's next step."""
    from mpc_code_tpu_torch.convert import mhe_carry_from_numpy
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced
    from mpc_code_tpu_torch.models import build_model

    up, data, runs = linear
    pcfg = _config("mpc_code_tpu_torch", False)
    pcfg.estimator = dc.replace(pcfg.estimator, mhe_up=up)
    step, from_rt = make_mhe_traced(pcfg, build_model(pcfg), device="cpu")
    c = mhe_carry_from_numpy(runs[1][N][1])
    assert c.steps.tolist() == [N + 1] and c.duals["ok"].dtype == torch.bool
    c1, xc = step(c, *(torch.as_tensor(a[1:2]) for a in data[N + 1]))
    jxc, jc = runs[1][N + 1]
    assert np.abs(xc[0].numpy() - jxc).max() <= 1e-8
    assert np.abs(c1.P[0].numpy() - jc.P).max() <= 1e-7
    # the hand-off from the host MHERuntime refuses a window that is not
    # full yet (test_torch_mhe_runtime.py holds the hand-off itself)
    from mpc_code_tpu_torch.estimators.mhe import MHERuntime

    with pytest.raises(ValueError, match="not full yet"):
        from_rt(MHERuntime(pcfg, build_model(pcfg), device="cpu"), np.eye(4))


def test_dense_engine_matches_structured():
    """``structured_mhe=False``: the window solved by the dense IPM on
    ``build_mhe_nlp`` gives the structured engine's estimates within 1e-7
    through the warmup and the steady steps, as JAX's engines agree."""
    data = _linear_data(3)
    rows = {}
    for structured in (True, False):
        pcfg = _config("mpc_code_tpu_torch", False)
        pcfg.estimator = dc.replace(pcfg.estimator, mhe_up="smooth",
                                    structured_mhe=structured)
        rows[structured] = _port_run(pcfg, data, 3)
    assert rows[False][-1][1].duals is None
    for (xs, cs), (xd, cd) in zip(rows[True], rows[False]):
        assert (xs - xd).abs().max() <= 1e-7
        assert (cs.P - cd.P).abs().max() <= 1e-7


def test_traced_step_enmpc_smooth():
    jcfg, pcfg = _enmpc_configs()
    data = _enmpc_data(2)
    runs = _jax_runs(jcfg, data, 2)
    rows = _port_run(pcfg, data, 2)
    _hold(rows, runs, True)
    # the dual warm start engaged once the previous window was full
    assert bool(rows[-1][1].duals["ok"].all())


def test_traced_step_stays_f32():
    from mpc_code_tpu_torch.config import SolverOptions

    _, pcfg = _enmpc_configs()
    pcfg = pcfg.replace(sol_opts_mhe=SolverOptions.for_f32())
    rows = _port_run(pcfg, _enmpc_data(2), 2, dtype=torch.float32)
    xc, c = rows[-1]
    tensors = [xc] + [t for t in jax.tree_util.tree_leaves(
        (c._replace(sm=None, duals=None, steps=None), tuple(c.sm), c.duals))
        if torch.is_tensor(t) and t.is_floating_point()]
    assert all(t.dtype == torch.float32 for t in tensors)
    assert all(bool(torch.isfinite(t).all()) for t in tensors)
