"""The port's batched closed loop (``loop/batched.py``) against the JAX package, CPU, f64.

- ``make_step_inputs``: the port's schedule and noise stack against JAX's,
  array for array and bit for bit, on ``examples/nmpc.py`` (output noise,
  ``defSP``) and ``examples/nmpc_dis.py`` (the ``def_pxp`` schedule, the
  setpoint program), 30 steps.
- The structured closed loop: 4 steps of ``make_mpc_step`` on 3 lanes
  (different plant states, shared step inputs) at N=5, against JAX's
  ``make_mpc_step`` jitted and vmapped once over the lanes with
  ``in_axes=(0, None)``, stepped by a Python loop.  nmpc: the EKF, the
  example's exact Hessian, RK4 Mx=2 in the model and the plant (nmpc_dis,
  the Luenberger observer with the u_prev warm start, is in
  ``test_torch_closed_loop_dis.py``).  STATUS_SS, STATUS_DYN and
  OCP_ITERS equal at every step (the dual warm start cuts the OCP
  iterations after step 0); U, Xp, XS, US, D_HAT and X_HAT_CORR within
  rtol 1e-6 / atol 1e-8: measured max |a-b| 1.7e-13 over both loops.
- ``use_structured=False`` on one lane: ``run_traced`` against JAX's
  ``run_traced(..., use_structured=False)`` on nmpc (N=5, Mx=2, 3 steps),
  the same keys within 1e-8 (measured 1.1e-13).
- What is still unported raises ``NotImplementedError`` naming its
  ROADMAP item (collocation, item 20; a structured-solver option, item 21;
  ``SolverOptions.debug``, item 29); the batched entry points, the MHE's
  and the host loop's run on the card unless given ``device="cpu"``.

About 30 s in one process with the suite's JAX compilation cache warm,
43 s cold (builder's CPU runs, most of it JAX tracing and compiling the
reference steps).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, NSIM = 5, 4
KEYS = (("U", "u"), ("Xp", "x"), ("XS", "xs"), ("US", "us"), ("D_HAT", "dhat"),
        ("X_HAT_CORR", "xhat"))
STATUS = (("STATUS_SS", "status_ss"), ("STATUS_DYN", "status_dyn"),
          ("OCP_ITERS", "ocp_iters"))


def _configs(name, Nsim=NSIM):
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=Nsim).replace(N=N)
    if name == "nmpc":
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=2),
                            plant=dc.replace(jcfg.plant, Mx=2))
    else:
        jcfg = jcfg.replace(sol_opts_dyn=JOpts(hessian="gauss_newton"))
    return jcfg, config_from_numpy(jcfg, pmod.make_config(Nsim=Nsim))


X0_SHIFT = {"nmpc": np.array([[0.0, 0.0, 0.0], [0.02, 1.0, 0.005], [-0.03, -2.0, -0.01]]),
            "nmpc_dis": np.array([[0.0] * 6, [0, 0, 0.3, -0.2, 0.05, 0],
                                  [0, 0, -0.5, 0.4, 0, 0.05]])}


@pytest.mark.parametrize("name", ["nmpc", "nmpc_dis"])
def test_step_inputs_match_jax(name):
    from mpc_code_tpu.loop.schedules import make_step_inputs as jmsi
    from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

    jcfg, pcfg = _configs(name, Nsim=30)
    got, ref = make_step_inputs(pcfg, 30), jmsi(jcfg, 30)
    for f in StepInput._fields:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if name == "nmpc":
        assert np.abs(got.v_wn).max() > 0          # the noise is drawn
    tens = make_step_inputs(pcfg, 3, dtype=torch.float64)
    assert torch.equal(tens.ysp, torch.as_tensor(got.ysp[:3]))


def structured_loops(name, vmapped=True):
    """(the port's history, JAX's outputs) of NSIM structured steps on the
    3 lanes of ``name``.  JAX's step is jitted and vmapped over the lanes,
    or with ``vmapped=False`` jitted for one lane and called per lane
    (the same arithmetic; JAX traces and compiles it in about half the
    time)."""
    from mpc_code_tpu.loop import batched as jb
    from mpc_code_tpu.loop.schedules import make_step_inputs as jmsi
    from mpc_code_tpu_torch.loop import batched as pb
    from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

    jcfg, pcfg = _configs(name)
    x0 = np.asarray(jcfg.x0_p, float)[None] + X0_SHIFT[name]

    # the split sweep form (as tests/test_torch_nmpc_dis.py): JAX traces
    # its lanes-minor discrete sweep far longer inside the solver
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    try:
        step = jb.make_mpc_step(jcfg)
    finally:
        mp.undo()
    # through numpy: no weak-typed leaves, so the carry the step returns
    # has the types of the one it takes and the step compiles once
    carries = [jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                            jb.init_carry(jcfg, jnp.asarray(x))) for x in x0]
    jin = jmsi(jcfg, NSIM)
    jouts = []
    if vmapped:
        jstep = jax.jit(jax.vmap(step, in_axes=(0, None)))
        jc = jax.tree.map(lambda *a: jnp.stack(a), *carries)
    else:
        jstep = jax.jit(step)
    for k in range(NSIM):
        inp = jax.tree.map(lambda a: jnp.asarray(a[k]), jin)
        if vmapped:
            jc, o = jstep(jc, inp)
        else:
            lanes = [jstep(c, inp) for c in carries]
            carries = [c for c, _ in lanes]
            o = jax.tree.map(lambda *a: jnp.stack(a), *[o for _, o in lanes])
        jouts.append(jax.device_get(o))
    J = {f: np.stack([np.asarray(getattr(o, f)) for o in jouts])
         for _, f in KEYS + STATUS}

    pstep = pb.make_mpc_step(pcfg, device="cpu")
    pc = pb.init_carry(pcfg, torch.as_tensor(x0), device="cpu")
    assert pc.duals is not None and not bool(pc.duals["ok"].any())
    pin = make_step_inputs(pcfg, NSIM)
    pouts = []
    for k in range(NSIM):
        pc, o = pstep(pc, StepInput(*(a[k] for a in pin)))
        pouts.append(o)
    return pb.history_from_outputs(pb.stack_outputs(pouts)), J


@pytest.fixture(scope="module")
def loops():
    return structured_loops("nmpc")


def check_statuses(H, J):
    for hk, jk in STATUS:
        assert H[hk].shape == (NSIM, 3)
        np.testing.assert_array_equal(H[hk], J[jk], err_msg=hk)
    assert (H["STATUS_DYN"] == 0).all()
    # warm steps take fewer OCP iterations than the cold step 0
    assert (H["OCP_ITERS"][1:].mean(0) < H["OCP_ITERS"][0]).all()


def check_trajectories(H, J):
    for hk, jk in KEYS:
        np.testing.assert_allclose(H[hk], J[jk], rtol=1e-6, atol=1e-8, err_msg=hk)


def test_structured_loop_statuses_match_jax(loops):
    check_statuses(*loops)


def test_structured_loop_trajectories_match_jax(loops):
    check_trajectories(*loops)


def test_dense_loop_matches_jax():
    from mpc_code_tpu.loop.batched import run_traced as jrun
    from mpc_code_tpu_torch.loop.batched import run_traced

    jcfg, pcfg = _configs("nmpc", Nsim=3)
    _, Hj = jrun(jcfg, Nsim=3, use_structured=False)
    _, H = run_traced(pcfg, Nsim=3, use_structured=False, device="cpu")
    for hk, _ in STATUS:
        np.testing.assert_array_equal(H[hk][:, 0], Hj[hk], err_msg=hk)
    for hk, _ in KEYS + (("Yp", "y"),):
        got, ref = H[hk][:, 0], np.asarray(Hj[hk])
        assert np.abs(got - ref).max() <= 1e-8, hk


def test_unported_features_raise(capsys):
    """The host loop, the hand-off from the host ``MHERuntime``, modifier
    adaptation, collocation, every structured-solver option (item 21: the
    associative-scan Riccati, ``mu_strategy='adaptive'``) and since item
    29 ``SolverOptions.debug`` run: nothing of the host loop is refused any
    more.  ``debug=True`` on the target's options builds the loop, and a
    step prints JAX's per-iteration line of the dense IPM."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.loop.batched import make_mpc_step
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp, make_structured_solver

    cfg = make_config().replace(N=N)
    socp = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device="cpu")
    assert callable(make_structured_solver(socp, cfg.sol_opts_dyn, parallel=True))
    assert callable(make_mpc_step(cfg.replace(sol_opts_dyn=SolverOptions(mu_strategy="adaptive")),
                                  device="cpu"))
    capsys.readouterr()
    # one step, its OCP capped at one iteration (the target's lines are read)
    loop = ClosedLoop(cfg.replace(Nsim=1, sol_opts_ss=SolverOptions(debug=True),
                                  sol_opts_dyn=SolverOptions(max_iter=1)), device="cpu")
    loop.run()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("it=")]
    assert lines[0].startswith("it=0 mu=") and " kkt=" in lines[0] and " feas=" in lines[0]
    assert len(lines) == int(loop.step_stats[0]["ss_iters"])   # one lane


def test_host_entry_points_default_to_the_card():
    """``ClosedLoop``, ``MHERuntime`` and the command line without ``--cpu``
    run on the card: without one they raise."""
    from mpc_code_tpu_torch.estimators.mhe import MHERuntime
    from mpc_code_tpu_torch.examples.__main__ import main
    from mpc_code_tpu_torch.examples.enmpc import make_config
    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.models import build_model

    cfg = make_config(Nsim=1).replace(N=N)
    if torch.cuda.is_available():
        assert ClosedLoop(cfg).device.type == "cuda"
        return
    for call in (lambda: ClosedLoop(cfg), lambda: MHERuntime(cfg, build_model(cfg)),
                 lambda: main(["enmpc", "--nsim", "1", "--n", str(N)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ClosedLoop(cfg, device="cpu").mhe_rt.device.type == "cpu"


def test_loop_entry_points_default_to_the_card():
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step

    cfg = make_config().replace(N=N)
    if torch.cuda.is_available():
        assert init_carry(cfg).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mpc_step(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_carry(cfg)
    c = init_carry(cfg, torch.zeros((2, 3), dtype=torch.float32), device="cpu")
    assert c.x.device.type == "cpu" and c.x.dtype == torch.float32 and c.P.shape == (2, 5, 5)


def test_mhe_entry_points_default_to_the_card():
    """With estimator kind 'mhe': ``make_mpc_step``, ``init_carry``,
    ``run_traced``, ``make_mhe_traced`` and ``make_mhe_cold_carry`` run on
    the card unless ``device="cpu"`` is passed; ``init_carry`` builds the
    cold MHE window of B lanes in the lanes' dtype."""
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_cold_carry, make_mhe_traced
    from mpc_code_tpu_torch.examples.enmpc import make_config
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step, run_traced
    from mpc_code_tpu_torch.models import build_model

    cfg = make_config().replace(N=N)
    calls = (lambda: make_mpc_step(cfg), lambda: init_carry(cfg),
             lambda: run_traced(cfg, Nsim=1), lambda: make_mhe_traced(cfg, build_model(cfg)),
             lambda: make_mhe_cold_carry(cfg))
    if torch.cuda.is_available():
        assert init_carry(cfg).mhe.x_bar.device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    c = init_carry(cfg, torch.zeros((3, 2), dtype=torch.float32), device="cpu")
    assert c.mhe.x_bar.shape == (3, 4) and c.mhe.x_bar.dtype == torch.float32
    assert c.mhe.steps.tolist() == [0, 0, 0] and c.mhe.duals["zl"].shape == (3, 11, 8)
    assert c.mhe.sm.Pycondx_inv.shape == (3, 18, 18)


def test_estimation_only_step_keeps_the_input():
    """``cfg.estimating`` (MPC_code.py:200, 675): the step only measures,
    estimates and moves the plant; the input, targets and warm start stay,
    and no OCP is built (``use_structured=True`` is refused)."""
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step

    cfg = make_config().replace(N=N, estimating=True)
    cfg = cfg.replace(model=dc.replace(cfg.model, Mx=2), plant=dc.replace(cfg.plant, Mx=2))
    with pytest.raises(ValueError, match="estimation-only"):
        make_mpc_step(cfg, use_structured=True, device="cpu")
    step = make_mpc_step(cfg, device="cpu")
    c0 = init_carry(cfg, torch.as_tensor([[0.8, 330.0, 0.6], [0.85, 326.0, 0.65]]),
                    device="cpu")
    assert c0.duals is None
    c1, out = step(c0)
    assert torch.equal(c1.u, c0.u) and torch.equal(c1.w_prev, c0.w_prev)
    assert (out.status_dyn == 0).all() and (out.ocp_iters == 0).all()
    assert not torch.equal(c1.x, c0.x) and not torch.equal(c1.P, c0.P)
    assert torch.isfinite(c1.xhat).all()
