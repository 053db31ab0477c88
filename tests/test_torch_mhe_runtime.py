"""The port's host MHE (``estimators/mhe.py::MHERuntime``) and the hand-off from it, against the JAX package, CPU, f64.

- ``MHERuntime.step`` against JAX's ``MHERuntime`` step by step through
  the growing-horizon warmup (one window NLP per horizon length), the
  first full window and steady steps (N_mhe + 3 = 7 steps): the linear
  configuration of ``tests/test_torch_mhe_solve.py`` (after JAX's
  ``tests/test_mhe.py:84,234``) under 'filter' and 'smooth', each with
  the structured and the dense engine, and ENMPC's nonlinear MHE
  ('smooth', the reactor's RK4 at Mx_mhe=2, N_mhe=4, structured).  x_corr,
  P, every window buffer, the smoothing state (the rolling stacks, Hbig,
  Obig, Pycondx_inv, the bookkeeping filter's P and estimate) and the
  latest NLP inputs within 1e-8; every window solve converged (status 0).
- ``carry_from_runtime`` field by field against JAX's (the port's with a
  leading lane axis of 1, ``steps`` None as JAX's), the runtime's duals
  carried; its ValueErrors (the window size, the update, a window not yet
  full, the smoothing stacks).
- The hand-off continuation (the analog of ``tests/test_mhe.py:163-217``):
  the port's ``ClosedLoop`` for K0 = 6 steps, ``carry_from_runtime`` and
  ``init_carry(state=...)``, then the batched step for T = 5 steps, equal
  to the port's full ``ClosedLoop`` run in U within 1e-9.
- ``examples/enmpc_loop_workload.py``'s warm hand-off at a small size
  (N=5, N_mhe=3, Mx=2, 3 lanes, f32 and f64): the host warmup, the tiled
  carry, two batched steps.

JAX's runtimes jit a solver per horizon length.  About 60 s in one
process on the CPU, most of it JAX's compiles.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from test_torch_mhe_solve import A, Bm, _config

torch.set_num_threads(1)

N = 4
STEPS = N + 3
TOL = 1e-8
BUFFERS = ("U", "Y", "T", "Xmin", "X", "V", "W", "PX", "PY", "x_bar", "w_k", "v_k",
           "P_k_kal", "P_corr_kal", "xm_kal", "Hbig", "Obig", "Pycondx_inv")
STACKS = ("bigC", "bigG", "bigA", "bigB", "bigf", "bigh", "bigQk", "bigRk", "bigSk",
          "bigQ", "bigU", "bigP", "bigPc")


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) if a.size else 0.0


def _linear(up, structured):
    jcfg, pcfg = _config("mpc_code_tpu", False), _config("mpc_code_tpu_torch", False)
    for c in (jcfg, pcfg):
        c.estimator = dc.replace(c.estimator, mhe_up=up, structured_mhe=structured)
    return jcfg, pcfg


def _enmpc():
    from mpc_code_tpu.examples.enmpc import make_config as jmake
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as pmake

    jcfg = jmake(Nsim=4)
    jcfg.estimator = dc.replace(jcfg.estimator, N_mhe=N, Mx_mhe=2)
    return jcfg, config_from_numpy(jcfg, pmake(Nsim=4))


def _data(kind):
    """Per step (y, u, xhat_min, t, px, py) for one lane."""
    rng = np.random.default_rng(5)
    out, x = [], np.array([0.5, -0.2])
    for k in range(STEPS):
        if kind == "linear":
            u = np.array([np.sin(0.3 * k)])
            x = A @ x + Bm @ u + 0.01 * rng.normal(size=2)
            y, t = x + 0.005 * rng.normal(size=2), float(k)
        else:
            x = np.array([0.45, 0.35]) + 0.02 * rng.normal(size=2)
            y, u, t = x + 0.01 * rng.normal(size=2), 0.9 + 0.3 * rng.uniform(size=1), 2.0 * k
        xm = np.concatenate([x, np.zeros(2)]) + 0.01 * rng.normal(size=4)
        out.append((y, u, xm, t, np.zeros(2), np.zeros(2)))
    return out


CASES = {f"linear-{up}-{eng}": (lambda up=up, eng=eng: _linear(up, eng == "structured"),
                                "linear")
         for up in ("filter", "smooth") for eng in ("structured", "dense")}
CASES["enmpc-smooth-structured"] = (_enmpc, "enmpc")


def _runtime(cfg, jax_side):
    if jax_side:
        from mpc_code_tpu.estimators.mhe import MHERuntime
        from mpc_code_tpu.models import build_model

        return MHERuntime(cfg, build_model(cfg))
    from mpc_code_tpu_torch.estimators.mhe import MHERuntime
    from mpc_code_tpu_torch.models import build_model

    return MHERuntime(cfg, build_model(cfg), device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def runtimes(request):
    make, kind = CASES[request.param]
    jcfg, pcfg = make()
    jr, pr = _runtime(jcfg, True), _runtime(pcfg, False)
    n = jr.n
    Pj = Pp = np.eye(n)
    rows = []
    for k, (y, u, xm, t, px, py) in enumerate(_data(kind)):
        xj, Pj = jr.step(k, y, u, xm, t, px, py, Pj)
        xp, Pp = pr.step(k, y, u, xm, t, px, py, Pp)
        rows.append(dict(x=(np.asarray(xp), np.asarray(xj)), P=(np.asarray(Pp), np.asarray(Pj)),
                         status=pr.last_status,
                         bufs={b: (np.asarray(getattr(pr, b)), np.asarray(getattr(jr, b)))
                               for b in BUFFERS},
                         stacks={s: (list(getattr(pr, s)), list(getattr(jr, s))) for s in STACKS},
                         nlp=(pr.last_nlp, jr.last_nlp)))
    return request.param, jcfg, pcfg, jr, pr, rows, (Pp, Pj)


def test_runtime_steps_match_jax(runtimes):
    name, _, _, _, _, rows, _ = runtimes
    for k, r in enumerate(rows):
        assert r["status"] == 0, (name, k)
        for what in ("x", "P"):
            assert _diff(*r[what]) <= TOL, (name, k, what)
        for b, pair in r["bufs"].items():
            assert _diff(*pair) <= TOL, (name, k, b)
        for s, (got, ref) in r["stacks"].items():
            assert len(got) == len(ref), (name, k, s)
            for a, c in zip(got, ref):
                assert _diff(a, c) <= TOL, (name, k, s)
        (pn, jn) = r["nlp"]
        assert pn["N"] == jn["N"] == min(k + 1, N)
        assert _diff(pn["w0"], jn["w0"]) <= TOL
        for key, v in jn["par"].items():
            assert _diff(pn["par"][key], v) <= TOL, (name, k, key)
    if "smooth" in name:
        assert np.abs(rows[-1]["bufs"]["Pycondx_inv"][0]).max() > 0


def test_carry_from_runtime_matches_jax(runtimes):
    from mpc_code_tpu.estimators.mhe import make_mhe_traced as jtraced
    from mpc_code_tpu.models import build_model as jbuild
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced
    from mpc_code_tpu_torch.models import build_model

    name, jcfg, pcfg, jr, pr, _, (Pp, Pj) = runtimes
    _, jfrom = jtraced(jcfg, jbuild(jcfg))
    _, pfrom = make_mhe_traced(pcfg, build_model(pcfg), device="cpu")
    jc, pc = jfrom(jr, Pj), pfrom(pr, Pp)
    assert pc.steps is None and jc.steps is None
    for f in ("U", "Y", "T", "Xmin", "PX", "PY", "X", "V", "W", "x_bar", "P"):
        got, ref = getattr(pc, f), np.asarray(getattr(jc, f))
        assert got.shape == (1,) + ref.shape and got.dtype == torch.float64, f
        assert _diff(got[0].numpy(), ref) <= TOL, f
    assert (pc.sm is None) == (jc.sm is None)
    if jc.sm is not None:
        for f in jc.sm._fields:
            assert _diff(getattr(pc.sm, f)[0].numpy(), getattr(jc.sm, f)) <= TOL, f
    assert (pc.duals is None) == (jc.duals is None)
    if jc.duals is not None:
        assert bool(pc.duals["ok"][0]) == bool(jc.duals["ok"])
        for f in ("zl", "zu", "lam", "nus", "mu", "sf"):
            assert _diff(pc.duals[f][0].numpy(), jc.duals[f]) <= 1e-6, f


def test_carry_from_runtime_refuses_what_jax_refuses():
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced
    from mpc_code_tpu_torch.models import build_model

    _, pcfg = _linear("smooth", True)
    model = build_model(pcfg)
    rt = _runtime(pcfg, False)
    _, from_rt = make_mhe_traced(pcfg, model, device="cpu")
    P = np.eye(4)
    with pytest.raises(ValueError, match="not full yet"):
        from_rt(rt, P)
    for k, (y, u, xm, t, px, py) in enumerate(_data("linear")[:N]):
        _, P = rt.step(k, y, u, xm, t, px, py, P)
    assert from_rt(rt, P).sm.bigA.shape == (1, N - 1, 4, 4)
    other = dc.replace(pcfg, estimator=dc.replace(pcfg.estimator, N_mhe=N + 1))
    with pytest.raises(ValueError, match="N_mhe mismatch"):
        make_mhe_traced(other, model, device="cpu")[1](rt, P)
    other = dc.replace(pcfg, estimator=dc.replace(pcfg.estimator, mhe_up="filter"))
    with pytest.raises(ValueError, match="mhe_up mismatch"):
        make_mhe_traced(other, model, device="cpu")[1](rt, P)
    rt.bigA = rt.bigA[1:]
    with pytest.raises(ValueError, match="smooth buffers"):
        from_rt(rt, P)


def _handoff_config(Nsim):
    """The linear MHE-MPC loop of ``tests/test_mhe.py:163-217`` in the
    port's config."""
    cfg = _config("mpc_code_tpu_torch", False).replace(
        Nsim=Nsim, N=8, defSP=lambda t: (np.array([0.6, 0.3]), np.zeros(1), np.zeros(2)))
    cfg.estimator = dc.replace(cfg.estimator, structured_mhe=False)
    return cfg


def test_handoff_continuation_equals_the_host_loop():
    from mpc_code_tpu_torch.estimators.mhe import make_mhe_traced
    from mpc_code_tpu_torch.loop import ClosedLoop
    from mpc_code_tpu_torch.loop.batched import (
        history_from_outputs, init_carry, make_mpc_step, stack_outputs,
    )
    from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

    K0, T = 6, 5
    H_full = ClosedLoop(_handoff_config(K0 + T), device="cpu").run()
    loop = ClosedLoop(_handoff_config(K0), device="cpu")
    H0 = loop.run()
    np.testing.assert_array_equal(H0["U"], H_full["U"][:K0])
    st = loop.final_state
    cfg = _handoff_config(K0 + T)
    _, from_rt = make_mhe_traced(cfg, loop.model, device="cpu")
    carry = init_carry(cfg, mhe=from_rt(loop.mhe_rt, st["P"]), state=st, device="cpu")
    step = make_mpc_step(cfg, device="cpu")
    inputs = make_step_inputs(cfg, T, t0=st["t"], k0=K0)
    outs = []
    for k in range(T):
        carry, out = step(carry, StepInput(*(a[k] for a in inputs)))
        outs.append(out)
    H = history_from_outputs(stack_outputs(outs))
    assert (H["STATUS_DYN"] == 0).all() and (H["MHE_STATUS"] == 0).all()
    assert carry.mhe.steps is None
    assert np.abs(H["U"][:, 0] - H_full["U"][K0:]).max() <= 1e-9
    assert np.abs(H["D_HAT"][:, 0] - H_full["D_HAT"][K0:]).max() <= 1e-7


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_enmpc_workload_warm_handoff(dtype):
    from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw

    cfg = mw.make_config(N=5, N_mhe=3, warm_handoff=True)
    cfg = cfg.replace(model=dc.replace(cfg.model, Mx=2), plant=dc.replace(cfg.plant, Mx=2))
    cfg.estimator = dc.replace(cfg.estimator, Mx_mhe=2)
    if dtype == torch.float64:
        from mpc_code_tpu_torch.config import SolverOptions

        cfg = cfg.replace(sol_opts_ss=SolverOptions(), sol_opts_mhe=SolverOptions(tol=1e-10),
                          sol_opts_dyn=SolverOptions(hessian="gauss_newton"))
    carry, loop, H0, warm_s = mw.warm_handoff(cfg, 3, "cpu", dtype=dtype)
    k0 = mw.handoff_steps(cfg)
    assert len(H0["U"]) == k0 == 5 and warm_s > 0
    assert carry.x.shape == (3, 2) and carry.x.dtype == dtype and carry.mhe.steps is None
    assert carry.mhe.x_bar.shape == (3, 4) and carry.mhe.duals["ok"].all()
    dx = carry.x.double() - torch.as_tensor(loop.final_state["x"])
    assert 1e-5 < float(dx.abs().max()) < 1e-2
    H, times = mw.run_loop(cfg, None, Nsim=2, device="cpu", step=mw.make_step(cfg, "cpu"),
                           carry=carry, t0=loop.final_state["t"], k0=k0)
    assert (H["STATUS_DYN"] == 0).all() and (H["MHE_STATUS"] == 0).all()
    assert np.isfinite(H["U"]).all() and len(times) == 2
    assert (H["MHE_ITERS"] <= 3).all()
