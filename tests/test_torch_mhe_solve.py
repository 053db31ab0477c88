"""The structured MHE solve of the port against the JAX package, CPU, f64.

The linear configuration of ``tests/test_mhe.py::test_mhe_structured_engine_matches_dense``
(A = [[0.8, 0.1], [0, 0.9]], B = [0.5, 1], C = I, output disturbances,
n = 4, p = 2, N_mhe = 4, QP cost 0.1 I / 0.01 I, the default ``sol_opts_mhe``
at tol 1e-10), with and without the w box (+-0.7); two lanes of window
data from a seeded simulation of the plant, solved in one batched call:

- ``make_structured_mhe_solver`` against JAX's jitted solve of each lane:
  the same status and iteration count, w (the dense layout, v rebuilt)
  within 1e-8;
- a second, warm-started solve on the window shifted by one measurement,
  from each side's ``shift_mhe_duals`` of the first solve's duals, against
  JAX's the same way;
- the structured solve against the port's dense engine (``build_mhe_nlp``
  through the dense IPM) within 1e-7, as JAX's test holds its engines.

About 15 s in one process on the CPU, most of it JAX's compiles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N = 4
LANES = 2
A = np.array([[0.8, 0.1], [0.0, 0.9]])
Bm = np.array([[0.5], [1.0]])


def _config(pkg, wbox):
    c = __import__(f"{pkg}.config", fromlist=["MPCConfig"])
    n = 4
    return c.MPCConfig(
        nx=2, nu=1, ny=2, nd=2, Nsim=30, N=5, h=1.0,
        model=c.LinearModel(A=A, B=Bm, C=np.eye(2)),
        plant=c.LinearPlant(Ap=A, Bp=Bm, Cp=np.eye(2)),
        dist=c.DisturbanceModel(offree="lin", Bd=np.zeros((2, 2)), Cd=np.eye(2)),
        x0_p=np.array([0.5, -0.2]), x0_m=np.zeros(2), u0=np.zeros(1),
        ss_cost=c.SSCost(Qss=np.eye(2), Rss=np.zeros((1, 1))),
        stage_cost=c.StageCost(Q=np.eye(2), R=0.1 * np.eye(1)),
        estimator=c.EstimatorConfig(
            kind="mhe", N_mhe=N, mhe_up="filter", structured_mhe=True,
            mhe_cost=c.MHECost(Q=0.1 * np.eye(n), R=0.01 * np.eye(2)), P0=np.eye(n)),
        bounds=c.Bounds(umin=np.array([-3.0]), umax=np.array([3.0]),
                        **(dict(wmin=-0.7 * np.ones(n), wmax=0.7 * np.ones(n))
                           if wbox else {})))


def _parts(cfg, jax_side):
    if jax_side:
        from mpc_code_tpu.estimators.linear import build_augmented
        from mpc_code_tpu.models import build_model
        from mpc_code_tpu.models.costs import build_mhe_cost
        from mpc_code_tpu.models.model import build_mhe_model
    else:
        from mpc_code_tpu_torch.estimators.linear import build_augmented
        from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    model = build_model(cfg)
    return (build_mhe_model(cfg, model), build_augmented(cfg, model).fy,
            build_mhe_cost(cfg.estimator.mhe_cost))


def _windows(seed):
    """Two consecutive windows of one lane (the second shifted by one
    measurement) from a noisy simulation of the plant, and their guesses."""
    rng = np.random.default_rng(seed)
    x = np.array([0.5, -0.2]) + 0.1 * rng.normal(size=2)
    us, ys = [], []
    for k in range(N + 1):
        u = np.array([np.sin(0.3 * k + seed)])
        x = A @ x + Bm @ u + 0.01 * rng.normal(size=2)
        us.append(u)
        ys.append(x + 0.2 + 0.005 * rng.normal(size=2))     # an output offset: d
    x_bar = np.concatenate([ys[0] - 0.2, [0.1, 0.1]])
    out = []
    for s in (0, 1):
        par = dict(U=np.stack(us[s:s + N]), Y=np.stack(ys[s:s + N]), x_bar=x_bar,
                   P_inv=np.eye(4) * (1.0 + s), T=np.arange(s, s + N, dtype=float),
                   PX=np.zeros((N, 2)), PY=np.zeros((N, 2)))
        w0 = np.zeros(N * 10 + 4)
        for i in range(N + 1):
            w0[i * 10:i * 10 + 4] = x_bar
        out.append((w0, par))
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["no_wbox", "wbox"])
def case(request):
    """JAX's results (two windows per lane, the second warm-started from
    the first's shifted duals) and the port's solvers and inputs."""
    from mpc_code_tpu.ocp.mhe import make_structured_mhe_solver as jmake
    from mpc_code_tpu.ocp.mhe import shift_mhe_duals as jshift

    wbox = request.param
    jcfg = _config("mpc_code_tpu", wbox)
    jsolve = jax.jit(jmake(jcfg, *_parts(jcfg, True), N, N, return_duals=True))
    lanes = [_windows(seed) for seed in range(LANES)]
    ref = []
    for (w0a, pa), (w0b, pb) in lanes:
        ja = {k: jnp.asarray(v) for k, v in pa.items()}
        jb = {k: jnp.asarray(v) for k, v in pb.items()}
        r1, d1 = jsolve(jnp.asarray(w0a), ja)
        r2, _ = jsolve(jnp.asarray(w0b), jb, ws=jshift(d1))
        ref.append(tuple({k: np.asarray(getattr(r, k)) for k in ("w", "status", "iters")}
                         for r in (r1, r2)))
    return wbox, lanes, ref


def _stack(lanes, s):
    w0 = torch.as_tensor(np.stack([ln[s][0] for ln in lanes]))
    par = {k: torch.as_tensor(np.stack([ln[s][1][k] for ln in lanes])) for k in lanes[0][s][1]}
    return w0, par


def _check(res, ref, s, tol):
    for lane in range(LANES):
        r = ref[lane][s]
        assert int(res.status[lane]) == int(r["status"]) == 0
        assert int(res.iters[lane]) == int(r["iters"])
        assert np.abs(res.w[lane].numpy() - r["w"]).max() <= tol


def test_structured_solve_matches_jax_cold_then_warm(case):
    from mpc_code_tpu_torch.ocp.mhe import make_structured_mhe_solver, shift_mhe_duals

    wbox, lanes, ref = case
    pcfg = _config("mpc_code_tpu_torch", wbox)
    solve = make_structured_mhe_solver(pcfg, *_parts(pcfg, False), N, N,
                                       return_duals=True, device="cpu")
    res1, d1 = solve(*_stack(lanes, 0))
    _check(res1, ref, 0, 1e-8)
    res2, _ = solve(*_stack(lanes, 1), ws=shift_mhe_duals(d1))
    _check(res2, ref, 1, 1e-8)
    # the warm start takes no more iterations than a cold solve of it
    cold2, _ = solve(*_stack(lanes, 1))
    assert (res2.iters <= cold2.iters).all()


def test_structured_matches_dense_engine(case):
    from mpc_code_tpu_torch.ocp.mhe import build_mhe_nlp, make_structured_mhe_solver
    from mpc_code_tpu_torch.solver.ipm import make_solver

    wbox = case[0]
    pcfg = _config("mpc_code_tpu_torch", wbox)
    parts = _parts(pcfg, False)
    spec = build_mhe_nlp(pcfg, *parts, N, N)
    dense = make_solver(spec.nlp, pcfg.sol_opts_mhe)
    structured = make_structured_mhe_solver(pcfg, *parts, N, N, device="cpu")
    lanes = [_windows(seed) for seed in range(LANES)]
    w0, par = _stack(lanes, 0)
    rd = dense(w0, par, spec.lbw, spec.ubw, spec.lbg, spec.ubg)
    rs = structured(w0, par)
    assert (rd.status == 0).all() and (rs.status == 0).all()
    assert (rs.w - rd.w).abs().max() <= 1e-7
