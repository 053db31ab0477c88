"""The port's structured solver under each option of ``SolverOptions``
and ``parallel`` against the JAX package's, CPU, f64.

The CSTR NMPC OCP of the bench (``examples/nmpc.py``, N=10, RK4 Mx=2,
the bench's saturation guard), Gauss-Newton Hessian, tol 1e-8, three
lanes drawn with a numpy seed, each from x0 tiled over the horizon.  The
JAX solver takes its split sweep (MPC_TPU_FAST_SWEEP=1, the lanes-minor
layout), as the port's takes kernel 1's plain version, and is jitted once
per option for one lane and run lane by lane; the port solves the three
lanes as one batch.

- ``mu_strategy`` 'adaptive' and 'mehrotra', ``ls_mode='backtrack'``,
  ``sweep_every=2``, ``dual_init='costate'`` and ``parallel=True``:
  statuses and iterations equal, X and U within 1e-8 (normalised
  ``|a-b|/(1+|b|)``).  ``parallel=True`` is held as tightly: the
  associative scan pairs its elements as ``jax.lax.associative_scan``
  does, so its rounding follows JAX's, and its merges' small solves are
  LAPACK's pivoted LU on both sides.
- ``ls_parallel=True`` under backtracking gives the sequential search's
  result bit for bit, on lanes where the search backtracks.
- ``parallel=True`` with TermCons raises JAX's ``ValueError``.
- Pins of the ways a batched port goes wrong: each lane's barrier under
  'adaptive' and 'mehrotra' is its own (a batch of two lanes with very
  different complementarity gives each lane what it gets alone); kernel
  2 is idle under ``parallel=True``; Mehrotra solves the KKT system twice
  a pass.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N = 10
XS = np.array([0.874317, 325.0, 0.6528])
US = np.array([300.157, 0.1])
BASE = dict(max_iter=60, tol=1e-8, hessian="gauss_newton")
# name -> (SolverOptions fields over BASE, parallel)
OPTIONS = {
    "adaptive": (dict(mu_strategy="adaptive"), False),
    "mehrotra": (dict(mu_strategy="mehrotra"), False),
    "backtrack": (dict(ls_mode="backtrack"), False),
    "sweep_every": (dict(sweep_every=2), False),
    "costate": (dict(dual_init="costate"), False),
    "parallel": ({}, True),
}


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _cfgs(**replace):
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port

    guard = dict(Mx=2, clip_lo=np.array([0.0, 280.0, 0.4]),
                 clip_hi=np.array([2.0, 420.0, 1.0]))
    jcfg = make_jax().replace(N=N, R_wn=None, **replace)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, **guard))
    return jcfg, config_from_numpy(jcfg, make_port().replace(N=N, R_wn=None))


def _jax_ocp(jcfg):
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp

    return build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                                build_terminal_cost(jcfg))


def _port_ocp(pcfg):
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                                build_terminal_cost(pcfg), device="cpu")


def _lanes(n=3, seed=5):
    x0 = np.random.default_rng(seed).uniform([0.4, 320, 0.56], [0.9, 334, 0.67], (n, 3))
    par = dict(x0=x0, xs=XS, us=US, d=np.array([0.0, 0.1]), um1=US, t=0.0,
               lam=np.zeros((2, 2)), px=np.zeros((N, 1)), py=np.zeros((N, 2)))
    return par, np.tile(x0[:, None], (1, N + 1, 1)), np.tile(US, (n, N, 1))


def _port_solve(socp, parallel=False, **opts):
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    return make_structured_solver(socp, SolverOptions(**dict(BASE, **opts)), parallel=parallel)


@pytest.fixture(scope="module")
def ocps():
    """Both packages' OCPs (JAX's with its split sweep)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        jcfg, pcfg = _cfgs()
        js = _jax_ocp(jcfg)
        assert js.stage_dyn_jac is not None
    finally:
        mp.undo()
    return js, _port_ocp(pcfg)


@pytest.fixture(scope="module")
def jax_results(ocps):
    """JAX's result of every option on every lane: name -> list of lane
    results (numpy)."""
    from mpc_code_tpu.config import SolverOptions
    from mpc_code_tpu.solver.riccati import make_structured_solver

    js = ocps[0]
    par, X0, U0 = _lanes()
    out = {}
    for name, (opts, parallel) in OPTIONS.items():
        solve = jax.jit(make_structured_solver(js, SolverOptions(**dict(BASE, **opts)),
                                               parallel=parallel))
        out[name] = [jax.device_get(solve(
            {k: jnp.asarray(v[i] if k == "x0" else v) for k, v in par.items()},
            jnp.asarray(X0[i]), jnp.asarray(U0[i]))) for i in range(len(X0))]
    return out


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name, ocps, jax_results):
    opts, parallel = OPTIONS[name]
    par, X0, U0 = _lanes()
    r = _port_solve(ocps[1], parallel, **opts)(par, torch.as_tensor(X0), torch.as_tensor(U0))
    for i, jr in enumerate(jax_results[name]):
        assert int(r.status[i]) == int(jr.status) == 0, (name, i)
        assert int(r.iters[i]) == int(jr.iters), (name, i)
        for got, ref in ((r.X[i], jr.X), (r.U[i], jr.U)):
            assert _nerr(got.numpy(), ref) <= 1e-8, (name, i)


def _count_trips(socp):
    """``socp`` whose map counts its calls (one a line-search trip, the
    trials of a trip batched in one call) and the counter."""
    calls = []

    def dyn(xa, u, pk):
        calls.append(None)
        return socp.dyn(xa, u, pk)

    return dc.replace(socp, dyn=dyn), calls


def test_ls_parallel_is_backtracking_bit_for_bit(ocps):
    """All twelve trials of a pass in one batched rollout pick the first
    acceptable step, so the whole solve equals the sequential search's
    bit for bit (JAX ``tests/test_riccati.py:620``); on these lanes
    (``tests/test_riccati.py:629-632``'s box, seed 11) the sequential
    search takes more trips than passes: it backtracks."""
    par, X0, U0 = _lanes(6, seed=11)
    socp, calls = _count_trips(ocps[1])
    args = (par, torch.as_tensor(X0), torch.as_tensor(U0))
    seq = _port_solve(socp, ls_mode="backtrack", max_iter=40)(*args)
    passes = int((seq.iters + (seq.status == 0).to(seq.iters.dtype)).max())
    trips = len(calls)
    par_ls = _port_solve(ocps[1], ls_mode="backtrack", ls_parallel=True, max_iter=40)(*args)
    for f in ("X", "U", "status", "iters", "kkt_err", "feas_err", "lam", "zl", "zu", "mu"):
        assert torch.equal(getattr(seq, f), getattr(par_ls, f)), f
    assert (seq.status == 0).all()
    assert trips > passes, (trips, passes)


def test_parallel_with_termcons_raises_jax_error():
    from mpc_code_tpu.config import SolverOptions as JOpts
    from mpc_code_tpu.solver.riccati import make_structured_solver as jmss
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    jcfg, pcfg = _cfgs(TermCons=True)
    with pytest.raises(ValueError) as jerr:
        jmss(_jax_ocp(jcfg), JOpts(), parallel=True)
    with pytest.raises(ValueError) as perr:
        make_structured_solver(_port_ocp(pcfg), SolverOptions(), parallel=True)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("strategy", ["adaptive", "mehrotra"])
def test_barrier_is_per_lane(strategy, ocps):
    """A lane at the setpoint (small complementarity from the start) and
    one far from it, four iterations: in one batch each lane's barrier,
    iterate and duals are what it gets alone, and the two barriers differ
    by more than 10x (a reduction over the batch would give both one)."""
    par, X0, U0 = _lanes(2)
    x0 = np.stack([XS, [0.4, 320.0, 0.56]])
    X0 = np.tile(x0[:, None], (1, N + 1, 1))
    solve = _port_solve(ocps[1], mu_strategy=strategy, max_iter=4)

    def run(idx):
        return solve(dict(par, x0=x0[idx]), torch.as_tensor(X0[idx]), torch.as_tensor(U0[idx]))

    both = run(slice(None))
    for i in range(2):
        alone = run(slice(i, i + 1))
        for f in ("X", "U", "mu", "zl", "zu", "lam"):
            assert _nerr(getattr(both, f)[i].numpy(), getattr(alone, f)[0].numpy()) <= 1e-12, f
    mu = both.mu.numpy()
    assert max(mu) > 10 * min(mu), mu


def _count_kkt(monkeypatch):
    """Counters of the solver's two Riccati solves (kernel 2's wrapper and
    the associative scan), called through the solver module."""
    from mpc_code_tpu_torch.solver import riccati

    calls = {"riccati_kkt": 0, "riccati_parallel": 0}
    for name in calls:
        fn = getattr(riccati, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(riccati, name, counted)
    return calls


@pytest.mark.parametrize("name, per_pass", [("parallel", (0, 1)), ("mehrotra", (2, 0)),
                                            ("backtrack", (1, 0))])
def test_kkt_solves_per_pass(name, per_pass, ocps, monkeypatch):
    """Kernel 2 once a loop pass, twice under Mehrotra (the predictor and
    the corrector share one sweep), never under ``parallel=True``, whose
    associative scan takes its place once a pass."""
    calls = _count_kkt(monkeypatch)
    opts, parallel = OPTIONS[name]
    par, X0, U0 = _lanes()
    r = _port_solve(ocps[1], parallel, **opts)(par, torch.as_tensor(X0), torch.as_tensor(U0))
    passes = int((r.iters + (r.status == 0).to(r.iters.dtype)).max())
    assert (calls["riccati_kkt"], calls["riccati_parallel"]) == (
        per_pass[0] * passes, per_pass[1] * passes)


def test_associative_scan_pairs_as_jax():
    """``associative_scan`` against ``jax.lax.associative_scan`` with
    ``fn(a, b) = 2 a + 3 b`` on small integers: not associative, so the
    result spells out the tree of combinations and the order of each
    pair's arguments; exact in f64.  Equal bit for bit, forward and
    reverse, at lengths 1 to 9."""
    from mpc_code_tpu_torch.solver.riccati import associative_scan

    rng = np.random.default_rng(3)
    for n in range(1, 10):
        v = rng.integers(-4, 5, size=(2, n)).astype(float)
        for reverse in (False, True):
            got = associative_scan(lambda a, b: (2.0 * a[0] + 3.0 * b[0],),
                                   (torch.as_tensor(v),), reverse=reverse)[0].numpy()
            ref = jax.vmap(lambda x: jax.lax.associative_scan(
                lambda a, b: 2.0 * a + 3.0 * b, x, reverse=reverse))(jnp.asarray(v))
            np.testing.assert_array_equal(got, np.asarray(ref))


# make_problem's arguments per run: each argument at least once (the
# option's arithmetic is held against JAX above)
PIPELINE_RUNS = {
    "parallel": dict(parallel=True),
    "mehrotra": dict(mu_strategy="mehrotra"),
    "ls_parallel": dict(ls_mode="backtrack", ls_parallel=True),
    "sweep_every": dict(sweep_every=2),
    "costate": dict(dual_init="costate"),
    "du_exact": dict(hessian="exact", DUForm=True),
}


@pytest.mark.parametrize("name", list(PIPELINE_RUNS))
def test_bench_workload_takes_each_option(name):
    """``examples/bench_workload.py`` takes each option as an argument of
    ``make_problem`` (no environment variable) and runs its pipeline on
    four lanes in f64 (N=8, Mx=2, the rescue at 2x4 lanes); a non-monotone
    pass 1 gets a second, monotone solver for the rescue
    (``bench.py:111-120``)."""
    from mpc_code_tpu_torch.examples.bench_workload import draw_x0, make_problem, run_pipeline

    cfg, model, socp, solve = make_problem("cpu", Nh=8, Mx=2, **PIPELINE_RUNS[name])
    assert (solve.rescue is solve.solve) == ("mu_strategy" not in PIPELINE_RUNS[name])
    status, iters, _, _, U, times = run_pipeline(
        cfg, model, solve, draw_x0(4, "cpu", dtype=torch.float64), rescue_cap=4, Nh=8,
        nup=socp.nxa - cfg.nx - socp.ns)
    assert (status != 2).all() and np.isfinite(U).all() and U.dtype == np.float64
