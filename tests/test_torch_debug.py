"""``SolverOptions(debug=True)`` in both of the port's solvers and
``solver/ipm.py::kkt_error``, against the JAX package's, CPU, f64.

JAX prints one line per iteration with ``jax.debug.print`` (under
``vmap``, one per lane); the port prints the same line, with the same
field names and format specs, for every lane at every pass, in lane
order.  At one lane the two runs' lines are parsed and held to each
other: the iteration counters equal, ``mu``, ``kkt`` and ``feas`` equal
to 1e-8 relative (a difference below 1e-14, a residual of rounding size
such as 0 against 5.6e-17, counts as none), or one unit apart in the
last digit the format prints (two values closer than 1e-8 that straddle
a rounding boundary of ``.2e``).  Text is not compared.  At three lanes the port prints
3 x passes lines.  The structured solve is the bench's CSTR OCP at
N=5, RK4 Mx=2, Gauss-Newton (JAX on its split sweep); the dense solve is
Ex_ENMPC's steady-state target.
"""

import dataclasses as dc
import functools
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NH, MX = 5, 2
STRUCT_OPTS = dict(max_iter=50, tol=1e-8, constr_viol_tol=1e-8, hessian="gauss_newton")
TARGET_OPTS = dict(max_iter=100, tol=1e-8)
STRUCT_LINE = re.compile(
    r"it=(\d+) mu=(\S+) a=\S+ amax=\S+ acc=(True|False) slv=(True|False) "
    r"\|dX\|=\S+ \|dU\|=\S+ nupen=\S+ psi0=\S+ kkt=(\S+) feas=(\S+) done=(True|False)$")
DENSE_LINE = re.compile(
    r"it=(\d+) mu=(\S+) a=\S+ ad=\S+ amax=\S+ acc=(True|False) \|dw\|=\S+ nu=\S+ "
    r"dlt=\S+ kkt=(\S+) feas=(\S+)$")


def _parse(text, pat):
    """(it, mu, kkt, feas) strings of every line of ``text`` that ``pat``
    matches."""
    out = []
    for line in text.splitlines():
        m = pat.search(line.strip())
        if m:
            g = m.groups()
            kkt, feas = (g[4], g[5]) if pat is STRUCT_LINE else (g[3], g[4])
            out.append((int(g[0]), g[1], kkt, feas))
    return out


def _printed_close(a, b, rel=1e-8, floor=1e-14):
    """Two printed numbers equal to ``rel`` (residuals of rounding size,
    below ``floor``, count as equal), or one unit apart in their last
    printed digit."""
    x, y = float(a), float(b)
    if abs(x - y) <= rel * max(abs(x), abs(y)) + floor:
        return True
    mant = b.split("e")[0]
    digits = len(mant.split(".")[1]) if "." in mant else 0
    unit = 10.0 ** (int(b.split("e")[1]) - digits)
    return abs(x - y) <= unit * (1 + 1e-6)


def _same_lines(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0], (g, w)
        for a, b in zip(g[1:], w[1:]):
            assert _printed_close(a, b), (g, w)


def _cstr():
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, bench_params, draw_x0, make_problem, warm_start,
    )

    cfg, model, socp, _ = make_problem("cpu", Nh=NH, Mx=MX)
    x0 = draw_x0(3, "cpu", seed=3, dtype=torch.float64)
    u = torch.as_tensor(U_SS, dtype=torch.float64).expand(3, cfg.nu)
    X0, U0 = warm_start(cfg, model, x0, u, Nh=NH)
    return socp, bench_params(cfg, x0, Nh=NH), X0, U0


def _jax_cstr_solver(debug):
    import jax

    from mpc_code_tpu.config import SolverOptions
    from mpc_code_tpu.examples.nmpc import make_config
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.examples.bench_workload import CLIP_HI, CLIP_LO

    mp = pytest.MonkeyPatch()
    mp.setenv("MPC_TPU_FAST_SWEEP", "1")
    mp.setenv("MPC_TPU_SWEEP_IMPL", "lanes")
    try:
        cfg = make_config().replace(N=NH, R_wn=None)
        cfg = cfg.replace(model=dc.replace(cfg.model, Mx=MX, clip_lo=CLIP_LO.astype(np.float32),
                                           clip_hi=CLIP_HI.astype(np.float32)))
        socp = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                    build_terminal_cost(cfg))
    finally:
        mp.undo()
    return jax.jit(make_structured_solver(socp, SolverOptions(debug=debug, **STRUCT_OPTS)))


def test_structured_debug_lines_match_jax(capfd):
    import jax
    import jax.numpy as jnp

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    socp, par, X0, U0 = _cstr()
    solve = _jax_cstr_solver(True)
    p0 = {k: jnp.asarray(np.asarray(v)[0] if k == "x0" else np.asarray(v, float))
          for k, v in par.items()}
    capfd.readouterr()
    jr = jax.device_get(solve(p0, jnp.asarray(X0[0].numpy()), jnp.asarray(U0[0].numpy())))
    jax.effects_barrier()
    want = _parse(capfd.readouterr().out, STRUCT_LINE)
    par1 = dict(par, x0=par["x0"][:1])
    r = make_structured_solver(socp, SolverOptions(debug=True, **STRUCT_OPTS))(
        par1, X0[:1], U0[:1])
    got = _parse(capfd.readouterr().out, STRUCT_LINE)
    assert int(r.iters[0]) == int(jr.iters) and int(r.status[0]) == int(jr.status) == 0
    _same_lines(got, want)
    assert got[-1][0] == int(r.iters[0])    # the converged lane's last pass


def test_structured_debug_prints_every_lane_every_pass(capfd):
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    socp, par, X0, U0 = _cstr()
    capfd.readouterr()
    r = make_structured_solver(socp, SolverOptions(debug=True, **STRUCT_OPTS))(par, X0, U0)
    lines = _parse(capfd.readouterr().out, STRUCT_LINE)
    passes = int((r.iters + (r.status == 0).to(r.iters.dtype)).max())
    assert len(lines) == 3 * passes
    # lane order within a pass: the pass counter of each lane
    assert [it for it, *_ in lines[:3]] == [0, 0, 0]


def _enmpc_target(pkg):
    """Ex_ENMPC's target NLP in package ``pkg`` ('jax' or 'torch'): (spec,
    model, cfg)."""
    import importlib

    root = "mpc_code_tpu" if pkg == "jax" else "mpc_code_tpu_torch"
    ex = importlib.import_module(f"{root}.examples.enmpc")
    models = importlib.import_module(f"{root}.models")
    target = importlib.import_module(f"{root}.ocp.target")
    cfg = ex.make_config()
    model = models.build_model(cfg)
    return target.build_target(cfg, model, models.build_ss_cost(cfg.ss_cost)), model, cfg


D_LANES = np.array([[0.01, -0.02], [0.0, 0.0], [-0.03, 0.02]])


def _port_target_solve(debug, lanes):
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.ipm import make_solver

    ts, model, cfg = _enmpc_target("torch")
    B = len(lanes)
    f64 = dict(dtype=torch.float64)
    d = torch.as_tensor(lanes, **f64)
    x0_m = torch.as_tensor(cfg.x0_m, **f64).expand(B, -1)
    u0 = torch.as_tensor(cfg.u0, **f64).expand(B, -1)
    par = dict(usp=torch.zeros(B, 1, **f64), ysp=torch.zeros(B, 2, **f64),
               xsp=torch.zeros(B, 2, **f64), d=d, us_prev=u0,
               lam=torch.zeros(B, 2, 1, **f64), t=torch.zeros(B, **f64),
               px=torch.zeros(B, 2, **f64), py=torch.zeros(B, 2, **f64))
    y0 = torch.func.vmap(model.fy)(x0_m, u0, d, par["t"], par["py"])
    w0 = torch.cat([x0_m, u0, y0], -1)
    solve = make_solver(ts.nlp, SolverOptions(debug=debug, **TARGET_OPTS))
    return ts, par, solve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)


@functools.lru_cache(maxsize=None)
def _jax_target():
    """JAX's target solve of one lane with ``debug=True`` and its
    ``kkt_error``, jitted once: ``d -> (IPMResult, kkt_error dict)``."""
    import jax
    import jax.numpy as jnp

    from mpc_code_tpu.config import SolverOptions
    from mpc_code_tpu.solver.ipm import kkt_error, make_solver

    ts, model, cfg = _enmpc_target("jax")
    tsolve = make_solver(ts.nlp, SolverOptions(debug=True, **TARGET_OPTS))
    x0_m, u0 = jnp.asarray(cfg.x0_m, float), jnp.asarray(cfg.u0, float)

    def target(d):
        par = dict(usp=jnp.zeros(1), ysp=jnp.zeros(2), xsp=jnp.zeros(2), d=d,
                   us_prev=u0, lam=jnp.zeros((2, 1)), t=jnp.asarray(0.0),
                   px=jnp.zeros(2), py=jnp.zeros(2))
        w0 = jnp.concatenate([x0_m, u0, model.fy(x0_m, u0, d, 0.0, jnp.zeros(2))])
        r = tsolve(w0, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)
        return r, kkt_error(ts.nlp, r, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)

    target = jax.jit(target)
    return lambda d: jax.device_get(target(jnp.asarray(d)))


def test_dense_debug_lines_match_jax(capfd):
    import jax

    solve = _jax_target()
    capfd.readouterr()
    jr, _ = solve(D_LANES[0])
    jax.effects_barrier()
    want = _parse(capfd.readouterr().out, DENSE_LINE)
    _, _, r = _port_target_solve(True, D_LANES[:1])
    got = _parse(capfd.readouterr().out, DENSE_LINE)
    assert int(r.iters[0]) == int(jr.iters) and int(r.status[0]) == int(jr.status) == 0
    _same_lines(got, want)


def test_dense_debug_prints_every_lane_every_iteration(capfd):
    capfd.readouterr()
    _, _, r = _port_target_solve(True, D_LANES)
    lines = _parse(capfd.readouterr().out, DENSE_LINE)
    assert len(lines) == 3 * int(r.iters.max())
    assert [it for it, *_ in lines[:3]] == [0, 0, 0]


def test_kkt_error_matches_jax():
    from mpc_code_tpu_torch.solver import kkt_error

    ts, par, r = _port_target_solve(False, D_LANES)
    got = kkt_error(ts.nlp, r, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)
    assert set(got) == {"feas_g", "feas_box", "kkt"}
    for i, d in enumerate(D_LANES):
        _, want = _jax_target()(d)
        for k in ("feas_g", "feas_box"):
            assert abs(float(got[k][i]) - float(want[k])) <= 1e-10, (k, i)
        assert float(got["kkt"][i]) == pytest.approx(float(want["kkt"]), rel=1e-8, abs=1e-14)
    # a point off its bounds shows its violation
    r_off = r._replace(w=r.w + 10.0)
    off = kkt_error(ts.nlp, r_off, par, ts.lbw, ts.ubw, ts.lbg, ts.ubg)
    assert (off["feas_box"] > 0).all() or (off["feas_g"] > 0).all()
