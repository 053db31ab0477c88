"""The port's ``ops/sweep_autotune.py`` and the structured solver's two
Gauss-Newton routes, CPU, f64.

The bench's CSTR NMPC OCP at a tiny size (``examples/bench_workload.py``:
N=5, RK4 Mx=2, the saturation guard).  The probe times both candidates
at B=8 lanes and caches its answer in a file of its own
(``sweep_autotune_torch.json``, beside JAX's ``sweep_autotune.json``);
it engages only under ``MPC_TPU_SWEEP_AUTOTUNE=1`` with a batch hint and
never writes ``os.environ``.  ``"fused"`` (the fused stage sweep's
Gauss-Newton build, here its plain version) equals ``"split"`` (the
dynamics sweep plus ``torch.func``) on 4 lanes, and both equal JAX's
Gauss-Newton solve (its split sweep, jitted for one lane).  Where the
fused sweep does not lower the OCP (an OCP without a lowering) the answer
is ``"split"`` without a probe; the u_prev augmentation (DUForm) and the
soft output bounds' slacks, lowered since the fused sweep took them, are
probed.
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NH, MX = 5, 2
OPTS = dict(max_iter=50, tol=1e-8, constr_viol_tol=1e-8, hessian="gauss_newton")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MPC_TPU_AOT_CACHE", str(tmp_path))
    monkeypatch.delenv("MPC_TPU_SWEEP_AUTOTUNE", raising=False)
    return tmp_path


def _problem(**kw):
    from mpc_code_tpu_torch.examples.bench_workload import make_problem

    return make_problem("cpu", Nh=NH, Mx=MX, **kw)


def test_probe_caches_in_its_own_file_and_leaves_the_environment(cache):
    from mpc_code_tpu_torch.ops import sweep_autotune as sa

    cfg, _, socp, _ = _problem()

    def knobs():
        return {k: v for k, v in os.environ.items() if k.startswith("MPC_TPU")}

    env = knobs()
    n0 = sa.PROBES
    impl = sa.autotune_sweep_impl(cfg, socp, 8)
    assert impl in ("split", "fused") and sa.PROBES == n0 + 1
    assert set(sa.LAST_TIMES) == {"split", "fused"}
    assert all(t > 0 for t in sa.LAST_TIMES.values())
    assert sa.autotune_sweep_impl(cfg, socp, 8) == impl and sa.PROBES == n0 + 1
    assert knobs() == env
    assert os.listdir(cache) == ["sweep_autotune_torch.json"]
    # another batch is another key
    sa.autotune_sweep_impl(cfg, socp, 4)
    assert sa.PROBES == n0 + 2


def test_autotune_engages_only_with_the_knob_and_a_hint(cache, monkeypatch):
    from mpc_code_tpu_torch.ops import sweep_autotune as sa

    n0 = sa.PROBES
    assert _problem(batch_hint=8)[2].sweep_impl == "split" and sa.PROBES == n0
    monkeypatch.setenv("MPC_TPU_SWEEP_AUTOTUNE", "1")
    assert _problem()[2].sweep_impl == "split" and sa.PROBES == n0
    cfg, _, socp, _ = _problem(batch_hint=8)
    assert sa.PROBES == n0 + 1
    assert socp.sweep_impl == sa.autotune_sweep_impl(cfg, socp, 8)
    # an OCP without a lowering: 'split' without a probe
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    bare = dc.replace(socp, lowering=None)
    assert sa.autotune_sweep_impl(cfg, bare, 8) == "split" and sa.PROBES == n0 + 1
    with pytest.raises(ValueError, match="impl='fused' needs"):
        make_structured_solver(bare, SolverOptions(**OPTS), impl="fused")
    # DUForm (the u_prev augmentation) and the shared slacks: lowered, so probed
    du = _problem(batch_hint=8, DUForm=True)[2]
    assert du.lowering.nup == 2 and du.sweep_impl in ("split", "fused")
    assert sa.PROBES == n0 + 2
    soft = _problem(batch_hint=8, slacks=True, Ws=10.0 * np.eye(4))[2]
    assert soft.lowering.ns == 4 and soft.sweep_impl in ("split", "fused")
    assert sa.PROBES == n0 + 3
    with pytest.raises(ValueError, match="unknown impl"):
        make_structured_solver(socp, SolverOptions(**OPTS), impl="pallas")


def _lanes(cfg, model, n=4):
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, bench_params, draw_x0, warm_start,
    )

    x0 = draw_x0(n, "cpu", seed=3, dtype=torch.float64)
    u = torch.as_tensor(U_SS, dtype=torch.float64).expand(n, cfg.nu)
    X0, U0 = warm_start(cfg, model, x0, u, Nh=NH)
    return bench_params(cfg, x0, Nh=NH), X0, U0


def _jax_gn(par, X0, U0):
    """JAX's Gauss-Newton solve of each lane (its split sweep), jitted once."""
    import jax
    import jax.numpy as jnp

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
        assert socp.stage_dyn_jac is not None
    finally:
        mp.undo()
    solve = jax.jit(make_structured_solver(socp, SolverOptions(**OPTS)))
    out = []
    for i in range(len(X0)):
        p = {k: jnp.asarray(np.asarray(v)[i] if k == "x0" else np.asarray(v, float))
             for k, v in par.items()}
        out.append(jax.device_get(solve(p, jnp.asarray(X0[i].numpy()),
                                        jnp.asarray(U0[i].numpy()))))
    return out


def test_fused_equals_split_and_jax():
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    cfg, model, socp, _ = _problem()
    par, X0, U0 = _lanes(cfg, model)
    split, fused = (make_structured_solver(socp, SolverOptions(**OPTS), impl=i)(par, X0, U0)
                    for i in ("split", "fused"))
    assert (split.status == 0).all()
    assert torch.equal(split.status, fused.status) and torch.equal(split.iters, fused.iters)
    for f in ("X", "U"):
        assert (getattr(split, f) - getattr(fused, f)).abs().max() <= 1e-10, f
    for i, jr in enumerate(_jax_gn(par, X0, U0)):
        assert int(split.iters[i]) == int(jr.iters) and int(jr.status) == 0, i
        for got, ref in ((fused.X[i], jr.X), (fused.U[i], jr.U)):
            assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-8, i
