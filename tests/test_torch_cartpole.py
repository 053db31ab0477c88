"""The cart-pole OCP (``chip_smoke.py``'s, acados's getting-started
pendulum on a cart), whose dynamics need ``sin`` and ``cos``, through the
port's structured solver against the JAX package's, CPU, f64.

N=5 intervals of the example's 0.05 s, RK4 at Mx=2, 2 lanes from
``CARTPOLE_BOX`` (seed 0), under the Gauss-Newton Hessian (kernel 1's
plain version beside ``torch.func`` for the cost) and the exact one
(kernel 5's plain version, after the lowering the card's build takes):
statuses and iterations equal, X and U within 1e-8 (normalised
``|a-b|/(1+|b|)``).

The exact Hessian solves to tol 1e-8.  The Gauss-Newton run is held after
12 passes (tol 1e-12: no lane stops early): this OCP's Gauss-Newton
iteration counts to a tolerance follow rounding, in both packages (the
weights of 1e3 put the merit near 155, and a relative change of 1e-15 in
x0 moves a lane's count by up to 4 at tol 1e-6; at tol 1e-8 a lane's
adaptive step took 0.25 in one package and 1 in the other at the same
iterate), while the iterate after 12 passes moves by 3e-10
(``chip_smoke.py``'s cart-pole phase holds the card's Gauss-Newton run to
the CPU's after a fixed number of passes, the exact run to tol 1e-8).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

N, MX, LANES = 5, 2, 2
OPTS = {"gauss_newton": dict(max_iter=12, tol=1e-12, constr_viol_tol=1e-12),
        "exact": dict(max_iter=100, tol=1e-8)}


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


@pytest.fixture(scope="module")
def problems():
    from mpc_code_tpu import config as jconfig
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp
    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.models import build_model as pbm
    from mpc_code_tpu_torch.models import build_stage_cost as pbs
    from mpc_code_tpu_torch.models import build_terminal_cost as pbt
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp as pbso

    jcfg = cs.cartpole_config(jconfig, jnp, N=N, Mx=MX)
    pcfg = cs.cartpole_config(pconfig, torch, N=N, Mx=MX)
    js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                              build_terminal_cost(jcfg))
    ps = pbso(pcfg, pbm(pcfg), pbs(pcfg.stage_cost), pbt(pcfg), device="cpu")
    x0 = cs.cartpole_x0(LANES)
    par = cs.upright_params(pcfg, x0, N)
    X0 = np.repeat(x0[:, None], N + 1, 1)
    return js, ps, par, X0, np.zeros((LANES, N, 1))


@pytest.mark.parametrize("hessian", ("gauss_newton", "exact"))
def test_cartpole_matches_jax(problems, hessian):
    from mpc_code_tpu.config import SolverOptions as JSO
    from mpc_code_tpu.solver.riccati import make_structured_solver as jmss
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import sweep_kernel
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    js, ps, par, X0, U0 = problems
    assert ps.lowering is not None
    opts = dict(OPTS[hessian], hessian=hessian)
    fused = []
    real = sweep_kernel.StageSweep.plain

    def counted(self, *a):
        fused.append(self.hessian)
        return real(self, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(sweep_kernel.StageSweep, "plain", counted)
    try:
        r = make_structured_solver(ps, SolverOptions(**opts))(
            par, torch.as_tensor(X0), torch.as_tensor(U0))
    finally:
        mp.undo()
    jr = jax.jit(jax.vmap(jmss(js, JSO(**opts))))(
        {k: jnp.asarray(v) for k, v in par.items()}, jnp.asarray(X0), jnp.asarray(U0))
    # the exact Hessian's derivatives come from kernel 5 (its plain version
    # here), the Gauss-Newton's from kernel 1's and torch.func
    assert bool(fused) == (hessian == "exact")
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(jr.status))
    assert (r.status.numpy() == 0).all() == (hessian == "exact")
    np.testing.assert_array_equal(r.iters.numpy(), np.asarray(jr.iters))
    assert _nerr(r.X.numpy(), jr.X) <= 1e-8 and _nerr(r.U.numpy(), jr.U) <= 1e-8


def test_unsolvable_lanes_take_no_direction():
    """F17: on a lane whose KKT solve fails, kernel 2 carries finite values
    (its clamped pivots) where the plain version carries NaN.  The solver
    takes no direction there either way: the cart-pole's check lanes (lane
    6's solve fails on pass 1 under the exact Hessian) give the same
    iterates after 8 passes when the recursion's NaN are replaced by the
    large finite values the kernel leaves."""
    from mpc_code_tpu_torch import config as pconfig
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import riccati

    cfg = cs.cartpole_config(pconfig, torch)
    ps = cs.structured(cfg, torch.device("cpu"))
    x0 = torch.as_tensor(cs.cartpole_x0(cs.CARTPOLE_B)[:8])
    opts = SolverOptions(hessian="exact", max_iter=8, tol=0.0, constr_viol_tol=0.0)
    ref = cs.upright_solve(cfg, ps, x0, opts)
    real, failed = riccati.riccati_kkt, []

    def finite(*a, **k):
        ok, *rest = real(*a, **k)
        failed.append(int((~ok).sum()))
        return (ok, *[torch.where(torch.isfinite(o), o, torch.full_like(o, 1e96))
                      for o in rest])

    mp = pytest.MonkeyPatch()
    mp.setattr(riccati, "riccati_kkt", finite)
    try:
        got = cs.upright_solve(cfg, ps, x0, opts)
    finally:
        mp.undo()
    assert sum(failed) > 0
    assert torch.equal(got.X, ref.X) and torch.equal(got.U, ref.U)
