"""The code generator on non-finite inputs (F8), CPU, torch only.

``ops/codegen.py`` folds an identity only when it is exact for every input.
``a * 0`` is not one: ``inf * 0`` and ``nan * 0`` are nan in torch, in JAX
and in the kernels, which ``nvcc`` builds without fast-math.  Each case runs
the lowered statements (``Program.execute``) and the function they came
from on the same input and asks for the same values, nan and inf included:
a constant identity matrix times a vector holding inf, a product by the
literal 0 of a nan, and the bench's exact-path stage cost with one state
at inf.
"""

import math

import pytest
import torch

from mpc_code_tpu_torch.ops.codegen import Arg, Program

torch.set_num_threads(1)


def _same(got, ref):
    got = torch.stack([torch.as_tensor(g, dtype=torch.float64) for g in got])
    ref = torch.as_tensor(ref, dtype=torch.float64).reshape(got.shape)
    assert torch.equal(got.isnan(), ref.isnan()), (got, ref)
    assert torch.equal(got.isinf(), ref.isinf()), (got, ref)
    fin = got.isfinite()
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(got[got.isinf()], ref[ref.isinf()], rtol=0, atol=0)


def _identity_matvec():
    C = torch.eye(2, dtype=torch.float64)

    def f(x):
        return C @ x

    prog = Program(f, (Arg("x", "vec", 2),), nz=0, out_dim=2)
    x = torch.tensor([1.0, math.inf], dtype=torch.float64)
    return prog.execute(x=x), f(x)


def _times_literal_zero():
    def f(x):
        return x[0] * 0.0 + x[1]

    prog = Program(f, (Arg("x", "dual", 2),), nz=2, out_dim=None)
    x = torch.tensor([math.nan, 0.5], dtype=torch.float64)
    return prog.execute(x=x), f(x)


def _exact_stage_cost():
    from mpc_code_tpu_torch.examples.bench_workload import make_problem
    from mpc_code_tpu_torch.solver.riccati import POINT_ARGS
    from mpc_code_tpu_torch.solver.sweep_kernel import stage_programs

    cfg, _, s, _ = make_problem("cpu", Nh=4, Mx=2, hessian="exact")
    low = s.lowering
    _, cost, _ = stage_programs(low, s.nxa, s.nu, s.ni, cfg.nd, cfg.npx, cfg.npy)
    f64 = dict(dtype=torch.float64)
    ins = dict(xa=torch.tensor([0.5, math.inf, 0.6], **f64),
               u=torch.tensor([300.0, 0.1], **f64), t=torch.tensor(0.0, **f64),
               xs=torch.tensor([0.874317, 325.0, 0.6528], **f64),
               us=torch.tensor([300.157, 0.1], **f64),
               d=torch.tensor([0.0, 0.1], **f64), um1=torch.tensor([300.157, 0.1], **f64),
               lam=torch.zeros(low.ny, s.nu, **f64),
               py=torch.zeros(cfg.npy, **f64), py0=torch.zeros(cfg.npy, **f64))
    ref = low.cost(*[ins[k] for k in ("xa", "u") + POINT_ARGS])
    ins["lam"] = ins["lam"].reshape(-1)
    return cost.execute(**ins), ref


@pytest.mark.parametrize("case", [_identity_matvec, _times_literal_zero, _exact_stage_cost],
                         ids=["identity_matvec", "times_literal_zero", "exact_stage_cost"])
def test_lowering_keeps_non_finite_values(case):
    got, ref = case()
    assert not torch.as_tensor(ref).isfinite().all()
    _same(got, ref)


def test_product_by_one_folds_and_by_zero_stays():
    """``x * 1`` is exact for every x and is folded; ``0 * x`` stays as one
    statement."""
    def f(x):
        return x * 1.0 + 0.0 * x

    prog = Program(f, (Arg("x", "dual", 1),), nz=1, out_dim=1)
    assert "S(1.0)" not in prog.body
    assert prog.body.count("(S(0.0) * x[0])") == 1
    assert prog.ops == 1 + 1 + 2          # the product (value, tangent), the sum
