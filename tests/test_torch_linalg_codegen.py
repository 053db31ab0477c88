"""The code generator's matrices, reductions and last elementary functions
against JAX's derivatives, CPU, f64.

Each case is a scalar function of z in R^3 written once in torch and once
in JAX: a traced matrix (``stack`` of traced rows or columns) through
``linalg.solve``/``inv``, products, transposes, reshapes and constant
indexing, a reduction (sum, prod, mean, cumsum, max/min, the 2-norm), or
one of asinh, acosh, atanh, log2, log10, exp2, erfc, erfinv, hypot, fmod,
remainder, floor and round.  ``ops/codegen.py`` lowers the torch function
(``Program``, at orders 1 and 2), and the lowered statements run by
``Program.execute`` under ``torch.func.jacfwd`` (order 1) and
``torch.func.hessian`` (order 2), vmapped over the points, against
``jax.jacfwd`` and ``jax.hessian`` of the JAX function: values and
derivatives within 1e-12, non-finite entries in the same places.  The
points are random ones inside each function's domain and the ties JAX
has a rule for: max/min over two and three equal entries (the tangent
split equally), the 2-norm at the zero vector (nan), hypot at the origin
and at |a| = |b|, round at halves (to even), a pivot tie in the solve
(LAPACK keeps the first row).

The same statements are built for the host with g++ on ``csrc/dual.cuh``
and ``csrc/dual2.cuh`` (``Dual<double, 3>``, ``Dual<float, 3>``,
``Dual2<double, 3>`` and collocation's nested ``Dual2<Dual<double, 1>,
3>``) and held to the same JAX rows.  The JAX references are one jitted
function of all cases, computed once in a module fixture.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import erfc as jerfc
from jax.scipy.special import erfinv as jerfinv

torch.set_num_threads(1)

TOL = 1e-12
NPTS = 6
W3 = (0.7, -1.3, 0.4)          # weights that reduce a vector to a scalar


def _mat(F, z):
    """A traced 3x3 matrix, strictly diagonally dominant by rows on the
    box, whose first column's pivot moves between rows 0 and 1."""
    one = F.ones_like(z[0])
    return F.stack([F.stack([0.6 + 0.1 * z[0], 0.1 * z[2], 0.2 * z[1]]),
                    F.stack([z[1], 2.0 * one, 0.3 * z[0] * z[2]]),
                    F.stack([0.2 * z[2], 0.4 * z[0], 2.5 + z[1] * z[1]])])


def _w(v):
    return W3[0] * v[0] + W3[1] * v[1] + W3[2] * v[2]


class _T:
    """torch's names for the cases' stack, ones_like, transpose and a
    captured constant."""
    stack, ones_like = staticmethod(torch.stack), staticmethod(torch.ones_like)
    t, swap = staticmethod(lambda a: a.t()), staticmethod(lambda a: a.transpose(0, 1))
    const = staticmethod(lambda a: torch.tensor(a, dtype=torch.float64))


class _J:
    stack, ones_like = staticmethod(jnp.stack), staticmethod(jnp.ones_like)
    t = swap = staticmethod(lambda a: a.T)
    const = staticmethod(jnp.asarray)


def _pair(body):
    """A case written once over (F, m): F's stack, ones_like, t and const,
    the library m (torch or jnp)."""
    return (lambda z: body(_T, torch, z), lambda z: body(_J, jnp, z))


def _solve_vec(F, m, z):
    b = F.stack([z[0] * z[1], m.sin(z[2]), 1.0 + z[0]])
    return _w(m.linalg.solve(_mat(F, z), b))


def _solve_mat(F, m, z):
    A = _mat(F, z)
    B = F.stack([F.stack([z[0], z[1], z[2]]), F.stack([z[2] * z[2], 0.5 + 0 * z[0], z[1]])], 1)
    X = m.linalg.solve(A, B)
    return _w(X[:, 0]) + 0.3 * _w(X[:, 1])


def _inv(F, m, z):
    Ai = m.linalg.inv(_mat(F, z))
    return _w(Ai @ F.stack([1.0 + z[0], z[1], z[2] * z[0]])) + 0.1 * Ai[2, 1]


def _pivot_tie(F, m, z):
    """|a00| = |a10| at the special point: the first row is the pivot."""
    A = F.stack([F.stack([z[0], 1.0 + 0 * z[0], 0.5 * z[2]]),
                 F.stack([-z[1], 2.0 + 0 * z[0], 0.3 + 0 * z[0]]),
                 F.stack([0.1 + 0 * z[0], 0.2 * z[2], 3.0 + 0 * z[0]])])
    return _w(m.linalg.solve(A, F.stack([z[2], 1.0 + 0 * z[0], z[0] * z[1]])))


def _products(F, m, z):
    A = _mat(F, z)
    x = F.stack([z[0], z[1] * z[2], 0.5 + z[1]])
    K = F.const([[1.0, 0.5, -0.2], [0.0, 2.0, 0.3], [0.1, -0.4, 1.5]])
    M = A @ A.T
    return (_w(A @ x) + _w(x @ A) + _w(M @ x) + 0.2 * _w((K @ A)[1]) + 0.3 * _w((A @ K)[:, 2])
            + x @ x + 0.1 * _w(A.mT @ x))


def _shapes(F, m, z):
    A = _mat(F, z)
    v = F.stack([z[0], z[1], z[2], z[0] * z[1], z[1] * z[2], 1.0 + 0 * z[0]])
    R = v.reshape(2, 3)
    Tt = F.swap(A)
    return (_w(R[1]) + R[0, 2] * R[1, 0] + _w(Tt[:, 0]) + _w(F.t(A)[2]) + A.reshape(-1)[5]
            + A.flatten()[7] * z[0] + _w(A[1:, :2].reshape(-1)[1:4]))


def _stack_cat(F, m, z):
    x, y = F.stack([z[0], z[1], z[2]]), F.stack([z[2], z[0] * z[1], z[1]])
    S1 = F.stack([x, y], 1)                      # (3, 2): the columns x and y
    S2 = F.stack([x, y], -1)
    C0 = m.concatenate([S1, S2], 0)              # (6, 2)
    C1 = m.concatenate([S1, S2], 1)              # (3, 4)
    return (_w(S1[:, 1]) + C0[4, 0] * C0[1, 1] + _w(C1[:, 3]) + _w(C1[:, 0] * C1[:, 2])
            + _w(m.concatenate([x[:1], y[1:]], 0)))


def _outer_cross(F, m, z):
    x = F.stack([z[0], z[1], 1.0 + z[2]])
    y = F.stack([z[2] * z[1], 0.5 + 0 * z[0], z[0]])
    return (_w(m.outer(x, y)[1]) + _w(m.outer(x, y)[:, 2]) + _w(m.linalg.cross(x, y))
            + _w(m.cross(y, x)) * 0.3)


def _like(F, m, z):
    x = F.stack([z[0], z[1], z[2]])
    return _w(x * m.full_like(x, 0.3) + m.zeros_like(x) + F.ones_like(x) * z[2])


def _reductions(F, m, z):
    A = _mat(F, z)
    x = F.stack([z[0], 1.0 + z[1], z[2] * z[0]])
    return (m.sum(A) + _w(m.sum(A, 0)) + _w(m.sum(A, 1)) + m.prod(x) + _w(m.prod(A, 0))
            + m.mean(A) * z[1] + _w(m.mean(A, 1)) + _w(m.cumsum(x, 0))
            + _w(m.cumsum(A, 1)[:, 2]) + _w(m.cumsum(A, 0)[2]))


def _maxmin(F, m, z):
    """Ties at the special points: (0.5, 0.5, ...) two-way, (1, 1, 1)
    three-way."""
    x = F.stack([z[0], z[1], z[2]])
    A = F.stack([x, F.stack([z[1], z[0], 0.2 + 0 * z[0]])])
    return (m.amax(x) * (1.0 + z[2]) + m.amin(x * x) + _w(m.amax(A, 0))
            + 0.4 * m.amin(A, 1)[0] + 0.2 * m.amax(A, 1)[1])


def _norm2(F, m, z):
    """At the zero vector the derivative is nan, as JAX's."""
    return m.linalg.norm(F.stack([z[0], z[1], z[2]])) * (1.0 + z[0])


def _norm_dim(F, m, z):
    A = _mat(F, z)
    return _w(m.linalg.norm(A, None, 0)) + m.linalg.norm(A) + _w(m.linalg.norm(A, None, 1))


def _hypot(F, m, z):
    """The origin ((0, 0)) and |a| = |b| at the special points."""
    return m.hypot(z[0], z[1]) * (1.0 + z[2]) + m.hypot(z[2], 0.5 + 0 * z[0])


def _fmod(F, m, z):
    return (m.fmod(1.0 + 2.0 * z[0], 0.7 + 0.1 * z[1]) * (1.0 + z[2])
            + m.fmod(-2.0 - z[2], 0.6 + 0 * z[0]) + m.fmod(0.9 + 0 * z[0], 0.4 + 0.1 * z[1]))


def _remainder(F, m, z):
    return (m.remainder(1.0 + 2.0 * z[0], -0.7 - 0.1 * z[1]) * (1.0 + z[2])
            + m.remainder(-2.0 - z[2], 0.6 + 0 * z[0]) + m.remainder(2.3 + z[0], 1.1 + z[1]))


def _floor_round(F, m, z):
    """round at 0.5, 1.5 and 2.5 (to even) at the special points; the
    derivatives are 0."""
    return m.floor(2.0 * z[0]) * z[1] + m.round(z[1] + z[2]) * z[0] + m.round(z[0]) * z[2]


def _gather(F, m, z, tensor, mask):
    x = F.stack([z[0], z[1] * z[2], z[2], z[0] * z[0]])
    A = _mat(F, z)
    return (_w(x[tensor([3, 0, 2])]) + (x[mask([True, False, True, True])] * 0.3).sum()
            + _w(A[tensor([2, 0, 1])][:, 1]) + A[tensor([1, 2])][1, 0])


CASES = {
    "solve_vector": (*_pair(_solve_vec), (-1.0, 1.0), ((0.0, 0.6, 0.2),)),
    "solve_matrix": (*_pair(_solve_mat), (-1.0, 1.0), ()),
    "inv": (*_pair(_inv), (-1.0, 1.0), ()),
    "pivot_tie": (*_pair(_pivot_tie), (-1.0, 1.0), ((0.7, 0.7, 0.3), (-0.5, -0.5, 0.1))),
    "products": (*_pair(_products), (-1.0, 1.0), ()),
    "shapes": (*_pair(_shapes), (-1.0, 1.0), ()),
    "stack_cat": (*_pair(_stack_cat), (-1.0, 1.0), ()),
    "outer_cross": (*_pair(_outer_cross), (-1.0, 1.0), ()),
    "like": (*_pair(_like), (-1.0, 1.0), ()),
    "reductions": (*_pair(_reductions), (-1.0, 1.0), ()),
    "maxmin": (*_pair(_maxmin), (-1.0, 1.0), ((0.5, 0.5, 0.1), (1.0, 1.0, 1.0),
                                              (0.2, -0.7, 0.2))),
    "norm2": (*_pair(_norm2), (-1.0, 1.0), ((0.0, 0.0, 0.0),)),
    "norm_dim": (*_pair(_norm_dim), (-1.0, 1.0), ()),
    "hypot": (*_pair(_hypot), (-1.0, 1.0), ((0.0, 0.0, 0.3), (0.4, -0.4, 0.5),
                                            (0.3, 0.2, -0.5))),
    "fmod": (*_pair(_fmod), (-0.9, 0.9), ((0.2, -0.3, 0.5),)),
    "remainder": (*_pair(_remainder), (-0.9, 0.9), ((0.2, -0.3, 0.5),)),
    "floor_round": (*_pair(_floor_round), (-1.2, 1.2), ((0.25, 0.5, 0.0), (1.25, 0.75, 0.75),
                                                         (0.5, 1.0, 1.5))),
    "gather": (lambda z: _gather(_T, torch, z, torch.tensor, torch.tensor),
               lambda z: _gather(_J, jnp, z, np.asarray, np.asarray), (-1.0, 1.0), ()),
    "max_dim_method": (lambda z: torch.max(_mat(_T, z), 1).values[0] + _mat(_T, z).min()
                       + torch.max(torch.stack([z[0], z[1]]), dim=0)[0] * z[2],
                       lambda z: jnp.max(_mat(_J, z), 1)[0] + jnp.min(_mat(_J, z))
                       + jnp.max(jnp.stack([z[0], z[1]]), 0) * z[2],
                       (-1.0, 1.0), ((0.4, 0.4, 0.2),)),
    "norm_forms": (lambda z: torch.norm(z) + z.norm() * z[0] + torch.linalg.vector_norm(z[:2]),
                   lambda z: (jnp.linalg.norm(z) + jnp.linalg.norm(z) * z[0]
                              + jnp.linalg.norm(z[:2])), (-1.0, 1.0), ()),
}
# the elementary functions, each as f(z_0) (1 + z_1) + 0.3 f(z_2)
UNARY = {
    "asinh": (torch.asinh, jnp.arcsinh, (-2.0, 2.0), ((0.0, 0.3, 0.0),)),
    "acosh": (lambda a: torch.acosh(1.5 + a * a), lambda a: jnp.arccosh(1.5 + a * a),
              (-1.5, 1.5), ()),
    "atanh": (torch.atanh, jnp.arctanh, (-0.8, 0.8), ((0.0, 0.3, 0.0),)),
    "log2": (lambda a: torch.log2(2.0 + a), lambda a: jnp.log2(2.0 + a), (-1.5, 1.5), ()),
    "log10": (lambda a: torch.log10(2.0 + a), lambda a: jnp.log10(2.0 + a), (-1.5, 1.5), ()),
    "exp2": (torch.exp2, jnp.exp2, (-2.0, 2.0), ((0.0, 0.3, 1.0),)),
    "erfc": (torch.erfc, jerfc, (-2.0, 2.0), ((0.0, 0.3, 0.0),)),
    "erfinv": (torch.erfinv, jerfinv, (-0.9, 0.9), ((0.0, 0.3, 0.0),)),
}
for _n, (_tf, _jf, _box, _sp) in UNARY.items():
    CASES[_n] = ((lambda tf: lambda z: tf(z[0]) * (1.0 + z[1]) + 0.3 * tf(z[2]))(_tf),
                 (lambda jf: lambda z: jf(z[0]) * (1.0 + z[1]) + 0.3 * jf(z[2]))(_jf),
                 _box, _sp)


def _points(name, seed):
    _, _, (lo, hi), special = CASES[name]
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (NPTS, 3))
    for k, p in enumerate(special):
        pts[k] = p
    return pts


@pytest.fixture(scope="module")
def jax_refs():
    """Value, Jacobian and Hessian of every case at its points, one jit."""
    names = list(CASES)
    pts = np.stack([_points(n, k) for k, n in enumerate(names)])

    def all_cases(P):
        out = []
        for k, n in enumerate(names):
            f = CASES[n][1]
            out.append((jax.vmap(f)(P[k]), jax.vmap(jax.jacfwd(f))(P[k]),
                        jax.vmap(jax.hessian(f))(P[k])))
        return out

    res = jax.jit(all_cases)(jnp.asarray(pts))
    return {n: (pts[k], [np.asarray(a) for a in res[k]]) for k, n in enumerate(names)}


def _program(name, order):
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    return Program(CASES[name][0], (Arg("z", "dual", 3),), 3, out_dim=None, order=order,
                   what=name)


def _close(got, ref):
    got = np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("order", (1, 2))
@pytest.mark.parametrize("name", list(CASES))
def test_lowered_op_matches_jax(jax_refs, name, order):
    """The lowered statements' value and derivative (Jacobian at order 1,
    Hessian at order 2) against JAX's, at random points and at the ties.
    (A 2-norm at 0 enters every case's component: there forward mode's nan
    reaches the Hessian's entries that reverse mode's zero cotangents keep
    finite, as atan2's at the origin.)"""
    prog = _program(name, order)
    pts, (val, jac, hess) = jax_refs[name]

    def f(z):
        return prog.execute(z=z)[0]

    Z = torch.tensor(pts)
    _close(torch.func.vmap(f)(Z).numpy(), val)
    if order == 1:
        _close(torch.func.vmap(torch.func.jacfwd(f))(Z).numpy(), jac)
    else:
        _close(torch.func.vmap(torch.func.hessian(f))(Z).numpy(), hess)


def test_special_points_take_jax_values(jax_refs):
    """The references sit on JAX's special values: the norm's nan at 0,
    hypot's (1/2, 1/2) at the origin, round to even at halves."""
    assert np.isnan(jax_refs["norm2"][1][1][0]).all()
    np.testing.assert_allclose(jax_refs["hypot"][1][1][0, :2], 1.3 * 0.5, rtol=1e-15)
    # floor(1.0) + round(2.5) 0.5 + round(0.5) 1.5: 1 + 1 + 0 (halves to even)
    assert jax_refs["floor_round"][1][0][2] == 2.0


def test_plain_rules_take_jax_derivatives_at_ties():
    """The plain versions' rules (``ops/jax_rules.py``) where torch's own
    derivative differs from JAX's: max over a dim splits a three-way tie
    equally (torch's gives it all to its index), the 2-norm is nan at 0
    (torch's 0), hypot is (1/2, 1/2) at the origin (torch's nan), and the
    solve's forward-mode derivative under vmap is right (F13)."""
    from mpc_code_tpu_torch.ops.jax_rules import jax_rules

    ones = torch.ones(3, dtype=torch.float64)
    zero = torch.zeros(3, dtype=torch.float64)
    with jax_rules():
        g_max = torch.func.jacfwd(lambda x: torch.max(x, 0).values)(ones)
        g_norm = torch.func.jacfwd(torch.linalg.norm)(zero)
        g_hyp = torch.func.jacrev(lambda x: torch.hypot(x[0], x[1]))(zero)
        Z = torch.tensor(_points("solve_vector", 0))
        g_solve = torch.func.vmap(torch.func.jacfwd(
            lambda z: _solve_vec(_T, torch, z)))(Z)
    torch.testing.assert_close(g_max, ones / 3, rtol=0, atol=1e-15)
    assert torch.isnan(g_norm).all()
    torch.testing.assert_close(g_hyp, torch.tensor([0.5, 0.5, 0.0], dtype=torch.float64))
    ref = jax.vmap(jax.jacfwd(CASES["solve_vector"][1]))(jnp.asarray(Z.numpy()))
    _close(g_solve.numpy(), np.asarray(ref))


def test_lu_counts_lapack_operations():
    """``Program.ops`` of a solve and an inverse of a 3x3 matrix without
    tangents: the compares of the pivot search, one reciprocal a column,
    the multipliers and updates (``_lu_ops``) and a forward and back
    substitution a right side (``_solve_ops``); the selects that exchange
    rows count nothing.  On numbers with tangents each product and sum
    counts its tangents."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program
    from mpc_code_tpu_torch.solver.sweep_kernel import _lu_ops, _solve_ops

    args = (Arg("a", "vec", 9), Arg("b", "vec", 3))

    def solve(a, b):
        return torch.linalg.solve(a.reshape(3, 3), b)

    def inv(a, b):
        return torch.linalg.inv(a.reshape(3, 3)).reshape(-1)

    # the last column's reciprocal forms no multiplier and is not kept
    assert Program(solve, args, 1, out_dim=3).ops == _lu_ops(3) - 1 + _solve_ops(3)
    # the identity's literal zeros skip their updates where no row exchange
    # has made them selects
    inv_ops = Program(inv, args, 1, out_dim=9).ops
    assert _lu_ops(3) - 1 + 3 * 3 < inv_ops <= _lu_ops(3) - 1 + 3 * _solve_ops(3)
    dual = Program(solve, (Arg("a", "dual", 9), Arg("b", "dual", 3)), 12, out_dim=3)
    src = "\n".join(dual.lines)
    assert "mpc_absv(" in src and "mpc_where(" in src
    # a product of two numbers with 12 tangents counts 1 + 3 * 12
    assert dual.ops > (_lu_ops(3) + _solve_ops(3)) * 12


def test_dedup_sees_through_the_pivot_selects():
    """A solve and an inverse of one matrix share the LU's statements."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    args = (Arg("z", "dual", 3),)

    def one(z):
        return _solve_vec(_T, torch, z)

    def two(z):
        return _solve_vec(_T, torch, z) + _solve_vec(_T, torch, z) * z[0]

    assert len(Program(two, args, 3, out_dim=None).lines) <= \
        len(Program(one, args, 3, out_dim=None).lines) + 3


@pytest.mark.parametrize("op", ("cholesky", "det", "traced_index", "three_dims", "ord"))
def test_refused_ops_name_themselves(op):
    """What stays refused raises NotImplementedError naming the op."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    fns = {"cholesky": lambda z: torch.linalg.cholesky(_mat(_T, z))[0, 0],
           "det": lambda z: torch.linalg.det(_mat(_T, z)),
           "traced_index": lambda z: z[(z[0] > 0).long()],
           "three_dims": lambda z: z.reshape(1, 1, 3)[0, 0, 0],
           "ord": lambda z: torch.linalg.norm(z, 1)}
    match = {"cholesky": "cholesky", "det": "det", "traced_index": "long|index",
             "three_dims": "reshape|dims", "ord": "ord=1"}[op]
    with pytest.raises(NotImplementedError, match=match):
        Program(fns[op], (Arg("z", "dual", 3),), 3, out_dim=None)


# ---------------------------------------------------------------------------
# csrc/dual.cuh and csrc/dual2.cuh built for the host
# ---------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mpc_code_tpu_torch", "csrc")
HOST_MAIN = r"""
template <class V> void seed(V* z, const double* p) {
  for (int i = 0; i < 3; ++i) { z[i] = V(p[i]); z[i].d[i] = 1.0; }
}
template <class F> void run(F f, const double* p) {
  // order 1 in f64 and in f32, order 2, and order 2 on numbers whose
  // components carry a tangent along z_0 (collocation's nesting)
  Dual<double, 3> z1[3], r1[1];
  seed(z1, p);
  f.template operator()<Dual<double, 3>, double>(z1, r1);
  std::printf("%.17g %.17g %.17g %.17g\n", r1[0].v, r1[0].d[0], r1[0].d[1], r1[0].d[2]);
  Dual<float, 3> zf[3], rf[1];
  for (int i = 0; i < 3; ++i) { zf[i] = Dual<float, 3>(float(p[i])); zf[i].d[i] = 1.0f; }
  f.template operator()<Dual<float, 3>, float>(zf, rf);
  std::printf("%.9g %.9g %.9g %.9g\n", rf[0].v, rf[0].d[0], rf[0].d[1], rf[0].d[2]);
  Dual2<double, 3> z2[3], r2[1];
  seed(z2, p);
  f.template operator()<Dual2<double, 3>, double>(z2, r2);
  std::printf("%.17g %.17g %.17g %.17g", r2[0].v, r2[0].d[0], r2[0].d[1], r2[0].d[2]);
  for (int q = 0; q < 6; ++q) std::printf(" %.17g", r2[0].h[q]);
  std::printf("\n");
  using E = Dual<double, 1>;
  using VE = Dual2<E, 3>;
  VE z3[3], r3[1];
  for (int i = 0; i < 3; ++i) {
    E e(p[i]);
    e.d[0] = i == 0 ? 1.0 : 0.0;
    z3[i] = VE(e);
    z3[i].d[i] = E(1.0);
  }
  f.template operator()<VE, E>(z3, r3);
  const VE& r = r3[0];
  std::printf("%.17g %.17g %.17g %.17g", r.v.v, r.d[0].v, r.d[1].v, r.d[2].v);
  for (int q = 0; q < 6; ++q) std::printf(" %.17g", r.h[q].v);
  std::printf(" %.17g %.17g %.17g %.17g\n", r.v.d[0], r.d[0].d[0], r.d[1].d[0], r.d[2].d[0]);
}
"""


@pytest.fixture(scope="module")
def host_rows(jax_refs, tmp_path_factory):
    """Each case's lowered statements instantiated on the host with
    ``Dual<double, 3>``, ``Dual<float, 3>``, ``Dual2<double, 3>`` and
    ``Dual2<Dual<double, 1>, 3>``: four rows a point.  Two translation
    units, compiled side by side."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the headers cannot be built on the host")
    names = list(CASES)
    d = tmp_path_factory.mktemp("linalg_host")
    head = ("#include <cmath>\n#include <cstdio>\n#define __device__\n"
            "#define __forceinline__ inline\n#define __host__\n" '#include "dual2.cuh"\n')
    units = [names[::2], names[1::2]]
    procs = []
    for u, part in enumerate(units):
        fns, calls = [], []
        for name in part:
            k = names.index(name)
            body = _program(name, 2).body
            fns.append(f"struct F{k} {{ template <class V, class S> void operator()"
                       f"(const V* z, V* out) const {{\n{body}\n}} }};")
            for p in jax_refs[name][0]:
                pt = ", ".join(repr(float(c)) for c in p)
                calls.append(f"  {{ const double p[3] = {{{pt}}}; run(F{k}(), p); }}")
        (d / f"u{u}.cpp").write_text(head + "\n".join(fns) + HOST_MAIN + "int main() {\n"
                                     + "\n".join(calls) + "\n}\n")
        procs.append(subprocess.Popen(
            [gxx, "-std=c++17", "-O0", "-w", "-I", CSRC, "-o", str(d / f"u{u}"),
             str(d / f"u{u}.cpp")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        assert p.returncode == 0, err[-4000:]
    rows = {}
    for u, part in enumerate(units):
        out = subprocess.run([str(d / f"u{u}")], check=True, capture_output=True,
                             text=True).stdout.split("\n")
        lines = [np.array(line.split(), float) for line in out if line.strip()]
        per = 4 * NPTS
        rows.update({n: lines[k * per:(k + 1) * per] for k, n in enumerate(part)})
    return rows


@pytest.mark.parametrize("name", list(CASES))
def test_cuda_rules_match_jax_on_the_host(jax_refs, host_rows, name):
    """dual.cuh's first-order and dual2.cuh's second-order rules on the
    lowered statements against JAX within 1e-12 (f32: 1e-5 of the value's
    size), and on numbers whose components are Dual: their tangent along
    z_0 is the derivative of the value and of the first-order tangents."""
    pts, (val, jac, hess) = jax_refs[name]
    rows = host_rows[name]
    iu = np.triu_indices(3)
    for k in range(NPTS):
        o1, of, o2, on = rows[4 * k:4 * k + 4]
        _close(o1, np.r_[val[k], jac[k]])
        _close(o2, np.r_[val[k], jac[k], hess[k][iu]])
        _close(on, np.r_[val[k], jac[k], hess[k][iu], jac[k][0], hess[k][0]])
        ref = np.r_[val[k], jac[k]]
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(of), fin)
        assert np.all(np.abs(of[fin] - ref[fin]) <= 1e-5 * (1 + np.abs(ref[fin]))), (k, of, ref)
