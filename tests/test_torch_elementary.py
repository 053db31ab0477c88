"""The code generator's elementary functions against JAX's derivatives, CPU, f64.

Each case is a scalar function of z in R^2 written once in torch and once
in JAX: an elementary function of z_0 times (1 + z_1) (so that the Hessian
holds f, f' and f'' of the function), or a function of both components
(``atan2``, ``pow`` with a traced exponent, ``clamp`` with a traced
bound).  ``ops/codegen.py`` lowers the torch function (``Program``, at
order 1 and at order 2), and the lowered statements run by
``Program.execute`` under ``torch.func.jacfwd`` (order 1) and
``torch.func.hessian`` (order 2), vmapped over the points, against
``jax.jacfwd`` and ``jax.hessian`` of the JAX function: values and
derivatives within 1e-12, non-finite entries in the same places.  The
points are random ones inside each function's domain and JAX's special
points: the clamp ties (derivative 0.5), ``atan2`` at the origin (nan),
``pow`` at base 0 (derivative 0 in the exponent), ``sign`` at 0.

The JAX references are one jitted function of all cases, computed once in
a module fixture.  The text checks: the emitted CUDA names the new
``mpc_*`` functions, ``Program.ops`` of one program, and what the code
generator still refuses.  ``csrc/dual.cuh``'s and ``csrc/dual2.cuh``'s
own rules are held to the same references in
``tests/test_torch_elementary_host.py``.
"""

import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import erf as jerf

torch.set_num_threads(1)

TOL = 1e-12
NPTS = 8


C03 = torch.tensor(-0.3, dtype=torch.float64)       # a captured constant


def _unary(tfn, jfn):
    return (lambda z: tfn(z[0]) * (1.0 + z[1]), lambda z: jfn(z[0]) * (1.0 + z[1]))


# name -> (torch function of z, JAX function of z, box of the random z_0
# (z_1 in [-0.5, 0.5]), special points)
CASES = {
    "exp": (*_unary(torch.exp, jnp.exp), (-2.0, 2.0), ()),
    "log": (*_unary(torch.log, jnp.log), (0.2, 3.0), ()),
    "sqrt": (*_unary(torch.sqrt, jnp.sqrt), (0.2, 3.0), ()),
    "tanh": (*_unary(torch.tanh, jnp.tanh), (-2.0, 2.0), ((0.0, 0.3),)),
    "sigmoid": (*_unary(torch.sigmoid, jax.nn.sigmoid), (-3.0, 3.0), ((0.0, 0.3),)),
    "sigmoid_method": (*_unary(lambda a: a.sigmoid(), jax.nn.sigmoid), (-3.0, 3.0), ()),
    "expit": (*_unary(torch.special.expit, jax.nn.sigmoid), (-3.0, 3.0), ()),
    "sin": (*_unary(torch.sin, jnp.sin), (-3.0, 3.0), ((0.0, 0.3),)),
    "cos": (*_unary(torch.cos, jnp.cos), (-3.0, 3.0), ((0.0, 0.3),)),
    "tan": (*_unary(torch.tan, jnp.tan), (-1.2, 1.2), ()),
    "asin": (*_unary(torch.asin, jnp.arcsin), (-0.9, 0.9), ((0.0, 0.3),)),
    "arcsin_method": (*_unary(lambda a: a.arcsin(), jnp.arcsin), (-0.9, 0.9), ()),
    "acos": (*_unary(torch.acos, jnp.arccos), (-0.9, 0.9), ()),
    "atan": (*_unary(torch.atan, jnp.arctan), (-3.0, 3.0), ()),
    "sinh": (*_unary(torch.sinh, jnp.sinh), (-2.0, 2.0), ()),
    "cosh": (*_unary(torch.cosh, jnp.cosh), (-2.0, 2.0), ()),
    "log1p": (*_unary(torch.log1p, jnp.log1p), (-0.5, 2.0), ((0.0, 0.3),)),
    "expm1": (*_unary(torch.expm1, jnp.expm1), (-2.0, 2.0), ((0.0, 0.3),)),
    "rsqrt": (*_unary(torch.rsqrt, jax.lax.rsqrt), (0.2, 3.0), ()),
    "reciprocal": (*_unary(torch.reciprocal, lambda a: 1.0 / a), (0.3, 2.0), ((-0.7, 0.2),)),
    "square": (*_unary(torch.square, jnp.square), (-2.0, 2.0), ((0.0, 0.3),)),
    "erf": (*_unary(torch.erf, jerf), (-2.0, 2.0), ((0.0, 0.3),)),
    "sign": (*_unary(torch.sign, jnp.sign), (-2.0, 2.0), ((0.0, 0.3), (-0.0, 0.1))),
    "atan2": (lambda z: torch.atan2(z[0], z[1]), lambda z: jnp.arctan2(z[0], z[1]),
              (-2.0, 2.0), ((0.0, 0.0), (0.0, -1.0), (1.0, 0.0))),
    "atan2_method": (lambda z: z[1].atan2(z[0] + 1.5), lambda z: jnp.arctan2(z[1], z[0] + 1.5),
                     (-1.0, 1.0), ()),
    "atan2_const": (lambda z: torch.atan2(0.5 * (1.0 + z[1]), z[0]) + torch.atan2(z[0], C03),
                    lambda z: jnp.arctan2(0.5 * (1.0 + z[1]), z[0]) + jnp.arctan2(z[0], -0.3),
                    (-2.0, 2.0), ()),
    "pow": (lambda z: torch.pow(z[0], z[1] + 2.0), lambda z: jnp.power(z[0], z[1] + 2.0),
            (0.2, 3.0), ((0.0, 0.5), (0.0, 1.0), (2.0, -2.0))),
    "pow_operator": (lambda z: z[0] ** (3.0 * z[1]), lambda z: z[0] ** (3.0 * z[1]),
                     (0.2, 3.0), ()),
    "pow_method": (lambda z: z[0].pow(z[1]) * 2.0, lambda z: jnp.power(z[0], z[1]) * 2.0,
                   (0.2, 3.0), ()),
    "pow_scalar_base": (lambda z: 2.0 ** (z[0] * (1.0 + z[1])),
                        lambda z: 2.0 ** (z[0] * (1.0 + z[1])), (-2.0, 2.0), ()),
    "pow_literal": (lambda z: z[0] ** 2.5 * (1.0 + z[1]), lambda z: z[0] ** 2.5 * (1.0 + z[1]),
                    (0.2, 3.0), ((0.0, 0.3),)),
    "clamp": (*_unary(lambda a: torch.clamp(a, -0.3, 0.5), lambda a: jnp.clip(a, -0.3, 0.5)),
              (-1.0, 1.0), ((0.5, 0.2), (-0.3, 0.1))),
    "clamp_kwargs": (*_unary(lambda a: torch.clamp(a, min=-0.3) + torch.clip(a, max=0.5),
                             lambda a: jnp.clip(a, -0.3) + jnp.clip(a, None, 0.5)),
                     (-1.0, 1.0), ((0.5, 0.2), (-0.3, 0.1))),
    "clip_method": (*_unary(lambda a: a.clip(-0.3, 0.5) - a.clamp(max=0.5),
                            lambda a: jnp.clip(a, -0.3, 0.5) - jnp.clip(a, None, 0.5)),
                    (-1.0, 1.0), ((0.5, 0.2),)),
    "clamp_traced": (lambda z: torch.clamp(z[0], min=z[1], max=0.8) * (2.0 + z[1]),
                     lambda z: jnp.clip(z[0], z[1], 0.8) * (2.0 + z[1]),
                     (-1.0, 1.0), ((0.25, 0.25), (0.8, 0.1))),
}


def _points(name, seed):
    _, _, (lo, hi), special = CASES[name]
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(lo, hi, NPTS), rng.uniform(-0.5, 0.5, NPTS)], 1)
    for k, p in enumerate(special):
        pts[k] = p
    return pts


@pytest.fixture(scope="module")
def jax_refs():
    """Value, Jacobian, Hessian and the Hessian's derivative along z_0 of
    every case at its points, one jit."""
    names = list(CASES)
    pts = np.stack([_points(n, k) for k, n in enumerate(names)])

    def all_cases(P):
        out = []
        for k, n in enumerate(names):
            f = CASES[n][1]
            out.append((jax.vmap(f)(P[k]), jax.vmap(jax.jacfwd(f))(P[k]),
                        jax.vmap(jax.hessian(f))(P[k]),
                        jax.vmap(jax.jacfwd(jax.hessian(f)))(P[k])[..., 0]))
        return out

    res = jax.jit(all_cases)(jnp.asarray(pts))
    return {n: (pts[k], [np.asarray(a) for a in res[k]]) for k, n in enumerate(names)}


def _program(name, order):
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    return Program(CASES[name][0], (Arg("z", "dual", 2),), 2, out_dim=None, order=order,
                   what=name)


def _close(got, ref):
    got = np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("order", (1, 2))
@pytest.mark.parametrize("name", list(CASES))
def test_lowered_function_matches_jax(jax_refs, name, order):
    """The lowered statements' value and derivative (Jacobian at order 1,
    Hessian at order 2) against JAX's, at random and special points."""
    prog = _program(name, order)
    pts, (val, jac, hess, _) = jax_refs[name]

    def f(z):
        return prog.execute(z=z)[0]

    Z = torch.tensor(pts)
    _close(torch.func.vmap(f)(Z).numpy(), val)
    if order == 1:
        _close(torch.func.vmap(torch.func.jacfwd(f))(Z).numpy(), jac)
    else:
        _close(torch.func.vmap(torch.func.hessian(f))(Z).numpy(), hess)


def test_special_points_take_jax_values(jax_refs):
    """The values the port follows JAX in, where torch differs."""
    assert jax_refs["clamp"][1][1][0, 0] == 0.5 * 1.2        # clip's tie, times 1 + z_1
    assert np.isnan(jax_refs["atan2"][1][1][0]).all()         # atan2 at the origin
    assert (jax_refs["pow"][1][1][:2, 1] == 0.0).all()        # d/db at a = 0
    assert jax_refs["sign"][1][1][0, 0] == 0.0


def _all_ops_ode(x, t, u, d, px):
    return torch.stack([
        torch.tanh(x[0]) + torch.sigmoid(x[1]) * torch.sin(u[0]) - torch.cos(x[2]),
        torch.atan2(x[0], u[1]) + torch.clamp(x[1], min=px[0], max=2.0) + x[2] ** u[0]
        + torch.sign(x[0]) * torch.erf(x[1]),
        torch.tan(x[2]) + torch.asin(0.9 * torch.tanh(x[0])) + torch.acos(0.5 * torch.sigmoid(u[0]))
        + torch.atan(x[1]) + torch.sinh(x[2]) + torch.cosh(u[1]) + torch.log1p(x[0] * x[0])
        + torch.expm1(x[1]) + torch.rsqrt(1.0 + x[2] * x[2]) + torch.reciprocal(2.0 + u[0])
        + torch.square(x[1]) + 2.0 ** u[1]])


def test_emitted_cuda_names_the_functions():
    """The generated header of kernel 1 calls each function's ``mpc_*``
    overload, lowers square and reciprocal to products and quotients,
    clamp to max then min, and counts its operations."""
    from mpc_code_tpu_torch.ops.sweep_cuda import emit_rhs_source, sweep_ops_per_lane

    src = emit_rhs_source(_all_ops_ode, 3, 2, 0, 1, 2)
    for fn in ("tanh", "sigmoid", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
               "cosh", "log1p", "expm1", "rsqrt", "erf", "sign", "atan2", "pow"):
        assert f"mpc_{fn}(" in src, fn
    for line in ("auto v_clamp__lo = mpc_max(v_getitem_1, v_getitem_7);",
                 "auto v_clamp__hi = mpc_min(v_clamp__lo, S(2.0));",
                 "auto v_pow_1 = mpc_pow(v_getitem_3, v_getitem_2);",
                 "auto v_pow_2 = mpc_pow(S(2.0), v_getitem_5);",
                 "auto v_square = (v_getitem_1 * v_getitem_1);",
                 "auto v_reciprocal = (S(1.0) / v_add_13);"):
        assert line in src, line
    assert sweep_ops_per_lane(_all_ops_ode, 3, 2, 2) == 3444


def test_program_ops_count_each_rule():
    """``Program.ops`` of one function at orders 1 and 2 with nz = 2: the
    value counts one, each rule its multiplies and adds."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    def f(z):
        return torch.tanh(z[0]) + torch.atan2(z[0], z[1]) + z[0] ** z[1] + torch.sign(z[1])

    args = (Arg("z", "dual", 2),)
    # tanh 1 + 2 + 2 (+ 2 + 4 * 3); atan2 7 + 6 (+ 6 + 14 * 3); pow 7 + 6
    # (+ 9 + 14 * 3); sign 1, without tangents; two sums of dual numbers
    # 1 + 2 (+ 3), one of a dual and a value 1
    assert Program(f, args, 2, out_dim=None, order=1).ops == 5 + 13 + 13 + 1 + 2 * 3 + 1
    assert Program(f, args, 2, out_dim=None, order=2).ops == (
        19 + 61 + 64 + 1 + 2 * 6 + 1)


def test_constants_fold_in_double_precision():
    """The constant components of a vector fold in double precision, inf
    and nan included, and emit no call (torch.fx computes an op on
    constants alone itself)."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    def f(z):
        v = torch.stack([z[0], torch.tensor(0.5), torch.tensor(-1.0), torch.tensor(2.0)])
        return torch.stack([z[0] + torch.tanh(v)[1], z[0] * torch.atan2(v * 0.0, v)[2],
                            z[0] + torch.clamp(v, max=1.0)[3], z[0] + (v ** v[1])[2],
                            z[0] + torch.log1p(v)[2]])

    prog = Program(f, (Arg("z", "dual", 1),), 1, out_dim=5)
    for v in (float(np.tanh(0.5)), -math.pi, 1.0):      # atan2(-0.0, -1.0) = -pi
        assert f"S({v!r})" in prog.body, v
    assert "S(NAN)" in prog.body and "S(-INFINITY)" in prog.body
    assert "mpc_" not in prog.body.replace("mpc_val", "")


@pytest.mark.parametrize("op", ("lgamma", "traced_index", "kwarg"))
def test_still_refused(op):
    """Ops outside the generator's list (lgamma: no digamma in CUDA's libm
    for its derivative), indices that depend on traced values and keyword
    arguments an op does not take raise NotImplementedError naming them."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    fns = {"lgamma": lambda z: torch.lgamma(z[0]),
           "traced_index": lambda z: z[z > 0.0].sum(),
           "kwarg": lambda z: torch.sum(z, dtype=torch.float64)}
    with pytest.raises(NotImplementedError, match="lgamma|index|keyword"):
        Program(fns[op], (Arg("z", "dual", 2),), 2, out_dim=None)


# ---------------------------------------------------------------------------
# csrc/dual.cuh and csrc/dual2.cuh built for the host
# ---------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mpc_code_tpu_torch", "csrc")
HOST_MAIN = r"""
template <class V> void seed(V* z, const double* p) {
  for (int i = 0; i < 2; ++i) { z[i] = V(p[i]); z[i].d[i] = 1.0; }
}
template <class F> void run(F f, const double* p) {
  // order 1 in f64 and in f32, order 2, and order 2 on numbers whose
  // components carry a tangent along z_0 (collocation's nesting)
  Dual<double, 2> z1[2], r1[1];
  seed(z1, p);
  f.template operator()<Dual<double, 2>, double>(z1, r1);
  std::printf("%.17g %.17g %.17g\n", r1[0].v, r1[0].d[0], r1[0].d[1]);
  Dual<float, 2> zf[2], rf[1];
  for (int i = 0; i < 2; ++i) { zf[i] = Dual<float, 2>(float(p[i])); zf[i].d[i] = 1.0f; }
  f.template operator()<Dual<float, 2>, float>(zf, rf);
  std::printf("%.9g %.9g %.9g\n", rf[0].v, rf[0].d[0], rf[0].d[1]);
  Dual2<double, 2> z2[2], r2[1];
  seed(z2, p);
  f.template operator()<Dual2<double, 2>, double>(z2, r2);
  std::printf("%.17g %.17g %.17g %.17g %.17g %.17g\n", r2[0].v, r2[0].d[0], r2[0].d[1],
              r2[0].h[0], r2[0].h[1], r2[0].h[2]);
  using E = Dual<double, 1>;
  using VE = Dual2<E, 2>;
  VE z3[2], r3[1];
  for (int i = 0; i < 2; ++i) {
    E e(p[i]);
    e.d[0] = i == 0 ? 1.0 : 0.0;
    z3[i] = VE(e);
    z3[i].d[i] = E(1.0);
  }
  f.template operator()<VE, E>(z3, r3);
  const VE& r = r3[0];
  std::printf("%.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g %.17g\n",
              r.v.v, r.d[0].v, r.d[1].v, r.h[0].v, r.h[1].v, r.h[2].v,
              r.v.d[0], r.d[0].d[0], r.d[1].d[0], r.h[0].d[0], r.h[1].d[0], r.h[2].d[0]);
}
"""


@pytest.fixture(scope="module")
def host_rows(jax_refs, tmp_path_factory):
    """Each case's lowered statements instantiated on the host with
    ``Dual<double, 2>``, ``Dual<float, 2>``, ``Dual2<double, 2>`` and
    ``Dual2<Dual<double, 1>, 2>``: four rows a point."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the headers cannot be built on the host")
    names = list(CASES)
    fns, calls = [], []
    for k, name in enumerate(names):
        body = _program(name, 2).body
        fns.append(f"struct F{k} {{ template <class V, class S> void operator()"
                   f"(const V* z, V* out) const {{\n{body}\n}} }};")
        for p in jax_refs[name][0]:
            pt = f"{float(p[0])!r}, {float(p[1])!r}"
            calls.append(f"  {{ const double p[2] = {{{pt}}}; run(F{k}(), p); }}")
    src = ("#include <cmath>\n#include <cstdio>\n#define __device__\n"
           "#define __forceinline__ inline\n"
           '#include "dual2.cuh"\n' + "\n".join(fns) + HOST_MAIN
           + "int main() {\n" + "\n".join(calls) + "\n}\n")
    d = tmp_path_factory.mktemp("elementary_host")
    (d / "main.cpp").write_text(src)
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-I", CSRC, "-o", str(d / "main"),
                    str(d / "main.cpp")], check=True, capture_output=True, text=True)
    out = subprocess.run([str(d / "main")], check=True, capture_output=True,
                         text=True).stdout.split("\n")
    rows = [np.array(line.split(), float) for line in out if line.strip()]
    per = 4 * NPTS
    return {n: rows[k * per:(k + 1) * per] for k, n in enumerate(names)}


@pytest.mark.parametrize("name", list(CASES))
def test_cuda_rules_match_jax_on_the_host(jax_refs, host_rows, name):
    """dual.cuh's first-order and dual2.cuh's second-order rules on the
    lowered statements against JAX within 1e-12 (f32: 1e-5 of the value's
    size), and on numbers whose components are Dual: their tangent along
    z_0 is the derivative of each component, the third derivative
    included where JAX's is finite."""
    pts, (val, jac, hess, d3) = jax_refs[name]
    rows = host_rows[name]
    iu = np.triu_indices(2)
    for k in range(NPTS):
        o1, of, o2, on = rows[4 * k:4 * k + 4]
        _close(o1, np.r_[val[k], jac[k]])
        _close(o2, np.r_[val[k], jac[k], hess[k][iu]])
        _close(on[:9], np.r_[val[k], jac[k], hess[k][iu], jac[k][0], hess[k][0]])
        # third derivatives where they are finite (at a zero base a^b's
        # holds a^(b-3) = inf, and 0 inf is nan or not by where it is formed)
        if np.isfinite(d3[k]).all():
            _close(on[9:], d3[k][iu])
        ref = np.r_[val[k], jac[k]]
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(of), fin)
        assert np.all(np.abs(of[fin] - ref[fin]) <= 1e-5 * (1 + np.abs(ref[fin]))), (k, of, ref)
