"""``csrc/dual.cuh`` compiled for the host by g++, against ``torch.func.jvp``, f64.

The header's first-order numbers carry kernels 1 and 3.  Here it is built
with ``__device__`` and ``__forceinline__`` defined away, seeded with unit
tangents at a point z in R^3, and run on the three quotient forms (Dual /
Dual, Dual / scalar, scalar / Dual), ``exp``, ``log``, ``sqrt``, ``pow``,
``max`` / ``min`` against a Dual and against a constant (with exact ties,
where the derivative takes half of each side, as JAX's) and a composition
like the quadruple tank's right-hand side; value and tangents match
``torch.func.jvp`` to 1e-12.  At a point with z_0 = 0 the square root,
log and quotients give inf and nan tangents, in the same places and with
the same signs as torch's; through ``max`` / ``min`` too when the Dual is
the first argument, as the generated guards write it.  With the constant
first and an infinite tangent, torch's forward rule for ``minimum``
(``b' + w (a' - b')``) gives nan where JAX's (each argument's tangent
times its weight) and the header give inf: that case is pinned to JAX's
rule.  Skips when g++ is absent.
"""

import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mpc_code_tpu_torch", "csrc")
Z = [0.7, 1.3, -0.4]
Z0 = [0.0, 1.3, -0.4]

# each expression is valid C++ on Dual<double, 3> and Python on torch scalars
TANK = ("(0.3 * x1 - 0.08 * mpc_sqrt(19.62 * mpc_max(x0, 0.0))) / 2.2"
        " + 0.05 * mpc_sqrt(19.62 * mpc_min(x2 + 1.0, 20.0)) / 2.2")
FUNCTIONS = {
    "dual/dual": "x0 / x1",
    "dual/scalar": "x2 / 0.37",
    "scalar/dual": "1.7 / x1",
    "exp": "mpc_exp(x0 * x2)",
    "log": "mpc_log(x1)",
    "sqrt": "mpc_sqrt(x1 + x0 * x0)",
    "pow": "mpc_pow(x1, 2.5)",
    "max dual": "mpc_max(x0, x2)",
    "min dual": "mpc_min(x0, x2)",
    "max constant": "mpc_max(x0, 0.5)",
    "max constant first": "mpc_max(0.5, x2)",
    "min constant": "mpc_min(x1, 2.0)",
    "min constant first": "mpc_min(2.0, x1)",
    "max constant tie": "mpc_max(x0, 0.7)",
    "min constant tie": "mpc_min(0.7, x0)",
    "max dual tie": "mpc_max(x0, 2.0 * x0 - 0.7)",
    "min dual tie": "mpc_min(x0, 2.0 * x0 - 0.7)",
    "tank composition": TANK,
}
NONFINITE = {
    "sqrt at 0": "mpc_sqrt(x0)",
    "max of sqrt at 0": "mpc_max(mpc_sqrt(x0), 1.0)",
    "min of sqrt at 0": "mpc_min(mpc_sqrt(x0) * x1, 5.0)",
    "log at 0": "mpc_log(x0)",
    "scalar/dual at 0": "1.7 / x0",
    "dual/dual at 0": "x1 / x0",
    "tank at an empty tank": TANK,
    "min of sqrt at 0, constant first": "mpc_min(5.0, mpc_sqrt(x0) * x1)",
}

PROGRAM = r"""
#define __device__
#define __forceinline__ inline
#include <cstdio>
#include <cstdlib>
#include "dual.cuh"

using V = Dual<double, 3>;

void print(const V& r) {
  std::printf("%.17g %.17g %.17g %.17g\n", r.v, r.d[0], r.d[1], r.d[2]);
}

void run(const double* z, int which) {
  V x[3];
  for (int i = 0; i < 3; ++i) { x[i] = V(z[i]); x[i].d[i] = 1.0; }
  const V &x0 = x[0], &x1 = x[1], &x2 = x[2];
  if (which == 0) {
REGULAR
  } else {
NONFINITE
  }
}

int main(int argc, char** argv) {
  double z[3];
  for (int i = 0; i < 3; ++i) z[i] = std::atof(argv[2 + i]);
  run(z, std::atoi(argv[1]));
}
"""


def _run(exe, which, z):
    out = subprocess.run([str(exe), str(which)] + [repr(v) for v in z], check=True,
                         capture_output=True, text=True).stdout
    return [np.array(line.split(), float) for line in out.strip().splitlines()]


@pytest.fixture(scope="module")
def host_output(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header cannot be built on the host")
    d = tmp_path_factory.mktemp("dual_host")
    src, exe = d / "dual_host.cpp", d / "dual_host"
    src.write_text(PROGRAM.replace(
        "REGULAR", "\n".join(f"    print({e});" for e in FUNCTIONS.values())).replace(
        "NONFINITE", "\n".join(f"    print({e});" for e in NONFINITE.values())))
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-I", CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    return _run(exe, 0, Z), _run(exe, 1, Z0)


def _t(a):
    return a if torch.is_tensor(a) else torch.tensor(a, dtype=torch.float64)


SCOPE = dict(mpc_exp=torch.exp, mpc_log=torch.log, mpc_sqrt=torch.sqrt, mpc_pow=torch.pow,
             mpc_max=lambda a, b: torch.maximum(_t(a), _t(b)),
             mpc_min=lambda a, b: torch.minimum(_t(a), _t(b)))


def _reference(expr, z):
    """Value and the three tangents by torch.func.jvp along the unit vectors."""
    def f(v):
        return eval(expr, dict(SCOPE, x0=v[0], x1=v[1], x2=v[2]))

    zt = torch.tensor(z, dtype=torch.float64)
    rows = [torch.func.jvp(f, (zt,), (torch.eye(3, dtype=torch.float64)[i],))
            for i in range(3)]
    return np.array([float(rows[0][0])] + [float(t) for _, t in rows])


@pytest.mark.parametrize("k,name", list(enumerate(FUNCTIONS)))
def test_value_and_tangents_match_torch(host_output, k, name):
    row = host_output[0][k]
    ref = _reference(FUNCTIONS[name], Z)
    assert np.all(np.isfinite(ref)), name
    err = np.abs(row - ref) / (1 + np.abs(ref))
    assert err.max() <= 1e-12, (name, row, ref)


def test_ties_take_half_of_each_side(host_output):
    rows = dict(zip(FUNCTIONS, host_output[0]))
    for name in ("max constant tie", "min constant tie"):
        np.testing.assert_array_equal(rows[name], [0.7, 0.5, 0.0, 0.0])
    for name in ("max dual tie", "min dual tie"):         # (1 + 2) / 2
        np.testing.assert_array_equal(rows[name], [0.7, 1.5, 0.0, 0.0])


@pytest.mark.parametrize("k,name", list(enumerate(NONFINITE))[:-1])
def test_non_finite_tangents_where_torch_has_them(host_output, k, name):
    row = host_output[1][k]
    ref = _reference(NONFINITE[name], Z0)
    assert not np.all(np.isfinite(ref)), name
    np.testing.assert_array_equal(np.isnan(row), np.isnan(ref), err_msg=name)
    inf = np.isinf(ref)
    np.testing.assert_array_equal(row[inf], ref[inf], err_msg=name)
    fin = np.isfinite(ref)
    assert np.all(np.abs(row[fin] - ref[fin]) <= 1e-12 * (1 + np.abs(ref[fin]))), name
    assert not math.isnan(row[0]) or math.isnan(ref[0])


def test_constant_first_follows_jax(host_output):
    """min(5, y) with y = sqrt(z_0) z_1 at z_0 = 0: y wins with weight 1, so
    its tangents (inf, 0 * inf, 0 * inf) pass unchanged, as under JAX's
    jvp of jnp.minimum."""
    row = host_output[1][len(NONFINITE) - 1]
    np.testing.assert_array_equal(row, [0.0, math.inf, math.nan, math.nan])
