"""``csrc/dual2.cuh`` compiled for the host by g++, against ``torch.func``, f64.

The header's second-order numbers carry kernels 4 and 5.  Here it is built
with ``__device__`` and ``__forceinline__`` defined away, seeded with unit
tangents at a point z in R^3, and run on the three quotient forms (Dual2 /
Dual2, Dual2 / scalar, scalar / Dual2), ``exp``, products and a composition
of them; value, gradient and Hessian of each match ``torch.func`` to 1e-12.
The same functions on numbers that keep only a slice of the second-order
triangle (``Dual2<T, NZ, H0, HN>``, as kernel 5 splits a lane over two
threads in f64) give the same entries.  Skips when g++ is absent.
"""

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


def _functions(x0, x1, x2, exp):
    """The functions, written once for torch scalars and once (below) in C++."""
    return [x0 / x1, x2 / 0.37, 1.7 / x1, exp(x0 * x2) * x1,
            (x0 * x1 - x2) / (exp(x2) + x0 * x0), 2.5 - x1 / (x0 + 3.0)]


PROGRAM = r"""
#define __device__
#define __forceinline__ inline
#include <cstdio>
#include "dual2.cuh"

template <int H0, int HN>
void run(const double* z) {
  using V = Dual2<double, 3, H0, HN>;
  V x[3];
  for (int i = 0; i < 3; ++i) { x[i] = V(z[i]); x[i].d[i] = 1.0; }
  V f[6] = {x[0] / x[1], x[2] / 0.37, 1.7 / x[1], mpc_exp(x[0] * x[2]) * x[1],
            (x[0] * x[1] - x[2]) / (mpc_exp(x[2]) + x[0] * x[0]),
            2.5 - x[1] / (x[0] + 3.0)};
  for (const V& r : f) {
    std::printf("%.17g", r.v);
    for (int i = 0; i < 3; ++i) std::printf(" %.17g", r.d[i]);
    for (int q = 0; q < HN; ++q) std::printf(" %.17g", r.h[q]);
    std::printf("\n");
  }
}

int main(int argc, char** argv) {
  double z[3];
  for (int i = 0; i < 3; ++i) z[i] = std::atof(argv[1 + i]);
  run<0, 6>(z);   // the whole triangle
  run<0, 4>(z);   // kernel 5's split in f64: entries [0, 4) and [4, 6)
  run<4, 2>(z);
}
"""


@pytest.fixture(scope="module")
def host_output(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header cannot be built on the host")
    d = tmp_path_factory.mktemp("dual2_host")
    src, exe = d / "dual2_host.cpp", d / "dual2_host"
    src.write_text("#include <cstdlib>\n" + PROGRAM)
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-I", CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)] + [repr(v) for v in Z], check=True,
                         capture_output=True, text=True).stdout
    rows = [np.array(line.split(), float) for line in out.strip().splitlines()]
    return rows[:6], rows[6:12], rows[12:]


def _reference(k):
    def f(z):
        return _functions(z[0], z[1], z[2], torch.exp)[k]

    z = torch.tensor(Z, dtype=torch.float64)
    H = torch.func.hessian(f)(z)
    iu = np.triu_indices(3)
    return (f(z).item(), torch.func.grad(f)(z).numpy(), H.numpy()[iu])


def _close(a, b):
    return np.max(np.abs(np.asarray(a) - b) / (1 + np.abs(b)))


@pytest.mark.parametrize("k,name", list(enumerate(
    ["dual/dual", "dual/scalar", "scalar/dual", "exp*dual", "composition",
     "scalar-dual/(dual+scalar)"])))
def test_values_and_derivatives_match_torch(host_output, k, name):
    full, _, _ = host_output
    v, g, h = _reference(k)
    row = full[k]
    assert _close(row[0], v) <= 1e-12, name
    assert _close(row[1:4], g) <= 1e-12, name
    assert _close(row[4:], h) <= 1e-12, name


@pytest.mark.parametrize("k", range(6))
def test_triangle_slices_give_the_same_entries(host_output, k):
    full, lo, hi = host_output
    np.testing.assert_array_equal(lo[k][:4], full[k][:4])    # value, gradient
    np.testing.assert_array_equal(hi[k][:4], full[k][:4])
    np.testing.assert_array_equal(np.concatenate([lo[k][4:], hi[k][4:]]), full[k][4:])
