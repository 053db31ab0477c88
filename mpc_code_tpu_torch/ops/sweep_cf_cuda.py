"""ContForm joint sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/ops/sweep_pallas.py::rk4_quad_stage_hess_pallas``,
which the JAX solver reaches through ``integrators.rk4_quad_stage_hess``
once per IPM iteration of a ContForm (economic) OCP.  For every
(scenario, stage) lane: ``Mx`` RK4 sub-steps of ``x' = f(x, t, u, d, px,
xs, us, py)`` together with the quadrature ``acc' = q(...)``, giving the
dynamics value and Jacobians and the quadrature's value, gradient and
Hessian with respect to z = (x, u).

The user's two functions reach the kernel through the code generator of
``ops/codegen.py``: ``emit_cf_source`` lowers them to scalar statements in
a generated header, which ``csrc/rk4_quad_stage_hess.cu`` instantiates
with the second-order forward-mode ``Dual2<T, nz>`` of ``csrc/dual2.cuh``
(value, nz tangents, nz(nz+1)/2 second-order tangents).  One pass carries
what the Pallas kernel's nested ``jax.jvp`` per direction pair computes.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/rk4_quad_stage_hess.cu``.

``Rk4QuadStageHess.__call__`` launches the kernel for CUDA tensors and
raises on what the kernel does not take; it runs the plain version only
for CPU tensors.  The plain version runs the user's functions under
``ops/jax_rules.py``: where torch's derivative differs from JAX's (clamp
at a tie, abs at 0, atan2 at the origin, pow in a traced exponent) it
takes JAX's, as the kernel does.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpc_code_tpu_torch.ops.codegen import Arg, Program
from mpc_code_tpu_torch.ops.jax_rules import with_jax_rules
from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep

LAUNCHES = 0
PLAIN_BLOCK_LANES = 1 << 16        # lanes per block of the plain version


def cf_programs(f: Callable, q: Callable, nx, nu, nd, npx, npy):
    """(ode, quad): ``f`` and ``q`` lowered with x and u carrying first-
    and second-order tangents."""
    args = (Arg("x", "dual", nx), Arg("t", "scalar"), Arg("u", "dual", nu),
            Arg("d", "vec", nd), Arg("px", "vec", npx), Arg("xs", "vec", nx),
            Arg("us", "vec", nu), Arg("py", "vec", npy))
    nz = nx + nu
    return (Program(f, args, nz, out_dim=nx, order=2, what="ContForm ODE"),
            Program(q, args, nz, out_dim=None, order=2, what="ContForm quadrature"))


def emit_cf_source(f: Callable, q: Callable, nx, nu, nd, npx, npy, Mx) -> str:
    """Generated header ``mpc_cf_gen.cuh`` for ``csrc/rk4_quad_stage_hess.cu``:
    the dimensions, ``mpc_ode`` and ``mpc_quad``."""
    ode, quad = cf_programs(f, q, nx, nu, nd, npx, npy)
    sig = ("const V* x, S t, const V* u, const S* d, const S* px, "
           "const S* xs, const S* us, const S* py, V* out")
    names = ", ".join(getattr(g, "__qualname__", repr(g)) for g in (f, q))
    return f"""// Generated by mpc_code_tpu_torch/ops/sweep_cf_cuda.py from {names}.
#pragma once
#include <cmath>
#define MPC_NX {nx}
#define MPC_NU {nu}
#define MPC_ND {nd}
#define MPC_NPX {npx}
#define MPC_NPY {npy}
#define MPC_MX {Mx}

template <class V, class S>
__device__ __forceinline__ void mpc_ode({sig}) {{
{ode.body}
}}

template <class V, class S>
__device__ __forceinline__ void mpc_quad({sig}) {{
{quad.body}
}}
"""


def cf_ops_per_lane(f: Callable, q: Callable, nx, nu, nd, npx, npy, Mx) -> int:
    """Arithmetic operations the function needs per lane: four evaluations
    of both functions per sub-step on values with nz first- and nz(nz+1)/2
    second-order tangents, plus the RK4 combination of the nx states
    (three stage points and the update, 13 operations) and of the
    quadrature (the update, 7)."""
    ode, quad = cf_programs(f, q, nx, nu, nd, npx, npy)
    nz = nx + nu
    width = 1 + nz + nz * (nz + 1) // 2
    return Mx * (4 * (ode.ops + quad.ops) + (13 * nx + 7) * width)


def cf_bytes(Bsz, N, nx, nu, nd, npx, npy, itemsize) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    L = Bsz * N
    nz = nx + nu
    ins = (nx + nu + npx + npy) * L + (2 + nd + nx + nu) * Bsz
    outs = (nx + nx * nz + 1 + nz + nz * nz) * L
    return itemsize * (ins + outs)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def rk4_quad_stage_hess_plain(f, q, Mx, xs, us, pxs, pys, t, h, d, x_ss, u_ss):
    """The joint rollout per (scenario, stage) point, vmapped over the
    points: the Jacobians of the state and of the quadrature by reverse
    mode, the quadrature's Hessian by reverse over reverse, then
    symmetrised.  The values are those of ``integrators.rk4_quad_stage_hess``'s
    batched JAX rule (forward tangents) to rounding; torch's forward mode
    runs Python decompositions for every op that mixes a tensor and a
    Python number, ~20x slower through the sub-steps on the CPU."""
    Bsz, N, nx = xs.shape
    nu = us.shape[-1]
    L = Bsz * N

    def flat(a):
        return a.reshape(L, a.shape[-1])

    def rep(a):
        return a.repeat_interleave(N, dim=0)

    def roll(z, t0, hh, dd, px, xss, uss, py):
        """[x(t0 + hh); quadrature] from z = [x; u] at one point."""
        xv, uv = z[:nx], z[nx:]
        dt = hh / Mx
        acc = torch.zeros_like(t0)
        tv = t0
        for _ in range(Mx):
            k1 = f(xv, tv, uv, dd, px, xss, uss, py)
            q1 = q(xv, tv, uv, dd, px, xss, uss, py)
            x2 = xv + dt / 2 * k1
            k2 = f(x2, tv + dt / 2, uv, dd, px, xss, uss, py)
            q2 = q(x2, tv + dt / 2, uv, dd, px, xss, uss, py)
            x3 = xv + dt / 2 * k2
            k3 = f(x3, tv + dt / 2, uv, dd, px, xss, uss, py)
            q3 = q(x3, tv + dt / 2, uv, dd, px, xss, uss, py)
            x4 = xv + dt * k3
            k4 = f(x4, tv + dt, uv, dd, px, xss, uss, py)
            q4 = q(x4, tv + dt, uv, dd, px, xss, uss, py)
            xv = xv + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            acc = acc + dt / 6 * (q1 + 2 * q2 + 2 * q3 + q4)
            tv = tv + dt
        return torch.cat([xv, acc[None]])

    def with_value(z, *p):
        out = roll(z, *p)
        return out, out

    pts = (torch.cat([flat(xs), flat(us)], -1), t.repeat_interleave(N),
           h.repeat_interleave(N), rep(d), flat(pxs), rep(x_ss), rep(u_ss), flat(pys))
    J, val = torch.func.vmap(torch.func.jacrev(with_value, has_aux=True))(*pts)
    H = torch.func.vmap(torch.func.jacrev(torch.func.jacrev(
        lambda z, *p: roll(z, *p)[nx])))(*pts)
    H = 0.5 * (H + H.transpose(-1, -2))
    nz = nx + nu
    return (val[:, :nx].reshape(Bsz, N, nx), J[:, :nx, :nx].reshape(Bsz, N, nx, nx),
            J[:, :nx, nx:].reshape(Bsz, N, nx, nu), val[:, nx].reshape(Bsz, N),
            J[:, nx].reshape(Bsz, N, nz), H.reshape(Bsz, N, nz, nz))


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


class Rk4QuadStageHess(LaneSweep):
    """``F(xs, us, pxs, pys, t, h, d, x_ss, u_ss) -> (xf, Jx, Ju, qv, gq,
    Hq)`` for one ODE ``f`` and quadrature ``q``."""

    kernel, header = "rk4_quad_stage_hess", "mpc_cf_gen.cuh"
    stage_inputs = ("xs", "us", "pxs", "pys")
    scenario_inputs = ("d", "x_ss", "u_ss")

    def __init__(self, f: Callable, q: Callable, Mx: int):
        super().__init__()
        self.f, self.q = f, q
        self.Mx = int(Mx)

    @with_jax_rules
    def plain(self, *args):
        """The plain version over blocks of at most PLAIN_BLOCK_LANES
        (scenario, stage) lanes: lanes are independent, and a block bounds
        the memory its reverse-mode graph holds."""
        Bsz, N = args[0].shape[:2]
        step = max(1, PLAIN_BLOCK_LANES // N)
        parts = [rk4_quad_stage_hess_plain(self.f, self.q, self.Mx,
                                           *[a[b0:b0 + step] for a in args])
                 for b0 in range(0, Bsz, step)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def source(self, nx, nu, nd, npx, npy) -> str:
        return emit_cf_source(self.f, self.q, nx, nu, nd, npx, npy, self.Mx)

    def ops_per_lane(self, nx, nu, nd, npx, npy) -> int:
        return cf_ops_per_lane(self.f, self.q, nx, nu, nd, npx, npy, self.Mx)

    @staticmethod
    def dims(w):
        if (w["x_ss"], w["u_ss"]) != (w["xs"], w["us"]):
            raise ValueError("x_ss must be (B, nx) and u_ss (B, nu)")
        return (w["xs"], w["us"], w["d"], w["pxs"], w["pys"])

    @staticmethod
    def out_rows(nx, nu):
        nz = nx + nu                         # xf, [Jx Ju], qv, gq, Hq
        return (nx, nx * nz, None, nz, nz * nz)

    def _count(self):
        global LAUNCHES
        LAUNCHES += 1

    def launch(self, *args):
        planes = self.pack(*args)
        Bsz, N, (nx, nu) = planes.Bsz, planes.N, planes.dims[:2]
        nz = nx + nu
        xf, jac, qv, gq, hq = self.launch_planes(planes)
        J = jac.t().reshape(Bsz, N, nx, nz)
        return (xf.t().reshape(Bsz, N, nx), J[..., :nx], J[..., nx:],
                qv.reshape(Bsz, N), gq.t().reshape(Bsz, N, nz),
                hq.t().reshape(Bsz, N, nz, nz))
