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
for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpc_code_tpu_torch.ops.codegen import Arg, Program
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
    """Lanes-minor joint rollout; first order by nz forward tangents
    (``torch.func.jvp``, vmapped over the directions), the Hessian by
    forward-over-reverse (jvp of the vjp gradient of the quadrature), then
    symmetrised: the arithmetic of ``integrators.rk4_quad_stage_hess``'s
    batched JAX rule."""
    Bsz, N, nx = xs.shape
    nu = us.shape[-1]
    L = Bsz * N
    nz = nx + nu

    def st(a):
        return a.reshape(L, a.shape[-1]).t()

    def sh(a):
        return a.repeat_interleave(N, dim=0).t()

    xT, uT, pxT, pyT = st(xs), st(us), st(pxs), st(pys)
    dT, xsT, usT = sh(d), sh(x_ss), sh(u_ss)
    tT, hT = t.repeat_interleave(N), h.repeat_interleave(N)

    def roll(xv, uv):
        dt = hT / Mx
        acc = torch.zeros_like(tT)
        tv = tT
        for _ in range(Mx):
            k1 = f(xv, tv, uv, dT, pxT, xsT, usT, pyT)
            q1 = q(xv, tv, uv, dT, pxT, xsT, usT, pyT)
            x2 = xv + dt / 2 * k1
            k2 = f(x2, tv + dt / 2, uv, dT, pxT, xsT, usT, pyT)
            q2 = q(x2, tv + dt / 2, uv, dT, pxT, xsT, usT, pyT)
            x3 = xv + dt / 2 * k2
            k3 = f(x3, tv + dt / 2, uv, dT, pxT, xsT, usT, pyT)
            q3 = q(x3, tv + dt / 2, uv, dT, pxT, xsT, usT, pyT)
            x4 = xv + dt * k3
            k4 = f(x4, tv + dt, uv, dT, pxT, xsT, usT, pyT)
            q4 = q(x4, tv + dt, uv, dT, pxT, xsT, usT, pyT)
            xv = xv + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            acc = acc + dt / 6 * (q1 + 2 * q2 + 2 * q3 + q4)
            tv = tv + dt
        return xv, acc

    eye = torch.eye(nz, dtype=xs.dtype, device=xs.device)
    TX = eye[:, :nx, None].expand(nz, nx, L)
    TU = eye[:, nx:, None].expand(nz, nu, L)

    def lin(a, b):
        return torch.func.jvp(roll, (xT, uT), (a, b))

    (xv, qv), (dX, dq) = torch.func.vmap(lin)(TX, TU)

    def grad_q(xx, uu):
        out, vjp_fn = torch.func.vjp(roll, xx, uu)
        return vjp_fn((torch.zeros_like(out[0]), torch.ones_like(out[1])))

    def hcol(a, b):
        return torch.func.jvp(grad_q, (xT, uT), (a, b))[1]

    hx, hu = torch.func.vmap(hcol)(TX, TU)
    H = torch.cat([hx, hu], dim=1).permute(2, 1, 0).reshape(Bsz, N, nz, nz)
    H = 0.5 * (H + H.transpose(-1, -2))
    J = dX.permute(2, 1, 0).reshape(Bsz, N, nx, nz)
    return (xv[0].t().reshape(Bsz, N, nx), J[..., :nx], J[..., nx:],
            qv[0].reshape(Bsz, N), dq.t().reshape(Bsz, N, nz), H)


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
