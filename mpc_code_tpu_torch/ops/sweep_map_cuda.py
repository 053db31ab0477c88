"""Discrete-map stage-Jacobian sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/ops/sweep_pallas.py::map_stage_jac_pallas``, which
the JAX solver reaches through ``integrators.map_stage_jac`` once per IPM
iteration of an OCP whose model is a discrete map (``DiscreteModel``).
For every (scenario, stage) lane: one evaluation of
``x_next = f(x, u, d, t, px)`` with the nx + nu forward tangents, giving
``xf``, ``Jx`` and ``Ju``.

The user's map reaches the kernel through the code generator of
``ops/codegen.py``: ``emit_map_source`` lowers the torch map to scalar
statements in a generated header, which ``csrc/map_stage_jac.cu``
instantiates with the forward-mode ``Dual<T, nz>`` of ``csrc/dual.cuh``.
One pass carries the value and all nz tangents: what the Pallas kernel's
``jax.linearize`` plus nz tangent applications compute.  Rows the map
copies come out exact, and columns with no dependence come out as zeros.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/map_stage_jac.cu`` (arithmetic-bound; one thread
per lane with the map's intermediates in registers, one reciprocal per
quotient and square root; it reads the solver's (B, N, ...) tensors in
place and writes contiguous ``xf``, ``Jx`` and ``Ju``).

``MapStageJac.__call__`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs the plain version only for CPU
tensors.  The plain version runs the user's functions under
``ops/jax_rules.py``: where torch's derivative differs from JAX's (clamp
at a tie, abs at 0, atan2 at the origin, pow in a traced exponent) it
takes JAX's, as the kernel does.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpc_code_tpu_torch.ops.codegen import Arg, Program
from mpc_code_tpu_torch.ops.jax_rules import with_jax_rules
from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep, per_lane

LAUNCHES = 0


def map_program(f: Callable, nx: int, nu: int, nd=None, npx=None, order=1) -> Program:
    """The map ``f(x, u, d, t, px)`` lowered with x, u carrying first-order
    tangents (``order=2``: and second-order ones, for the fused stage
    sweep's exact Hessian)."""
    return Program(f, (Arg("x", "dual", nx), Arg("u", "dual", nu),
                       Arg("d", "vec", nd), Arg("t", "scalar"), Arg("px", "vec", npx)),
                   nz=nx + nu, out_dim=nx, order=order, what="discrete map")


def emit_map_source(f: Callable, nx: int, nu: int, nd: int, npx: int) -> str:
    """Generated header ``mpc_map_gen.cuh`` for ``csrc/map_stage_jac.cu``:
    the dimensions and ``mpc_map`` (the traced map)."""
    prog = map_program(f, nx, nu, nd, npx)
    name = getattr(f, "__qualname__", repr(f))
    return f"""// Generated by mpc_code_tpu_torch/ops/sweep_map_cuda.py from {name}.
#pragma once
#include <cmath>
#define MPC_NX {nx}
#define MPC_NU {nu}
#define MPC_ND {nd}
#define MPC_NPX {npx}

template <class V, class S>
__device__ __forceinline__ void mpc_map(const V* x, const V* u, const S* d,
                                        S t, const S* px, V* out) {{
{prog.body}
}}
"""


def map_ops_per_lane(f: Callable, nx: int, nu: int, nd=None, npx=None) -> int:
    """Arithmetic operations the function needs per lane: one evaluation of
    the map on values with nz tangents (exp/log/sqrt count as one each; a
    bound against a constant is a compare and nz tangent selects)."""
    return map_program(f, nx, nu, nd, npx).ops


def map_bytes(Bsz: int, N: int, nx: int, nu: int, nd: int, npx: int,
              itemsize: int) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    L = Bsz * N
    nz = nx + nu
    return itemsize * ((nx + nu + npx) * L + (1 + nd) * Bsz + nx * (1 + nz) * L)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def map_stage_jac_plain(f, xs, us, pxs, t, d):
    """One evaluation of the map on lanes-minor (dim, L) planes with nx+nu
    forward tangents (``torch.func.jvp``, vmapped over the directions) —
    the arithmetic of ``integrators.map_stage_jac``'s batched JAX rule, with
    the map run on one lane's vectors, vmapped over the lanes
    (``per_lane``)."""
    Bsz, N, nx = xs.shape
    nu = us.shape[-1]
    L = Bsz * N
    nz = nx + nu
    xT = xs.reshape(L, nx).t()
    uT = us.reshape(L, nu).t()
    pxT = pxs.reshape(L, -1).t()
    dT = d.repeat_interleave(N, dim=0).t()
    tv = t.repeat_interleave(N)

    eye = torch.eye(nz, dtype=xs.dtype, device=xs.device)
    TX = eye[:, :nx, None].expand(nz, nx, L)
    TU = eye[:, nx:, None].expand(nz, nu, L)

    f_lanes = per_lane(f)

    def lin(a, b):
        return torch.func.jvp(lambda xx, uu: f_lanes(xx, uu, dT, tv, pxT), (xT, uT), (a, b))

    prim, J = torch.func.vmap(lin)(TX, TU)
    xf = prim[0].t().reshape(Bsz, N, nx)
    J = J.permute(2, 1, 0).reshape(Bsz, N, nx, nz)
    return xf, J[..., :nx], J[..., nx:]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


class MapStageJac(LaneSweep):
    """``F(xs, us, pxs, t, d) -> (xf, Jx, Ju)`` for one discrete map."""

    kernel, header, in_place = "map_stage_jac", "mpc_map_gen.cuh", True
    stage_inputs, scalar_inputs, scenario_inputs = ("xs", "us", "pxs"), ("t",), ("d",)

    def __init__(self, f: Callable):
        super().__init__()
        self.f = f

    @with_jax_rules
    def plain(self, xs, us, pxs, t, d):
        return map_stage_jac_plain(self.f, xs, us, pxs, t, d)

    def source(self, nx, nu, nd, npx) -> str:
        return emit_map_source(self.f, nx, nu, nd, npx)

    @staticmethod
    def dims(w):
        return (w["xs"], w["us"], w["d"], w["pxs"])

    @staticmethod
    def out_dims(nx, nu, nd, npx):
        return ((nx,), (nx, nx), (nx, nu))   # xf, Jx, Ju

    def _count(self):
        global LAUNCHES
        LAUNCHES += 1
