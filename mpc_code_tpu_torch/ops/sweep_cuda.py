"""RK4 stage-Jacobian sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/ops/sweep_pallas.py::rk4_stage_jac_pallas``, which
the JAX solver reaches through ``integrators.rk4_stage_jac`` once per IPM
iteration.  For every (scenario, stage) lane: ``Mx`` RK4 sub-steps of
``x' = f(x, t, u, d, px)`` with the saturation guard, plus the nx + nu
forward tangents, giving ``xf``, ``Jx`` and ``Ju``.

The TPU kernel runs any user ODE because Pallas traces it.  The port keeps
that property with a code generator: ``emit_rhs_source`` lowers the torch
ODE to scalar statements (``ops/codegen.py``) and writes them as a
``template <class V, class S> __device__`` function, which the kernel
(``csrc/rk4_stage_jac.cu``) instantiates with the forward-mode
``Dual<T, nz>`` of ``csrc/dual.cuh``.  Any op the generator does not know
raises ``NotImplementedError`` naming it.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/rk4_stage_jac.cu`` (arithmetic-bound; one thread
per lane with state and tangents in registers, one reciprocal per
quotient; it reads the solver's (B, N, ...) tensors in place and writes
contiguous ``xf``, ``Jx`` and ``Ju``).

``Rk4StageJac.__call__`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs the plain version only for CPU
tensors.  The plain version runs the user's functions under
``ops/jax_rules.py``: where torch's derivative differs from JAX's (clamp
at a tie, abs at 0, atan2 at the origin, pow in a traced exponent) it
takes JAX's, as the kernel does.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from mpc_code_tpu_torch.ops.codegen import Arg, Program, lit
from mpc_code_tpu_torch.ops.integrators import saturate
from mpc_code_tpu_torch.ops.jax_rules import with_jax_rules
from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep, per_lane

LAUNCHES = 0


def _rhs_program(f: Callable, nx: int, nu: int, nd=None, npx=None) -> Program:
    """The ODE ``f(x, t, u, d, px)`` lowered with x, u carrying tangents."""
    return Program(f, (Arg("x", "dual", nx), Arg("t", "scalar"), Arg("u", "dual", nu),
                       Arg("d", "vec", nd), Arg("px", "vec", npx)),
                   nz=nx + nu, out_dim=nx, what="ODE")


def emit_rhs_source(f: Callable, nx: int, nu: int, nd: int, npx: int, Mx: int,
                    clip_lo=None, clip_hi=None) -> str:
    """Generated header ``mpc_rhs_gen.cuh`` for ``csrc/rk4_stage_jac.cu``:
    the dimensions, ``mpc_rhs`` (the traced ODE) and ``mpc_clip`` (the
    saturation guard from literal bounds, max then min per component, finite
    bounds only, as ``sweep_pallas._make_clip`` does)."""
    prog = _rhs_program(f, nx, nu, nd, npx)
    clip = []
    lo = [None] * nx if clip_lo is None else [float(v) for v in clip_lo]
    hi = [None] * nx if clip_hi is None else [float(v) for v in clip_hi]
    for i in range(nx):
        e = f"x[{i}]"
        if lo[i] is not None and math.isfinite(lo[i]):
            e = f"mpc_max({e}, {lit(lo[i])})"
        if hi[i] is not None and math.isfinite(hi[i]):
            e = f"mpc_min({e}, {lit(hi[i])})"
        clip.append(f"  xc[{i}] = {e};")
    name = getattr(f, "__qualname__", repr(f))
    return f"""// Generated by mpc_code_tpu_torch/ops/sweep_cuda.py from {name}.
#pragma once
#include <cmath>
#define MPC_NX {nx}
#define MPC_NU {nu}
#define MPC_ND {nd}
#define MPC_NPX {npx}
#define MPC_MX {Mx}

template <class V, class S>
__device__ __forceinline__ void mpc_rhs(const V* x, S t, const V* u,
                                        const S* d, const S* px, V* out) {{
{prog.body}
}}

template <class V, class S>
__device__ __forceinline__ void mpc_clip(const V* x, V* xc) {{
{chr(10).join(clip)}
}}
"""


def sweep_ops_per_lane(f: Callable, nx: int, nu: int, Mx: int,
                       clip_lo=None, clip_hi=None, nd=None, npx=None) -> int:
    """Arithmetic operations the function needs per lane (value plus nz
    tangents; exp/log/sqrt count as one each; a bound against a constant
    is a compare and nz tangent selects)."""
    nz = nx + nu
    rhs = _rhs_program(f, nx, nu, nd, npx).ops
    n_bounds = sum(1 for b in (clip_lo, clip_hi) if b is not None
                   for v in b if math.isfinite(float(v)))
    clip = n_bounds * (1 + nz)
    combine = nx * 13 * (1 + nz)      # three stage points + the RK4 update
    return Mx * (4 * (rhs + clip) + combine)


def sweep_bytes(Bsz: int, N: int, nx: int, nu: int, nd: int, npx: int,
                itemsize: int) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    L = Bsz * N
    nz = nx + nu
    return itemsize * ((nx + nu + npx) * L + (2 + nd) * Bsz + nx * (1 + nz) * L)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def rk4_stage_jac_plain(f, Mx, clip_lo, clip_hi, xs, us, pxs, t, h, d):
    """Lanes-minor RK4 rollout with nx+nu forward tangents (``torch.func.jvp``
    of one sub-step per direction, vmapped over the directions) — the
    arithmetic of ``integrators.rk4_stage_jac``'s batched JAX rule, with the
    ODE run on one lane's vectors, vmapped over the lanes (``per_lane``), so
    that a model written with matrices and solves runs as written."""
    Bsz, N, nx = xs.shape
    nu = us.shape[-1]
    L = Bsz * N
    nz = nx + nu
    xT = xs.reshape(L, nx).t()
    uT = us.reshape(L, nu).t()
    pxT = pxs.reshape(L, -1).t()
    dT = d.repeat_interleave(N, dim=0).t()
    tv = t.repeat_interleave(N)
    dt = h.repeat_interleave(N) / Mx

    f_lanes = per_lane(f)

    def fc(xx, tt, uu):
        return f_lanes(saturate(xx, clip_lo, clip_hi), tt, uu, dT, pxT)

    def sub(xx, uu, tt):
        k1 = fc(xx, tt, uu)
        k2 = fc(xx + dt / 2 * k1, tt + dt / 2, uu)
        k3 = fc(xx + dt / 2 * k2, tt + dt / 2, uu)
        k4 = fc(xx + dt * k3, tt + dt, uu)
        return xx + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    eye = torch.eye(nz, dtype=xs.dtype, device=xs.device)
    TX = eye[:, :nx, None].expand(nz, nx, L)
    TU = eye[:, nx:, None].expand(nz, nu, L)
    xv = xT
    for _ in range(Mx):
        def lin(a, b, xv=xv, tv=tv):
            return torch.func.jvp(lambda xx, uu: sub(xx, uu, tv), (xv, uT), (a, b))

        prim, TX = torch.func.vmap(lin)(TX, TU)
        xv = prim[0]
        tv = tv + dt
    xf = xv.t().reshape(Bsz, N, nx)
    J = TX.permute(2, 1, 0).reshape(Bsz, N, nx, nz)
    return xf, J[..., :nx], J[..., nx:]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


class Rk4StageJac(LaneSweep):
    """``F(xs, us, pxs, t, h, d) -> (xf, Jx, Ju)`` for one ODE and guard."""

    kernel, header, in_place = "rk4_stage_jac", "mpc_rhs_gen.cuh", True
    stage_inputs, scenario_inputs = ("xs", "us", "pxs"), ("d",)

    def __init__(self, f: Callable, Mx: int, clip_lo=None, clip_hi=None):
        super().__init__()
        self.f = f
        self.Mx = int(Mx)
        self.clip_lo = None if clip_lo is None else [float(v) for v in clip_lo]
        self.clip_hi = None if clip_hi is None else [float(v) for v in clip_hi]

    @with_jax_rules
    def plain(self, xs, us, pxs, t, h, d):
        return rk4_stage_jac_plain(self.f, self.Mx, self.clip_lo, self.clip_hi,
                                   xs, us, pxs, t, h, d)

    def source(self, nx, nu, nd, npx) -> str:
        return emit_rhs_source(self.f, nx, nu, nd, npx, self.Mx,
                               self.clip_lo, self.clip_hi)

    @staticmethod
    def dims(w):
        return (w["xs"], w["us"], w["d"], w["pxs"])

    @staticmethod
    def out_dims(nx, nu, nd, npx):
        return ((nx,), (nx, nx), (nx, nu))   # xf, Jx, Ju

    def _count(self):
        global LAUNCHES
        LAUNCHES += 1
