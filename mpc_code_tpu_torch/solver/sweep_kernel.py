"""Fused generic stage-derivative sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/solver/sweep_kernel.py::make_stage_sweep`` (its
kernel body is built by ``_get_kernel_impl``), the Pallas program that runs
every output of ``make_stage_derivs`` for all N stages of a batch: the
structured solver's derivative sweep whenever it has no split dynamics
sweep, which is whenever the Hessian is exact.  For every (scenario,
stage) lane, at z = (xa, u) in scaled units and the iterate's multipliers
lam and nus:

- ``H`` (nz, nz): ∇²(sf·c + lam·dyn + nus·ineq) under the exact Hessian,
  ∇²(sf·c) under Gauss-Newton;
- ``gc`` (nz): ∇(sf·c);
- ``A`` (nxa, nxa), ``B`` (nxa, nu) and ``dval`` (nxa): the one-interval
  map's Jacobians and value;
- ``E`` (ni, nz) and ``ival`` (ni): the inequality rows' Jacobian and
  value.

The OCP's functions reach the kernel through the code generator of
``ops/codegen.py``: ``emit_stage_source`` lowers the step (``StageLowering
.kind``: the user ODE with its guard, RK4 sub-steps in the kernel; the
user's discrete map, as kernel 3 lowers it, at order 2; or ContForm's ODE
and quadrature, as kernel 4 lowers them), the stage cost and the
inequality rows to scalar statements in a generated header, with the
scales, weights, bounds, the interval and the u_prev width as literals;
``csrc/stage_sweep.cu`` instantiates them with the second-order
forward-mode ``Dual2`` of ``csrc/dual2.cuh``.  With the u_prev
augmentation the step runs on the state's and the input's tangents alone
and the kernel writes the augmentation's rows itself.  The TPU kernel's
per-stage traces and (8, 128) tiles exist for Mosaic and have no
counterpart here.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/stage_sweep.cu``.

``StageSweep.__call__`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs the plain version (the vmapped
``make_stage_derivs``) only for CPU tensors.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.ops.codegen import Arg, Program, lit
from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep
from mpc_code_tpu_torch.ops.sweep_cf_cuda import cf_programs
from mpc_code_tpu_torch.ops.sweep_map_cuda import map_program
from mpc_code_tpu_torch.solver.riccati import (
    StageLowering, StructuredOCP, make_stage_derivs, stage_params,
)

LAUNCHES = 0
PLAIN_BLOCK_LANES = 1 << 17        # lanes per block of the plain version


class BuiltPair(NamedTuple):
    """Both dtypes' libraries of one build: their launchers and the
    compiler's two reports."""
    lib: SimpleNamespace
    log: str


class StagePrograms(NamedTuple):
    """The lowered functions of one stage: ``step`` the one-interval
    step's programs (``(ode,)`` for "rk4", ``(fmap,)`` for "map", ``(ode,
    quad)`` for "cf"), on the state and the input alone (nx + nu tangents),
    ``cost`` the stage cost (None for "cf", whose cost is the quadrature)
    and ``ineq`` the rows (None when ni = 0), on z = (xa, u)."""
    step: tuple
    cost: Optional[Program]
    ineq: Optional[Program]


def stage_programs(low: StageLowering, nxa, nu, ni, nd, npx, npy,
                   order=2) -> StagePrograms:
    """The OCP's stage functions lowered with the state and the input
    carrying first- and second-order tangents; ``order=1`` counts the
    step's (but ContForm's, whose quadrature is the cost) and the rows'
    operations on first-order tangents only (the cost's stay second
    order)."""
    nz, nx = nxa + nu, low.nx
    nzm = nx + nu
    if low.kind == "cf":
        step = cf_programs(low.ode, low.quad, nx, nu, nd, npx, npy)
    elif low.kind == "map":
        step = (map_program(low.fmap, nx, nu, nd, npx, order=order),)
    else:
        step = (Program(low.ode, (Arg("x", "dual", nx), Arg("t", "scalar"),
                                  Arg("u", "dual", nu), Arg("d", "vec", nd),
                                  Arg("px", "vec", npx)),
                        nzm, out_dim=nx, order=order, what="ODE"),)
    dims = dict(t=None, xs=nx, us=nu, d=nd, um1=nu, lam=(low.ny, nu),
                py=npy, py0=npy, k0=None)
    kinds = dict(t="scalar", k0="scalar", lam="mat")
    pt = (Arg("xa", "dual", nxa), Arg("u", "dual", nu)) + tuple(
        Arg(k, kinds.get(k, "vec"), dims[k]) for k in low.point_args)
    cost = (Program(low.cost, pt, nz, out_dim=None, order=2, what="stage cost")
            if low.cost is not None else None)
    ineq = (Program(low.ineq, pt, nz, out_dim=ni, order=order, what="inequality rows")
            if ni else None)
    return StagePrograms(step, cost, ineq)


def _bounds(b, n):
    return [None] * n if b is None else [float(v) for v in np.asarray(b).reshape(-1)]


def _array(vals) -> str:
    return "{" + ", ".join(repr(float(v)) for v in (list(vals) or [1.0])) + "}"


KINDS = {"rk4": 0, "map": 1, "cf": 2}


def emit_stage_source(low: StageLowering, sxa, su, si, hessian, nxa, nu, ni,
                      nd, npx, npy) -> str:
    """Generated header ``mpc_stage_gen.cuh`` for ``csrc/stage_sweep.cu``:
    the step kind (``MPC_KIND``), the dimensions with the u_prev width
    ``MPC_NUP``, the interval's RK4 steps, the scales, the step's functions
    (``mpc_rhs``, the traced ODE, and ``mpc_clip``, the guard from literal
    bounds, max then min per component, finite bounds only; or
    ``mpc_map``; or ContForm's ``mpc_ode`` and ``mpc_quad``),
    ``mpc_terms`` (``+ Bd d``, then ``+ px`` under LinPar, as
    ``models/model.py`` adds them), ``mpc_cost`` and ``mpc_ineq``."""
    progs = stage_programs(low, nxa, nu, ni, nd, npx, npy)
    nx = low.nx
    lo, hi = _bounds(low.clip_lo, nx), _bounds(low.clip_hi, nx)
    clip, terms = [], []
    for i in range(nx):
        e = f"x[{i}]"
        if lo[i] is not None and math.isfinite(lo[i]):
            e = f"mpc_max({e}, {lit(lo[i])})"
        if hi[i] is not None and math.isfinite(hi[i]):
            e = f"mpc_min({e}, {lit(hi[i])})"
        clip.append(f"  xc[{i}] = {e};")
    if low.Bd is not None:
        Bd = np.asarray(low.Bd, float).reshape(nx, nd)
        for i in range(nx):
            dot = " + ".join(f"{lit(Bd[i, j])} * d[{j}]" for j in range(nd))
            terms.append(f"  x[{i}] = x[{i}] + ({dot});")
    if low.lin_par:
        terms += [f"  x[{i}] = x[{i}] + px[{i}];" for i in range(nx)]
    tpl = "template <class V, class S>\n__device__ __forceinline__ void"
    if low.kind == "cf":
        cf_sig = ("const V* x, S t, const V* u, const S* d, const S* px, "
                  "const S* xs, const S* us, const S* py, V* out")
        step = (f"{tpl} mpc_ode({cf_sig}) {{\n{progs.step[0].body}\n}}\n\n"
                f"{tpl} mpc_quad({cf_sig}) {{\n{progs.step[1].body}\n}}\n")
    elif low.kind == "map":
        step = (f"{tpl} mpc_map(const V* x, const V* u, const S* d, S t, "
                f"const S* px, V* out) {{\n{progs.step[0].body}\n}}\n")
    else:
        step = (f"{tpl} mpc_rhs(const V* x, S t, const V* u, const S* d, "
                f"const S* px, V* out) {{\n{progs.step[0].body}\n}}\n\n"
                f"{tpl} mpc_clip(const V* x, V* xc) {{\n{chr(10).join(clip)}\n}}\n")
    pt_sig = ("const V* xa, const V* u, S t, const S* xs, const S* us, "
              "const S* d, const S* um1, const S* lam, const S* py, "
              "const S* py0, bool k0, V* out")
    cost_fn = ("" if progs.cost is None else
               f"\n{tpl} mpc_cost({pt_sig}) {{\n{progs.cost.body}\n}}\n")
    ineq_fn = ("" if progs.ineq is None else
               f"\n{tpl} mpc_ineq({pt_sig}) {{\n{progs.ineq.body}\n}}\n")
    dt = low.h / low.Mx
    return f"""// Generated by mpc_code_tpu_torch/solver/sweep_kernel.py.
#pragma once
#include <cmath>
#define MPC_KIND_RK4 {KINDS["rk4"]}
#define MPC_KIND_MAP {KINDS["map"]}
#define MPC_KIND_CF {KINDS["cf"]}
#define MPC_KIND {KINDS[low.kind]}
#define MPC_NX {nx}
#define MPC_NUP {low.nup}
#define MPC_NXA {nxa}
#define MPC_NU {nu}
#define MPC_NI {ni}
#define MPC_ND {nd}
#define MPC_NPX {npx}
#define MPC_NPY {npy}
#define MPC_NLAM {low.ny * nu}
#define MPC_MX {low.Mx}
#define MPC_EXACT {int(hessian == "exact")}
#define MPC_DT {dt!r}
#define MPC_DT2 {dt / 2!r}
#define MPC_DT6 {dt / 6!r}
#define MPC_SXA {_array(sxa)}
#define MPC_SU {_array(su)}
#define MPC_SI {_array(si)}

{step}
{tpl} mpc_terms(V* x, const S* d, const S* px) {{
{chr(10).join(terms)}
}}
{cost_fn}{ineq_fn}"""


def stage_ops_per_lane(low: StageLowering, hessian, nxa, nu, ni, nd, npx, npy) -> int:
    """Arithmetic operations the kernel's function needs per lane (exp, log
    and sqrt count as one each; a bound against a constant is a compare
    and a select per component): the cost and the rows once, on numbers
    with nz = nxa + nu first- and nz(nz+1)/2 second-order tangents; the
    step on numbers with the nx + nu tangents of the state and the input
    alone (the u_prev slots do not enter it): for "rk4" four ODE
    evaluations with the guard and the RK4 combination (13 operations a
    state) per sub-step, for "map" one evaluation of the map, for "cf" four
    evaluations of the ODE and the quadrature and their RK4 combination (13
    a state, 7 the quadrature) per sub-step; ``+ Bd d`` and ``+ px`` on the
    values; the scalings (sf, 1/si, 1/sxa; the u_prev rows' value and B
    entry); and the assembly of H's upper triangle (one product, then a
    multiply-add for each inequality row and, on the step's block, each
    dynamics row under the exact Hessian).  Under Gauss-Newton H is the
    cost's Hessian alone, so the step and the rows need first-order
    tangents only, but ContForm's step, whose quadrature is the cost."""
    exact = hessian == "exact"
    cf = low.kind == "cf"
    progs = stage_programs(low, nxa, nu, ni, nd, npx, npy, order=2 if exact else 1)
    nx, nup = low.nx, low.nup
    nz, nzm = nxa + nu, nx + nu
    np2, npm = nz * (nz + 1) // 2, nzm * (nzm + 1) // 2
    width = 1 + nz + np2
    wrow = width if exact else 1 + nz          # the rows' numbers
    wm = 1 + nzm + (npm if exact or cf else 0)  # the step's numbers
    if cf:
        ode, quad = progs.step
        step = low.Mx * (4 * (ode.ops + quad.ops) + (13 * nx + 7) * wm)
    elif low.kind == "map":
        step = progs.step[0].ops
    else:
        n_bounds = sum(1 for b in (_bounds(low.clip_lo, nx), _bounds(low.clip_hi, nx))
                       for v in b if v is not None and math.isfinite(v))
        step = low.Mx * (4 * (progs.step[0].ops + n_bounds * wm) + 13 * nx * wm)
    terms = (2 * nd * nx if low.Bd is not None else 0) + (nx if low.lin_par else 0)
    scale = width + ni * wrow + nx * wm + 2 * nup
    assembly = np2 + (2 * (ni * np2 + nx * npm) if exact else 0)
    return ((progs.cost.ops if progs.cost is not None else 0)
            + (progs.ineq.ops if progs.ineq is not None else 0)
            + step + terms + scale + assembly)


def stage_bytes(Bsz, N, nxa, nu, ni, nd, npx, npy, nlam, itemsize) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    L = Bsz * N
    nz = nxa + nu
    ins = (2 * nxa + nu + ni + npx + npy) * L + (2 + nxa + 2 * nu + nd + nlam) * Bsz
    outs = (nz * nz + nz + nxa * nxa + nxa * nu + ni * nz + ni + nxa) * L
    return itemsize * (ins + outs)


class StageSweep(LaneSweep):
    """``F(X, U, lam, nus, px, py, t, sf, xs, us, d, um1, lamy) -> (H, gc,
    A, B, E, ival, dval)`` for one OCP and Hessian mode: X, U, lam, nus,
    px, py per stage (B, N, k), t and sf per scenario (B,), xs, us, d, um1
    and the output-correction matrix ``lamy`` (B, ny*nu, row-major) per
    scenario.  ``inputs`` builds these from the solver's iterate."""

    kernel, header = "stage_sweep", "mpc_stage_gen.cuh"
    stage_inputs = ("X", "U", "lam", "nus", "px", "py")
    scalar_inputs = ("t", "sf")
    scenario_inputs = ("xs", "us", "d", "um1", "lamy")

    def __init__(self, s: StructuredOCP, hessian: str = "exact"):
        super().__init__()
        if hessian not in ("exact", "gauss_newton"):
            raise ValueError(f"unknown hessian {hessian!r}")
        if s.lowering is None:
            raise ValueError("the fused stage sweep needs an OCP with a lowering "
                             "(StructuredOCP.lowering): a shooting OCP without "
                             "slacks or user rows")
        self.derivs = make_stage_derivs(s, hessian)   # raises where unported
        self.s, self.hessian, self.low = s, hessian, s.lowering
        self._v = vmap(self.derivs)

    @staticmethod
    def inputs(Xs, Us, p, lam, nus):
        """The kernel's inputs at the solver's iterate: X[:, :N], U, the
        batched parameter dict (with ``_sf``), lam and nus."""
        return (Xs, Us, lam, nus, p["px"], p["py"], p["t"], p["_sf"], p["xs"],
                p["us"], p["d"], p["um1"], p["lam"].reshape(Xs.shape[0], -1))

    def plain(self, *args):
        """The vmapped ``make_stage_derivs`` over blocks of at most
        PLAIN_BLOCK_LANES (scenario, stage) lanes: lanes are independent,
        and a block bounds the memory its reverse-mode graph holds."""
        Bsz, N = args[0].shape[:2]
        step = max(1, PLAIN_BLOCK_LANES // N)
        parts = [self._plain_block(*[a[b0:b0 + step] for a in args])
                 for b0 in range(0, Bsz, step)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def _plain_block(self, X, U, lam, nus, px, py, t, sf, xs, us, d, um1, lamy):
        Bsz, N, nxa = X.shape
        nu = U.shape[-1]
        p = dict(xs=xs, us=us, d=d, um1=um1, t=t,
                 lam=lamy.reshape(Bsz, -1, nu), px=px, py=py, _sf=sf)
        pk = stage_params(p, N)
        L = Bsz * N
        Z = torch.cat([X, U], -1).reshape(L, nxa + nu)
        out = self._v(Z, pk, lam.reshape(L, nxa), nus.reshape(L, nus.shape[-1]))
        return tuple(o.reshape((Bsz, N) + tuple(o.shape[1:])) for o in out)

    def build(self, *dims, dtypes=("f32", "f64")):
        """The kernel's libraries for ``dims``, one for each of ``dtypes``
        ("f32", "f64"), each from its own ``nvcc`` run (``-DMPC_DTYPE_BITS``),
        the two side by side: a wide OCP's build takes minutes, and a solve
        needs only its dtype's.  Returns the one library, or for both a
        pair with the two launchers and the two compiler reports."""
        from concurrent.futures import ThreadPoolExecutor

        from mpc_code_tpu_torch.ops.cuda_build import build, used

        todo = [d for d in dtypes if (dims, d) not in self._libs]
        if todo:
            generated = {self.header: self.source(*dims)}

            def one(d):
                built = build(self.kernel, self.kernel + ".cu",
                              defines={"MPC_DTYPE_BITS": d[1:]}, generated=generated)
                fn = getattr(built.lib, f"{self.kernel}_{d}")
                fn.argtypes = ([ctypes.c_void_p] * (len(self.stage_inputs)
                               + len(self.scalar_inputs) + len(self.scenario_inputs)
                               + len(self.out_rows(*dims[:2])))
                               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
                return built

            with ThreadPoolExecutor(len(todo)) as ex:
                for d, built in zip(todo, ex.map(one, todo)):
                    self._libs[(dims, d)] = built
        built = [used(self._libs[(dims, d)]) for d in dtypes]
        if len(built) == 1:
            return built[0]
        return BuiltPair(SimpleNamespace(**{f"{self.kernel}_{d}": getattr(
            b.lib, f"{self.kernel}_{d}") for d, b in zip(dtypes, built)}),
            "".join(b.log for b in built))

    def launcher(self, dims, dtype):
        d = "f32" if dtype == torch.float32 else "f64"
        return getattr(self.build(*dims, dtypes=(d,)).lib, f"{self.kernel}_{d}")

    def source(self, nxa, nu, ni, nd, npx, npy) -> str:
        s = self.s
        return emit_stage_source(self.low, s.sxa, s.su, s.si, self.hessian,
                                 nxa, nu, ni, nd, npx, npy)

    def ops_per_lane(self, nxa, nu, ni, nd, npx, npy) -> int:
        return stage_ops_per_lane(self.low, self.hessian, nxa, nu, ni, nd, npx, npy)

    def dims(self, w):
        s = self.s
        nxa, nu, ni = w["X"], w["U"], w["nus"]
        if ((nxa, nu, ni) != (s.nxa, s.nu, s.ni) or w["lam"] != nxa
                or (w["xs"], w["us"], w["um1"]) != (self.low.nx, nu, nu)
                or w["lamy"] != self.low.ny * nu):
            raise ValueError(f"inputs of widths {w} do not fit the OCP's "
                             f"(nxa, nu, ni) = {(s.nxa, s.nu, s.ni)}")
        return (nxa, nu, ni, w["d"], w["px"], w["py"])

    def out_rows(self, nxa, nu):
        nz, ni = nxa + nu, self.s.ni          # H, gc, A, B, E, ival, dval
        return (nz * nz, nz, nxa * nxa, nxa * nu, ni * nz, ni, nxa)

    @staticmethod
    def out_shape(rows, L):
        """Outputs lane by lane, (L, rows): the solver's (B, N, ...) layout."""
        return (L, rows)

    def _count(self):
        global LAUNCHES
        LAUNCHES += 1

    def launch(self, *args):
        """The kernel's outputs as contiguous (B, N, ...) tensors."""
        planes = self.pack(*args)
        Bsz, N, (nxa, nu, ni) = planes.Bsz, planes.N, planes.dims[:3]
        nz = nxa + nu
        shapes = ((nz, nz), (nz,), (nxa, nxa), (nxa, nu), (ni, nz), (ni,), (nxa,))
        return tuple(o.view((Bsz, N) + sh)
                     for o, sh in zip(self.launch_planes(planes), shapes))


def make_stage_sweep(s: StructuredOCP, hessian: str = "exact") -> StageSweep:
    """The full-output stage sweep of ``make_stage_derivs(s, hessian)`` for
    all N stages of a batch: on CUDA tensors ``csrc/stage_sweep.cu``, on
    CPU tensors the vmapped plain version."""
    return StageSweep(s, hessian)
