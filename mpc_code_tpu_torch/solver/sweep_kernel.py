"""Fused generic stage-derivative sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/solver/sweep_kernel.py::make_stage_sweep`` (its
kernel body is built by ``_get_kernel_impl``), the Pallas program that runs
every output of ``make_stage_derivs`` for all N stages of a batch: the
structured solver's derivative sweep whenever it has no split dynamics
sweep (the exact Hessian; a LinearModel, collocation, ContForm with
slacks and the MHE's window under either Hessian).  For every (scenario,
stage) lane, at z = (xa, u) in scaled units and the iterate's multipliers
lam, nus and mu_h:

- ``H`` (nz, nz): ∇²(sf·c + lam·dyn + nus·ineq + mu_h·eq) under the exact
  Hessian, ∇²(sf·c) under Gauss-Newton;
- ``gc`` (nz): ∇(sf·c);
- ``A`` (nxa, nxa), ``B`` (nxa, nu) and ``dval`` (nxa): the one-interval
  map's Jacobians and value;
- ``E`` (ni, nz) and ``ival`` (ni): the inequality rows' Jacobian and
  value;
- ``Cz`` (n_eq, nz) and ``hval`` (n_eq): the stage equalities' (H_eq),
  where the OCP has them.

The OCP's functions reach the kernel through the code generator of
``ops/codegen.py``: ``emit_stage_source`` lowers the step (``StageLowering
.kind``: the user ODE with its guard, RK4 sub-steps in the kernel; a
discrete map, the user's as kernel 3 lowers it or a linear model's affine
step, at order 2; ContForm's ODE and quadrature, as kernel 4 lowers them;
or the raw ODE for collocation's implicit step, whose Newton solve runs in
the kernel), the stage cost and the inequality and equality rows to
scalar statements in a generated header, with the scales, weights,
bounds, the interval, the tableau and the u_prev and slack widths as
literals; ``csrc/stage_sweep.cu`` instantiates them with the second-order
forward-mode ``Dual2`` of ``csrc/dual2.cuh``.  The step runs on the
state's and the model input's tangents alone, and the kernel writes the
u_prev and slack rows itself.  The TPU kernel's per-stage traces and (8,
128) tiles exist for Mosaic and have no counterpart here.

The MHE's window (``ocp/mhe.py::WindowLowering``, kind "mhe") has inputs
of its own (``WindowSweep``): the window's data per window stage, which
the kernel indexes for structured stage n at clip(n - 1, 0, N - 2), and
the per-lane arrival-cost and smoothing-correction matrices, read where
they stand once a scenario.  ``emit_window_source`` lowers the MHE
model's step (its ODE, RK4 sub-steps in the kernel with d and the noise w
held, or its map; then ``+ Bd d``, ``+ px``, d carried and ``+ G w``), the
stage cost and the rows; the step runs on all nz tangents, since the
noise w is the input and may enter the model.  Its bound counts the step
on the tangents it depends on (``window_ops``): Ex_ENMPC's MHE ODE reads
neither w nor d, so the step needs the state's alone.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/stage_sweep.cu``.

``StageSweep.__call__`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs the plain version (the vmapped
``make_stage_derivs``) only for CPU tensors, after lowering the OCP's
functions as a launch would, so that an OCP the kernel cannot take is
refused on the CPU too.  The plain version runs the user's functions under
``ops/jax_rules.py``: where torch's derivative differs from JAX's (clamp
at a tie, abs at 0, atan2 at the origin, pow in a traced exponent) it
takes JAX's, as the kernel does.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.ocp.mhe import WindowLowering
from mpc_code_tpu_torch.ops.codegen import Arg, Program, lit
from mpc_code_tpu_torch.ops.jax_rules import jax_rules
from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep, Planes
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
    step's programs (``(ode,)`` for "rk4" and "coll", ``(fmap,)`` for
    "map", ``(ode, quad)`` for "cf"), on the state and the model's input
    alone (nx + nu - ns tangents), ``cost`` the stage cost (for "cf" the
    slack penalty beside the quadrature, or None) and ``ineq`` the
    inequality rows (None when ni = 0), on z = (xa, u).  The equality rows
    are ``eq_program``'s."""
    step: tuple
    cost: Optional[Program]
    ineq: Optional[Program]


def _ode_program(ode, nx, nuc, nd, npx, order, u_kind="dual"):
    """The ODE ``ode(x, t, u, d, px)`` with x (and u, unless ``u_kind`` is
    'vec') carrying tangents."""
    return Program(ode, (Arg("x", "dual", nx), Arg("t", "scalar"), Arg("u", u_kind, nuc),
                         Arg("d", "vec", nd), Arg("px", "vec", npx)),
                   nx + (nuc if u_kind == "dual" else 0), out_dim=nx, order=order,
                   what="ODE")


def stage_programs(low: StageLowering, nxa, nu, ni, nd, npx, npy,
                   order=2) -> StagePrograms:
    """The OCP's stage functions lowered with the state and the input
    carrying first- and second-order tangents; ``order=1`` counts the
    step's (but ContForm's, whose quadrature is the cost, and
    collocation's, whose stage states the cost reads) and the rows'
    operations on first-order tangents only (the cost's stay second
    order)."""
    nz, nx = nxa + nu, low.nx
    nuc = nu - low.ns
    if low.kind == "cf":
        step = cf_programs(low.ode, low.quad, nx, nuc, nd, npx, npy)
    elif low.kind == "map":
        step = (map_program(low.fmap, nx, nuc, nd, npx, order=order),)
    else:
        step = (_ode_program(low.ode, nx, nuc, nd, npx, 2 if low.kind == "coll" else order),)
    pt = _point_args(low, nxa, nu, nd, npx, npy)
    cost = (Program(low.cost, pt, nz, out_dim=None, order=2, what="stage cost")
            if low.cost is not None else None)
    ineq = (Program(low.ineq, pt, nz, out_dim=ni, order=order, what="inequality rows")
            if ni else None)
    return StagePrograms(step, cost, ineq)


def _point_args(low: StageLowering, nxa, nu, nd, npx, npy) -> tuple:
    """The arguments of the stage cost and rows: z = (xa, u), then the
    point's parameters (``low.point_args``)."""
    nx, nuc = low.nx, nu - low.ns
    dims = dict(t=None, xs=nx, us=nuc, d=nd, um1=nuc, lam=(low.ny, nuc),
                py=npy, py0=npy, px=npx, s_coll=2 * nx, k0=None)
    kinds = dict(t="scalar", k0="scalar", lam="mat", s_coll="dual")
    return (Arg("xa", "dual", nxa), Arg("u", "dual", nu)) + tuple(
        Arg(k, kinds.get(k, "vec"), dims[k]) for k in low.point_args)


def eq_program(low: StageLowering, nxa, nu, nd, npx, npy, order=2) -> Optional[Program]:
    """The stage equality rows lowered as the inequality rows are (None
    when n_eq = 0)."""
    if not low.n_eq:
        return None
    return Program(low.eq, _point_args(low, nxa, nu, nd, npx, npy), nxa + nu,
                   out_dim=low.n_eq, order=order, what="equality rows")


def _bounds(b, n):
    return [None] * n if b is None else [float(v) for v in np.asarray(b).reshape(-1)]


def _array(vals) -> str:
    return "{" + ", ".join(repr(float(v)) for v in (list(vals) or [1.0])) + "}"


KINDS = {"rk4": 0, "map": 1, "cf": 2, "coll": 3, "mhe": 4}


def _coll_tableau():
    """The 2-point Gauss-Legendre tableau of ``ocp/collocation.py``: the
    inverse of its A and b~."""
    from mpc_code_tpu_torch.ocp.collocation import _AD, _BT

    return np.asarray(_AD, float), np.asarray(_BT, float)


def emit_stage_source(low: StageLowering, sxa, su, si, hessian, nxa, nu, ni,
                      nd, npx, npy) -> str:
    """Generated header ``mpc_stage_gen.cuh`` for ``csrc/stage_sweep.cu``:
    the step kind (``MPC_KIND``), the dimensions with the u_prev width
    ``MPC_NUP``, the slack width ``MPC_NS`` and the equality rows'
    ``MPC_NEQ``, the interval's RK4 steps, the scales, the step's functions
    (``mpc_rhs``, the traced ODE, and ``mpc_clip``, the guard from literal
    bounds, max then min per component, finite bounds only; or
    ``mpc_map``; or ContForm's ``mpc_ode`` and ``mpc_quad``; or for
    collocation ``mpc_rhs`` with the tableau ``MPC_AD``, ``MPC_BT``, the
    Newton steps ``MPC_NEWTON`` and ``MPC_PX0``, stage 0's px),
    ``mpc_terms`` (``+ Bd d``, then ``+ px`` under LinPar, as
    ``models/model.py`` adds them), ``mpc_cost``, ``mpc_ineq`` and
    ``mpc_eq``."""
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
    rhs = (f"{tpl} mpc_rhs(const V* x, S t, const V* u, const S* d, "
           f"const S* px, V* out) {{\n{progs.step[0].body}\n}}\n")
    coll = ""
    if low.kind == "cf":
        cf_sig = ("const V* x, S t, const V* u, const S* d, const S* px, "
                  "const S* xs, const S* us, const S* py, V* out")
        step = (f"{tpl} mpc_ode({cf_sig}) {{\n{progs.step[0].body}\n}}\n\n"
                f"{tpl} mpc_quad({cf_sig}) {{\n{progs.step[1].body}\n}}\n")
    elif low.kind == "map":
        step = (f"{tpl} mpc_map(const V* x, const V* u, const S* d, S t, "
                f"const S* px, V* out) {{\n{progs.step[0].body}\n}}\n")
    elif low.kind == "coll":
        step = rhs
        ad, bt = _coll_tableau()
        coll = (f"#define MPC_H {float(low.h)!r}\n#define MPC_NEWTON {low.n_newton}\n"
                f"#define MPC_AD {{{_array(ad[0])}, {_array(ad[1])}}}\n"
                f"#define MPC_BT {_array(bt)}\n")
    else:
        step = rhs + f"\n{tpl} mpc_clip(const V* x, V* xc) {{\n{chr(10).join(clip)}\n}}\n"
    pt_sig = ("const V* xa, const V* u, const V* s_coll, S t, const S* xs, const S* us, "
              "const S* d, const S* um1, const S* lam, const S* py, "
              "const S* py0, const S* px, bool k0, V* out")
    eq = eq_program(low, nxa, nu, nd, npx, npy)
    fns = "".join(f"\n{tpl} {name}({pt_sig}) {{\n{prog.body}\n}}\n"
                  for name, prog in (("mpc_cost", progs.cost), ("mpc_ineq", progs.ineq),
                                     ("mpc_eq", eq)) if prog is not None)
    dt = low.h / low.Mx
    return f"""// Generated by mpc_code_tpu_torch/solver/sweep_kernel.py.
#pragma once
#include <cmath>
#define MPC_KIND_RK4 {KINDS["rk4"]}
#define MPC_KIND_MAP {KINDS["map"]}
#define MPC_KIND_CF {KINDS["cf"]}
#define MPC_KIND_COLL {KINDS["coll"]}
#define MPC_KIND_MHE {KINDS["mhe"]}
#define MPC_KIND {KINDS[low.kind]}
#define MPC_NX {nx}
#define MPC_NUP {low.nup}
#define MPC_NS {low.ns}
#define MPC_NXA {nxa}
#define MPC_NU {nu}
#define MPC_NI {ni}
#define MPC_NEQ {low.n_eq}
#define MPC_ND {nd}
#define MPC_NPX {npx}
#define MPC_NPY {npy}
#define MPC_NLAM {low.ny * (nu - low.ns)}
#define MPC_MX {low.Mx}
#define MPC_EXACT {int(hessian == "exact")}
#define MPC_HAS_COST {int(progs.cost is not None)}
#define MPC_PX0 {int(low.kind == "coll" and not low.stagewise_px)}
#define MPC_DT {dt!r}
#define MPC_DT2 {dt / 2!r}
#define MPC_DT6 {dt / 6!r}
#define MPC_SXA {_array(sxa)}
#define MPC_SU {_array(su)}
#define MPC_SI {_array(si)}
{coll}
{step}
{tpl} mpc_terms(V* x, const S* d, const S* px) {{
{chr(10).join(terms)}
}}
{fns}"""


def _lu_ops(n) -> int:
    """LU with partial pivoting of (n, n): per column the compares, one
    reciprocal, the multipliers and the update's multiply-adds."""
    return sum((n - k - 1) + 1 + (n - k - 1) * (1 + 2 * (n - k - 1)) for k in range(n))


def _solve_ops(n) -> int:
    """One solve with the LU's factors: the two triangles and n divisions."""
    return 2 * n * (n - 1) + n


def _coll_ops(low: StageLowering, nuc, nd, npx) -> int:
    """The collocation step's operations: ``n_newton`` Newton steps on
    values (two ODE evaluations on first-order numbers over s, the
    residual, the Jacobian's diagonal blocks, an LU and a solve), then the
    differentiable step: two ODE evaluations on second-order numbers over
    (s, u), the residual on those numbers, one LU, a solve for the value and
    for each tangent with the Jacobian's first and second derivatives'
    corrections, S = S* - G and x + b~'(S - x).  The second derivatives
    come from two more ODE evaluations on second-order numbers over u
    whose components carry one more tangent, counted as twice the
    operations of those numbers (a value and a tangent each: a lower
    count)."""
    nx = low.nx
    n2, nzm = 2 * nx, nx + nuc
    npm = nzm * (nzm + 1) // 2
    wm = 1 + nzm + npm
    ode1 = _ode_program(low.ode, nx, nuc, nd, npx, 1, u_kind="vec").ops
    ode2 = _ode_program(low.ode, nx, nuc, nd, npx, 2).ops
    newton = 2 * ode1 + 7 * n2 + 2 * nx * nx + _lu_ops(n2) + _solve_ops(n2) + n2
    # the corrections: one multiply-add a block entry for each u tangent of
    # a first-order tangent and of each second-order entry's pair
    u_terms = nuc + sum((i >= nx) + (j >= nx) for i in range(nzm) for j in range(i, nzm))
    npu = nuc * (nuc + 1) // 2
    ode_uu = Program(low.ode, (Arg("x", "dual", nx), Arg("t", "scalar"), Arg("u", "dual", nuc),
                               Arg("d", "vec", nd), Arg("px", "vec", npx)),
                     nuc, out_dim=nx, order=2, what="ODE").ops if nuc else 0
    final = (2 * ode2 + 7 * n2 * wm + 2 * nx * nx + _lu_ops(n2)
             + (1 + nzm + npm) * _solve_ops(n2) + u_terms * 2 * n2 * nx
             + 2 * 2 * ode_uu + npu * n2
             + n2 * wm + 5 * nx * wm)
    return low.n_newton * newton + final


def stage_ops_per_lane(low: StageLowering, hessian, nxa, nu, ni, nd, npx, npy) -> int:
    """Arithmetic operations the kernel's function needs per lane (exp, log
    and sqrt count as one each; a bound against a constant is a compare
    and a select per component): the cost and the rows once, on numbers
    with nz = nxa + nu first- and nz(nz+1)/2 second-order tangents; the
    step on numbers with the nx + nu - ns tangents of the state and the
    model's input alone (the u_prev and slack slots do not enter it): for
    "rk4" four ODE evaluations with the guard and the RK4 combination (13
    operations a state) per sub-step, for "map" one evaluation of the map,
    for "cf" four evaluations of the ODE and the quadrature and their RK4
    combination (13 a state, 7 the quadrature) per sub-step, for "coll"
    the Newton solve and the implicit step (``_coll_ops``); ``+ Bd d`` and
    ``+ px`` on the values; the scalings (sf, 1/si, 1/sxa; the u_prev and
    slack rows' value and entry); and the assembly of H's upper triangle
    (one product, then a multiply-add for each inequality and equality row
    and, on the step's block, each dynamics row under the exact Hessian).
    Under Gauss-Newton H is the cost's Hessian alone, so the step and the
    rows need first-order tangents only, but ContForm's step, whose
    quadrature is the cost, and collocation's, whose stage states the cost
    reads."""
    exact = hessian == "exact"
    cf, coll = low.kind == "cf", low.kind == "coll"
    progs = stage_programs(low, nxa, nu, ni, nd, npx, npy, order=2 if exact else 1)
    nx, nup, ns = low.nx, low.nup, low.ns
    nz, nzm = nxa + nu, nx + nu - ns
    np2, npm = nz * (nz + 1) // 2, nzm * (nzm + 1) // 2
    width = 1 + nz + np2
    wrow = width if exact else 1 + nz          # the rows' numbers
    wm = 1 + nzm + (npm if exact or cf or coll else 0)  # the step's numbers
    if cf:
        ode, quad = progs.step
        step = low.Mx * (4 * (ode.ops + quad.ops) + (13 * nx + 7) * wm)
    elif coll:
        step = _coll_ops(low, nu - ns, nd, npx)
    elif low.kind == "map":
        step = progs.step[0].ops
    else:
        n_bounds = sum(1 for b in (_bounds(low.clip_lo, nx), _bounds(low.clip_hi, nx))
                       for v in b if v is not None and math.isfinite(v))
        step = low.Mx * (4 * (progs.step[0].ops + n_bounds * wm) + 13 * nx * wm)
    terms = (2 * nd * nx if low.Bd is not None else 0) + (nx if low.lin_par else 0)
    scale = width + ni * wrow + nx * wm + 2 * (nup + ns)
    assembly = np2 + (2 * ((ni + low.n_eq) * np2 + nx * npm) if exact else 0)
    eq = eq_program(low, nxa, nu, nd, npx, npy, order=2 if exact else 1)
    return (sum(p.ops for p in (progs.cost, progs.ineq, eq) if p is not None)
            + step + terms + scale + assembly)


def stage_bytes(Bsz, N, nxa, nu, ni, nd, npx, npy, nlam, itemsize, n_eq=0) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    L = Bsz * N
    nz = nxa + nu
    ins = (2 * nxa + nu + ni + n_eq + npx + npy) * L + (2 + nxa + 2 * nu + nd + nlam) * Bsz
    outs = (nz * nz + nz + nxa * nxa + nxa * nu + (ni + n_eq) * (nz + 1) + nxa) * L
    return itemsize * (ins + outs)


class StageSweep(LaneSweep):
    """``F(X, U, lam, nus, px, py, mu_h, t, sf, xs, us, d, um1, lamy) ->
    (H, gc, A, B, E, ival, dval, Cz, hval)`` for one OCP and Hessian mode:
    X, U, lam, nus, px, py and the stage equalities' multipliers mu_h per
    stage (B, N, k; mu_h zero-width, and Cz and hval empty, for an OCP
    without them), t and sf per scenario (B,), xs, us, d, um1 and the
    output-correction matrix ``lamy`` (B, ny*nu, row-major) per scenario.
    ``inputs`` builds these from the solver's iterate."""

    kernel, header = "stage_sweep", "mpc_stage_gen.cuh"
    stage_inputs = ("X", "U", "lam", "nus", "px", "py", "mu_h")
    scalar_inputs = ("t", "sf")
    scenario_inputs = ("xs", "us", "d", "um1", "lamy")

    def __init__(self, s: StructuredOCP, hessian: str = "exact"):
        super().__init__()
        if hessian not in ("exact", "gauss_newton"):
            raise ValueError(f"unknown hessian {hessian!r}")
        if s.lowering is None:
            raise ValueError("the fused stage sweep needs an OCP with a lowering "
                             "(StructuredOCP.lowering)")
        self.derivs = make_stage_derivs(s, hessian)   # raises where unported
        self.s, self.hessian, self.low = s, hessian, s.lowering
        self._src = {}
        self._v = vmap(self.derivs)

    @staticmethod
    def inputs(Xs, Us, p, lam, nus, mu_h):
        """The kernel's inputs at the solver's iterate: X[:, :N], U, the
        batched parameter dict (with ``_sf``), lam, nus and mu_h."""
        return (Xs, Us, lam, nus, p["px"], p["py"], mu_h, p["t"], p["_sf"], p["xs"],
                p["us"], p["d"], p["um1"], p["lam"].reshape(Xs.shape[0], -1))

    def plain(self, *args):
        """The vmapped ``make_stage_derivs`` over blocks of at most
        PLAIN_BLOCK_LANES (scenario, stage) lanes: lanes are independent,
        and a block bounds the memory its reverse-mode graph holds.  The
        outputs are contiguous (B, N, ...) tensors, as the kernel writes
        them.  The OCP's functions are lowered first, as for a launch:
        what the code generator cannot lower raises here too."""
        names = self.input_names()
        if len(args) != len(names):
            raise TypeError(f"{self.kernel} takes {names}, got {len(args)} inputs")
        self.source(*self.dims({k: a.shape[-1] for k, a in zip(names, args) if a.dim() > 1}))
        Bsz, N = args[0].shape[:2]
        step = max(1, PLAIN_BLOCK_LANES // N)
        with jax_rules():
            parts = [self._plain_block(*[a[b0:b0 + step] for a in args])
                     for b0 in range(0, Bsz, step)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def _plain_block(self, X, U, lam, nus, px, py, mu_h, t, sf, xs, us, d, um1, lamy):
        Bsz, N, nxa = X.shape
        nuc = us.shape[-1]
        p = dict(xs=xs, us=us, d=d, um1=um1, t=t,
                 lam=lamy.reshape(Bsz, -1, nuc), px=px, py=py, _sf=sf)
        pk = stage_params(p, N)
        L = Bsz * N
        Z = torch.cat([X, U], -1).reshape(L, nxa + U.shape[-1])
        n_eq = self.s.n_eq
        mu_arg = (mu_h.reshape(L, n_eq),) if n_eq else ()
        out = self._v(Z, pk, lam.reshape(L, nxa), nus.reshape(L, nus.shape[-1]), *mu_arg)
        if not n_eq:     # make_stage_derivs returns Cz and hval only with rows
            out += (Z.new_zeros(L, 0, Z.shape[-1]), Z.new_zeros(L, 0))
        return tuple(o.reshape((Bsz, N) + tuple(o.shape[1:])).contiguous() for o in out)

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
                fn.argtypes = ([ctypes.c_void_p] * (len(self.input_names())
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
        dims = (nxa, nu, ni, nd, npx, npy)
        if dims not in self._src:
            s = self.s
            self._src[dims] = emit_stage_source(self.low, s.sxa, s.su, s.si, self.hessian,
                                                *dims)
        return self._src[dims]

    def ops_per_lane(self, nxa, nu, ni, nd, npx, npy) -> int:
        return stage_ops_per_lane(self.low, self.hessian, nxa, nu, ni, nd, npx, npy)

    def _widths(self, args) -> dict:
        return {k: a.shape[-1] for k, a in zip(self.input_names(), args) if a.dim() > 1}

    def ops(self, *args) -> int:
        """The operations the function needs on these inputs: every lane's."""
        Bsz, N = args[0].shape[:2]
        return Bsz * N * self.ops_per_lane(*self.dims(self._widths(args)))

    def moved_bytes(self, *args) -> int:
        """The bytes the function must move on these inputs."""
        Bsz, N = args[0].shape[:2]
        dims = self.dims(self._widths(args))
        return stage_bytes(Bsz, N, *dims, self.low.ny * (dims[1] - self.low.ns),
                           args[0].element_size(), self.s.n_eq)

    def dims(self, w):
        s = self.s
        nxa, nu, ni = w["X"], w["U"], w["nus"]
        nuc = nu - self.low.ns
        if ((nxa, nu, ni, w["mu_h"]) != (s.nxa, s.nu, s.ni, s.n_eq) or w["lam"] != nxa
                or (w["xs"], w["us"], w["um1"]) != (self.low.nx, nuc, nuc)
                or w["lamy"] != self.low.ny * nuc):
            raise ValueError(f"inputs of widths {w} do not fit the OCP's "
                             f"(nxa, nu, ni, n_eq) = {(s.nxa, s.nu, s.ni, s.n_eq)}")
        return (nxa, nu, ni, w["d"], w["px"], w["py"])

    def out_rows(self, nxa, nu):
        # H, gc, A, B, E, ival, dval, Cz, hval
        nz, ni, n_eq = nxa + nu, self.s.ni, self.s.n_eq
        return (nz * nz, nz, nxa * nxa, nxa * nu, ni * nz, ni, nxa, n_eq * nz, n_eq)

    @staticmethod
    def out_shape(rows, L):
        """Outputs lane by lane, (L, rows): the solver's (B, N, ...) layout."""
        return (L, rows)

    def _count(self):
        global LAUNCHES
        LAUNCHES += 1

    def launch(self, *args):
        """The kernel's nine outputs as contiguous (B, N, ...) tensors."""
        planes = self.pack(*args)
        Bsz, N, (nxa, nu, ni) = planes.Bsz, planes.N, planes.dims[:3]
        nz, n_eq = nxa + nu, self.s.n_eq
        shapes = ((nz, nz), (nz,), (nxa, nxa), (nxa, nu), (ni, nz), (ni,), (nxa,),
                  (n_eq, nz), (n_eq,))
        return tuple(o.view((Bsz, N) + sh)
                     for o, sh in zip(self.launch_planes(planes), shapes))


# ---------------------------------------------------------------------------
# the MHE window (kind "mhe")
# ---------------------------------------------------------------------------


def _window_point_args(nxa, nu, m, p, npy, nc) -> tuple:
    """The arguments of the window's stage cost and rows: z = (xa, u), then
    ``ocp/mhe.py::WINDOW_ARGS``."""
    return (Arg("xa", "dual", nxa), Arg("u", "dual", nu), Arg("um", "vec", m),
            Arg("y", "vec", p), Arg("tw", "scalar"), Arg("pyw", "vec", npy),
            Arg("mask", "scalar"), Arg("k0", "scalar"), Arg("x_bar", "vec", nxa),
            Arg("P_inv", "mat", (nxa, nxa)), Arg("Yc", "vec", nc),
            Arg("Obig", "mat", (nc, nxa)), Arg("Hbig", "vec", nc), Arg("Pyc", "mat", (nc, nc)))


def _step_program(st, nz, nu, m, npx, order) -> Program:
    """The MHE model's ODE or map on values carrying ``nz`` tangents."""
    sargs = (Arg("x", "dual", st.nx), Arg("t", "scalar"), Arg("w", "dual", nu),
             Arg("d", "dual", st.nd), Arg("u", "vec", m), Arg("px", "vec", npx))
    return Program(st.fn, sargs, nz, out_dim=st.nx, order=order,
                   what="MHE ODE" if st.kind == "rk4" else "MHE map")


def _terms_program(st, nz, nu, npx, order) -> Program:
    """The MHE model's terms after the step (``MHEStep.terms``)."""
    return Program(st.terms(), (Arg("x", "dual", st.nx), Arg("d", "dual", st.nd),
                                Arg("w", "dual", nu), Arg("px", "vec", npx)),
                   nz, out_dim=st.nx + st.nd, order=order, what="MHE terms")


def window_programs(low: WindowLowering, nxa, nu, ni, m, p, npx, npy, nc,
                    order=2) -> StagePrograms:
    """The window's functions lowered as ``stage_programs`` lowers an
    OCP's: ``step`` the MHE model's ODE or map on the state x, the noise w
    and d carrying tangents (nxa + nu of them), then its terms; ``cost``
    and ``ineq`` on z = (xa, u) and the window's point arguments."""
    st, nz = low.step, nxa + nu
    step = _step_program(st, nz, nu, m, npx, order)
    terms = _terms_program(st, nz, nu, npx, order)
    pt = _window_point_args(nxa, nu, m, p, npy, nc)
    cost = Program(low.cost, pt, nz, out_dim=None, order=2, what="MHE stage cost")
    ineq = (Program(low.ineq, pt, nz, out_dim=ni, order=order, what="MHE rows")
            if ni else None)
    return StagePrograms((step, terms), cost, ineq)


def emit_window_source(low: WindowLowering, sxa, su, si, hessian, nxa, nu, ni, m, p,
                       npx, npy, nc) -> str:
    """Generated header ``mpc_stage_gen.cuh`` of an MHE window
    (``MPC_KIND_MHE``): the dimensions (``MPC_NX`` the augmented state,
    ``MPC_NXM`` the model's state, ``MPC_NUM``, ``MPC_NYW`` and
    ``MPC_NCORR`` the window's measured input, output and correction
    widths), the RK4 steps over the interval, the scales, the step
    (``mpc_rhs`` and ``mpc_clip``, or ``mpc_map``), ``mpc_terms``,
    ``mpc_cost`` and ``mpc_ineq``."""
    progs = window_programs(low, nxa, nu, ni, m, p, npx, npy, nc)
    st = low.step
    (step, terms), tpl = progs.step, "template <class V, class S>\n__device__ __forceinline__ void"
    lo, hi = _bounds(st.clip_lo, st.nx), _bounds(st.clip_hi, st.nx)
    clip = []
    for i in range(st.nx):
        e = f"x[{i}]"
        if lo[i] is not None and math.isfinite(lo[i]):
            e = f"mpc_max({e}, {lit(lo[i])})"
        if hi[i] is not None and math.isfinite(hi[i]):
            e = f"mpc_min({e}, {lit(hi[i])})"
        clip.append(f"  xc[{i}] = {e};")
    sig = "const V* x, S t, const V* w, const V* d, const S* u, const S* px, V* out"
    name = "mpc_map" if st.kind == "map" else "mpc_rhs"
    pt_sig = ("const V* xa, const V* u, const S* um, const S* y, S tw, const S* pyw, "
              "bool mask, bool k0, const S* x_bar, const S* P_inv, const S* Yc, "
              "const S* Obig, const S* Hbig, const S* Pyc, V* out")
    fns = "".join(f"\n{tpl} {fn}({pt_sig}) {{\n{prog.body}\n}}\n"
                  for fn, prog in (("mpc_cost", progs.cost), ("mpc_ineq", progs.ineq))
                  if prog is not None)
    dt = low.h / st.Mx
    return f"""// Generated by mpc_code_tpu_torch/solver/sweep_kernel.py.
#pragma once
#include <cmath>
#define MPC_KIND_RK4 {KINDS["rk4"]}
#define MPC_KIND_MAP {KINDS["map"]}
#define MPC_KIND_CF {KINDS["cf"]}
#define MPC_KIND_COLL {KINDS["coll"]}
#define MPC_KIND_MHE {KINDS["mhe"]}
#define MPC_KIND {KINDS["mhe"]}
#define MPC_MHE_MAP {int(st.kind == "map")}
#define MPC_NX {nxa}
#define MPC_NXM {st.nx}
#define MPC_NUP 0
#define MPC_NS 0
#define MPC_NXA {nxa}
#define MPC_NU {nu}
#define MPC_NI {ni}
#define MPC_NEQ 0
#define MPC_ND 0
#define MPC_NPX {npx}
#define MPC_NPY {npy}
#define MPC_NLAM 0
#define MPC_NUM {m}
#define MPC_NYW {p}
#define MPC_NCORR {nc}
#define MPC_MX {st.Mx}
#define MPC_EXACT {int(hessian == "exact")}
#define MPC_HAS_COST 1
#define MPC_PX0 0
#define MPC_DT {dt!r}
#define MPC_DT2 {dt / 2!r}
#define MPC_DT6 {dt / 6!r}
#define MPC_SXA {_array(sxa)}
#define MPC_SU {_array(su)}
#define MPC_SI {_array(si)}

{tpl} {name}({sig}) {{
{step.body}
}}

{tpl} mpc_clip(const V* x, V* xc) {{
{chr(10).join(clip)}
}}

{tpl} mpc_terms(const V* x, const V* d, const V* w, const S* px, V* out) {{
{terms.body}
}}
{fns}"""


def step_tangents(low: WindowLowering, nu, m, npx) -> int:
    """The tangents the MHE model's step depends on: the model state's,
    and the noise's and d's where its ODE or map reads them (the terms
    after it are affine in d and w)."""
    st = low.step
    reads = _step_program(st, st.nx + st.nd + nu, nu, m, npx, 1).reads
    return st.nx + (nu if "w" in reads else 0) + (st.nd if "d" in reads else 0)


def window_ops(low: WindowLowering, hessian, nxa, nu, ni, m, p, npx, npy, nc) -> tuple:
    """``(every lane's, a stepping lane's more)``: the arithmetic the
    window's function needs on a lane, counted as ``stage_ops_per_lane``
    counts an OCP's.  Every lane: the cost and the rows on numbers with nz
    = nxa + nu tangents, the scalings (sf and 1/si of their numbers, 1/sxa
    of the dynamics' value and Jacobian) and the assembly of H's upper
    triangle (one product, then under the exact Hessian a multiply-add for
    each row).  A lane that steps (neither the arrival stage nor a pad
    stage) also: the step on numbers with the k tangents it depends on
    (``step_tangents``; their second order under the exact Hessian alone):
    for "rk4" four ODE evaluations with the guard and the RK4 combination
    (13 operations a state) per sub-step, for "map" one evaluation of the
    map; then the terms, affine, on the values; and under the exact
    Hessian a multiply-add for each model-state row on the step's
    k(k+1)/2 entries."""
    exact = hessian == "exact"
    order = 2 if exact else 1
    progs = window_programs(low, nxa, nu, ni, m, p, npx, npy, nc, order=order)
    st = low.step
    k = step_tangents(low, nu, m, npx)
    fn = _step_program(st, k, nu, m, npx, order)
    nz = nxa + nu
    np2, km = nz * (nz + 1) // 2, (k * (k + 1) // 2 if exact else 0)
    width = 1 + nz + np2
    wrow = width if exact else 1 + nz
    wm = 1 + k + km
    if st.kind == "map":
        step = fn.ops
    else:
        n_bounds = sum(1 for b in (_bounds(st.clip_lo, st.nx), _bounds(st.clip_hi, st.nx))
                       for v in b if v is not None and math.isfinite(v))
        step = st.Mx * (4 * (fn.ops + n_bounds * wm) + 13 * st.nx * wm)
    terms = _terms_program(st, 0, nu, npx, 1).ops
    every = (sum(q.ops for q in (progs.cost, progs.ineq) if q is not None)
             + width + ni * wrow + nxa * (1 + nz)
             + np2 + (2 * ni * np2 if exact else 0))
    return every, step + terms + 2 * st.nx * km


def window_bytes(Bsz, N, nxa, nu, ni, m, p, npx, npy, nc, itemsize) -> int:
    """Bytes a window's function must move: each input read once (the
    window planes over B * (N - 1) lanes, the per-lane matrices once a
    scenario), each output written once."""
    L, Lw = Bsz * N, Bsz * (N - 1)
    nz = nxa + nu
    ins = ((2 * nxa + nu + ni) * L + (m + p + 2 + npx + npy) * Lw
           + (1 + nxa + nxa * nxa + nc * nxa + nc + nc * nc) * Bsz)
    outs = (nz * nz + nz + nxa * nxa + nxa * nu + ni * (nz + 1) + nxa) * L
    return itemsize * (ins + outs)


class WindowSweep(StageSweep):
    """Kernel 5 on an MHE window (``ocp/mhe.py::build_structured_mhe``):
    ``F(X, U, lam, nus, um, y, tw, pxw, pyw, mask, sf, x_bar, P_inv, obig,
    hbig, pyc) -> (H, gc, A, B, E, ival, dval, Cz, hval)`` (Cz and hval
    empty): X, U, lam and nus per structured stage (B, N, k); the window's
    measured inputs, outputs, times, px, py and mask per window stage (B,
    N - 1, k), times and mask (B, N - 1, 1), the mask 1 or 0; sf (B,); per
    scenario (B, k), row-major: x_bar, P_inv, and the smoothing
    correction's Obig, Hbig and Pycondx_inv (zero-width without it; its
    measurements are the first window stages' outputs).  Structured stage
    n reads window stage clip(n - 1, 0, N - 2), and the kernel indexes it
    there.  ``inputs`` builds these from the solver's iterate and the
    window's parameter dict."""

    stage_inputs = ("X", "U", "lam", "nus")
    window_inputs = ("um", "y", "tw", "pxw", "pyw", "mask")
    scalar_inputs = ("sf",)
    scenario_inputs = ("x_bar", "P_inv", "obig", "hbig", "pyc")

    def input_names(self) -> tuple:
        return (self.stage_inputs + self.window_inputs + self.scalar_inputs
                + self.scenario_inputs)

    def inputs(self, Xs, Us, p, lam, nus, mu_h):
        """The kernel's inputs at the solver's iterate: X[:, :N], U, the
        batched parameter dict (with ``_sf``), lam and nus (mu_h is
        empty)."""
        Bsz, n, nc = Xs.shape[0], self.s.nxa, self.low.n_corr
        Nw = p["U"].shape[1]
        mask = (p["mask"].to(Xs.dtype)[..., None] if "mask" in p and self.low.maskable
                else Xs.new_ones((Bsz, Nw, 1)))
        corr = ((p["Obig"].reshape(Bsz, -1), p["Hbig"], p["Pycondx_inv"].reshape(Bsz, -1))
                if nc else (Xs.new_zeros((Bsz, 0)),) * 3)
        return (Xs, Us, lam, nus, p["U"], p["Y"], p["T"][..., None], p["PX"], p["PY"], mask,
                p["_sf"], p["x_bar"], p["P_inv"].reshape(Bsz, n * n)) + corr

    def _plain_block(self, X, U, lam, nus, um, y, tw, pxw, pyw, mask, sf, x_bar, P_inv,
                     obig, hbig, pyc):
        Bsz, N, nxa = X.shape
        nc, nz = self.low.n_corr, nxa + U.shape[-1]
        p = dict(U=um, Y=y, T=tw[..., 0], PX=pxw, PY=pyw, x_bar=x_bar,
                 P_inv=P_inv.reshape(Bsz, nxa, nxa))
        if self.low.maskable:
            p["mask"] = mask[..., 0] != 0
        if nc:
            p.update(Obig=obig.reshape(Bsz, nc, nxa), Hbig=hbig,
                     Pycondx_inv=pyc.reshape(Bsz, nc, nc))
        pk = self.s.params.stage(p, N)
        pk["_sf"] = sf.repeat_interleave(N)
        L = Bsz * N
        Z = torch.cat([X, U], -1).reshape(L, nz)
        out = self._v(Z, pk, lam.reshape(L, nxa), nus.reshape(L, nus.shape[-1]))
        out += (Z.new_zeros(L, 0, nz), Z.new_zeros(L, 0))
        return tuple(o.reshape((Bsz, N) + tuple(o.shape[1:])).contiguous() for o in out)

    def window_dims(self) -> tuple:
        """The build key of the window's own widths."""
        s, low = self.s, self.low
        return (s.nxa, s.nu, s.ni, low.m, low.p, low.npx, low.npy, low.n_corr)

    def dims(self, w):
        want = dict(X=self.s.nxa, U=self.s.nu, lam=self.s.nxa, nus=self.s.ni, tw=1, mask=1,
                    um=self.low.m, y=self.low.p, x_bar=self.s.nxa,
                    P_inv=self.s.nxa ** 2, hbig=self.low.n_corr,
                    obig=self.low.n_corr * self.s.nxa, pyc=self.low.n_corr ** 2)
        if any(w[k] != v for k, v in want.items()):
            raise ValueError(f"inputs of widths {w} do not fit the window's {want}")
        return self.window_dims()[:5] + (w["pxw"], w["pyw"], self.low.n_corr)

    def source(self, *dims) -> str:
        if dims not in self._src:
            s = self.s
            self._src[dims] = emit_window_source(self.low, s.sxa, s.su, s.si, self.hessian,
                                                 *dims)
        return self._src[dims]

    def ops_per_lane(self, *dims) -> int:
        """A stepping lane's operations."""
        return sum(window_ops(self.low, self.hessian, *dims))

    def ops(self, *args) -> int:
        """The operations on these inputs: every lane's, and the step's on
        the lanes that step (neither stage 0 nor a pad stage)."""
        X, mask = args[0], args[self.input_names().index("mask")]
        Bsz, N = X.shape[:2]
        every, step = window_ops(self.low, self.hessian, *self.dims(self._widths(args)))
        return Bsz * N * every + int((mask[:, :, 0] != 0).sum()) * step

    def moved_bytes(self, *args) -> int:
        Bsz, N = args[0].shape[:2]
        return window_bytes(Bsz, N, *self.dims(self._widths(args)), args[0].element_size())

    def pack(self, *args) -> Planes:
        """Check the inputs and lay them out: the stage and window inputs
        as planes, lanes innermost; sf as it is; the per-scenario inputs
        row-major.  Raises on a bad device, dtype or shape."""
        named, Bsz, N, dims = self.check(*args)
        if N < 2:
            raise ValueError(f"a window has N >= 2 structured stages, got {N}")
        if any(named[k].dim() != 3 or named[k].shape[:2] != (Bsz, N - 1)
               for k in self.window_inputs):
            raise ValueError(f"{', '.join(self.window_inputs)} must be (B, N - 1, dim) = "
                             f"{(Bsz, N - 1)} + (dim,)")
        dummy = torch.zeros(1, dtype=args[0].dtype, device=args[0].device)

        def plane(a):
            return a.reshape(-1, a.shape[-1]).t().contiguous() if a.shape[-1] else dummy

        ins = ([plane(named[k]) for k in self.stage_inputs + self.window_inputs]
               + [named["sf"].contiguous()]
               + [named[k].contiguous() if named[k].shape[-1] else dummy
                  for k in self.scenario_inputs])
        return Planes(ins, Bsz, N, dims)


def make_stage_sweep(s: StructuredOCP, hessian: str = "exact") -> StageSweep:
    """The full-output stage sweep of ``make_stage_derivs(s, hessian)`` for
    all N stages of a batch: on CUDA tensors ``csrc/stage_sweep.cu``, on
    CPU tensors the vmapped plain version.  An MHE window (its lowering a
    ``WindowLowering``) takes its own inputs (``WindowSweep``)."""
    if isinstance(s.lowering, WindowLowering):
        return WindowSweep(s, hessian)
    return StageSweep(s, hessian)
