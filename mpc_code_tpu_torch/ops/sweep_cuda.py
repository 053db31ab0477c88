"""RK4 stage-Jacobian sweep: hand-written CUDA kernel and its plain version.

Replaces ``mpc_code_tpu/ops/sweep_pallas.py::rk4_stage_jac_pallas``, which
the JAX solver reaches through ``integrators.rk4_stage_jac`` once per IPM
iteration.  For every (scenario, stage) lane: ``Mx`` RK4 sub-steps of
``x' = f(x, t, u, d, px)`` with the saturation guard, plus the nx + nu
forward tangents, giving ``xf``, ``Jx`` and ``Ju``.

The TPU kernel runs any user ODE because Pallas traces it.  The port keeps
that property with a small code generator: ``emit_rhs_source`` traces the
torch ODE with ``torch.fx.symbolic_trace`` and writes it as a
``template <class V, class S> __device__`` function, which the kernel
(``csrc/rk4_stage_jac.cu``) instantiates with the forward-mode
``Dual<T, nz>`` of ``csrc/dual.cuh``.  Only the ops in ``_SUPPORTED`` are
emitted; any other op raises ``NotImplementedError`` naming it.

What bounds the kernel on the H100, and how the design meets it: see the
note at the top of ``csrc/rk4_stage_jac.cu`` (arithmetic-bound; one thread
per lane with state and tangents in registers, lanes-innermost planes).

``Rk4StageJac.__call__`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs the plain version only for CPU
tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Callable

import torch

from mpc_code_tpu_torch.ops.integrators import saturate

LAUNCHES = 0

_ARGS = ("x", "t", "u", "d", "px")          # positional order of the ODE
_ARRAYS = {"x", "u", "d", "px"}
_DUAL_INPUTS = {"x", "u"}

_BIN = {operator.add: "+", operator.sub: "-", operator.mul: "*",
        operator.truediv: "/", torch.add: "+", torch.sub: "-",
        torch.mul: "*", torch.div: "/", torch.true_divide: "/"}
_CMP = {operator.lt: "<", operator.le: "<=", operator.gt: ">",
        operator.ge: ">=", operator.eq: "==", operator.ne: "!=",
        torch.lt: "<", torch.le: "<=", torch.gt: ">", torch.ge: ">=",
        torch.eq: "==", torch.ne: "!="}
_UNARY = {torch.exp: "mpc_exp", torch.log: "mpc_log", torch.sqrt: "mpc_sqrt",
          operator.neg: "-", torch.neg: "-"}
_METHODS = {"exp": "mpc_exp", "log": "mpc_log", "sqrt": "mpc_sqrt",
            "neg": "-", "__neg__": "-"}
_MAXMIN = {torch.maximum: "mpc_max", torch.minimum: "mpc_min"}
_POW = {operator.pow, torch.pow}
_SUPPORTED = ("getitem, add, sub, mul, truediv, neg, exp, log, sqrt, "
              "pow by a scalar, maximum, minimum, comparisons, where, stack")


def _op_name(node) -> str:
    t = node.target
    return t if isinstance(t, str) else getattr(t, "__name__", repr(t))


def _lit(c) -> str:
    c = float(c)
    if math.isnan(c):
        return "S(NAN)"
    if math.isinf(c):
        return "S(INFINITY)" if c > 0 else "S(-INFINITY)"
    return f"S({c!r})"


class _RhsProgram:
    """The traced ODE as C++ statements plus an operation count."""

    def __init__(self, f: Callable, nx: int, nz: int):
        gm = torch.fx.symbolic_trace(f)
        names, dual, lines = {}, {}, []
        ops = 0
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(_ARGS):
            raise NotImplementedError(
                f"the ODE must take exactly {_ARGS}, got "
                f"{[n.name for n in placeholders]}")
        for n, a in zip(placeholders, _ARGS):
            names[n] = a
            dual[n] = a in _DUAL_INPUTS

        def arg(a):
            if isinstance(a, torch.fx.Node):
                if names.get(a) in _ARRAYS:
                    raise NotImplementedError(
                        f"whole-vector use of input {names[a]!r}: only "
                        "indexed components are supported")
                return names[a]
            if isinstance(a, (int, float)) and not isinstance(a, bool):
                return _lit(a)
            raise NotImplementedError(f"unsupported operand {a!r}")

        def is_dual(a):
            return isinstance(a, torch.fx.Node) and dual[a]

        out_items = None
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "output":
                res = n.args[0]
                if not (isinstance(res, torch.fx.Node) and res.op == "call_function"
                        and res.target is torch.stack):
                    raise NotImplementedError(
                        "the ODE must return torch.stack([...]) of its "
                        "components")
                out_items = res.args[0]
                continue
            name = "v_" + n.name
            tgt = n.target
            if n.op == "call_function" and tgt is torch.stack:
                dim = n.kwargs.get("dim", n.args[1] if len(n.args) > 1 else 0)
                if dim != 0 or any(u.op != "output" for u in n.users):
                    raise NotImplementedError(
                        "torch.stack is supported only as the returned value "
                        "(dim 0)")
                continue
            if n.kwargs:
                raise NotImplementedError(
                    f"op {_op_name(n)!r} with keyword arguments {dict(n.kwargs)}")
            if n.op == "call_function" and tgt is operator.getitem:
                base, idx = n.args
                if not (isinstance(base, torch.fx.Node) and names.get(base) in _ARRAYS
                        and isinstance(idx, int)):
                    raise NotImplementedError(
                        "getitem is supported only as an integer index into "
                        f"the inputs {sorted(_ARRAYS)}")
                expr = f"{names[base]}[{idx}]"
                dual[n] = dual[base]
            elif n.op == "call_function" and tgt in _BIN:
                a, b = n.args
                expr = f"({arg(a)} {_BIN[tgt]} {arg(b)})"
                da, db = is_dual(a), is_dual(b)
                dual[n] = da or db
                sym = _BIN[tgt]
                # the operations the function needs: tangents of a dual
                # plus or minus a non-dual are copied (or negated, folded
                # into the consumer); 1/b is one operation
                if sym in "+-":
                    ops += 1 + nz * (da and db)
                elif sym == "*":
                    ops += 1 + (3 * nz if da and db else nz * (da or db))
                elif da and db:                  # (da - q db) / b
                    ops += 2 + 3 * nz
                elif db:                         # -(q / b) db
                    ops += 2 + nz
                else:
                    ops += 1 + nz * da
            elif (n.op == "call_function" and tgt in _UNARY) or (
                    n.op == "call_method" and tgt in _METHODS):
                fn = _UNARY[tgt] if n.op == "call_function" else _METHODS[tgt]
                (a,) = n.args
                expr = f"(-{arg(a)})" if fn == "-" else f"{fn}({arg(a)})"
                dual[n] = is_dual(a)
                if is_dual(a) and fn != "-":     # value, f'(a), nz products
                    ops += (1 if fn == "mpc_exp" else 2) + nz
                else:
                    ops += 1
            elif n.op == "call_function" and tgt in _POW:
                a, c = n.args
                if isinstance(c, torch.fx.Node):
                    raise NotImplementedError(
                        "pow is supported only with a scalar exponent")
                expr = f"mpc_pow({arg(a)}, {_lit(c)})"
                dual[n] = is_dual(a)
                ops += 1 + (2 + nz if is_dual(a) else 0)
            elif n.op == "call_function" and tgt in _MAXMIN:
                a, b = n.args
                expr = f"{_MAXMIN[tgt]}({arg(a)}, {arg(b)})"
                dual[n] = is_dual(a) or is_dual(b)
                ops += 1 + (nz if dual[n] else 0)    # compare, select
            elif n.op == "call_function" and tgt in _CMP:
                a, b = n.args
                expr = f"(mpc_val({arg(a)}) {_CMP[tgt]} mpc_val({arg(b)}))"
                dual[n] = False
                ops += 1
            elif n.op == "call_function" and tgt is torch.where:
                c, a, b = n.args
                expr = f"mpc_where({arg(c)}, {arg(a)}, {arg(b)})"
                dual[n] = is_dual(a) or is_dual(b)
                ops += 1 + (nz if dual[n] else 0)
            else:
                raise NotImplementedError(
                    f"op {_op_name(n)!r} ({n.op}) is not supported by the CUDA "
                    f"sweep's code generator; supported: {_SUPPORTED}")
            names[n] = name
            lines.append(f"  auto {name} = {expr};")
        if out_items is None or len(out_items) != nx:
            raise NotImplementedError(
                f"the ODE must return {nx} stacked components")
        for i, it in enumerate(out_items):
            lines.append(f"  out[{i}] = {arg(it)};")
        self.body = "\n".join(lines)
        self.ops = ops


def emit_rhs_source(f: Callable, nx: int, nu: int, nd: int, npx: int, Mx: int,
                    clip_lo=None, clip_hi=None) -> str:
    """Generated header ``mpc_rhs_gen.cuh`` for ``csrc/rk4_stage_jac.cu``:
    the dimensions, ``mpc_rhs`` (the traced ODE) and ``mpc_clip`` (the
    saturation guard from literal bounds, max then min per component, finite
    bounds only, as ``sweep_pallas._make_clip`` does)."""
    prog = _RhsProgram(f, nx, nx + nu)
    clip = []
    lo = [None] * nx if clip_lo is None else [float(v) for v in clip_lo]
    hi = [None] * nx if clip_hi is None else [float(v) for v in clip_hi]
    for i in range(nx):
        e = f"x[{i}]"
        if lo[i] is not None and math.isfinite(lo[i]):
            e = f"mpc_max({e}, {_lit(lo[i])})"
        if hi[i] is not None and math.isfinite(hi[i]):
            e = f"mpc_min({e}, {_lit(hi[i])})"
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
                       clip_lo=None, clip_hi=None) -> int:
    """Arithmetic operations the function needs per lane (value plus nz
    tangents; exp/log/sqrt count as one each; a bound against a constant
    is a compare and nz tangent selects)."""
    nz = nx + nu
    rhs = _RhsProgram(f, nx, nz).ops
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
    arithmetic of ``integrators.rk4_stage_jac``'s batched JAX rule."""
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

    def fc(xx, tt, uu):
        return f(saturate(xx, clip_lo, clip_hi), tt, uu, dT, pxT)

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


class Rk4StageJac:
    """``F(xs, us, pxs, t, h, d) -> (xf, Jx, Ju)`` for one ODE and guard."""

    def __init__(self, f: Callable, Mx: int, clip_lo=None, clip_hi=None):
        self.f = f
        self.Mx = int(Mx)
        self.clip_lo = None if clip_lo is None else [float(v) for v in clip_lo]
        self.clip_hi = None if clip_hi is None else [float(v) for v in clip_hi]
        self._libs = {}

    def plain(self, xs, us, pxs, t, h, d):
        return rk4_stage_jac_plain(self.f, self.Mx, self.clip_lo, self.clip_hi,
                                   xs, us, pxs, t, h, d)

    def __call__(self, xs, us, pxs, t, h, d):
        if xs.device.type == "cpu":
            return self.plain(xs, us, pxs, t, h, d)
        return self.launch(xs, us, pxs, t, h, d)

    def source(self, nx, nu, nd, npx) -> str:
        return emit_rhs_source(self.f, nx, nu, nd, npx, self.Mx,
                               self.clip_lo, self.clip_hi)

    def build(self, nx, nu, nd, npx):
        key = (nx, nu, nd, npx)
        if key not in self._libs:
            from mpc_code_tpu_torch.ops.cuda_build import build

            built = build("rk4_stage_jac", "rk4_stage_jac.cu",
                          generated={"mpc_rhs_gen.cuh":
                                     self.source(nx, nu, nd, npx)})
            for fn in (built.lib.rk4_stage_jac_f32, built.lib.rk4_stage_jac_f64):
                fn.argtypes = [ctypes.c_void_p] * 8 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._libs[key] = built
        return self._libs[key]

    def pack(self, xs, us, pxs, t, h, d):
        """Check the inputs and lay them out as the kernel's planes
        (lanes innermost, lane = b * N + n).  Raises on a bad device, dtype
        or shape."""
        dev = xs.device
        if dev.type != "cuda":
            raise ValueError(f"rk4_stage_jac kernel needs CUDA tensors, got {dev}")
        if xs.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"rk4_stage_jac kernel takes float32/float64, got {xs.dtype}")
        for name, a in (("us", us), ("pxs", pxs), ("t", t), ("h", h), ("d", d)):
            if a.device != dev or a.dtype != xs.dtype:
                raise ValueError(f"{name} must be {xs.dtype} on {dev}, got "
                                 f"{a.dtype} on {a.device}")
        if xs.dim() != 3 or us.dim() != 3 or pxs.dim() != 3:
            raise ValueError("xs, us, pxs must be (B, N, dim)")
        Bsz, N, nx = xs.shape
        nu, npx = us.shape[-1], pxs.shape[-1]
        if us.shape[:2] != (Bsz, N) or pxs.shape[:2] != (Bsz, N):
            raise ValueError(f"us {tuple(us.shape)} / pxs {tuple(pxs.shape)} "
                             f"do not match xs {tuple(xs.shape)}")
        if t.shape != (Bsz,) or h.shape != (Bsz,) or d.dim() != 2 or d.shape[0] != Bsz:
            raise ValueError("t, h must be (B,) and d (B, nd)")
        nd = d.shape[1]
        L = Bsz * N
        dummy = torch.zeros(1, dtype=xs.dtype, device=dev)
        return dict(
            xT=xs.reshape(L, nx).t().contiguous(),
            uT=us.reshape(L, nu).t().contiguous(),
            pxT=pxs.reshape(L, npx).t().contiguous() if npx else dummy,
            t=t.contiguous(), h=h.contiguous(),
            dT=d.t().contiguous() if nd else dummy,
            dims=(Bsz, N, nx, nu, nd, npx))

    def launch_planes(self, planes):
        """Launch the kernel on packed planes; returns (xf (nx, L),
        jac (nx * nz, L)).  Counts one launch."""
        global LAUNCHES
        from mpc_code_tpu_torch.ops.cuda_build import check_launch, stream_ptr

        Bsz, N, nx, nu, nd, npx = planes["dims"]
        ins = [planes[k] for k in ("xT", "uT", "pxT", "t", "h", "dT")]
        dev, dtype = ins[0].device, ins[0].dtype
        if not all(a.is_contiguous() and a.device == dev and a.dtype == dtype
                   for a in ins):
            raise ValueError("kernel planes must be contiguous, on one device, "
                             "of one dtype")
        L = Bsz * N
        xf = torch.empty((nx, L), dtype=dtype, device=dev)
        jac = torch.empty((nx * (nx + nu), L), dtype=dtype, device=dev)
        lib = self.build(nx, nu, nd, npx).lib
        fn = lib.rk4_stage_jac_f32 if dtype == torch.float32 else lib.rk4_stage_jac_f64
        with torch.cuda.device(dev):
            rc = fn(*[a.data_ptr() for a in ins], xf.data_ptr(), jac.data_ptr(),
                    L, N, Bsz, stream_ptr(dev))
        check_launch(rc, "rk4_stage_jac")
        LAUNCHES += 1
        return xf, jac

    def launch(self, xs, us, pxs, t, h, d):
        planes = self.pack(xs, us, pxs, t, h, d)
        Bsz, N, nx, nu, _, _ = planes["dims"]
        xf, jac = self.launch_planes(planes)
        J = jac.t().reshape(Bsz, N, nx, nx + nu)
        return xf.t().reshape(Bsz, N, nx), J[..., :nx], J[..., nx:]
