"""Lower a traced torch function to scalar C++ statements for the CUDA sweeps.

The TPU sweep kernels run any user model because Pallas traces it.  The
port keeps that property with this code generator: ``Program`` traces a
torch function with ``torch.fx.symbolic_trace`` and lowers every node to
per-component scalar statements, which the sweep kernels instantiate with
forward-mode dual numbers (``csrc/dual.cuh``, ``csrc/dual2.cuh``).

What it lowers: integer indexing and slices of inputs and intermediates,
whole-vector use of an input, elementwise ``+ - * /``, negation, the
elementary functions of ``FUNCTIONS`` (``exp``, ``log``, ``sqrt``,
``tanh``, ``sigmoid``, ``sin``, ``cos``, ``tan``, ``asin``, ``acos``,
``atan``, ``sinh``, ``cosh``, ``log1p``, ``expm1``, ``rsqrt``, ``erf``, as
``torch.f(x)`` or ``x.f()``, with the ``arc*`` and ``special.expit``
names), ``square`` (as ``a * a``), ``reciprocal`` (as ``1 / a``), ``sign``
(a value without tangents: JAX's derivative is 0), ``atan2`` (JAX's
derivative, nan at the origin), ``pow`` and ``**`` with a scalar, a
traced or a tangent-carrying exponent and a scalar or traced base (JAX's
rules: ``b a^(b-1)`` and ``log(a) a^b``, with ``log`` of a zero base
taken as 0), ``maximum``/``minimum``, ``clamp``/``clip`` with bounds that
are scalars, constants or traced values, passed by position or as
``min=``/``max=`` (as ``minimum(maximum(x, lo), hi)``, ``jnp.clip``: half
the tangent to each side at a tie, where ``torch.clamp`` passes all of
it), ``abs`` (as ``where(a >= 0, a, -a)``: JAX's derivative, +1 at 0,
where ``torch.abs`` has 0), comparisons, ``where``, ``stack`` and ``cat``
over dim 0, ``@`` (a captured constant matrix or vector times a vector, a
matrix input times a vector, or a dot product of two vectors, written as
literal multiply-adds), ``.sum()`` of a vector (left to right),
``.reshape(-1)`` and ``torch.atleast_1d`` (a scalar becomes a vector of
one component) and ``.to(...)`` (the cast of a captured constant).  Any
other op raises ``NotImplementedError`` naming it; so does a keyword
argument to any op but ``clamp``/``clip``, ``stack`` and ``cat``.
Literal operands are folded in double precision.  The statements are the
ones the compiler would keep: ``a * 1``, ``a / 1``, ``a - 0`` and ``a +
0`` (exact but for the sign of a zero) are
folded, ``a * 0`` only when ``a`` is a literal too (``inf * 0`` and
``nan * 0`` are ``nan``, as in torch and JAX), a statement that repeats
an earlier one reuses its value, and statements no output needs are
dropped.

The statements are also valid Python: ``Program.execute`` runs them on
torch tensors, each ``mpc_*`` function with JAX's derivative, so the CPU
tests hold the lowering against the function it came from, and against
JAX, derivatives included, without a CUDA compiler.

``Program.ops`` counts the arithmetic of those statements per evaluation
on values that carry ``nz`` tangents (``order=1``) or also the
nz(nz+1)/2 second-order tangents (``order=2``): the bound of a sweep
kernel comes from it.  An elementary function's value counts as one
operation, as a division does, whatever its libm routine costs, so the
bound stays a lower bound; its derivative rule counts its multiplies and
adds (``FUNCTIONS``).  ``Program.reads`` names the inputs the kept
statements read.
"""

from __future__ import annotations

import functools
import math
import operator
import re
import threading
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mpc_code_tpu_torch.ops import jax_rules

_BIN = {operator.add: "+", operator.sub: "-", operator.mul: "*",
        operator.truediv: "/", torch.add: "+", torch.sub: "-",
        torch.mul: "*", torch.div: "/", torch.true_divide: "/"}
_CMP = {operator.lt: "<", operator.le: "<=", operator.gt: ">",
        operator.ge: ">=", operator.eq: "==", operator.ne: "!=",
        torch.lt: "<", torch.le: "<=", torch.gt: ">", torch.ge: ">=",
        torch.eq: "==", torch.ne: "!="}
# The elementary functions: name -> (its value on a double, the operations
# that form f' from the value and the argument, those that form f'' from
# them).  Each lowers to ``mpc_<name>`` (csrc/dual.cuh, csrc/dual2.cuh; in
# Python ``Program.execute``'s scope).
FUNCTIONS = {
    "exp": (np.exp, 0, 0), "log": (np.log, 1, 1), "sqrt": (np.sqrt, 1, 1),
    "tanh": (np.tanh, 2, 2),                              # 1 - t^2; -2 t f'
    "sigmoid": (lambda a: 1.0 / (1.0 + np.exp(-a)), 2, 3),  # s (1 - s); f' (1 - 2 s)
    "sin": (np.sin, 1, 1), "cos": (np.cos, 1, 1),       # cos, -sin; -f
    "tan": (np.tan, 2, 2),                                # 1 + t^2; 2 t f'
    "asin": (np.arcsin, 3, 3), "acos": (np.arccos, 3, 3),  # +-(1 - a^2)^-1/2; a f'^3
    "atan": (np.arctan, 3, 3),                            # 1 / (1 + a^2); -2 a f'^2
    "sinh": (np.sinh, 1, 0), "cosh": (np.cosh, 1, 0),   # cosh, sinh; f
    "log1p": (np.log1p, 2, 1),                            # 1 / (1 + a); -f'^2
    "expm1": (np.expm1, 1, 0),                            # f + 1; f'
    "rsqrt": (lambda a: 1.0 / np.sqrt(a), 2, 2),          # -f / 2a; -3 f' / 2a
    "erf": (math.erf, 3, 2),                              # 2/sqrt(pi) e^-a^2; -2 a f'
}
_ALIASES = {"arcsin": "asin", "arccos": "acos", "arctan": "atan", "expit": "sigmoid"}
_UNARY = {getattr(torch, f): f"mpc_{f}" for f in FUNCTIONS}
_UNARY.update({torch.arcsin: "mpc_asin", torch.arccos: "mpc_acos",
               torch.arctan: "mpc_atan", torch.special.expit: "mpc_sigmoid",
               torch.special.erf: "mpc_erf", operator.neg: "-", torch.neg: "-"})
_METHODS = {f: f"mpc_{f}" for f in FUNCTIONS}
_METHODS.update({a: f"mpc_{f}" for a, f in _ALIASES.items()}, neg="-", __neg__="-")
_MAXMIN = {torch.maximum: "mpc_max", torch.minimum: "mpc_min"}
_POW = {operator.pow, torch.pow}
_ATAN2 = {torch.atan2, torch.arctan2}
_CLAMP = {torch.clamp, torch.clip}
_MATMUL = {operator.matmul, torch.matmul}
# torch.fx tracing patches module globals and is not thread-safe; kernels
# are built from several threads at once
_TRACE_LOCK = threading.Lock()
SUPPORTED = ("getitem (int or slice), add, sub, mul, truediv, neg, "
             + ", ".join(FUNCTIONS) + " (and arcsin, arccos, arctan, special.expit, "
             "special.erf), square, reciprocal, sign, atan2, pow and ** (scalar, "
             "traced or dual exponent), maximum, minimum, clamp/clip (min=, max=), "
             "abs, comparisons, where, stack and cat over dim 0, matmul with a "
             "constant, of a matrix input by a vector or a dot product, sum of a "
             "vector, reshape(-1), atleast_1d, .to()")


def _fold(fn, *a) -> float:
    """A literal operation in double precision, IEEE's inf and nan included."""
    with np.errstate(all="ignore"):
        return float(fn(*(np.float64(x) for x in a)))


def _sign_value(a):
    """JAX's sign of a double: +-0 and nan kept."""
    return a if a == 0 or a != a else math.copysign(1.0, a)


class Arg(NamedTuple):
    """One positional argument of the traced function: ``kind`` is 'dual'
    (a vector that carries tangents), 'vec' (a vector without tangents),
    'scalar' (a scalar without tangents) or 'mat' (a matrix without
    tangents, ``dim`` = (rows, cols), stored row-major: entry (i, j) is
    ``name[i * cols + j]``; only ``name @ vector`` is lowered)."""
    name: str
    kind: str
    dim: int | tuple | None = None   # None: unknown, only indexed use is lowered


class Scalar(NamedTuple):
    """A scalar value of the program: a C++/Python expression (a variable
    name or an input component) and whether it carries tangents."""
    expr: str
    dual: bool


class _Input(NamedTuple):
    name: str
    dim: int
    dual: bool


class _Mat(NamedTuple):
    name: str
    rows: int
    cols: int


def _op_name(node) -> str:
    t = node.target
    return t if isinstance(t, str) else getattr(t, "__name__", repr(t))


def lit(c) -> str:
    c = float(c)
    if math.isnan(c):
        return "S(NAN)"
    if math.isinf(c):
        return "S(INFINITY)" if c > 0 else "S(-INFINITY)"
    return f"S({c!r})"


def _is_num(a) -> bool:
    return isinstance(a, (int, float)) and not isinstance(a, bool)


_VAR = re.compile(r"\bv_\w+")


class _Stmt(NamedTuple):
    name: str
    expr: str
    ops: int


class Program:
    """``f`` traced and lowered to scalar statements (``lines``) that write
    ``out[i]`` for a vector result of ``out_dim`` components, or ``out[0]``
    for a scalar result (``out_dim=None``)."""

    def __init__(self, f: Callable, args: Sequence[Arg], nz: int,
                 out_dim: int | None, order: int = 1, what: str = "function"):
        self.args = tuple(args)
        self.nz = nz
        self.np2 = nz * (nz + 1) // 2 if order == 2 else 0
        self.what = what
        self._stmts: list[_Stmt] = []
        self._seen: dict[str, Scalar] = {}     # expression -> its statement
        with _TRACE_LOCK:
            gm = torch.fx.symbolic_trace(f)
        gm.graph.eliminate_dead_code()   # e.g. a steady-state output f_obj ignores
        env = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(self.args):
            raise NotImplementedError(
                f"the {what} must take exactly {tuple(a.name for a in self.args)}, "
                f"got {[n.name for n in placeholders]}")
        for n, a in zip(placeholders, self.args):
            if a.kind == "mat":
                env[n] = _Mat(a.name, *a.dim)
            elif a.kind == "scalar":
                env[n] = Scalar(a.name, False)
            else:
                env[n] = _Input(a.name, a.dim, a.kind == "dual")
        result = None
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "output":
                result = self._value(env, n.args[0])
                continue
            env[n] = self._lower(gm, env, n)
        self._write_out(result, out_dim)
        self.body = "\n".join(self.lines)

    # ----- values --------------------------------------------------------
    def _value(self, env, a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if _is_num(a):
            return float(a)
        if isinstance(a, (list, tuple)):
            return [self._scalar(self._value(env, x)) for x in a]
        raise NotImplementedError(f"unsupported operand {a!r} in the {self.what}")

    @staticmethod
    def _vec(v):
        """The value as a list of scalars, or the value itself if scalar."""
        if isinstance(v, _Mat):
            raise NotImplementedError(
                f"matrix input {v.name!r} used otherwise than as {v.name} @ vector")
        if isinstance(v, _Input):
            if v.dim is None:
                raise NotImplementedError(
                    f"whole-vector use of input {v.name!r} of unknown length")
            return [Scalar(f"{v.name}[{i}]", v.dual) for i in range(v.dim)]
        if isinstance(v, np.ndarray):
            if v.ndim == 0:
                return float(v)
            if v.ndim != 1:
                raise NotImplementedError(
                    f"a constant of shape {v.shape} used elementwise")
            return [float(c) for c in v]
        return v

    def _scalar(self, v):
        v = self._vec(v)
        if isinstance(v, list):
            raise NotImplementedError(
                f"a vector where the {self.what} needs a scalar")
        return v

    def _emit(self, name, expr, dual, ops=0):
        """A statement ``name = expr`` of ``ops`` operations, or the value
        of an earlier statement with the same expression."""
        if expr not in self._seen:
            self._stmts.append(_Stmt(name, expr, ops))
            self._seen[expr] = Scalar(name, dual)
        return self._seen[expr]

    @staticmethod
    def _x(a) -> str:
        return lit(a) if _is_num(a) else a.expr

    # ----- scalar ops and their operation counts -------------------------
    def _bin(self, name, sym, a, b):
        if _is_num(a) and _is_num(b):
            return float({"+": operator.add, "-": operator.sub,
                          "*": operator.mul, "/": operator.truediv}[sym](a, b))
        # identities exact for every input, folded as the compiler folds
        # them; a * 0 is not one (inf * 0 and nan * 0 are nan)
        if sym == "*" and (a == 1.0 or b == 1.0):
            return b if a == 1.0 else a
        if (sym == "/" and b == 1.0) or (sym in "+-" and b == 0.0):
            return a
        if sym == "+" and a == 0.0:
            return b
        da = not _is_num(a) and a.dual
        db = not _is_num(b) and b.dual
        nz, np2 = self.nz, self.np2
        # the operations the function needs: tangents of a dual plus or
        # minus a non-dual are copied (or negated, folded into the
        # consumer); 1/b is one operation
        if sym in "+-":
            ops = 1 + (nz + np2) * (da and db)
        elif sym == "*":
            ops = 1 + (3 * nz + 7 * np2 if da and db else (nz + np2) * (da or db))
        elif da and db:                  # (da - q db) / b
            ops = 2 + 3 * nz + 7 * np2
        elif db:                         # -(q / b) db
            ops = 2 + nz + 5 * np2
        else:
            ops = 1 + (nz + np2) * da
        return self._emit(name, f"({self._x(a)} {sym} {self._x(b)})", da or db, ops)

    def _unary(self, name, fn, a):
        if fn == "-":
            if _is_num(a):
                return -float(a)
            return self._emit(name, f"(-{a.expr})", a.dual, 1)
        f0, k1, k2 = FUNCTIONS[fn.removeprefix("mpc_")]
        if _is_num(a):
            return _fold(f0, a)
        ops = 1
        if a.dual:                       # value, f'(a), nz products
            ops = 1 + k1 + self.nz + (k2 + 4 * self.np2 if self.np2 else 0)
        return self._emit(name, f"{fn}({a.expr})", a.dual, ops)

    def _pow(self, name, a, c):
        """a ** c for an exponent without tangents (a literal or a traced
        value)."""
        if _is_num(a) and _is_num(c):
            return _fold(np.power, a, c)
        if _is_num(a):                   # a literal base, a traced exponent
            return self._emit(name, f"mpc_pow({lit(a)}, {c.expr})", False, 1)
        ops = 1 + ((2 + self.nz + (2 + 4 * self.np2 if self.np2 else 0))
                   if a.dual else 0)
        return self._emit(name, f"mpc_pow({a.expr}, {self._x(c)})", a.dual, ops)

    def _pow2(self, name, a, b):
        """a ** b, the exponent carrying tangents: f_a = b a^(b-1), f_b =
        log(a) a^b with log(0) taken as 0 (JAX's rules), and their
        derivatives."""
        if not b.dual:
            return self._pow(name, a, b)
        nz, np2 = self.nz, self.np2
        if _is_num(a) or not a.dual:     # log a, f_b, nz products; f_bb
            ops = 4 + nz + (1 + 4 * np2 if np2 else 0)
        else:                            # a^(b-1), f_a, log a, f_b; the two
            ops = 7 + 3 * nz + (9 + 14 * np2 if np2 else 0)   # tangent rules
        return self._emit(name, f"mpc_pow({self._x(a)}, {b.expr})", True, ops)

    def _atan2(self, name, y, x):
        """atan2(y, x): f_y = x / (x^2 + y^2), f_x = -y / (x^2 + y^2) (nan
        at the origin, as JAX's) and their derivatives."""
        if _is_num(y) and _is_num(x):
            return _fold(np.arctan2, y, x)
        dy = not _is_num(y) and y.dual
        dx = not _is_num(x) and x.dual
        nz, np2 = self.nz, self.np2
        if dy and dx:                    # x^2 + y^2, its reciprocal, f_y, f_x
            ops = 7 + 3 * nz + (6 + 14 * np2 if np2 else 0)
        elif dy or dx:
            ops = 6 + nz + (2 + 4 * np2 if np2 else 0)
        else:
            ops = 1
        return self._emit(name, f"mpc_atan2({self._x(y)}, {self._x(x)})", dy or dx, ops)

    def _sign(self, name, a):
        """sign(a): its derivative is 0, so its value carries no tangents."""
        if _is_num(a):
            return _sign_value(float(a))
        return self._emit(name, f"mpc_sign({a.expr})", False, 1)

    def _select(self, name, expr, dual):
        # compare, select
        return self._emit(name, expr, dual, 1 + ((self.nz + self.np2) if dual else 0))

    def _maxmin(self, name, fn, a, b):
        if _is_num(a) and _is_num(b):
            return _fold(np.maximum if fn == "mpc_max" else np.minimum, a, b)
        return self._select(name, f"{fn}({self._x(a)}, {self._x(b)})",
                            not _is_num(a) and a.dual or not _is_num(b) and b.dual)

    def _clamp(self, name, a, lo, hi):
        """jnp.clip: minimum(maximum(a, lo), hi)."""
        if lo is not None:
            a = self._maxmin(f"{name}__lo", "mpc_max", a, lo)
        if hi is not None:
            a = self._maxmin(f"{name}__hi", "mpc_min", a, hi)
        return a

    def _abs(self, name, a):
        if _is_num(a):
            return abs(float(a))
        ge = self._emit(f"{name}__ge", f"(mpc_val({a.expr}) >= S(0.0))", False, 1)
        neg = self._unary(f"{name}__neg", "-", a)
        return self._select(name, f"mpc_where({ge.expr}, {a.expr}, {neg.expr})", a.dual)

    # ----- elementwise over vectors -------------------------------------
    def _map(self, name, fn, *vals):
        vals = [self._vec(v) for v in vals]
        lens = {len(v) for v in vals if isinstance(v, list)}
        if len(lens) > 1:
            raise NotImplementedError(f"vectors of lengths {sorted(lens)} "
                                      f"combined elementwise in {name}")
        if not lens:
            return fn(name, *vals)
        n = lens.pop()
        return [fn(f"{name}__{i}", *[v[i] if isinstance(v, list) else v
                                    for v in vals]) for i in range(n)]

    def _dot(self, name, a, b):
        """sum_i a_i b_i, left to right, one statement per operation."""
        acc = 0.0
        for k, (x, y) in enumerate(zip(a, b)):
            acc = self._bin(f"{name}__s{k}", "+", acc,
                            self._bin(f"{name}__m{k}", "*", x, y))
        return acc

    def _matmul(self, name, a, b):
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return a @ b
        if isinstance(a, _Mat):
            bv = self._vec(b)
            if not isinstance(bv, list) or len(bv) != a.cols:
                raise NotImplementedError(f"matmul of the ({a.rows}, {a.cols}) "
                                          f"input {a.name!r} with a value of "
                                          "another length")
            return [self._dot(f"{name}__{i}",
                              [Scalar(f"{a.name}[{i * a.cols + j}]", False)
                               for j in range(a.cols)], bv)
                    for i in range(a.rows)]
        if isinstance(a, np.ndarray) and a.ndim == 2:
            bv = self._vec(b)
            if not isinstance(bv, list) or len(bv) != a.shape[1]:
                raise NotImplementedError(f"matmul of a {a.shape} constant with "
                                          "a value of another length")
            return [self._dot(f"{name}__{i}", [float(c) for c in a[i]], bv)
                    for i in range(a.shape[0])]
        if isinstance(b, np.ndarray) and b.ndim == 2:
            av = self._vec(a)
            if not isinstance(av, list) or len(av) != b.shape[0]:
                raise NotImplementedError(f"matmul of a value with a {b.shape} "
                                          "constant of another length")
            return [self._dot(f"{name}__{j}", av, [float(c) for c in b[:, j]])
                    for j in range(b.shape[1])]
        av, bv = self._vec(a), self._vec(b)
        if not (isinstance(av, list) and isinstance(bv, list) and len(av) == len(bv)):
            raise NotImplementedError("matmul is supported for a constant matrix "
                                      "times a vector or a dot product of two "
                                      "vectors of one length")
        return self._dot(name, av, bv)

    # ----- one fx node -----------------------------------------------------
    def _lower(self, gm, env, n):
        name = "v_" + n.name
        tgt = n.target
        call = n.op == "call_function"
        meth = n.op == "call_method"
        if n.op == "get_attr":
            c = functools.reduce(getattr, tgt.split("."), gm)
            return np.asarray(torch.as_tensor(c).detach().cpu().double().numpy())
        if meth and tgt == "to":
            return self._value(env, n.args[0])
        if call and tgt is torch.stack:
            dim = n.kwargs.get("dim", n.args[1] if len(n.args) > 1 else 0)
            if dim != 0 or set(n.kwargs) - {"dim"}:
                raise NotImplementedError("torch.stack is supported only over dim 0")
            return self._value(env, list(n.args[0]))
        if call and tgt is torch.cat:
            dim = n.kwargs.get("dim", n.args[1] if len(n.args) > 1 else 0)
            if dim != 0 or set(n.kwargs) - {"dim"}:
                raise NotImplementedError("torch.cat is supported only over dim 0")
            parts = [self._vec(self._value(env, a)) for a in n.args[0]]
            if not all(isinstance(v, list) for v in parts):
                raise NotImplementedError("torch.cat of a scalar")
            return [c for v in parts for c in v]
        if (call and tgt in _CLAMP) or (meth and tgt in ("clamp", "clip")):
            if set(n.kwargs) - {"min", "max"} or len(n.args) > 3:
                raise NotImplementedError(f"{_op_name(n)} is supported with the input "
                                          "and the bounds min, max only")
            pos = list(n.args[1:]) + [None] * (3 - len(n.args))
            lo, hi = n.kwargs.get("min", pos[0]), n.kwargs.get("max", pos[1])
            vals = [None if v is None else self._value(env, v) for v in (n.args[0], lo, hi)]
            return self._map(name, self._clamp, *vals)
        if n.kwargs:
            raise NotImplementedError(
                f"op {_op_name(n)!r} with keyword arguments {dict(n.kwargs)}")
        if (meth and tgt == "sum") or (call and tgt is torch.sum):
            if len(n.args) != 1:
                raise NotImplementedError("sum is supported only over a whole vector")
            v = self._vec(self._value(env, n.args[0]))
            if not isinstance(v, list):
                return v
            acc = 0.0
            for k, c in enumerate(v):
                acc = self._bin(f"{name}__s{k}", "+", acc, c)
            return acc
        if (meth and tgt == "reshape") or (call and tgt is torch.atleast_1d):
            shape = n.args[1:] if meth else (-1,)
            if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                shape = tuple(shape[0])
            if tuple(shape) != (-1,) or (call and len(n.args) != 1):
                raise NotImplementedError(
                    "reshape is supported only as reshape(-1), atleast_1d of one value")
            v = self._vec(self._value(env, n.args[0]))
            return v if isinstance(v, list) else [v]
        if call and tgt is operator.getitem:
            base, idx = self._value(env, n.args[0]), n.args[1]
            if isinstance(base, _Input) and isinstance(idx, int):
                if base.dim is not None:
                    if not -base.dim <= idx < base.dim:
                        raise NotImplementedError(
                            f"index {idx} out of range for input {base.name!r} "
                            f"({base.dim})")
                    idx %= base.dim
                return self._emit(name, f"{base.name}[{idx}]", base.dual)
            if not isinstance(idx, (int, slice)):
                raise NotImplementedError(
                    "getitem is supported only with an integer or a slice")
            v = base if isinstance(base, np.ndarray) else self._vec(base)
            if not isinstance(v, (list, np.ndarray)):
                raise NotImplementedError("getitem on a scalar")
            return v[idx]
        args = [self._value(env, a) for a in n.args]
        if call and tgt in _BIN:
            sym = _BIN[tgt]
            return self._map(name, lambda nm, x, y: self._bin(nm, sym, x, y), *args)
        if (call and tgt in _UNARY) or (meth and tgt in _METHODS):
            fn = _UNARY[tgt] if call else _METHODS[tgt]
            return self._map(name, lambda nm, x: self._unary(nm, fn, x), args[0])
        if (call and tgt in (torch.abs, operator.abs)) or (meth and tgt == "abs"):
            return self._map(name, self._abs, args[0])
        if (call and tgt is torch.sign) or (meth and tgt == "sign"):
            return self._map(name, self._sign, args[0])
        if (call and tgt is torch.square) or (meth and tgt == "square"):
            return self._map(name, lambda nm, x: self._bin(nm, "*", x, x), args[0])
        if (call and tgt is torch.reciprocal) or (meth and tgt == "reciprocal"):
            return self._map(name, lambda nm, x: self._bin(nm, "/", 1.0, x), args[0])
        if (call and tgt in _ATAN2) or (meth and tgt in ("atan2", "arctan2")):
            return self._map(name, self._atan2, *args)
        if (call and tgt in _POW) or (meth and tgt == "pow"):
            return self._map(name, lambda nm, a, b: (self._pow(nm, a, b) if _is_num(b)
                                                     else self._pow2(nm, a, b)), *args)
        if call and tgt in _MAXMIN:
            fn = _MAXMIN[tgt]
            return self._map(name, lambda nm, x, y: self._maxmin(nm, fn, x, y), *args)
        if call and tgt in _CMP:
            sym = _CMP[tgt]

            def cmp(nm, x, y):
                return self._emit(nm, f"(mpc_val({self._x(x)}) {sym} "
                                  f"mpc_val({self._x(y)}))", False, 1)
            return self._map(name, cmp, *args)
        if call and tgt is torch.where:
            return self._map(
                name, lambda nm, c, x, y: self._select(
                    nm, f"mpc_where({c.expr}, {self._x(x)}, {self._x(y)})",
                    not _is_num(x) and x.dual or not _is_num(y) and y.dual),
                *args)
        if (call and tgt in _MATMUL) or (meth and tgt in ("matmul", "__matmul__")):
            return self._matmul(name, *args)
        raise NotImplementedError(
            f"op {_op_name(n)!r} ({n.op}) is not supported by the CUDA "
            f"sweep's code generator; supported: {SUPPORTED}")

    def _write_out(self, result, out_dim):
        if out_dim is None:
            val = self._vec(result) if result is not None else None
            if not (_is_num(val) or isinstance(val, Scalar)):
                raise NotImplementedError(f"the {self.what} must return a scalar")
            items = [val]
        else:
            items = self._vec(result) if result is not None else None
            if not isinstance(items, list) or len(items) != out_dim:
                raise NotImplementedError(
                    f"the {self.what} must return {out_dim} stacked components")
        self.out = [self._x(self._scalar(it)) for it in items]
        # keep the statements an output needs, as the compiler does
        live = set(_VAR.findall(" ".join(self.out)))
        keep = []
        for st in reversed(self._stmts):
            if st.name in live:
                keep.append(st)
                live.update(_VAR.findall(st.expr))
        keep.reverse()
        self.ops = sum(st.ops for st in keep)
        # the inputs the kept statements and the outputs read
        text = " ".join([st.expr for st in keep] + self.out)
        self.reads = frozenset(a.name for a in self.args
                               if re.search(rf"(?<![\w.]){re.escape(a.name)}\b", text))
        self.lines = [f"  auto {st.name} = {st.expr};" for st in keep]
        self.lines += [f"  out[{i}] = {e};" for i, e in enumerate(self.out)]

    # ----- run the statements in Python ------------------------------------
    def execute(self, **inputs):
        """Run the lowered statements on torch tensors: each named input is
        a tensor (a vector input indexed along its first dimension, a
        matrix input flattened row-major along it).
        Returns the list of output components.  Used by the CPU tests.
        Each function takes JAX's derivative (``ops/jax_rules.py``)."""
        def val(a):
            return a if torch.is_tensor(a) else torch.tensor(a, dtype=torch.float64)

        def where(c, a, b):
            return torch.where(c, val(a), val(b))

        def sign(a):                     # JAX's value at 0 and nan, derivative 0
            return torch.where(a > 0, 1.0, torch.where(a < 0, -1.0, a)).detach()

        scope = dict(
            S=float, NAN=math.nan, INFINITY=math.inf,
            mpc_pow=jax_rules.power, mpc_val=lambda a: a, mpc_where=where,
            mpc_max=lambda a, b: torch.maximum(val(a), val(b)),
            mpc_min=lambda a, b: torch.minimum(val(a), val(b)),
            mpc_sign=sign, mpc_atan2=jax_rules.atan2,
            **{f"mpc_{f}": getattr(torch, f) for f in FUNCTIONS})
        scope.update(inputs)
        scope["out"] = [None] * len(self.out)
        for line in self.lines:
            exec(line.strip().removeprefix("auto ").rstrip(";"), scope)
        return scope["out"]
