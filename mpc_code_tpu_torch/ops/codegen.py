"""Lower a traced torch function to scalar C++ statements for the CUDA sweeps.

The TPU sweep kernels run any user model because Pallas traces it.  The
port keeps that property with this code generator: ``Program`` traces a
torch function with ``torch.fx.symbolic_trace`` and lowers every node to
per-component scalar statements, which the sweep kernels instantiate with
forward-mode dual numbers (``csrc/dual.cuh``, ``csrc/dual2.cuh``).

A value of the program is a scalar, a vector or a matrix (rows of
scalars) of literals and traced scalars; a value of more than 2 dims is
refused.  What it lowers (``SUPPORTED``):

- shapes: ``stack`` over dim 0 or 1 (``dim=`` by position or keyword;
  scalars stack to a vector, vectors to the rows or the columns of a
  matrix), ``cat``/``concatenate`` over dim 0 or 1, ``.T``, ``.mT``,
  ``transpose(0, 1)``, ``t()``, ``reshape`` (``(-1)``, or a vector to
  ``(r, c)``), ``flatten``, ``atleast_1d``, ``ones_like``/``zeros_like``/
  ``full_like`` (literals), ``.to(...)`` (the cast of a captured constant);
- indexing by constants: an integer, a slice, a pair of them (``A[i, j]``,
  ``A[:, j]``), a list or a constant integer tensor (a gather of
  components) and a constant boolean mask; an index that depends on
  traced values is refused;
- elementwise, with broadcasting: ``+ - * /``, negation, the elementary
  functions of ``FUNCTIONS`` (``exp``, ``log``, ``sqrt``, ``tanh``,
  ``sigmoid``, ``sin``, ``cos``, ``tan``, ``asin``, ``acos``, ``atan``,
  ``sinh``, ``cosh``, ``asinh``, ``acosh``, ``atanh``, ``log1p``,
  ``expm1``, ``log2``, ``log10``, ``exp2``, ``rsqrt``, ``erf``, ``erfc``,
  ``erfinv``, as ``torch.f(x)`` or ``x.f()``, with the ``arc*`` and
  ``special.*`` names), ``square`` (as ``a * a``), ``reciprocal`` (as ``1 /
  a``), ``sign``, ``floor`` and ``round`` (half to even) (values without
  tangents: JAX's derivative is 0), ``atan2`` (JAX's derivative, nan at the
  origin), ``pow`` and ``**`` with a scalar, a traced or a tangent-carrying
  exponent and a scalar or traced base (JAX's rules: ``b a^(b-1)`` and
  ``log(a) a^b``, with ``log`` of a zero base taken as 0),
  ``maximum``/``minimum`` (and ``max``/``min`` of two tensors),
  ``clamp``/``clip`` with bounds that are scalars, constants or traced
  values, passed by position or as ``min=``/``max=`` (as
  ``minimum(maximum(x, lo), hi)``, ``jnp.clip``: half the tangent to each
  side at a tie, where ``torch.clamp`` passes all of it), ``abs`` (as
  ``where(a >= 0, a, -a)``: JAX's derivative, +1 at 0, where ``torch.abs``
  has 0), ``hypot`` (as ``jnp.hypot``'s composition of abs, max, min,
  where and sqrt, so its derivative at the origin and at ties is JAX's),
  ``fmod`` (C's: the sign of the dividend; d/db = -trunc(a/b), as JAX's
  ``rem``) and ``remainder`` (the divisor's sign, as ``jnp.remainder``'s
  select), comparisons, ``where``;
- products: ``@``/``matmul``/``mv``/``mm``/``dot`` of vectors and
  matrices in every pairing of traced values, inputs and constants, written
  as literal multiply-adds, ``outer``, ``cross``/``linalg.cross`` of
  3-vectors;
- reductions over a whole vector or matrix or over one ``dim`` (by
  position or keyword, ``keepdim=False``): ``sum`` (left to right),
  ``prod``, ``mean``, ``max``/``min``/``amax``/``amin`` (the value only;
  JAX's derivative: the tangent split equally among the entries equal to
  the value), ``cumsum``, and the 2-norm ``norm``/``linalg.norm``/
  ``linalg.vector_norm`` (as ``sqrt(sum(x * x))``, nan derivative at 0, as
  JAX's); any other order is refused;
- ``linalg.solve(A, b)`` (b a vector or a matrix), ``linalg.inv`` and
  ``inverse`` of an n x n matrix, n <= 6: LU with partial pivoting, the
  pivot the first largest |a| of its column chosen on the values as
  LAPACK's ``getrf`` chooses it, then the two triangular solves in
  LAPACK's ``trsm`` order, written out as scalar statements.

Any other op raises ``NotImplementedError`` naming it (``REFUSED`` gives the
reason for the ops that stay refused on purpose); so does a keyword argument
an op does not take.  Literal operands are folded in double precision.  The
statements are the ones the compiler would keep: ``a * 1``, ``a / 1``, ``a
- 0`` and ``a + 0`` (exact but for the sign of a zero) are folded, ``a * 0``
only when ``a`` is a literal too (``inf * 0`` and ``nan * 0`` are ``nan``,
as in torch and JAX; the LU skips a literal zero as LAPACK's ``ger`` and
``trsm`` do), a statement that repeats an earlier one reuses its value, and
statements no output needs are dropped.

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
adds (``FUNCTIONS``).  A compare counts one; the pivot search's selects
and absolute values and the max/min reductions' selects count at most one
each, so the LU counts the operations of ``solver/sweep_kernel.py::
_lu_ops`` and ``_solve_ops`` on numbers with tangents.  ``Program.reads``
names the inputs the kept statements read.
"""

from __future__ import annotations

import builtins
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


def _erfinv(a):
    return float(torch.special.erfinv(torch.tensor(float(a), dtype=torch.float64)))


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
    "asinh": (np.arcsinh, 3, 3),                          # (a^2 + 1)^-1/2; -a f'^3
    "acosh": (np.arccosh, 3, 3),                          # (a^2 - 1)^-1/2; -a f'^3
    "atanh": (np.arctanh, 3, 3),                          # 1 / (1 - a^2); 2 a f'^2
    "log1p": (np.log1p, 2, 1),                            # 1 / (1 + a); -f'^2
    "expm1": (np.expm1, 1, 0),                            # f + 1; f'
    "log2": (np.log2, 1, 1), "log10": (np.log10, 1, 1),  # c / a; -f' / a
    "exp2": (np.exp2, 1, 1),                              # ln2 f; ln2 f'
    "rsqrt": (lambda a: 1.0 / np.sqrt(a), 2, 2),          # -f / 2a; -3 f' / 2a
    "erf": (math.erf, 3, 2),                              # 2/sqrt(pi) e^-a^2; -2 a f'
    "erfc": (math.erfc, 3, 2),                            # -2/sqrt(pi) e^-a^2; -2 a f'
    "erfinv": (_erfinv, 3, 3),                            # sqrt(pi)/2 e^f^2; 2 f f'^2
}
_ALIASES = {"arcsin": "asin", "arccos": "acos", "arctan": "atan", "arcsinh": "asinh",
            "arccosh": "acosh", "arctanh": "atanh", "expit": "sigmoid"}
_UNARY = {getattr(torch, f): f"mpc_{f}" for f in FUNCTIONS}
_UNARY.update({getattr(torch, a): f"mpc_{f}" for a, f in _ALIASES.items() if a != "expit"})
_UNARY.update({torch.special.expit: "mpc_sigmoid", torch.special.erf: "mpc_erf",
               torch.special.erfc: "mpc_erfc", torch.special.erfinv: "mpc_erfinv",
               torch.special.exp2: "mpc_exp2", torch.special.expm1: "mpc_expm1",
               torch.special.log1p: "mpc_log1p", operator.neg: "-", torch.neg: "-"})
_METHODS = {f: f"mpc_{f}" for f in FUNCTIONS}
_METHODS.update({a: f"mpc_{f}" for a, f in _ALIASES.items()}, neg="-", __neg__="-")
_MAXMIN = {torch.maximum: "mpc_max", torch.minimum: "mpc_min"}
_POW = {operator.pow, torch.pow}
_ATAN2 = {torch.atan2, torch.arctan2}
_CLAMP = {torch.clamp, torch.clip}
_PRODUCTS = {operator.matmul: "matmul", torch.matmul: "matmul", torch.mv: "matmul",
             torch.mm: "matmul", torch.dot: "matmul", torch.outer: "outer",
             torch.cross: "cross", torch.linalg.cross: "cross"}
_PRODUCT_METHODS = {"matmul": "matmul", "__matmul__": "matmul", "mv": "matmul",
                    "mm": "matmul", "dot": "matmul", "outer": "outer", "cross": "cross"}
_REDUCTIONS = {torch.sum: "sum", torch.prod: "prod", torch.mean: "mean",
               torch.amax: "max", torch.amin: "min", torch.cumsum: "cumsum"}
_REDUCTION_METHODS = {"sum": "sum", "prod": "prod", "mean": "mean", "amax": "max",
                      "amin": "min", "cumsum": "cumsum"}
_NORMS = {torch.norm: "p", torch.linalg.norm: "ord", torch.linalg.vector_norm: "ord"}
_JOINS = (torch.stack, torch.cat, getattr(torch, "concatenate", torch.cat))
_LIKE = {torch.ones_like: 1.0, torch.zeros_like: 0.0, torch.full_like: None}
_SOLVE_MAX = 6               # the largest n of an n x n solve or inverse
# ops refused on purpose, with the reason
REFUSED = {
    "lgamma": "CUDA's libm has no digamma or trigamma for its derivatives",
    "digamma": "CUDA's libm has no digamma or trigamma for its derivatives",
    "polygamma": "CUDA's libm has no polygamma for its derivatives",
    **{f"linalg_{k}": "linear algebra beyond solve and inv is not lowered"
       for k in ("cholesky", "cholesky_ex", "eig", "eigh", "eigvals", "eigvalsh", "svd",
                 "svdvals", "det", "slogdet", "qr", "lstsq", "pinv", "matrix_norm",
                 "matrix_power", "lu", "lu_factor", "matrix_exp")},
    **{k: "linear algebra beyond solve and inv is not lowered"
       for k in ("cholesky", "det", "logdet", "svd", "qr", "pinverse", "matrix_exp")},
}
# torch.fx tracing patches module globals and is not thread-safe; kernels
# are built from several threads at once
_TRACE_LOCK = threading.Lock()
SUPPORTED = (
    "constant indexing (int, slice, A[i, j], A[:, j], a list, a constant integer tensor "
    "or boolean mask), stack and cat/concatenate over dim 0 or 1, .T, .mT, transpose(0, 1), "
    "t(), reshape(-1) or a vector to (r, c), flatten, atleast_1d, ones_like, zeros_like, "
    "full_like, .to(); elementwise with broadcasting: add, sub, mul, truediv, neg, "
    + ", ".join(FUNCTIONS) + " (and arcsin, arccos, arctan, arcsinh, arccosh, arctanh, "
    "special.expit, special.erf, special.erfc, special.erfinv, special.exp2), square, "
    "reciprocal, sign, floor, round, atan2, pow and ** (scalar, traced or dual exponent), "
    "maximum, minimum, max/min of two tensors, clamp/clip (min=, max=), abs, hypot, fmod, "
    "remainder, comparisons, where; matmul/@/mv/mm/dot of vectors and matrices, outer, "
    "cross and linalg.cross of 3-vectors; sum, prod, mean, max, min, amax, amin, cumsum "
    "and the 2-norm (norm, linalg.norm, linalg.vector_norm) over everything or one dim "
    "(keepdim=False); linalg.solve, linalg.inv and inverse of an n x n matrix, n <= 6")


def _fold(fn, *a) -> float:
    """A literal operation in double precision, IEEE's inf and nan included."""
    with np.errstate(all="ignore"):
        return float(fn(*(np.float64(x) for x in a)))


def _sign_value(a):
    """JAX's sign of a double: +-0 and nan kept."""
    return a if a == 0 or a != a else math.copysign(1.0, a)


# functions whose derivative is 0: their values carry no tangents
_FLAT = {"sign": _sign_value, "floor": np.floor, "round": np.round}   # round: half to even


class Arg(NamedTuple):
    """One positional argument of the traced function: ``kind`` is 'dual'
    (a vector that carries tangents), 'vec' (a vector without tangents),
    'scalar' (a scalar without tangents) or 'mat' (a matrix without
    tangents, ``dim`` = (rows, cols), stored row-major: entry (i, j) is
    ``name[i * cols + j]``)."""
    name: str
    kind: str
    dim: int | tuple | None = None   # None: unknown, only indexed use is lowered


class Scalar(NamedTuple):
    """A scalar value of the program: a C++/Python expression (a variable
    name or an input component) and whether it carries tangents."""
    expr: str
    dual: bool


class Matrix:
    """A 2-D value of the program: an object array of literals (floats)
    and ``Scalar``s."""
    __slots__ = ("a",)

    def __init__(self, a: np.ndarray):
        self.a = a


class _Input(NamedTuple):
    name: str
    dim: int
    dual: bool


class _Mat(NamedTuple):
    name: str
    rows: int
    cols: int


class _Chosen(NamedTuple):
    """``torch.max(x, dim)``'s (values, indices): only the values are
    lowered."""
    values: object


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
    return (isinstance(a, (int, float, np.integer, np.floating))
            and not isinstance(a, (bool, np.bool_)))


def _objs(shape, items) -> np.ndarray:
    """An object array of ``shape`` holding ``items`` in row-major order
    (element by element: a ``Scalar`` is a tuple numpy would unpack)."""
    out = np.empty(shape, dtype=object)
    for idx, x in zip(np.ndindex(*shape), items):
        out[idx] = x
    return out


def _same(a, b) -> bool:
    if _is_num(a) and _is_num(b):
        return repr(float(a)) == repr(float(b))
    return isinstance(a, Scalar) and isinstance(b, Scalar) and a.expr == b.expr


def _dual(a) -> bool:
    return isinstance(a, Scalar) and a.dual


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
            vals = [self._vec(self._value(env, x)) for x in a]
            if not any(isinstance(v, (list, Matrix)) for v in vals):
                return vals
            return self._from(np.stack([self._arr(v) for v in vals]))
        raise NotImplementedError(f"unsupported operand {a!r} in the {self.what}")

    def _vec(self, v):
        """The value as a list of scalars, or the value itself if scalar."""
        if isinstance(v, _Mat):
            return self._from(self._arr(v))
        if isinstance(v, _Input):
            if v.dim is None:
                raise NotImplementedError(
                    f"whole-vector use of input {v.name!r} of unknown length")
            return [Scalar(f"{v.name}[{i}]", v.dual) for i in range(v.dim)]
        if isinstance(v, np.ndarray):
            if v.ndim == 0:
                return float(v)
            if v.ndim == 1:
                return [float(c) for c in v]
            return Matrix(_objs(v.shape, [float(c) for c in v.reshape(-1)]))
        if isinstance(v, _Chosen):
            return v.values
        return v

    def _scalar(self, v):
        v = self._vec(v)
        if isinstance(v, (list, Matrix)):
            raise NotImplementedError(
                f"a {'vector' if isinstance(v, list) else 'matrix'} where the "
                f"{self.what} needs a scalar")
        return v

    def _arr(self, v) -> np.ndarray:
        """The value as an object array of 0, 1 or 2 dims."""
        if isinstance(v, Matrix):
            return v.a
        if isinstance(v, _Mat):
            return _objs((v.rows, v.cols), [Scalar(f"{v.name}[{i * v.cols + j}]", False)
                                            for i in range(v.rows) for j in range(v.cols)])
        if isinstance(v, np.ndarray):
            return _objs(v.shape, [float(c) for c in v.reshape(-1)])
        v = self._vec(v)
        if isinstance(v, Matrix):
            return v.a
        if isinstance(v, list):
            return _objs((len(v),), v)
        return _objs((), [v])

    @staticmethod
    def _from(a):
        """An object array (or one of its elements) back as a scalar, a list
        or a ``Matrix``."""
        if not isinstance(a, np.ndarray):
            return a
        if a.ndim == 0:
            return a[()]
        if a.ndim == 1:
            return list(a)
        if a.ndim == 2:
            return Matrix(a)
        raise NotImplementedError(f"a value of shape {a.shape}: values of more than 2 "
                                  "dims are not lowered")

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

    @staticmethod
    def _v(a) -> str:
        """The expression of ``a``'s value (its tangents dropped)."""
        if _is_num(a):
            return lit(a)
        return f"mpc_val({a.expr})" if a.dual else a.expr

    # ----- scalar ops and their operation counts -------------------------
    def _bin(self, name, sym, a, b):
        if _is_num(a) and _is_num(b):
            return _fold({"+": np.add, "-": np.subtract, "*": np.multiply,
                          "/": np.divide}[sym], a, b)
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

    def _flat(self, name, fn, a):
        """sign, floor, round: their derivative is 0, so their values carry
        no tangents."""
        if _is_num(a):
            return float(_FLAT[fn](float(a)))
        return self._emit(name, f"mpc_{fn}({a.expr})", False, 1)

    def _fmod(self, name, a, b):
        """fmod(a, b), C's (JAX's ``rem``): f_a = 1, f_b = -trunc(a / b);
        the second derivatives are 0."""
        if _is_num(a) and _is_num(b):
            return _fold(np.fmod, a, b)
        da, db = _dual(a), _dual(b)
        nz, np2 = self.nz, self.np2
        # the value; the quotient's truncation; a' - q b'
        ops = 1 + ((2 + (2 if da else 1) * (nz + np2)) if db else 0)
        return self._emit(name, f"mpc_fmod({self._x(a)}, {self._x(b)})", da or db, ops)

    def _remainder(self, name, a, b):
        """jnp.remainder: r = fmod(a, b), r + b where r is not 0 and its
        sign is not b's."""
        if _is_num(a) and _is_num(b):
            r = _fold(np.fmod, a, b)
            return r + b if r != 0 and (r < 0) != (b < 0) else r
        r = self._fmod(f"{name}__r", a, b)
        if _is_num(r):
            return r
        nz = self._emit(f"{name}__nz", f"({self._v(r)} != S(0.0))", False, 1)
        flip = self._emit(f"{name}__sg", f"(({self._v(r)} < S(0.0)) != "
                          f"({self._v(b)} < S(0.0)))", False, 1)
        plus = self._bin(f"{name}__p", "+", r, b)
        return self._pick(name, nz, self._pick(f"{name}__f", flip, plus, r), r)

    def _hypot(self, name, a, b):
        """jnp.hypot's composition: |a|, |b|, their max m and min n, m
        sqrt(1 + (n / m)^2) (m where m is 0), inf where either is +inf."""
        if _is_num(a) and _is_num(b):
            return _fold(np.hypot, a, b)
        x1, x2 = self._abs(f"{name}__a", a), self._abs(f"{name}__b", b)
        hi = self._maxmin(f"{name}__hi", "mpc_max", x1, x2)
        lo = self._maxmin(f"{name}__lo", "mpc_min", x1, x2)
        zero = self._cmp(f"{name}__z", "==", hi, 0.0)
        den = self._pick(f"{name}__d", zero, 1.0, hi)
        q = self._bin(f"{name}__q", "/", lo, den)
        s = self._unary(f"{name}__s", "mpc_sqrt",
                        self._bin(f"{name}__w", "+", 1.0, self._bin(f"{name}__qq", "*", q, q)))
        x = self._pick(f"{name}__x", zero, hi, self._bin(f"{name}__m", "*", hi, s))
        x = self._pick(f"{name}__i2", self._cmp(f"{name}__f2", "==", x2, math.inf),
                       math.inf, x)
        return self._pick(name, self._cmp(f"{name}__f1", "==", x1, math.inf), math.inf, x)

    def _cmp(self, name, sym, a, b):
        """A compare of the values: a Python bool for two literals."""
        if _is_num(a) and _is_num(b):
            return bool({"<": operator.lt, "<=": operator.le, ">": operator.gt,
                         ">=": operator.ge, "==": operator.eq, "!=": operator.ne}[sym](a, b))
        return self._emit(name, f"({self._v(a)} {sym} {self._v(b)})", False, 1)

    def _pick(self, name, c, a, b, ops=1):
        """where(c, a, b) as data movement: at most one operation."""
        if isinstance(c, (bool, np.bool_)):
            return a if c else b
        if _same(a, b):
            return a
        return self._emit(name, f"mpc_where({c.expr}, {self._x(a)}, {self._x(b)})",
                          _dual(a) or _dual(b), ops)

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

    def _where(self, name, c, x, y):
        if _is_num(c):
            return x if c else y
        return self._select(name, f"mpc_where({c.expr}, {self._x(x)}, {self._x(y)})",
                            _dual(x) or _dual(y))

    # ----- elementwise over vectors and matrices --------------------------
    def _map(self, name, fn, *vals):
        if any(isinstance(v, (Matrix, _Mat)) or (isinstance(v, np.ndarray) and v.ndim > 1)
               for v in vals):
            arrs = [None if v is None else self._arr(v) for v in vals]
            try:
                shape = np.broadcast_shapes(*[a.shape for a in arrs if a is not None])
            except ValueError:
                raise NotImplementedError(
                    f"values of shapes {[a.shape for a in arrs if a is not None]} "
                    f"combined elementwise in {name}") from None
            arrs = [None if a is None else np.broadcast_to(a, shape) for a in arrs]
            return self._from(_objs(shape, [
                fn(f"{name}__{'_'.join(map(str, idx))}", *[None if a is None else a[idx]
                                                             for a in arrs])
                for idx in np.ndindex(*shape)]))
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

    # ----- products -----------------------------------------------------------
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
        A, B = self._arr(a), self._arr(b)
        if A.ndim == 0 or B.ndim == 0:
            raise NotImplementedError("matmul of a scalar")
        if A.shape[-1] != B.shape[0]:
            raise NotImplementedError(f"matmul of values of shapes {A.shape} and {B.shape}")
        if A.ndim == 1 and B.ndim == 1:
            return self._dot(name, A, B)
        if B.ndim == 1:
            return [self._dot(f"{name}__{i}", A[i], B) for i in range(A.shape[0])]
        if A.ndim == 1:
            return [self._dot(f"{name}__{j}", A, B[:, j]) for j in range(B.shape[1])]
        return Matrix(_objs((A.shape[0], B.shape[1]), [
            self._dot(f"{name}__{i}_{j}", A[i], B[:, j])
            for i in range(A.shape[0]) for j in range(B.shape[1])]))

    def _outer(self, name, a, b):
        A, B = self._arr(a), self._arr(b)
        if A.ndim != 1 or B.ndim != 1:
            raise NotImplementedError("outer of values that are not vectors")
        return Matrix(_objs((len(A), len(B)), [
            self._bin(f"{name}__{i}_{j}", "*", x, y)
            for i, x in enumerate(A) for j, y in enumerate(B)]))

    def _cross(self, name, a, b):
        A, B = self._arr(a), self._arr(b)
        if A.shape != (3,) or B.shape != (3,):
            raise NotImplementedError("cross is lowered for two 3-vectors")

        def term(i, j, k):          # a_j b_k - a_k b_j
            return self._bin(f"{name}__{i}", "-", self._bin(f"{name}__{i}a", "*", A[j], B[k]),
                             self._bin(f"{name}__{i}b", "*", A[k], B[j]))
        return [term(0, 1, 2), term(1, 2, 0), term(2, 0, 1)]

    # ----- linear solves --------------------------------------------------
    def _absv(self, name, a):
        """|a| on the value (no tangents)."""
        if _is_num(a):
            return abs(float(a))
        return self._emit(name, f"mpc_absv({a.expr})", False, 0)

    def _solve(self, name, A, B):
        """A X = B, A (n, n) and B (n, m) object arrays: LU with partial
        pivoting on the augmented rows [A | B], the pivot of column k the
        first largest |a_ik|, i >= k (LAPACK's idamax), chosen on the
        values and the rows exchanged by selects; the multipliers by the
        pivot's reciprocal (getrf's scal), the rank-1 updates (ger), then
        the back substitution by division (trsm, from the last row up).
        A literal zero update is skipped, as ger and trsm skip it.
        Returns X (n, m)."""
        n, m = A.shape[0], B.shape[1]
        M = [list(A[i]) + list(B[i]) for i in range(n)]
        w = n + m
        for k in range(n):
            if k < n - 1:
                best, piv, takes = self._absv(f"{name}__a{k}_{k}", M[k][k]), float(k), {}
                for r in range(k + 1, n):
                    a = M[r][k]
                    if _is_num(a) and a == 0.0:      # |0| is never the larger
                        takes[r] = False
                        continue
                    mag = self._absv(f"{name}__a{k}_{r}", a)
                    t = self._cmp(f"{name}__t{k}_{r}", ">", mag, best)
                    takes[r] = t
                    if isinstance(t, bool):
                        best, piv = (mag, float(r)) if t else (best, piv)
                        continue
                    # the running largest and its row, selects of values
                    best = self._emit(f"{name}__b{k}_{r}",
                                      f"mpc_where({t.expr}, {self._x(mag)}, {self._x(best)})",
                                      False, 0)
                    piv = self._emit(f"{name}__i{k}_{r}",
                                     f"mpc_where({t.expr}, {lit(r)}, {self._x(piv)})",
                                     False, 0)
                if _is_num(piv):                      # chosen at generation time
                    p = int(piv)
                    M[k], M[p] = M[p], M[k]
                else:
                    rows = {r: M[r] for r in range(n)}
                    new_k = list(M[k])
                    for r in range(k + 1, n):         # the last row taken is the pivot
                        if takes[r] is not False:
                            new_k = [new_k[j] if j < k else self._pick(
                                f"{name}__r{k}_{r}_{j}", takes[r], rows[r][j], new_k[j], 0)
                                for j in range(w)]
                    for r in range(k + 1, n):         # the pivot row gets row k
                        if takes[r] is False:
                            continue
                        here = self._emit(f"{name}__p{k}_{r}", f"({piv.expr} == {lit(r)})",
                                          False, 0)
                        M[r] = [rows[r][j] if j < k else self._pick(
                            f"{name}__s{k}_{r}_{j}", here, rows[k][j], rows[r][j], 0)
                            for j in range(w)]
                    M[k] = new_k
            rp = self._bin(f"{name}__rp{k}", "/", 1.0, M[k][k])
            for i in range(k + 1, n):
                li = self._bin(f"{name}__l{k}_{i}", "*", M[i][k], rp)
                for j in range(k + 1, w):
                    u = M[k][j]
                    if _is_num(u) and u == 0.0:
                        continue
                    M[i][j] = self._bin(f"{name}__u{k}_{i}_{j}", "-", M[i][j],
                                        self._bin(f"{name}__m{k}_{i}_{j}", "*", li, u))
        X = np.empty((n, m), dtype=object)
        for c in range(m):
            j = n + c
            for k in reversed(range(n)):
                b = M[k][j]
                if _is_num(b) and b == 0.0:
                    X[k, c] = 0.0
                    continue
                xk = self._bin(f"{name}__x{k}_{c}", "/", b, M[k][k])
                X[k, c] = xk
                for i in range(k):
                    M[i][j] = self._bin(f"{name}__y{k}_{i}_{c}", "-", M[i][j],
                                        self._bin(f"{name}__z{k}_{i}_{c}", "*", xk, M[i][k]))
        return X

    def _linsolve(self, name, a, b=None):
        """linalg.solve(a, b) for b a vector or a matrix, or inv(a) (b None)."""
        A = self._arr(a)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise NotImplementedError(f"linalg.solve/inv of a value of shape {A.shape}: "
                                      "a square matrix is needed")
        n = A.shape[0]
        if n > _SOLVE_MAX:
            raise NotImplementedError(f"linalg.solve/inv of a ({n}, {n}) matrix: lowered "
                                      f"for n <= {_SOLVE_MAX}")
        if b is None:
            return Matrix(self._solve(name, A, _objs((n, n), [float(i == j) for i in range(n)
                                                                for j in range(n)])))
        B = self._arr(b)
        if B.ndim == 0 or B.shape[0] != n:
            raise NotImplementedError(f"linalg.solve of a ({n}, {n}) matrix with a right "
                                      f"side of shape {B.shape}")
        if B.ndim == 1:
            return list(self._solve(name, A, B.reshape(n, 1))[:, 0])
        return Matrix(self._solve(name, A, B))

    # ----- reductions ------------------------------------------------------
    def _chooser(self, name, fn, xs):
        """max/min of ``xs`` with JAX's derivative: the value on the values,
        left to right (nan propagates), the tangent the mean of the tangents
        of the entries equal to it (nan where none is: a nan value)."""
        if len(xs) == 1:
            return xs[0]
        if all(_is_num(x) for x in xs):
            return functools.reduce(lambda p, q: _fold(
                np.maximum if fn == "mpc_max" else np.minimum, p, q), xs)
        m = xs[0]
        for k, x in enumerate(xs[1:], 1):
            m = (_fold(np.maximum if fn == "mpc_max" else np.minimum, m, x)
                 if _is_num(m) and _is_num(x) else
                 self._emit(f"{name}__v{k}", f"{fn}({self._v(m)}, {self._v(x)})", False, 1))
        if not any(_dual(x) for x in xs):
            return m
        count, tang = 0.0, 0.0
        for k, x in enumerate(xs):
            at = self._cmp(f"{name}__e{k}", "==", x, m)
            count = self._bin(f"{name}__c{k}", "+", count, self._pick(
                f"{name}__w{k}", at, 1.0, 0.0))
            tang = self._bin(f"{name}__g{k}", "+", tang, self._pick(
                f"{name}__t{k}", at, x, 0.0))
        lin = self._bin(f"{name}__lin", "/", tang, count)
        return self._emit(name, f"mpc_setv({self._x(lin)}, {self._x(m)})", True, 1)

    def _lane(self, name, kind, xs):
        """One reduction over the scalars ``xs``."""
        if kind in ("sum", "mean", "norm"):
            if kind == "norm":
                xs = [self._bin(f"{name}__q{k}", "*", x, x) for k, x in enumerate(xs)]
            acc = 0.0
            for k, c in enumerate(xs):
                acc = self._bin(f"{name}__s{k}", "+", acc, c)
            if kind == "mean":
                acc = self._bin(f"{name}__mean", "/", acc, float(len(xs)))
            if kind == "norm":
                acc = self._unary(f"{name}__sqrt", "mpc_sqrt", acc)
            return acc
        if kind == "prod":
            acc = 1.0
            for k, c in enumerate(xs):
                acc = self._bin(f"{name}__p{k}", "*", acc, c)
            return acc
        if kind == "cumsum":
            out = [xs[0]] if xs else []
            for k, c in enumerate(xs[1:], 1):
                out.append(self._bin(f"{name}__c{k}", "+", out[-1], c))
            return out
        return self._chooser(name, "mpc_max" if kind == "max" else "mpc_min", xs)

    def _reduce(self, name, kind, v, dim):
        """``kind`` over everything (``dim`` None) or over one dim."""
        a = self._arr(v)
        if dim is None:
            if kind == "cumsum":
                raise NotImplementedError("cumsum needs a dim")
            if a.ndim == 0 and kind != "norm":
                return a[()]
            return self._lane(name, kind, list(a.reshape(-1)))
        if not isinstance(dim, int) or not -max(a.ndim, 1) <= dim < max(a.ndim, 1):
            raise NotImplementedError(f"{kind} over dim {dim!r} of a value of shape {a.shape}")
        if a.ndim <= 1:
            out = self._lane(name, kind, list(a.reshape(-1)))
            return out if kind != "cumsum" or a.ndim else out[0]
        dim %= a.ndim
        lanes = np.moveaxis(a, dim, -1)
        res = [self._lane(f"{name}__{i}", kind, list(lanes[i])) for i in range(lanes.shape[0])]
        if kind == "cumsum":
            out = _objs(lanes.shape, [x for r in res for x in r])
            return self._from(np.moveaxis(out, -1, dim))
        return res

    # ----- arguments ---------------------------------------------------------
    @staticmethod
    def _kw(n, allowed):
        extra = set(n.kwargs) - set(allowed)
        if extra:
            raise NotImplementedError(
                f"op {_op_name(n)!r} with keyword arguments "
                f"{ {k: n.kwargs[k] for k in sorted(extra)} }")

    @staticmethod
    def _arg(n, pos, key, default=None):
        if key in n.kwargs:
            return n.kwargs[key]
        return n.args[pos] if len(n.args) > pos else default

    def _no_keepdim(self, n):
        if self._arg(n, 2, "keepdim", False):
            raise NotImplementedError(f"{_op_name(n)} with keepdim=True (lowered with "
                                      "keepdim=False)")

    def _index(self, env, idx):
        """A constant index of getitem in numpy's terms."""
        if isinstance(idx, torch.fx.Node):
            v = env[idx]
            if isinstance(v, np.ndarray) and (v.dtype == bool or
                                              np.issubdtype(v.dtype, np.integer)):
                return v
            raise NotImplementedError(
                "getitem with an index that depends on traced values (or a float tensor): "
                "indices must be constants")
        if isinstance(idx, tuple):
            return tuple(self._index(env, i) for i in idx)
        if isinstance(idx, list):
            items = [self._index(env, i) for i in idx]
            if not all(isinstance(i, (int, bool, np.integer, np.bool_)) for i in items):
                raise NotImplementedError("getitem with a list index of other than integers "
                                          "or booleans")
            return np.asarray(items)
        if isinstance(idx, slice):
            if any(isinstance(s, torch.fx.Node) for s in (idx.start, idx.stop, idx.step)):
                raise NotImplementedError("getitem with a slice bound that depends on traced "
                                          "values")
            return idx
        if idx is None or idx is Ellipsis or isinstance(idx, (int, np.integer)):
            return idx
        raise NotImplementedError(f"getitem with the index {idx!r}")

    # ----- one fx node -----------------------------------------------------
    def _lower(self, gm, env, n):
        name = "v_" + n.name
        tgt = n.target
        call = n.op == "call_function"
        meth = n.op == "call_method"
        if n.op == "get_attr":
            c = torch.as_tensor(functools.reduce(getattr, tgt.split("."), gm)).detach().cpu()
            if c.dtype == torch.bool or not (c.is_floating_point() or c.is_complex()):
                return np.asarray(c.numpy())          # an index or a mask keeps its dtype
            return np.asarray(c.double().numpy())
        if meth and tgt == "to":
            return self._value(env, n.args[0])
        if call and tgt is builtins.getattr:
            base, attr = self._value(env, n.args[0]), n.args[1]
            if attr in ("T", "mT"):
                a = self._arr(base)
                if attr == "mT" and a.ndim != 2:
                    raise NotImplementedError(".mT of a value that is not a matrix")
                return self._from(a.T)
            if attr == "values" and isinstance(base, _Chosen):
                return base.values
            raise NotImplementedError(f"attribute {attr!r} in the {self.what}")
        if call and tgt in _JOINS:
            self._kw(n, ("dim", "axis"))
            dim = n.kwargs.get("dim", n.kwargs.get("axis", n.args[1] if len(n.args) > 1
                                                    else 0))
            parts = [self._arr(self._value(env, a)) for a in n.args[0]]
            stack = tgt is torch.stack
            if not stack and any(p.ndim == 0 for p in parts):
                raise NotImplementedError("torch.cat of a scalar")
            nd = parts[0].ndim + stack
            if not isinstance(dim, int) or not -nd <= dim < nd:
                raise NotImplementedError(f"{_op_name(n)} over dim {dim!r} of values of "
                                          f"shape {parts[0].shape}")
            try:
                return self._from((np.stack if stack else np.concatenate)(parts, dim % nd))
            except ValueError:
                raise NotImplementedError(f"{_op_name(n)} of values whose shapes do not "
                                          "fit") from None
        if (call and tgt in _CLAMP) or (meth and tgt in ("clamp", "clip")):
            if set(n.kwargs) - {"min", "max"} or len(n.args) > 3:
                raise NotImplementedError(f"{_op_name(n)} is supported with the input "
                                          "and the bounds min, max only")
            pos = list(n.args[1:]) + [None] * (3 - len(n.args))
            lo, hi = n.kwargs.get("min", pos[0]), n.kwargs.get("max", pos[1])
            vals = [None if v is None else self._value(env, v) for v in (n.args[0], lo, hi)]
            return self._map(name, self._clamp, *vals)
        if (call and tgt in _REDUCTIONS) or (meth and tgt in _REDUCTION_METHODS):
            kind = _REDUCTIONS[tgt] if call else _REDUCTION_METHODS[tgt]
            self._kw(n, ("dim", "keepdim"))
            self._no_keepdim(n)
            return self._reduce(name, kind, self._value(env, n.args[0]),
                                self._arg(n, 1, "dim"))
        if (call and tgt in (torch.max, torch.min)) or (meth and tgt in ("max", "min")):
            kind = _op_name(n) if meth else tgt.__name__
            other = self._arg(n, 1, "dim")
            if isinstance(other, torch.fx.Node):      # max(a, b): elementwise
                self._kw(n, ())
                fn = "mpc_max" if kind == "max" else "mpc_min"
                return self._map(name, lambda nm, x, y: self._maxmin(nm, fn, x, y),
                                 self._value(env, n.args[0]), env[other])
            self._kw(n, ("dim", "keepdim"))
            self._no_keepdim(n)
            out = self._reduce(name, kind, self._value(env, n.args[0]), other)
            return out if other is None else _Chosen(out)
        if (call and tgt in _NORMS) or (meth and tgt == "norm"):
            key = "p" if meth or tgt is torch.norm else "ord"
            self._kw(n, (key, "dim", "keepdim", "out", "dtype"))
            order, dim = self._arg(n, 1, key), self._arg(n, 2, "dim")
            keep = self._arg(n, 3, "keepdim", False)
            v = self._arr(self._value(env, n.args[0]))
            matrix = tgt is torch.linalg.norm and v.ndim == 2 and dim is None
            ok = (order in (None, "fro") if matrix else
                  order in (None, 2, 2.0) or (order == "fro" and key == "p"))
            if not ok or keep or n.kwargs.get("out") is not None \
                    or n.kwargs.get("dtype") is not None or isinstance(dim, (list, tuple)):
                raise NotImplementedError(
                    f"{_op_name(n)} with {key}={order!r}, dim={dim!r}, keepdim={keep!r}: only "
                    "the 2-norm (Frobenius for a matrix) over everything or one dim is lowered")
            return self._reduce(name, "norm", self._from(v), dim)
        if (meth and tgt in ("reshape", "view", "flatten")) or (
                call and tgt in (torch.atleast_1d, torch.flatten, torch.reshape)):
            self._kw(n, ())
            if tgt in ("flatten", torch.flatten, torch.atleast_1d):
                if len(n.args) != 1:
                    raise NotImplementedError(f"{_op_name(n)} of one value, no dims")
                shape = (-1,)
            else:
                shape = n.args[1:]
                if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                    shape = tuple(shape[0])
            a = self._arr(self._value(env, n.args[0]))
            if not all(isinstance(s, int) for s in shape) or len(shape) > 2 or (
                    len(shape) == 2 and a.ndim > 1):
                raise NotImplementedError(
                    f"reshape to {tuple(shape)}: lowered as reshape(-1), flatten, "
                    "atleast_1d, or a vector to (r, c)")
            try:
                return self._from(a.reshape(shape))
            except ValueError:
                raise NotImplementedError(f"reshape of {a.shape} to {tuple(shape)}") from None
        if (meth and tgt in ("transpose", "t")) or (call and tgt in (torch.transpose, torch.t)):
            self._kw(n, ())
            a = self._arr(self._value(env, n.args[0]))
            dims = tuple(d % 2 for d in n.args[1:]) if a.ndim == 2 else ()
            if (tgt in ("t", torch.t) and a.ndim <= 2) or sorted(dims) == [0, 1]:
                return self._from(a.T)
            raise NotImplementedError(f"{_op_name(n)}{tuple(n.args[1:])} of a value of shape "
                                      f"{a.shape}")
        if call and tgt in _LIKE:
            self._kw(n, ("dtype",))
            a = self._arr(self._value(env, n.args[0]))
            c = _LIKE[tgt] if tgt is not torch.full_like else self._value(env, n.args[1])
            if not _is_num(c):
                raise NotImplementedError("full_like with a traced fill value")
            return self._from(_objs(a.shape, [float(c)] * a.size))
        if call and tgt is operator.getitem:
            base, idx = self._value(env, n.args[0]), n.args[1]
            if isinstance(base, _Chosen):
                if idx != 0:
                    raise NotImplementedError("the indices of max/min over a dim are not "
                                              "lowered (the values are)")
                return base.values
            if isinstance(base, _Input) and isinstance(idx, int):
                if base.dim is not None:
                    if not -base.dim <= idx < base.dim:
                        raise NotImplementedError(
                            f"index {idx} out of range for input {base.name!r} "
                            f"({base.dim})")
                    idx %= base.dim
                return self._emit(name, f"{base.name}[{idx}]", base.dual)
            idx = self._index(env, idx)
            if isinstance(base, np.ndarray):
                return base[idx]
            a = self._arr(base)
            if a.ndim == 0:
                raise NotImplementedError("getitem on a scalar")
            try:
                return self._from(a[idx])
            except IndexError as e:
                raise NotImplementedError(f"getitem: {e}") from None
        if (call and tgt is torch.linalg.solve):
            self._kw(n, ("left",))
            if not n.kwargs.get("left", True):
                raise NotImplementedError("linalg.solve with left=False")
            return self._linsolve(name, self._value(env, n.args[0]),
                                  self._value(env, n.args[1]))
        if (call and tgt in (torch.linalg.inv, torch.inverse)) or (meth and tgt == "inverse"):
            self._kw(n, ())
            return self._linsolve(name, self._value(env, n.args[0]))
        if (call and tgt in _PRODUCTS) or (meth and tgt in _PRODUCT_METHODS):
            kind = _PRODUCTS[tgt] if call else _PRODUCT_METHODS[tgt]
            self._kw(n, ("dim",) if kind == "cross" else ())
            if kind == "cross" and self._arg(n, 2, "dim", -1) not in (None, 0, -1):
                raise NotImplementedError("cross of 3-vectors over their dim 0")
            a, b = (self._value(env, x) for x in n.args[:2])
            return {"matmul": self._matmul, "outer": self._outer,
                    "cross": self._cross}[kind](name, a, b)
        if n.kwargs:
            raise NotImplementedError(
                f"op {_op_name(n)!r} with keyword arguments {dict(n.kwargs)}")
        args = [self._value(env, a) for a in n.args]
        if call and tgt in _BIN:
            sym = _BIN[tgt]
            return self._map(name, lambda nm, x, y: self._bin(nm, sym, x, y), *args)
        if (call and tgt in _UNARY) or (meth and tgt in _METHODS):
            fn = _UNARY[tgt] if call else _METHODS[tgt]
            return self._map(name, lambda nm, x: self._unary(nm, fn, x), args[0])
        if (call and tgt in (torch.abs, operator.abs)) or (meth and tgt == "abs"):
            return self._map(name, self._abs, args[0])
        flat = {torch.sign: "sign", torch.floor: "floor", torch.round: "round"}
        if (call and tgt in flat) or (meth and tgt in _FLAT):
            fn = flat[tgt] if call else tgt
            if len(args) != 1:
                raise NotImplementedError(f"{fn} with more arguments than the value")
            return self._map(name, lambda nm, x: self._flat(nm, fn, x), args[0])
        if (call and tgt is torch.square) or (meth and tgt == "square"):
            return self._map(name, lambda nm, x: self._bin(nm, "*", x, x), args[0])
        if (call and tgt is torch.reciprocal) or (meth and tgt == "reciprocal"):
            return self._map(name, lambda nm, x: self._bin(nm, "/", 1.0, x), args[0])
        if (call and tgt in _ATAN2) or (meth and tgt in ("atan2", "arctan2")):
            return self._map(name, self._atan2, *args)
        if (call and tgt is torch.hypot) or (meth and tgt == "hypot"):
            return self._map(name, self._hypot, *args)
        if (call and tgt is torch.fmod) or (meth and tgt == "fmod"):
            return self._map(name, self._fmod, *args)
        if (call and tgt in (torch.remainder, operator.mod)) or (meth and tgt == "remainder"):
            return self._map(name, self._remainder, *args)
        if (call and tgt in _POW) or (meth and tgt == "pow"):
            return self._map(name, lambda nm, a, b: (self._pow(nm, a, b) if _is_num(b)
                                                     else self._pow2(nm, a, b)), *args)
        if (call and tgt in _MAXMIN) or (meth and tgt in ("maximum", "minimum")):
            fn = _MAXMIN[tgt] if call else f"mpc_{tgt[:3]}"
            return self._map(name, lambda nm, x, y: self._maxmin(nm, fn, x, y), *args)
        if call and tgt in _CMP:
            sym = _CMP[tgt]

            def cmp(nm, x, y):
                return self._emit(nm, f"(mpc_val({self._x(x)}) {sym} "
                                  f"mpc_val({self._x(y)}))", False, 1)
            return self._map(name, cmp, *args)
        if call and tgt is torch.where:
            return self._map(name, self._where, *args)
        why = REFUSED.get(_op_name(n).removeprefix("special_"))
        raise NotImplementedError(
            f"op {_op_name(n)!r} ({n.op}) is not supported by the CUDA sweep's code "
            f"generator{': ' + why if why else ''}; supported: {SUPPORTED}")

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
            return torch.where(val(c).bool(), val(a), val(b))

        def flat(fn):                    # JAX's value at 0 and nan, derivative 0
            return lambda a: fn(val(a)).detach()

        scope = dict(
            S=float, NAN=math.nan, INFINITY=math.inf,
            mpc_pow=jax_rules.power, mpc_val=lambda a: a, mpc_where=where,
            mpc_max=lambda a, b: torch.maximum(val(a), val(b)),
            mpc_min=lambda a, b: torch.minimum(val(a), val(b)),
            mpc_sign=flat(lambda a: torch.where(a > 0, 1.0, torch.where(a < 0, -1.0, a))),
            mpc_floor=flat(torch.floor), mpc_round=flat(torch.round),
            mpc_atan2=jax_rules.atan2,
            mpc_fmod=lambda a, b: torch.fmod(val(a), val(b)),
            mpc_absv=lambda a: torch.abs(val(a)).detach(),
            mpc_setv=lambda a, v: jax_rules.set_value(val(a), val(v)),
            **{f"mpc_{f}": getattr(torch, f) for f in FUNCTIONS})
        scope.update(inputs)
        scope["out"] = [None] * len(self.out)
        for line in self.lines:
            exec(line.strip().removeprefix("auto ").rstrip(";"), scope)
        return scope["out"]
