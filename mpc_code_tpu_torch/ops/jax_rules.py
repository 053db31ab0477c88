"""The torch functions whose derivative differs from JAX's, with JAX's.

The port follows JAX's derivatives, and the CUDA sweeps take them from the
rules in ``csrc/dual.cuh`` and ``csrc/dual2.cuh``.  torch disagrees with
JAX at these kinds of point that a model can sit on:

- ``clamp``/``clip`` at a tie with a bound: JAX's ``jnp.clip`` is
  ``minimum(maximum(x, lo), hi)``, whose derivative gives each side half
  the tangent (0.5); torch's ``clamp`` passes all of it (1);
- ``abs`` at 0: JAX's derivative is ``sign``-free, +1 (``select(x >= 0,
  x, -x)``); torch's is 0;
- ``atan2`` at the origin: JAX's derivative is ``(x dy - y dx) / (x^2 +
  y^2)``, nan there; torch's reverse mode gives 0;
- ``pow`` with a traced exponent: at a zero base JAX's second derivatives
  are finite (``log(0)`` taken as 0), torch's in reverse mode nan; at a
  zero exponent JAX's derivative of ``b a^(b-1)`` in b is ``a^-1``,
  torch's 0;
- the 2-norm (``norm``, ``linalg.norm``, ``linalg.vector_norm``) at the
  zero vector: JAX's ``sqrt(sum(x * x))`` has a nan derivative there,
  torch's 0;
- ``max``/``min`` over a dim at a tie: JAX splits the tangent equally
  among the tied entries (as ``torch.amax`` does), torch's ``max(x, dim)``
  gives all of it to the index it returns (and ``max()`` in reverse mode
  to a nan entry);
- ``hypot`` at the origin: JAX's composition of abs, max, min and sqrt has
  the derivative (1/2, 1/2) there, torch's is nan;
- ``remainder``: JAX's select (``fmod`` plus the divisor where the signs
  differ), whose derivative in the divisor is -trunc(a/b) + 1 there;
- ``linalg.solve`` and ``linalg.inv`` under ``vmap(jacfwd)``: torch's
  forward-mode derivative comes out wrong (F13); they run through
  ``ops/smalllin.py::solve_lu_ad``, whose derivatives are written out.

Indexing by a constant tensor also runs here where ``vmap`` cannot run it
as written: a boolean mask becomes the indices of its true entries, and a
constant index moves to the indexed tensor's device (``getitem``).

``jax_rules()`` is a torch function mode under which these functions (as
``torch.*`` functions, as tensor methods and as ``abs(x)``, ``x ** y``)
run with JAX's derivative and the same values (``pow`` of a positive base,
the norms, ``hypot`` and the solves up to rounding); every other call
passes through.  Tracing (``torch.fx``) runs outside it.  The sweeps' plain
versions run the user's functions under it (``with_jax_rules``), so that
a plain version and its kernel take the same derivative on every lane.
``atan2``, ``power`` and ``set_value`` are also what
``ops/codegen.py::Program.execute`` runs for the lowered ``mpc_atan2``,
``mpc_pow`` and ``mpc_setv``.
"""

from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode


def _like(c, x):
    return c if torch.is_tensor(c) else torch.as_tensor(c, dtype=x.dtype, device=x.device)


def clamp(x, min=None, max=None):
    """``jnp.clip``: ``minimum(maximum(x, min), max)``, half the tangent
    to each side at a tie."""
    if min is not None:
        x = torch.maximum(x, _like(min, x))
    if max is not None:
        x = torch.minimum(x, _like(max, x))
    return x


def absolute(x):
    """``|x|`` as ``where(x >= 0, x, -x)``: derivative +1 at 0, as JAX's."""
    return torch.where(x >= 0, x, -x)


def atan2(y, x):
    """``atan2(y, x)`` with JAX's derivative, nan at the origin.  Away from
    it torch's derivative is JAX's; the term ``0 * sqrt(x^2 + y^2)``
    adds an exact 0 to the value and to every derivative there, and nan to
    every derivative at the origin (sqrt's derivative at 0 times a zero
    tangent), in forward and in reverse mode."""
    if not torch.is_tensor(y):
        y = _like(y, x)
    if not torch.is_tensor(x):
        x = _like(x, y)
    return torch.atan2(y, x) + 0.0 * torch.sqrt(x * x + y * y)


def power(a, b):
    """``a ** b`` with JAX's derivatives in a traced exponent: f_a = b
    a^(b-1), f_b = log(a) a^b with log(0) taken as 0.  torch's pow masks
    f_a at b = 0, which drops its derivative in b there (JAX's is a^-1),
    and in reverse mode its second derivatives at a = 0 multiply a zero by
    log(0) (nan).  So a positive base runs ``exp(b log a)``, whose
    derivatives are JAX's rules; a zero base pow with the exponent's
    tangent dropped (JAX's f_b and f_bb are 0 there); a negative base
    torch's pow (nan for a non-integer exponent, as JAX's).  Each branch
    sees a base at which the others' derivatives are finite.  A scalar
    exponent or base takes torch's pow."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        return torch.pow(a, b)
    pos, zero, neg = a > 0, a == 0, a < 0
    one = torch.ones_like(a)
    return torch.where(pos, torch.exp(b * torch.log(torch.where(pos, a, one))),
                       torch.where(zero, torch.pow(torch.where(zero, a, one), b.detach()),
                                   torch.pow(torch.where(neg, a, -one),
                                             torch.where(neg, b, torch.ones_like(b)))))


def norm2(x, dim=None, keepdim=False):
    """The 2-norm as JAX's ``sqrt(sum(x * x))``: its derivative at the zero
    vector is nan."""
    sq = x * x
    return torch.sqrt(sq.sum() if dim is None else sq.sum(dim, keepdim=keepdim))


def _norm(orig, key):
    """``orig`` (a norm with its order under ``key``) as ``norm2`` where it
    is the 2-norm of a vector or the Frobenius norm, else ``orig``."""
    def rule(x, *args, **kwargs):
        names = (key, "dim", "keepdim")
        kw = dict(zip(names, args), **kwargs)
        order, dim = kw.get(key), kw.get("dim")
        matrix = orig is torch.linalg.norm and x.dim() == 2 and dim is None
        if (set(kw) <= set(names) | {"out", "dtype"} and kw.get("out") is None
                and kw.get("dtype") is None and not isinstance(dim, (list, tuple))
                and (order in (None, "fro") if matrix else order in (None, 2, 2.0, "fro"))):
            return norm2(x, dim, kw.get("keepdim", False))
        return orig(x, *args, **kwargs)
    return rule


def _chooser(orig, reduce):
    """``max``/``min`` (``orig``) with JAX's derivative at ties: the
    reductions as ``amax``/``amin`` (``reduce``), ``max(x, dim)``'s values
    too (its indices torch's); ``max(a, b)`` elementwise passes through."""
    def rule(x, *args, **kwargs):
        dim = kwargs.get("dim", args[0] if args else None)
        if torch.is_tensor(dim):
            return orig(x, *args, **kwargs)
        keepdim = kwargs.get("keepdim", args[1] if len(args) > 1 else False)
        if dim is None:
            return reduce(x)
        idx = (torch.argmax if reduce is torch.amax else torch.argmin)(x, dim, keepdim)
        rtype = torch.return_types.max if reduce is torch.amax else torch.return_types.min
        return rtype((reduce(x, dim, keepdim), idx))
    return rule


def hypot(a, b):
    """``jnp.hypot``: |a|, |b|, their maximum m and minimum n, m sqrt(1 +
    (n / m)^2) (m where m is 0), inf where either is +inf."""
    if not torch.is_tensor(a):
        a = _like(a, b)
    if not torch.is_tensor(b):
        b = _like(b, a)
    x1, x2 = absolute(a), absolute(b)
    inf = torch.isposinf(x1) | torch.isposinf(x2)
    x1, x2 = torch.maximum(x1, x2), torch.minimum(x1, x2)
    zero = x1 == 0
    x = torch.where(zero, x1, x1 * torch.sqrt(
        1 + torch.square(x2 / torch.where(zero, torch.ones_like(x1), x1))))
    return torch.where(inf, torch.full_like(x, float("inf")), x)


def remainder(a, b):
    """``jnp.remainder``: r = fmod(a, b), r + b where r is not 0 and its
    sign is not b's."""
    if not torch.is_tensor(a):
        a = _like(a, b)
    if not torch.is_tensor(b):
        b = _like(b, a)
    r = torch.fmod(a, b)
    plus = ((r < 0) != (b < 0)) & (r != 0)
    return torch.where(plus, r + b, r)


def solve(A, B, *, left=True, out=None):
    """``linalg.solve`` by ``solve_lu_ad``: derivatives right under
    ``vmap(jacfwd)`` (F13)."""
    from mpc_code_tpu_torch.ops.smalllin import solve_lu_ad

    if not left or out is not None:
        return torch.linalg.solve(A, B, left=left, out=out)
    return solve_lu_ad(A, B)


def inverse(A, *, out=None):
    """``linalg.inv`` as the solve with the identity."""
    if out is not None:
        return torch.linalg.inv(A, out=out)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return solve(A, eye.expand(A.shape))


class _SetValue(torch.autograd.Function):
    """``a`` with the value ``v`` (the same shape): the value ``v``, the
    derivative ``a``'s."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, v):
        return v.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, a_t, v_t):
        return a_t


def getitem(x, idx):
    """``x[idx]`` with a constant boolean mask as the indices of its true
    entries (``vmap`` runs no mask) and a constant index tensor on ``x``'s
    device."""
    if torch.is_tensor(idx) and torch.is_tensor(x):
        if idx.dtype == torch.bool:
            idx = idx.nonzero().squeeze(-1)
        idx = idx.to(x.device)
    return torch.Tensor.__getitem__(x, idx)


def set_value(a, v):
    """``mpc_setv``: a number with ``v``'s value and ``a``'s tangents (the
    max/min reductions' value beside their tangent rule)."""
    return _SetValue.apply(a, v.to(a.dtype).expand_as(a))


_RULES = {torch.clamp: clamp, torch.clip: clamp,
          torch.Tensor.clamp: clamp, torch.Tensor.clip: clamp,
          torch.abs: absolute, torch.Tensor.abs: absolute, torch.Tensor.__abs__: absolute,
          torch.atan2: atan2, torch.arctan2: atan2,
          torch.Tensor.atan2: atan2, torch.Tensor.arctan2: atan2,
          torch.pow: power, torch.Tensor.pow: power, torch.Tensor.__pow__: power,
          torch.hypot: hypot, torch.Tensor.hypot: hypot,
          torch.remainder: remainder, torch.Tensor.remainder: remainder,
          torch.Tensor.__mod__: remainder, torch.Tensor.__getitem__: getitem,
          torch.linalg.solve: solve, torch.linalg.inv: inverse, torch.inverse: inverse,
          torch.Tensor.inverse: inverse,
          torch.norm: _norm(torch.norm, "p"), torch.Tensor.norm: _norm(torch.norm, "p"),
          torch.linalg.norm: _norm(torch.linalg.norm, "ord"),
          torch.linalg.vector_norm: _norm(torch.linalg.vector_norm, "ord"),
          torch.max: _chooser(torch.max, torch.amax),
          torch.Tensor.max: _chooser(torch.max, torch.amax),
          torch.min: _chooser(torch.min, torch.amin),
          torch.Tensor.min: _chooser(torch.min, torch.amin)}


class _JaxRules(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _RULES.get(func, func)(*args, **(kwargs or {}))


def jax_rules() -> TorchFunctionMode:
    """A context under which the functions of ``_RULES`` take JAX's
    derivatives."""
    return _JaxRules()


def with_jax_rules(fn):
    """``fn`` run under ``jax_rules()``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with jax_rules():
            return fn(*args, **kwargs)
    return run
