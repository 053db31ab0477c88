"""The torch functions whose derivative differs from JAX's, with JAX's.

The port follows JAX's derivatives, and the CUDA sweeps take them from the
rules in ``csrc/dual.cuh`` and ``csrc/dual2.cuh``.  torch disagrees with
JAX at four kinds of point that a model can sit on:

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
  torch's 0.

``jax_rules()`` is a torch function mode under which these functions (as
``torch.*`` functions, as tensor methods and as ``abs(x)``, ``x ** y``)
run with JAX's derivative and the same values (``pow`` of a positive base
up to rounding); every other call passes through.  Tracing (``torch.fx``) runs outside it.  The sweeps' plain
versions run the user's functions under it (``with_jax_rules``), so that
a plain version and its kernel take the same derivative on every lane.
``atan2`` and ``power`` are also what ``ops/codegen.py::Program.execute``
runs for the lowered ``mpc_atan2`` and ``mpc_pow``.
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


_RULES = {torch.clamp: clamp, torch.clip: clamp,
          torch.Tensor.clamp: clamp, torch.Tensor.clip: clamp,
          torch.abs: absolute, torch.Tensor.abs: absolute, torch.Tensor.__abs__: absolute,
          torch.atan2: atan2, torch.arctan2: atan2,
          torch.Tensor.atan2: atan2, torch.Tensor.arctan2: atan2,
          torch.pow: power, torch.Tensor.pow: power, torch.Tensor.__pow__: power}


class _JaxRules(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _RULES.get(func, func)(*args, **(kwargs or {}))


def jax_rules() -> TorchFunctionMode:
    """A context under which clamp/clip, abs, atan2 and pow take JAX's
    derivatives."""
    return _JaxRules()


def with_jax_rules(fn):
    """``fn`` run under ``jax_rules()``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with jax_rules():
            return fn(*args, **kwargs)
    return run
