"""Carry state across from the JAX package to the port, without importing JAX.

``config_from_numpy`` copies every array and scalar field of a JAX
``MPCConfig`` (read through ``dataclasses.fields``, handed over as numpy)
into a port config whose callables (model and plant maps, setpoint
schedule, user costs) come from the port's own example.  ``result_from_numpy``
carries ``X``, ``U``, the duals and the solver statistics of a result, and
``mhe_carry_from_numpy`` the window state of the MHE (a JAX ``MHECarry``).
Both sides then solve the same problem from the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_code_tpu_torch.solver.riccati import StructResult


def _copy_value(src, base):
    if callable(src) and not isinstance(src, type) and not dataclasses.is_dataclass(src):
        return base          # callables come from the port's own example
    if dataclasses.is_dataclass(src) and not isinstance(src, type):
        if base is None or type(base).__name__ != type(src).__name__:
            raise TypeError(f"no port counterpart for {type(src).__name__} "
                            f"(port has {type(base).__name__})")
        return config_from_numpy(src, base)
    if src is None or isinstance(src, (bool, int, float, str)):
        return src
    return np.array(np.asarray(src))


def config_from_numpy(src, base):
    """A copy of ``base`` (a port dataclass) whose data fields are those of
    ``src`` (the matching JAX dataclass), field by field, as numpy."""
    names = {f.name for f in dataclasses.fields(base)}
    kw = {}
    for f in dataclasses.fields(src):
        if f.name not in names:
            raise TypeError(f"field {f.name!r} of {type(src).__name__} is "
                            "missing from the port's config")
        kw[f.name] = _copy_value(getattr(src, f.name), getattr(base, f.name))
    init = {k: v for k, v in kw.items()
            if next(f for f in dataclasses.fields(base) if f.name == k).init}
    out = dataclasses.replace(base, **init)
    # derived flags (QForm, ...) are set by __post_init__; keep src's values
    for k, v in kw.items():
        setattr(out, k, v)
    return out


def result_from_numpy(res, device="cpu") -> StructResult:
    """A ``StructResult`` of torch tensors from any object with the same
    fields (a JAX ``StructResult`` read through ``np.asarray``)."""
    return StructResult(**{name: torch.as_tensor(np.array(getattr(res, name)),
                                                 device=device)
                           for name in StructResult._fields})


def result_to_numpy(res: StructResult) -> dict:
    """Every field of a port result as a numpy array."""
    return {k: getattr(res, k).detach().cpu().numpy() for k in StructResult._fields}


def mhe_carry_from_numpy(carry, lanes_axis: bool = False, device="cpu"):
    """The port's ``MHECarry`` from any object with its fields (a JAX
    ``MHECarry`` read through ``np.asarray``): the window buffers, ``sm``
    field by field, ``steps`` (the warmup's counter: a carry of the traced
    warmup) and the ``duals`` dict.  A JAX carry is one
    lane: it gets a leading lane axis of 1 unless ``lanes_axis`` says its
    arrays already have one."""
    from mpc_code_tpu_torch.estimators.mhe import MHECarry, MHESmoothState

    def T(a):
        t = torch.as_tensor(np.array(np.asarray(a)), device=device)
        return t if lanes_axis else t.unsqueeze(0)

    sm = (None if carry.sm is None else
          MHESmoothState(*(T(getattr(carry.sm, f)) for f in MHESmoothState._fields)))
    fields = {f: T(getattr(carry, f)) for f in MHECarry._fields
              if f not in ("sm", "steps", "duals")}
    return MHECarry(**fields, sm=sm, steps=T(carry.steps).to(torch.int32),
                    duals=None if carry.duals is None else
                    {k: T(v) for k, v in carry.duals.items()})
