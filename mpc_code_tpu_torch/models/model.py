"""Controller-model constructor (port of ``mpc_code_tpu/models/model.py``).

Returns plain callables over torch tensors with the reference's positional
signatures (``defF_model``, Utilities.py:102-245):

- ``Fx_model(x, u, k, d, t, px) -> x_next``   (k = integration interval h)
- ``Fy_model(x, u, d, t, py) -> y``

The callables act on one point; a batch goes through ``torch.func.vmap``.
They also take lanes-minor (dim, L) arguments, and ``torch.fx`` traces the
output map for the CUDA sweeps.  This slice covers the NL-continuous model
form (RK4 with Mx sub-steps and the optional saturation guard) and the
NL-discrete form (a user one-step map), with a user output map or
StateFeedback, and ``offree`` in {'no', 'nl', 'lin'}; the linear form and
C-matrix outputs raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mpc_code_tpu_torch.config import ContinuousModel, DiscreteModel, MPCConfig
from mpc_code_tpu_torch.ops.integrators import rk4, saturate


class ModelFns(NamedTuple):
    fx: Callable  # Fx_model(x, u, k, d, t, px)
    fy: Callable  # Fy_model(x, u, d, t, py)


def _mat(M):
    return None if M is None else torch.as_tensor(np.asarray(M, float))


def build_model(cfg: MPCConfig) -> ModelFns:
    """Build (Fx_model, Fy_model) for a ``ContinuousModel`` or
    ``DiscreteModel`` config."""
    m = cfg.model
    if not isinstance(m, (ContinuousModel, DiscreteModel)):
        raise NotImplementedError(
            f"model form {type(m).__name__} is not ported yet (ROADMAP "
            "Queue 1 item 24)")
    if not cfg.StateFeedback and m.fy is None:
        raise NotImplementedError(
            "C-matrix outputs are not ported yet (ROADMAP Queue 1 item 24)")
    lin = cfg.dist.offree == "lin"
    # the matrices stay f64 CPU tensors; ``.to(x)`` casts them at call time
    # (and is what torch.fx records, so the CUDA code generator sees a
    # constant matrix)
    Bd, Cd = _mat(cfg.dist.Bd), _mat(cfg.dist.Cd)
    lin_par, state_fb = cfg.LinPar, cfg.StateFeedback
    user_fy = m.fy
    if isinstance(m, DiscreteModel):
        user_map = m.Fx

        def step(x, u, k, d, t, px):
            return user_map(x, u, d, t, px)                # Utilities.py:186-190
    else:
        user_fx, lo, hi = m.fx, m.clip_lo, m.clip_hi

        def fx_eval(xx, tt, uu, dd, pp):
            # ODE-input saturation (the reference's own stability guard
            # pattern, Ex_NMPC_dis.py:75-77)
            return user_fx(saturate(xx, lo, hi), uu, dd, tt, pp)

        integ = rk4(fx_eval, m.Mx)

        def step(x, u, k, d, t, px):
            return integ(x, t, k, u, d, px)                # Utilities.py:157-172

    def fx(x, u, k, d, t, px):
        out = step(x, u, k, d, t, px)
        if lin:
            out = out + Bd.to(out) @ d                     # Utilities.py:174-177
        if lin_par:
            out = out + px                                 # Utilities.py:180-183
        return out

    def fy(x, u, d, t, py):
        if state_fb:
            out = x                                        # Utilities.py:201-205
        else:
            out = user_fy(x, u, d, t, py)                  # Utilities.py:232-238
        if lin:
            out = out + Cd.to(x) @ d
        if lin_par:
            out = out + py                                 # Utilities.py:240-243
        return out

    return ModelFns(fx=fx, fy=fy)
