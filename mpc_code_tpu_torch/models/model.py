"""Controller-model and plant constructors (port of ``mpc_code_tpu/models/model.py``).

Returns plain callables over torch tensors with the reference's positional
signatures (``defF_model``, Utilities.py:102-245; ``defF_p``,
Utilities.py:21-100):

- ``Fx_model(x, u, k, d, t, px) -> x_next``   (k = integration interval h)
- ``Fy_model(x, u, d, t, py) -> y``
- ``Fx_p(x, u, pxp, t, k, pxmp) -> x_next``
- ``Fy_p(x, u, pyp, t, pymp) -> y``

The callables act on one point; a batch goes through ``torch.func.vmap``.
The continuous and discrete forms also take lanes-minor (dim, L) arguments,
and ``torch.fx`` traces their output maps for the CUDA sweeps.  Every model
form is covered: the linear form (``A x + B u``, or affine around ``xlin``
and ``ulin``), the NL-continuous form (RK4 with Mx sub-steps and the
optional saturation guard) and the NL-discrete form (a user one-step map);
outputs from StateFeedback, the C matrix (affine around ``xlin`` and
``ylin`` for the linear form) or the user's ``fy``; and ``offree`` in
{'no', 'nl', 'lin'}.  ``build_plant`` covers every plant form: the nominal
alias of the model, ``LinearPlant``, ``ContinuousPlant`` (RK4 with its
optional saturation guard) and ``DiscretePlant``, with LinPar and outputs
from StateFeedback, ``Cp`` or the user's ``fy``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mpc_code_tpu_torch.config import (
    ContinuousModel, ContinuousPlant, DiscreteModel, DiscretePlant,
    LinearModel, LinearPlant, MPCConfig,
)
from mpc_code_tpu_torch.ops.integrators import rk4, saturate


class ModelFns(NamedTuple):
    fx: Callable  # Fx_model(x, u, k, d, t, px)
    fy: Callable  # Fy_model(x, u, d, t, py)


class PlantFns(NamedTuple):
    fx: Callable  # Fx_p(x, u, pxp, t, k, pxmp)  [nominal: model signature]
    fy: Callable  # Fy_p(x, u, pyp, t, pymp)     [nominal: model signature]
    nominal: bool


def _mat(M):
    return None if M is None else torch.as_tensor(np.asarray(M, float))


def build_model(cfg: MPCConfig) -> ModelFns:
    """Build (Fx_model, Fy_model) from the config (Utilities.defF_model,
    Utilities.py:102-245; dispatch MPC_code.py:94-167)."""
    m = cfg.model
    lin = cfg.dist.offree == "lin"
    # the matrices stay f64 CPU tensors; ``.to(x)`` casts them at call time
    # (and is what torch.fx records, so the CUDA code generator sees a
    # constant matrix)
    Bd, Cd = _mat(cfg.dist.Bd), _mat(cfg.dist.Cd)
    lin_par, state_fb = cfg.LinPar, cfg.StateFeedback
    if isinstance(m, LinearModel):
        A, Bm = _mat(m.A), _mat(m.B)
        xlin, ulin = _mat(m.xlin), _mat(m.ulin)

        def fx(x, u, k, d, t, px):
            if xlin is not None:
                xl = xlin.to(x)
                out = A.to(x) @ (x - xl) + Bm.to(x) @ (u - ulin.to(x)) + xl  # Utilities.py:142
            else:
                out = A.to(x) @ x + Bm.to(x) @ u           # Utilities.py:147
            if lin:
                out = out + Bd.to(out) @ d                 # Utilities.py:150
            return out + px                                # Utilities.py:153 (always)

    elif isinstance(m, (ContinuousModel, DiscreteModel)):
        if isinstance(m, DiscreteModel):
            user_map = m.Fx

            def step(x, u, k, d, t, px):
                return user_map(x, u, d, t, px)            # Utilities.py:186-190
        else:
            user_fx, lo, hi = m.fx, m.clip_lo, m.clip_hi

            def fx_eval(xx, tt, uu, dd, pp):
                # ODE-input saturation (the reference's own stability guard
                # pattern, Ex_NMPC_dis.py:75-77)
                return user_fx(saturate(xx, lo, hi), uu, dd, tt, pp)

            integ = rk4(fx_eval, m.Mx)

            def step(x, u, k, d, t, px):
                return integ(x, t, k, u, d, px)            # Utilities.py:157-172

        def fx(x, u, k, d, t, px):
            out = step(x, u, k, d, t, px)
            if lin:
                out = out + Bd.to(out) @ d                 # Utilities.py:174-177
            if lin_par:
                out = out + px                             # Utilities.py:180-183
            return out

    else:
        raise TypeError(f"unsupported model spec {type(m)}")

    if state_fb:
        def y_base(x, u, d, t, py):
            return x                                       # Utilities.py:201-205

    elif isinstance(m, LinearModel) and m.C is not None:
        C = _mat(m.C)
        xlin, ylin = _mat(m.xlin), _mat(m.ylin)

        def y_base(x, u, d, t, py):
            if ylin is not None and xlin is not None:
                return C.to(x) @ (x - xlin.to(x)) + ylin.to(x)  # Utilities.py:216
            if ylin is not None:
                return C.to(x) @ x + ylin.to(x)            # Utilities.py:222
            return C.to(x) @ x                             # Utilities.py:227

    elif not isinstance(m, LinearModel) and m.fy is None and m.C is not None:
        C = _mat(m.C)

        def y_base(x, u, d, t, py):
            return C.to(x) @ x

    else:
        user_fy = None if isinstance(m, LinearModel) else m.fy
        if user_fy is None:
            raise ValueError("model output map missing: provide C, fy, or StateFeedback")

        def y_base(x, u, d, t, py):
            return user_fy(x, u, d, t, py)                 # Utilities.py:232-238

    def fy(x, u, d, t, py):
        out = y_base(x, u, d, t, py)
        if lin:
            out = out + Cd.to(x) @ d
        if lin_par:
            out = out + py                                 # Utilities.py:240-243
        return out

    return ModelFns(fx=fx, fy=fy)


def build_plant(cfg: MPCConfig, model: ModelFns) -> PlantFns:
    """Build (Fx_p, Fy_p) from the config.

    Reference: Utilities.defF_p (Utilities.py:21-100) and dispatch
    MPC_code.py:171-198.  With Fp_nominal the plant aliases the model and is
    called with the *model* signature in the loop (MPC_code.py:532, 814).
    """
    if cfg.Fp_nominal or cfg.plant is None:
        return PlantFns(fx=model.fx, fy=model.fy, nominal=True)

    p = cfg.plant
    lin_par = cfg.LinPar

    if isinstance(p, LinearPlant):
        Ap, Bp = _mat(p.Ap), _mat(p.Bp)

        def fxp(x, u, pxp, t, k, pxmp):
            return Ap.to(x) @ x + Bp.to(x) @ u + pxp + pxmp   # Utilities.py:48

    elif isinstance(p, ContinuousPlant):
        user_fxp, plo, phi = p.fx, p.clip_lo, p.clip_hi

        def fxp_eval(xx, tt, uu, pp, pm):
            # ODE-input saturation (same guard as ContinuousModel; the
            # reference pattern Ex_NMPC_dis.py:75-77)
            return user_fxp(saturate(xx, plo, phi), tt, uu, pp, pm)

        integ = rk4(fxp_eval, p.Mx)

        def fxp(x, u, pxp, t, k, pxmp):
            out = integ(x, t, k, u, pxp, pxmp)                 # Utilities.py:58-75
            if lin_par:
                out = out + pxp + pxmp                         # Utilities.py:78-82
            return out

    elif isinstance(p, DiscretePlant):
        user_map = p.Fx

        def fxp(x, u, pxp, t, k, pxmp):
            out = user_map(x, t, u, pxp, pxmp)                 # Utilities.py:51-56
            if lin_par:
                out = out + pxp + pxmp
            return out

    else:
        raise TypeError(f"unsupported plant spec {type(p)}")

    if cfg.StateFeedback:

        def fyp(x, u, pyp, t, pymp):
            return x                                           # Utilities.py:84-86

    elif isinstance(p, LinearPlant) or p.fy is None:
        Cp = _mat(p.Cp)
        if Cp is None:
            raise ValueError("plant output map missing: provide Cp, fy, or StateFeedback")

        def fyp(x, u, pyp, t, pymp):
            return Cp.to(x) @ x + pyp + pymp                   # Utilities.py:88-91

    else:
        user_fyp = p.fy

        def fyp(x, u, pyp, t, pymp):
            out = user_fyp(x, u, t, pyp, pymp)                 # Utilities.py:93-98
            if lin_par:
                out = out + pyp + pymp
            return out

    return PlantFns(fx=fxp, fy=fyp, nominal=False)


class MHEStep(NamedTuple):
    """The MHE model's map over csi = [x; d] (nx + nd) and the noise w in
    its raw parts, which ``build_mhe_model`` composes in torch and the
    fused stage sweep (``solver/sweep_kernel.py``) lowers: ``fn(x, t, w, d,
    u, px)`` is the model state's ODE (``kind`` "rk4": ``Mx`` RK4 sub-steps
    over the interval, on the state clipped to ``clip_lo``/``clip_hi``) or
    its one-step map (``kind`` "map"), with x, w and d carrying tangents
    and the measured input u and px data; ``terms`` then adds ``Bd d``
    (``Bd`` None unless it is added outside ``fn``) and ``px`` on the
    state's rows (where ``lin_par``), carries d and adds ``G w``."""
    kind: str
    fn: Callable
    Mx: int
    clip_lo: Optional[np.ndarray]
    clip_hi: Optional[np.ndarray]
    Bd: Optional[np.ndarray]
    lin_par: bool
    G: np.ndarray
    nx: int
    nd: int

    def terms(self) -> Callable:
        """``terms(x, d, w, px) -> csi_next`` from the state's step x."""
        Bd, G, lin_par = _mat(self.Bd), _mat(self.G), self.lin_par

        def terms(x, d, w, px):
            if Bd is not None:
                x = x + Bd.to(x) @ d                           # Utilities.py:804-808
            if lin_par:
                x = x + px
            return torch.cat([x, d]) + G.to(x) @ w             # Utilities.py:813-821

        return terms


def mhe_step(cfg: MPCConfig, model: ModelFns) -> MHEStep:
    """The raw parts of the MHE model: the dedicated MHE map
    (``fx_mhe_cont`` by RK4 with ``Mx_mhe`` sub-steps, no guard, or
    ``fx_mhe_dis``), else the controller model (a ContinuousModel's guarded
    RK4, a DiscreteModel's map, or a LinearModel's affine step, which adds
    its own ``Bd d`` and ``px``)."""
    nx, nd, est, m = cfg.nx, cfg.nd, cfg.estimator, cfg.model
    G = (np.eye(nx + nd) if est.G_mhe is None
         else np.asarray(est.G_mhe, float).reshape(nx + nd, -1))
    lin = cfg.dist.offree == "lin"
    Bd = np.asarray(cfg.dist.Bd, float).reshape(nx, nd) if lin and nd else None
    common = dict(clip_lo=None, clip_hi=None, Bd=Bd, lin_par=cfg.LinPar, G=G, nx=nx, nd=nd)
    if est.fx_mhe_cont is not None:
        user_fc = est.fx_mhe_cont

        def ode(x, t, w, d, u, px):
            return user_fc(x, u, d, t, px, w)                  # Utilities.py:746-762

        return MHEStep(kind="rk4", fn=ode, Mx=int(est.Mx_mhe), **common)
    if est.fx_mhe_dis is not None:
        user_fd = est.fx_mhe_dis

        def fmap(x, t, w, d, u, px):
            return user_fd(x, u, d, t, px, w)                  # Utilities.py:776-780

        return MHEStep(kind="map", fn=fmap, Mx=1, **common)
    # the controller model augmented as the main loop does for the other
    # estimators (MPC_code.py:546-558)
    if isinstance(m, ContinuousModel):
        user_fx = m.fx

        def ode(x, t, w, d, u, px):
            return user_fx(x, u, d, t, px)

        return MHEStep(kind="rk4", fn=ode, Mx=int(m.Mx),
                       **dict(common, clip_lo=m.clip_lo, clip_hi=m.clip_hi))
    if isinstance(m, DiscreteModel):
        user_map = m.Fx

        def fmap(x, t, w, d, u, px):
            return user_map(x, u, d, t, px)

        return MHEStep(kind="map", fn=fmap, Mx=1, **common)
    lin_fx, h = model.fx, cfg.h

    def fmap(x, t, w, d, u, px):
        return lin_fx(x, u, h, d, t, px)

    return MHEStep(kind="map", fn=fmap, Mx=1, **dict(common, Bd=None, lin_par=False))


def build_mhe_model(cfg: MPCConfig, model: ModelFns) -> Callable:
    """Augmented-state MHE dynamics ``Fx_mhe(csi, u, k, t, w, px) -> csi_next``
    over csi = [x; d], with the process noise w entering through G
    (Utilities.defFx_mhe, Utilities.py:713-823).

    A dedicated MHE state map (``fx_mhe_cont`` by RK4 with ``Mx_mhe``
    sub-steps, or ``fx_mhe_dis``) is used when the config gives one, with
    ``+ Bd d`` under offree='lin', d carried constant, ``+ G w`` and the
    LinPar term; otherwise the controller model is augmented as the main
    loop does for the other estimators (MPC_code.py:546-558), plus ``G w``.
    The map is composed from ``mhe_step``'s parts, which it carries as
    ``.step``: the fused stage sweep lowers the same parts."""
    st = mhe_step(cfg, model)
    nx, fn, terms = st.nx, st.fn, st.terms()
    if st.kind == "rk4":
        lo, hi = st.clip_lo, st.clip_hi
        integ = rk4(lambda xx, tt, uu, dd, pp, ww: fn(saturate(xx, lo, hi), tt, ww, dd, uu, pp),
                    st.Mx)

        def core(x, u, k, d, t, px, w):
            return integ(x, t, k, u, d, px, w)
    else:
        def core(x, u, k, d, t, px, w):
            return fn(x, t, w, d, u, px)

    def fx_mhe(csi, u, k, t, w, px):
        x1, d1 = csi[:nx], csi[nx:]
        return terms(core(x1, u, k, d1, t, px, w), d1, w, px)

    fx_mhe.step = st
    return fx_mhe
