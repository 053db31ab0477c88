"""Typed, declarative configuration for the MPC framework (PyTorch port).

A copy of ``mpc_code_tpu/config.py`` with the same dataclasses and field
names; it imports only numpy, so the port never loads the JAX package.

Replaces the reference's two-level module shadowing (`Default_Values.py`
imported first, example module `import *`'d second, then ~60 reserved names
probed with ``'name' in locals()`` ladders — reference: MPC_code.py:23-28,
94-167, 202-246; Default_Values.py:16-131) with explicit dataclasses and
enums.  Every semantic switch of the reference exists here under the same
name so a reference user can map their example file 1:1.

Model/plant dynamics and user costs are plain Python callables over torch
tensors with the reference's positional signatures:

- continuous model state map   ``fx(x, u, d, t, px) -> dx/dt``
- discrete model state map     ``Fx(x, u, d, t, px) -> x_next``
- model output map             ``fy(x, u, d, t, py) -> y``
- continuous plant state map   ``fx_p(x, t, u, pxp, pxmp) -> dx/dt``
- discrete plant state map     ``Fx_p(x, t, u, pxp, pxmp) -> x_next``
- plant output map             ``fy_p(x, u, t, pyp, pymp) -> y``
- stage / ss / mhe objectives  as in Utilities.defF_obj / defFss_obj /
  defF_obj_mhe; terminal cost ``vfin(x, xs)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

Array = Any  # numpy array or torch tensor


# ---------------------------------------------------------------------------
# Model / plant specifications
# ---------------------------------------------------------------------------


@dataclass
class LinearModel:
    """x+ = A(x-xlin) + B(u-ulin) + xlin ; y = C(x-xlin) + ylin.

    Reference forms: Utilities.py:135-155 (state), 208-230 (output).
    xlin/ulin/ylin optional (pure linear when absent).
    """

    A: Array
    B: Array
    C: Optional[Array] = None
    xlin: Optional[Array] = None
    ulin: Optional[Array] = None
    ylin: Optional[Array] = None


@dataclass
class ContinuousModel:
    """Continuous-time state map integrated with RK4 and ``Mx`` sub-steps.

    Reference form: Utilities.py:157-183 (`User_fxm_Cont` + simpleRK).

    clip_lo/clip_hi optionally saturate the ODE *input* state to a physical
    envelope before evaluating fx — the same numerical-stability guard the
    reference builds into its tank model (`if_else` clipping,
    Ex_NMPC_dis.py:75-77); essential for stiff models (e.g. Arrhenius
    ignition) in f32.
    """

    fx: Callable  # fx(x, u, d, t, px) -> dx/dt
    Mx: int = 10
    fy: Optional[Callable] = None  # fy(x, u, d, t, py) -> y
    C: Optional[Array] = None
    clip_lo: Optional[Array] = None
    clip_hi: Optional[Array] = None


@dataclass
class DiscreteModel:
    """Discrete-time state map. Reference form: Utilities.py:186-198."""

    Fx: Callable  # Fx(x, u, d, t, px) -> x_next
    fy: Optional[Callable] = None
    C: Optional[Array] = None


@dataclass
class LinearPlant:
    """Plant as linear system (reference: Utilities.py:45-49, 88-91)."""

    Ap: Array
    Bp: Array
    Cp: Optional[Array] = None


@dataclass
class ContinuousPlant:
    """Plant as continuous-time ODE (reference: Utilities.py:58-82).

    clip_lo/clip_hi optionally saturate the ODE *input* state before
    evaluating fx — the same stability guard as ContinuousModel (the
    reference's own tank-model pattern, Ex_NMPC_dis.py:75-77); needed for
    stiff plants (Arrhenius ignition) simulated in f32.
    """

    fx: Callable  # fx(x, t, u, pxp, pxmp) -> dx/dt   (note reference arg order)
    Mx: int = 10
    fy: Optional[Callable] = None  # fy(x, u, t, pyp, pymp) -> y
    Cp: Optional[Array] = None
    clip_lo: Optional[Array] = None
    clip_hi: Optional[Array] = None


@dataclass
class DiscretePlant:
    """Plant as discrete-time map (reference: Utilities.py:51-56)."""

    Fx: Callable  # Fx(x, t, u, pxp, pxmp) -> x_next
    fy: Optional[Callable] = None
    Cp: Optional[Array] = None


@dataclass
class DisturbanceModel:
    """Offset-free disturbance model.

    offree: 'no' | 'lin' | 'nl' (reference: Default_Values.py:24,
    Utilities.py:123-130). For 'lin', Bd/Cd inject d into state/output maps.
    For 'nl', d is an extra argument the user maps consume.
    """

    offree: str = "no"
    Bd: Optional[Array] = None
    Cd: Optional[Array] = None


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


@dataclass
class StageCost:
    """Dynamic-optimization stage cost (reference: Utilities.defF_obj:323-381).

    Exactly one family should be set:
    - LP:   r_x with r_u or r_Du    (|x|, |u| weighted one-norms)
    - QP:   Q with R or S           (0.5 x'Qx + 0.5 u'{R|S}u)
    - user: f_cont | f_dis | f_coll (callables (x,u,y,xs,us,ys[,s_coll]))
    Setting r_Du/S selects DUForm (du = u_k - u_{k-1}); Q/r_x select QForm.
    """

    r_x: Optional[Array] = None
    r_u: Optional[Array] = None
    r_Du: Optional[Array] = None
    Q: Optional[Array] = None
    R: Optional[Array] = None
    S: Optional[Array] = None
    f_cont: Optional[Callable] = None
    f_dis: Optional[Callable] = None
    f_coll: Optional[Callable] = None


@dataclass
class SSCost:
    """Steady-state target cost (reference: Utilities.defFss_obj:267-321)."""

    rss_y: Optional[Array] = None
    rss_u: Optional[Array] = None
    rss_Du: Optional[Array] = None
    Qss: Optional[Array] = None
    Rss: Optional[Array] = None
    Sss: Optional[Array] = None
    f_obj: Optional[Callable] = None  # f(x, u, y, xsp, usp, ysp)


@dataclass
class MHECost:
    """MHE stage cost (reference: Utilities.defF_obj_mhe:675-709)."""

    r_w: Optional[Array] = None
    r_v: Optional[Array] = None
    Q: Optional[Array] = None
    R: Optional[Array] = None
    f_obj: Optional[Callable] = None  # f(w, v, t)


@dataclass
class TerminalCost:
    """Terminal cost: user callable, auto-Riccati, or zero.

    Reference: Utilities.defVfin:383-420 (DARE terminal weight when the
    model is linear and the cost quadratic; MPC_code.py:248-257).
    """

    vfin: Optional[Callable] = None  # vfin(x, xs)
    riccati: bool = False  # auto 0.5 x'Px with P from DARE(A,B,Q,R|S)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


@dataclass
class EstimatorConfig:
    """Estimator selection + tuning.

    kind: 'none' | 'kal' | 'ekf' | 'kalss' | 'lue' | 'mhe'
    (reference flags kal/ekf/kalss/lue/mhe, Default_Values.py:109-122).
    """

    kind: str = "none"
    Q_kf: Optional[Array] = None
    R_kf: Optional[Array] = None
    P0: Optional[Array] = None
    K: Optional[Array] = None  # Luenberger / user steady-state gain
    # kalss linearization point (reference: MPC_code.py:346-363)
    x_ss: Optional[Array] = None
    u_ss: Optional[Array] = None
    px_ss: Optional[Array] = None
    py_ss: Optional[Array] = None
    # MHE
    N_mhe: int = 10
    mhe_up: str = "smooth"  # 'filter' | 'smooth'
    G_mhe: Optional[Array] = None  # noise-shaping matrix (default I_{nx+nd})
    fx_mhe_cont: Optional[Callable] = None  # fx(x, u, d, t, px, w) -> dx/dt
    fx_mhe_dis: Optional[Callable] = None   # Fx(x, u, d, t, px, w) -> x_next
    Mx_mhe: int = 10
    mhe_cost: Optional[MHECost] = None
    x_bar0: Optional[Array] = None
    # MHE solver engine: True (default) maps the window NLP onto the
    # stagewise Riccati IPM (ocp/mhe.py::build_structured_mhe — no dense
    # KKT factorization custom-calls on the chip); False keeps the dense
    # IPM, whose converged iterates the structured path matches to solver
    # tolerance.  Applies to MHERuntime and make_mhe_traced alike, so the
    # host loop and the traced loop always run the same engine.
    structured_mhe: bool = True


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def _opt(v):
    return None if v is None else np.asarray(v, dtype=float).reshape(-1)


@dataclass
class Bounds:
    """Box bounds; `_ss`/`_dyn` override the base bounds per problem
    (reference: Default_Values.py:27-79, MPC_code.py:291-304)."""

    umin: Optional[Array] = None
    umax: Optional[Array] = None
    xmin: Optional[Array] = None
    xmax: Optional[Array] = None
    ymin: Optional[Array] = None
    ymax: Optional[Array] = None
    umin_ss: Optional[Array] = None
    umax_ss: Optional[Array] = None
    xmin_ss: Optional[Array] = None
    xmax_ss: Optional[Array] = None
    ymin_ss: Optional[Array] = None
    ymax_ss: Optional[Array] = None
    umin_dyn: Optional[Array] = None
    umax_dyn: Optional[Array] = None
    xmin_dyn: Optional[Array] = None
    xmax_dyn: Optional[Array] = None
    ymin_dyn: Optional[Array] = None
    ymax_dyn: Optional[Array] = None
    dmin: Optional[Array] = None
    dmax: Optional[Array] = None
    Dumin: Optional[Array] = None
    Dumax: Optional[Array] = None
    wmin: Optional[Array] = None
    wmax: Optional[Array] = None
    vmin: Optional[Array] = None
    vmax: Optional[Array] = None
    xpmin: Optional[Array] = None  # plant-state bounds for adaptation NLPs
    xpmax: Optional[Array] = None

    def resolved(self, which: str, name: str):
        """Bound for problem `which` in {'ss','dyn'}: override or base."""
        ov = getattr(self, f"{name}_{which}")
        return _opt(ov if ov is not None else getattr(self, name))


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------


@dataclass
class SolverOptions:
    """NLP solver options (reference: MPC_code.py:261-263, Sol_itmax).

    Field for field the same as the JAX package's ``SolverOptions``; the
    comments there record why each option exists.  The port's structured
    solver implements every option and raises ``NotImplementedError``
    (ROADMAP Queue 1 item 29) only for ``debug``, as does the dense IPM.
    """

    max_iter: int = 100
    tol: float = 1e-8
    mu_init: float = 1e-1
    constr_viol_tol: float = 1e-6
    debug: bool = False
    # 'exact' | 'gauss_newton'
    hessian: str = "exact"
    # 'monotone' | 'adaptive' | 'mehrotra'
    mu_strategy: str = "monotone"
    ls_parallel: bool = False
    # 'adaptive' (rollout-free step-size controller) | 'backtrack'
    ls_mode: str = "adaptive"
    # cold-start equality-multiplier initialization: 'zero' | 'costate'
    dual_init: str = "zero"
    # return the best-KKT iterate when the final one is materially worse
    track_best: bool = True
    # re-linearize every K-th iteration only
    sweep_every: int = 1

    @classmethod
    def for_f32(cls, max_iter: int = 30, hessian: str = "exact",
                **kw) -> "SolverOptions":
        """Tolerances reachable in single precision."""
        kw.setdefault("tol", 1e-3)
        kw.setdefault("constr_viol_tol", 1e-3)
        return cls(max_iter=max_iter, hessian=hessian, **kw)


@dataclass
class MPCConfig:
    # dimensions
    nx: int = 0
    nxp: int = 0
    nu: int = 0
    ny: int = 0
    nd: int = 0

    # simulation fundamentals
    Nsim: int = 100
    N: int = 50
    h: float = 1.0

    # model / plant / disturbance
    model: Any = None           # LinearModel | ContinuousModel | DiscreteModel
    plant: Any = None           # LinearPlant | ContinuousPlant | DiscretePlant | None (nominal)
    Fp_nominal: bool = False
    dist: DisturbanceModel = field(default_factory=DisturbanceModel)
    StateFeedback: bool = False
    LinPar: bool = True

    # initial conditions
    x0_p: Optional[Array] = None
    x0_m: Optional[Array] = None
    u0: Optional[Array] = None
    dhat0: Optional[Array] = None

    # costs
    ss_cost: Optional[SSCost] = None
    stage_cost: Optional[StageCost] = None
    terminal: TerminalCost = field(default_factory=TerminalCost)

    # estimator
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)

    # bounds
    bounds: Bounds = field(default_factory=Bounds)

    # parameter dimensions for LinPar=False (user-sized px/py instead of the
    # additive nx/ny-sized defaults — reference MPC_code.py:36-48)
    npx_user: Optional[int] = None
    npy_user: Optional[int] = None

    # semantic flags (reference Default_Values.py; most are derived from the
    # cost family exactly as MPC_code.py:200-259 derives them)
    estimating: bool = False
    ssjacid: bool = False
    QForm_ss: bool = False
    DUssForm: bool = False
    Adaptation: bool = False
    alpha_mod: float = 0.2
    ContForm: bool = False
    TermCons: bool = False
    QForm: bool = False
    DUForm: bool = False
    DUFormEcon: bool = False
    Collocation: bool = False
    slacks: bool = False
    slacksG: bool = True
    slacksH: bool = True
    Ws: Optional[Array] = None

    # time-varying parameter hooks (reference: MPC_code.py:489-515)
    def_px: Optional[Callable] = None     # t -> px   (model state params)
    def_py: Optional[Callable] = None     # t -> py
    def_pxp: Optional[Callable] = None    # t -> pxp  (plant state params)
    def_pyp: Optional[Callable] = None    # t -> pyp
    def_pxmp: Optional[Callable] = None   # t -> pxmp (measurable plant params)
    def_pymp: Optional[Callable] = None   # t -> pymp

    # setpoint schedule (reference: defSP, e.g. Ex_LMPC_WB.py:77-99)
    defSP: Optional[Callable] = None      # t -> (ysp, usp, xsp)

    # user constraints (reference: MPC_code.py:306-324)
    G_ineq: Optional[Callable] = None     # g(x,u,y,d,t,px,py) <= 0
    H_eq: Optional[Callable] = None       # h(x,u,y,d,t,px,py) == 0
    G_ineq_SS: Optional[Callable] = None
    H_eq_SS: Optional[Callable] = None

    # noise (reference: MPC_code.py:537-541, 823-827)
    R_wn: Optional[Array] = None          # output white-noise covariance
    Q_wn: Optional[Array] = None          # state white-noise covariance
    G_wn: Optional[Array] = None          # state noise shaping matrix
    noise_seed: int = 0

    # solver options
    sol_opts_ss: SolverOptions = field(default_factory=SolverOptions)
    sol_opts_dyn: SolverOptions = field(default_factory=SolverOptions)
    sol_opts_mhe: SolverOptions = field(default_factory=lambda: SolverOptions(tol=1e-10))

    # check-numerics mode (SURVEY.md §5): verify every history array each
    # step instead of the reference's two spot checks (MPC_code.py:671, 819)
    check_numerics: bool = False

    def __post_init__(self):
        self.derive()

    def derive(self):
        """Derive flags from the cost family, mirroring MPC_code.py:200-259."""
        sc = self.stage_cost
        if sc is not None:
            if sc.r_x is not None:
                self.QForm = True
                if sc.r_Du is not None:
                    self.DUForm = True
            elif sc.Q is not None:
                self.QForm = True
                if sc.S is not None and sc.R is None:
                    self.DUForm = True
            elif sc.f_cont is not None:
                self.ContForm = True
        ssc = self.ss_cost
        if ssc is not None:
            if ssc.rss_y is not None and ssc.rss_Du is not None and ssc.rss_u is None:
                self.DUssForm = True
            elif ssc.Qss is not None:
                self.QForm_ss = True
                if ssc.Sss is not None and ssc.Rss is None:
                    self.DUssForm = True
        # Riccati terminal cost default for linear+QP without user vfin
        # (MPC_code.py:248-257).
        if (
            self.terminal.vfin is None
            and not self.terminal.riccati
            and isinstance(self.model, LinearModel)
            and sc is not None
            and sc.Q is not None
        ):
            self.terminal = TerminalCost(riccati=True)
        if self.nxp == 0:
            self.nxp = self.nx

    @property
    def npx(self) -> int:
        # LinPar=True: additive state params sized nx (MPC_code.py:45-48);
        # LinPar=False: user-declared parameter size
        if not self.LinPar and self.npx_user is not None:
            return self.npx_user
        return self.nx

    @property
    def npy(self) -> int:
        if not self.LinPar and self.npy_user is not None:
            return self.npy_user
        return self.ny

    @property
    def npxp(self) -> int:
        return self.nxp

    @property
    def npyp(self) -> int:
        return self.ny

    def replace(self, **kw) -> "MPCConfig":
        return dataclasses.replace(self, **kw)
