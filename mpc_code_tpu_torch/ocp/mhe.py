"""The MHE window NLP (port of ``mpc_code_tpu/ocp/mhe.py``).

The reference's `mhe_opt` (Utilities.py:825-990): the decision sequence
w = [x_0, v_0, w_0, ..., x_{N-1}, v_{N-1}, w_{N-1}, x_N] over the augmented
state x = [state; disturbance] (n = nx+nd), measurement residuals
Fy(x_k) + v_k = y_k interleaved with dynamics defects, and the arrival cost
0.5 (x_0 - x_bar)' P^{-1} (x_0 - x_bar).  Parameters are the dict {U (N,m),
Y (N,p), x_bar (n), P_inv (n,n), T (N,), PX (N,npx), PY (N,npy), mask (N,)
(``maskable`` only), Pycondx_inv, Hbig, Obig}.

Two forms of the same problem:

- ``build_mhe_nlp``: the dense NLP, ``f(w, par)`` and ``g(w, par)`` on one
  lane, for the dense IPM (``solver/ipm.py``), which batches over lanes.
- ``build_structured_mhe``: the stagewise form the structured Riccati IPM
  (``solver/riccati.py``) solves, with the measurement noise v eliminated
  through its defining equality.  Its stage functions act on one (lane,
  stage) point; the solver reads the MHE's parameter dict through the
  OCP's ``params`` hook (``_mhe_params`` here), which indexes the window
  stage ``clip(k-1, 0, N-1)`` of structured stage k once per solve, where
  the JAX stage functions index the whole pytree with ``k``.  The window
  carries a ``WindowLowering``: its raw stage cost and rows in the form the
  code generator lowers, and the parts ``build_mhe_model``'s map is
  composed of (``models/model.py::MHEStep``), so the solver takes every
  stage derivative from the fused stage sweep (``solver/sweep_kernel.py``,
  kernel 5 on the card) under both Hessians, as JAX's opt-in route wraps
  the window in ``make_stage_sweep``, and runs the Riccati KKT kernel once
  a pass.  The torch stage functions here stay the plain version's.

``smooth_correction`` (the reference's intended smoothing-update term,
Utilities.py:948-952, which its main loop never reaches) and ``maskable`` (a
per-stage validity mask that expresses every growing-horizon warmup
problem in one fixed shape) are as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.models.model import MHEStep
from mpc_code_tpu_torch.solver.nlp import IPMResult, NLP, STATUS_INFEASIBLE

# per-lane rank of each entry of the MHE's parameter dict
MHE_NDIM = {"U": 2, "Y": 2, "T": 1, "PX": 2, "PY": 2, "mask": 1, "x_bar": 1,
            "P_inv": 2, "Pycondx_inv": 2, "Hbig": 1, "Obig": 2}


@dataclass(frozen=True)
class MHESpec:
    nlp: NLP
    N: int
    n: int
    n_w: int
    p: int
    nxvw: int
    lbw: np.ndarray
    ubw: np.ndarray
    lbg: np.ndarray
    ubg: np.ndarray


def _bounds(cfg: MPCConfig):
    """The MHE's boxes: the augmented state's (x then d), the noises' and
    the outputs' (MPC_code.py:399-404), infinite where not given."""
    nx, nd, p = cfg.nx, cfg.nd, cfg.ny
    n = nx + nd if cfg.dist.offree != "no" else nx
    b = cfg.bounds

    def lohi(lo, hi, size):
        return (np.full(size, -np.inf) if lo is None else np.asarray(lo, float).reshape(-1),
                np.full(size, np.inf) if hi is None else np.asarray(hi, float).reshape(-1))

    xmi, xma = lohi(b.xmin, b.xmax, nx)
    if cfg.dist.offree != "no":
        dmi, dma = lohi(b.dmin, b.dmax, nd)
        xmi, xma = np.concatenate([xmi, dmi]), np.concatenate([xma, dma])
    wmin, wmax = lohi(b.wmin, b.wmax, n)
    vmin, vmax = lohi(b.vmin, b.vmax, p)
    ymin, ymax = lohi(b.ymin, b.ymax, p)
    y_free = b.ymin is None and b.ymax is None
    return n, xmi, xma, wmin, wmax, vmin, vmax, ymin, ymax, y_free


def _where(cond, a, pad):
    """``torch.where`` against a numpy constant in ``a``'s dtype."""
    return torch.where(cond, a, torch.as_tensor(pad, dtype=a.dtype, device=a.device))


def build_mhe_nlp(cfg: MPCConfig, fx_mhe: Callable, fy_es: Callable,
                  f_obj_mhe: Callable, N: int, N_mhe: int,
                  smooth_correction: bool = False,
                  maskable: bool = False) -> MHESpec:
    """The dense MHE NLP (JAX ``ocp/mhe.py:39-161``).  With ``maskable`` the
    pad stages (``par["mask"]`` false, back-aligned) get identity dynamics,
    v pinned to 0 and cost-decoupled w, so the padded optimum is the
    reduced-horizon optimum; with the mask all true the rows select the
    same values as the unmasked build."""
    p = cfg.ny
    n, xmin_mhe, xmax_mhe, wmin, wmax, vmin, vmax, ymin, ymax, y_free = _bounds(cfg)
    n_w = n
    nxv = n + p
    nxvw = nxv + n_w
    n_opt = N * nxvw + n
    idx = N_mhe if N_mhe == 1 else N_mhe - 1
    h = cfg.h

    def unpack(w):
        body = w[: N * nxvw].reshape(N, nxvw)
        X = torch.cat([body[:, :n], w[None, N * nxvw:]], 0)     # (N+1, n)
        return X, body[:, n:n + p], body[:, n + p:]

    if not y_free:
        # a strictly feasible constant for masked-off y-bound rows: any
        # finite point inside the (1.5x loosened) output box
        y_pad = np.clip(np.zeros(p), ymin + 0.5 * ymin + 1e-6, ymax + 0.5 * ymax - 1e-6)

    def g_fn(w, par):
        X, V, W = unpack(w)
        Yk = vmap(fy_es)(X[:N], par["U"], par["T"], par["PY"]) + V
        yres = Yk - par["Y"]                                     # Utilities.py:911-928
        xnext = vmap(fx_mhe, in_dims=(0, 0, None, 0, 0, 0))(
            X[:N], par["U"], h, par["T"], W, par["PX"])
        if maskable:
            mk = par["mask"].to(torch.bool)[:, None]
            # pad stages: v_i = 0 replaces the measurement residual and
            # x_{i+1} = x_i (carrying x_bar to the first valid stage)
            # replaces the dynamics defect
            yres = torch.where(mk, yres, V)
            xnext = torch.where(mk, xnext, X[:N])
        defect = xnext - X[1:]                                   # Utilities.py:930-932
        rows = [torch.cat([yres, defect], 1).reshape(-1)]        # per stage [yres; dyn]
        if not y_free:
            Ybnd = _where(par["mask"].to(torch.bool)[:, None], Yk, y_pad) if maskable else Yk
            rows.append(Ybnd.reshape(-1))                        # Utilities.py:925-926
        return torch.cat(rows)

    def f_fn(w, par):
        X, V, W = unpack(w)
        total = vmap(f_obj_mhe)(W, V, par["T"]).sum()            # Utilities.py:934-936
        dx0 = X[0] - par["x_bar"]
        total = total + 0.5 * dx0 @ (par["P_inv"] @ dx0)         # Utilities.py:944-945
        if smooth_correction and N == N_mhe and idx > 0:
            # Utilities.py:948-952 (never active in the reference's main loop)
            yes = par["Y"][:idx].reshape(-1) - par["Obig"] @ X[0] - par["Hbig"]
            total = total - 0.5 * yes @ (par["Pycondx_inv"] @ yes)
        return total

    ng_eq = N * (p + n)
    ng1 = 0 if y_free else N * p
    lbg = np.zeros(ng_eq + ng1)
    ubg = np.zeros(ng_eq + ng1)
    if ng1:
        # the reference's 1.5x loosened output bounds (Utilities.py:981-982)
        lbg[ng_eq:] = np.tile(ymin + 0.5 * ymin, N)
        ubg[ng_eq:] = np.tile(ymax + 0.5 * ymax, N)
    lbw = np.full(n_opt, -np.inf)
    ubw = np.full(n_opt, np.inf)
    for k in range(N + 1):
        lbw[k * nxvw:k * nxvw + n] = xmin_mhe
        ubw[k * nxvw:k * nxvw + n] = xmax_mhe
    for k in range(N):
        lbw[k * nxvw + n:k * nxvw + nxv] = vmin
        ubw[k * nxvw + n:k * nxvw + nxv] = vmax
        lbw[k * nxvw + nxv:(k + 1) * nxvw] = wmin
        ubw[k * nxvw + nxv:(k + 1) * nxvw] = wmax
    return MHESpec(nlp=NLP(f=f_fn, g=g_fn, nw=n_opt, ng=ng_eq + ng1),
                   N=N, n=n, n_w=n_w, p=p, nxvw=nxvw,
                   lbw=lbw, ubw=ubw, lbg=lbg, ubg=ubg)


# ----------------------------------------------------------------------
# Structured (Riccati) MHE
# ----------------------------------------------------------------------


# the per-point arguments of the window's lowered stage cost and rows after
# (xa, u): the point's window stage's measured input, output, time, output
# parameters and mask, the stage-0 flag, the lane's x_bar and P_inv, and the
# smoothing correction's measurements Yc, Obig, Hbig and Pycondx_inv
WINDOW_ARGS = ("um", "y", "tw", "pyw", "mask", "k0", "x_bar", "P_inv", "Yc", "Obig",
               "Hbig", "Pyc")


class WindowLowering(NamedTuple):
    """The MHE window in the form the fused stage sweep
    (``solver/sweep_kernel.py``) lowers to CUDA: ``step``, the MHE model's
    map over the interval ``h`` (``models/model.py::MHEStep``), the raw
    stage cost ``cost`` and rows ``ineq`` (None when ni = 0) as ``f(xa, u,
    *WINDOW_ARGS)``, in the operations the code generator takes, with both
    sides of every selection evaluated as in the torch functions; the
    widths: the augmented state n (the noise's too), the measured input m,
    the output p, px and py, and the correction's ``n_corr`` measurements
    (its first ``corr_idx`` window stages' outputs; 0 without it)."""
    step: MHEStep
    h: float
    cost: Callable
    ineq: Optional[Callable]
    n: int
    m: int
    p: int
    npx: int
    npy: int
    n_corr: int
    maskable: bool
    kind: str = "mhe"


def _mhe_params(N: int, corr_idx: int):
    """The MHE's ``ParamHook``: per-point dicts for structured stage k of
    window stage ``clip(k-1, 0, N-1)`` (stage 0 is the arrival stage), the
    per-lane x_bar and P_inv, and with the smoothing correction
    (``corr_idx`` > 0) the first ``corr_idx`` measurements, Obig, Hbig
    and Pycondx_inv."""
    from mpc_code_tpu_torch.solver.riccati import ParamHook

    def stage(p, N_s):
        Bsz = p["x_bar"].shape[0]
        dev = p["x_bar"].device
        win = torch.clamp(torch.arange(N_s, device=dev) - 1, 0, N - 1)

        def per(v):
            v = v[:, win]
            return v.reshape((Bsz * N_s,) + tuple(v.shape[2:]))

        def rep(v):
            return v.unsqueeze(1).expand((Bsz, N_s) + tuple(v.shape[1:])).reshape(
                (Bsz * N_s,) + tuple(v.shape[1:]))

        pk = {k: per(p[k]) for k in ("U", "Y", "T", "PX", "PY", "mask") if k in p}
        pk["x_bar"] = rep(p["x_bar"])
        pk["P_inv"] = rep(p["P_inv"])
        pk["k0"] = (torch.arange(N_s, device=dev) == 0).repeat(Bsz)
        if corr_idx:
            pk["Yc"] = rep(p["Y"][:, :corr_idx].reshape(Bsz, -1))
            for k in ("Obig", "Hbig", "Pycondx_inv"):
                pk[k] = rep(p[k])
        return pk

    return ParamHook(MHE_NDIM, stage, lambda p: {})


def build_structured_mhe(cfg: MPCConfig, fx_mhe: Callable, fy_es: Callable,
                         f_obj_mhe: Callable, N: int, N_mhe: int,
                         smooth_correction: bool = False,
                         maskable: bool = False, device=None):
    """Map the MHE NLP onto the stagewise ``StructuredOCP`` form (JAX
    ``ocp/mhe.py:170-392``), on ``device`` (default ``cuda``).  ``fx_mhe``,
    ``fy_es`` and ``f_obj_mhe`` are the maps ``build_mhe_model``,
    ``build_augmented`` and ``build_mhe_cost`` build from ``cfg``; the
    window's ``WindowLowering`` takes its step from ``fx_mhe.step``, the
    parts ``build_mhe_model`` composed it of, and a map without them is
    refused.

    Structured horizon N_s = N + 1.  z_0 is pinned to x_bar; stage 0's
    control is the free initial window state x_0 (dynamics z_1 = u_0, cost
    the arrival penalty, plus the optional smoothing correction, a
    quadratic in x_0); stage k = i+1 has the process noise w_i as its
    control, dynamics ``fx_mhe(z_k, U_i, h, T_i, w, PX_i)`` and cost
    ``f_obj_mhe(w, v_i, T_i)`` with ``v_i = Y_i - fy_es(z_k, U_i, T_i,
    PY_i)`` eliminated.  The window states carry the state box; finite v/w
    boxes and the reference's loosened output-bound rows (data-constant
    rows: they bound fy + v, which the measurement equality pins to Y_i)
    become stage inequality rows, with feasible constants on stage 0 and
    on pad stages, where the mask gives identity dynamics and v = 0.  Both
    sides of every ``torch.where`` are evaluated, as JAX's ``jnp.where``
    does, so the pad constants keep the unused side finite.

    Returns ``(socp, meta)``; ``meta`` holds the layout constants and
    ``v_of``."""
    from mpc_code_tpu_torch.solver.riccati import StructuredOCP, _point_fn

    dev = resolve_device(device)
    p = cfg.ny
    n, xmin_mhe, xmax_mhe, wmin, wmax, vmin, vmax, ymin, ymax, y_free = _bounds(cfg)
    n_w = n
    idx = N_mhe if N_mhe == 1 else N_mhe - 1
    corr = smooth_correction and N == N_mhe and idx > 0
    w_box = np.isfinite(wmin).any() or np.isfinite(wmax).any()
    v_box = np.isfinite(vmin).any() or np.isfinite(vmax).any()
    h = cfg.h

    def _mk(pk):
        # the window stage's validity (every stage without the mask)
        return pk["mask"] if maskable else torch.ones((), dtype=torch.bool,
                                                      device=pk["k0"].device)

    def v_of(z, pk):
        v = pk["Y"] - fy_es(z, pk["U"], pk["T"], pk["PY"])
        if maskable:
            v = torch.where(pk["mask"], v, torch.zeros_like(v))
        return v

    def dyn(z, u, pk):
        xn = fx_mhe(z, pk["U"], h, pk["T"], u, pk["PX"])
        if maskable:
            xn = torch.where(pk["mask"], xn, z)
        return torch.where(pk["k0"], u, xn)

    def cost(z, u, pk):
        du0 = u - pk["x_bar"]
        arrival = 0.5 * du0 @ (pk["P_inv"] @ du0)
        if corr:
            yes = pk["Yc"] - pk["Obig"] @ u - pk["Hbig"]
            arrival = arrival - 0.5 * yes @ (pk["Pycondx_inv"] @ yes)
        return torch.where(pk["k0"], arrival, f_obj_mhe(u, v_of(z, pk), pk["T"]))

    def cost_N(z, pN):
        return torch.zeros((), dtype=z.dtype, device=z.device)

    def _feas_const(lo, hi):
        return np.where(np.isfinite(lo) & np.isfinite(hi), 0.5 * (lo + hi),
                        np.where(np.isfinite(lo), lo + 1.0,
                                 np.where(np.isfinite(hi), hi - 1.0, 0.0)))

    rows_lo, rows_hi, row_fns = [], [], []
    if not y_free:
        ylo, yhi = ymin + 0.5 * ymin, ymax + 0.5 * ymax
        y_pad = _feas_const(ylo, yhi)

        def y_rows(z, u, pk):
            return _where(_mk(pk) & ~pk["k0"], pk["Y"], y_pad)

        rows_lo.append(ylo)
        rows_hi.append(yhi)
        row_fns.append(y_rows)
    if v_box:
        v_pad = _feas_const(vmin, vmax)

        def v_rows(z, u, pk):
            return _where(_mk(pk) & ~pk["k0"],
                          pk["Y"] - fy_es(z, pk["U"], pk["T"], pk["PY"]), v_pad)

        rows_lo.append(vmin)
        rows_hi.append(vmax)
        row_fns.append(v_rows)
    if w_box:
        w_pad = _feas_const(wmin, wmax)

        def w_rows(z, u, pk):
            return _where(~pk["k0"], u, w_pad)

        rows_lo.append(wmin)
        rows_hi.append(wmax)
        row_fns.append(w_rows)
    lbi = np.concatenate(rows_lo) if row_fns else np.zeros(0)
    ubi = np.concatenate(rows_hi) if row_fns else np.zeros(0)
    ni = int(lbi.shape[0])

    # the same cost and rows in the operations the code generator lowers
    # (WindowLowering): the selections by the mask and the stage-0 flag as
    # torch.where of the two sides, the pads as constant tensors
    pads = {}
    if not y_free:
        pads["y"] = torch.as_tensor(y_pad)
    if v_box:
        pads["v"] = torch.as_tensor(v_pad)
    if w_box:
        pads["w"] = torch.as_tensor(w_pad)

    def low_cost(z, u, pk):
        du0 = u - pk["x_bar"]
        arrival = 0.5 * du0 @ (pk["P_inv"] @ du0)
        if corr:
            yes = pk["Yc"] - pk["Obig"] @ u - pk["Hbig"]
            arrival = arrival - 0.5 * yes @ (pk["Pyc"] @ yes)
        v = pk["y"] - fy_es(z, pk["um"], pk["tw"], pk["pyw"])
        if maskable:
            v = torch.where(pk["mask"], v, 0.0)
        return torch.where(pk["k0"], arrival, f_obj_mhe(u, v, pk["tw"]))

    def low_rows(z, u, pk):
        def live(a, pad):
            if maskable:
                a = torch.where(pk["mask"], a, pad)
            return torch.where(pk["k0"], pad, a)

        parts = []
        if not y_free:
            parts.append(live(pk["y"], pads["y"]))
        if v_box:
            parts.append(live(pk["y"] - fy_es(z, pk["um"], pk["tw"], pk["pyw"]), pads["v"]))
        if w_box:
            parts.append(torch.where(pk["k0"], pads["w"], u))
        return torch.cat(parts)

    step = getattr(fx_mhe, "step", None)
    if not isinstance(step, MHEStep):
        raise TypeError("fx_mhe must be build_mhe_model's map: the window's sweep lowers "
                        "the parts it carries as fx_mhe.step")
    lowering = WindowLowering(
        step=step, h=float(h),
        cost=_point_fn(low_cost, WINDOW_ARGS),
        ineq=_point_fn(low_rows, WINDOW_ARGS) if ni else None,
        n=n, m=cfg.nu, p=p, npx=cfg.npx, npy=cfg.npy, n_corr=idx * p if corr else 0,
        maskable=maskable)

    # per-variable scales from the state box (as build_structured_ocp);
    # the noise control shares the state scale
    def _scales(lo, hi):
        mag = np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                         np.abs(np.where(np.isfinite(hi), hi, 0.0)))
        return np.where(mag > 1.0, mag, 1.0)

    sxa = _scales(xmin_mhe, xmax_mhe)
    su = sxa.copy()
    si = _scales(lbi, ubi)

    def _s(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def dyn_s(z, u, pk):
        return dyn(_s(sxa, z) * z, _s(su, u) * u, pk) / _s(sxa, z)

    def cost_s(z, u, pk):
        return cost(_s(sxa, z) * z, _s(su, u) * u, pk)

    def ineq_s(z, u, pk):
        zz, uu = _s(sxa, z) * z, _s(su, u) * u
        return torch.cat([f(zz, uu, pk) for f in row_fns]) / _s(si, z)

    def x0_s(par):
        return par["x_bar"] / _s(sxa, par["x_bar"])

    socp = StructuredOCP(
        N=N + 1, nxa=n, nu=n_w, ni=ni, cost=cost_s, cost_N=cost_N,
        ineq=ineq_s if ni else None, lbi=lbi / si, ubi=ubi / si,
        lbx=xmin_mhe / sxa, ubx=xmax_mhe / sxa,
        lbu=np.full(n_w, -np.inf), ubu=np.full(n_w, np.inf),
        x0_of_p=x0_s, sxa=sxa, su=su, si=si, stage_dyn_jac=None, device=dev,
        dyn=dyn_s, params=_mhe_params(N, idx if corr else 0), lowering=lowering)
    meta = dict(N=N, n=n, n_w=n_w, p=p, nxv=n + p, nxvw=n + p + n_w,
                maskable=maskable, v_of=v_of)
    return socp, meta


def make_structured_mhe_solver(cfg: MPCConfig, fx_mhe: Callable,
                               fy_es: Callable, f_obj_mhe: Callable,
                               N: int, N_mhe: int,
                               smooth_correction: bool = False,
                               maskable: bool = False, opts=None,
                               return_duals: bool = False, device=None):
    """The structured MHE solve with the dense solver's call signature:
    ``solve(w_guess (B, nw), par, lbw, ubw, lbg, ubg, ws=None) ->
    IPMResult`` (the bounds are accepted and ignored: they are built into
    the structured problem), on ``device`` (default ``cuda``).  ``w``
    comes back in the dense flat layout, the eliminated v rebuilt from the
    measurement equality.  ``ws`` is the structured solver's dual/barrier
    warm start; with ``return_duals`` the call returns ``(IPMResult,
    duals)``, the duals for the next solve (shift them one window stage
    first: ``shift_mhe_duals``)."""
    from mpc_code_tpu_torch.solver.riccati import batch_params, make_structured_solver

    socp, meta = build_structured_mhe(cfg, fx_mhe, fy_es, f_obj_mhe, N, N_mhe,
                                      smooth_correction=smooth_correction,
                                      maskable=maskable, device=device)
    struct_solve = make_structured_solver(socp, opts if opts is not None
                                          else cfg.sol_opts_mhe)
    n, nxv, nxvw = meta["n"], meta["nxv"], meta["nxvw"]
    v_of = vmap(meta["v_of"])

    def solve(w_guess, par, lbw=None, ubw=None, lbg=None, ubg=None, ws=None):
        w_guess = torch.as_tensor(w_guess, device=socp.device)
        Bsz = w_guess.shape[0]
        par = batch_params(par, Bsz, w_guess.dtype, socp.device, MHE_NDIM)
        body = w_guess[:, :N * nxvw].reshape(Bsz, N, nxvw)
        Xg_w = torch.cat([body[:, :, :n], w_guess[:, None, N * nxvw:]], 1)   # x_0..x_N
        # structured stages: z = [x_bar, x_0..x_N]; u = [x_0 guess, w_0..w_{N-1}]
        Xg = torch.cat([par["x_bar"][:, None], Xg_w], 1)
        Ug = torch.cat([Xg_w[:, :1], body[:, :, nxv:]], 1)
        rs = struct_solve(par, Xg, Ug, ws=ws)

        Xw, Ww = rs.X[:, 1:], rs.U[:, 1:]                   # x_0..x_N, w_0..w_{N-1}
        pv = {k: par[k].reshape((Bsz * N,) + tuple(par[k].shape[2:]))
              for k in ("Y", "U", "T", "PY", "mask") if k in par}
        Vw = v_of(Xw[:, :N].reshape(Bsz * N, n), pv).reshape(Bsz, N, -1)
        body_o = torch.cat([Xw[:, :N], Vw, Ww], -1).reshape(Bsz, -1)
        w_opt = torch.cat([body_o, Xw[:, N]], -1)
        res = IPMResult(w=w_opt, f=rs.f, lam_g=w_opt.new_zeros((Bsz, 0)),
                        status=rs.status, iters=rs.iters,
                        kkt_err=rs.kkt_err, feas_err=rs.feas_err)
        if not return_duals:
            return res
        duals = dict(zl=rs.zl, zu=rs.zu, lam=rs.lam, nus=rs.nus, mu=rs.mu,
                     sf=rs.sf, ok=rs.status != STATUS_INFEASIBLE)
        return res, duals

    return solve


def mhe_dual_zeros(cfg: MPCConfig, N: int, batch: int = 1, dtype=torch.float64,
                   device=None) -> dict:
    """Zero (cold) dual warm start of the structured MHE solve for ``batch``
    lanes on ``device`` (default ``cuda``): the shapes
    ``make_structured_mhe_solver(return_duals=True)`` returns, with ``ok``
    False so that the solver starts each lane cold."""
    dev = resolve_device(device)
    p = cfg.ny
    n, _, _, wmin, wmax, vmin, vmax, _, _, y_free = _bounds(cfg)
    # the row count of build_structured_mhe's y/v/w rows
    ni = ((0 if y_free else p)
          + (p if (np.isfinite(vmin).any() or np.isfinite(vmax).any()) else 0)
          + (n if (np.isfinite(wmin).any() or np.isfinite(wmax).any()) else 0))
    kw = dict(dtype=dtype, device=dev)
    N_s, nzs = N + 1, n + n + ni
    return dict(zl=torch.zeros((batch, N_s, nzs), **kw),
                zu=torch.zeros((batch, N_s, nzs), **kw),
                lam=torch.zeros((batch, N_s, n), **kw),
                nus=torch.zeros((batch, N_s, ni), **kw),
                mu=torch.zeros(batch, **kw), sf=torch.ones(batch, **kw),
                ok=torch.zeros(batch, dtype=torch.bool, device=dev))


def shift_mhe_duals(d: dict) -> dict:
    """Shift structured-MHE duals (B, N_s, ...) one window stage: structured
    stage k takes over old stage k+1's subproblem for k >= 1, the newest
    stage repeats the last, and the arrival stage keeps its own duals."""
    def sh(a):
        return torch.cat([a[:, :1], a[:, 2:], a[:, -1:]], 1)

    return dict(zl=sh(d["zl"]), zu=sh(d["zu"]), lam=sh(d["lam"]),
                nus=sh(d["nus"]), mu=d["mu"], sf=d["sf"], ok=d["ok"])
