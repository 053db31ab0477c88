"""The traced moving-horizon estimator (port of the traced part of
``mpc_code_tpu/estimators/mhe.py``).

The reference's `mhe` (Estimator.py:388-768) with its wiring in the main
loop (MPC_code.py:367-440, 583-641) as one fixed-shape step for a batch of B
lanes: the sliding-window shift with the fictitious-input doubling, the
forward-simulated initial guess, the window NLP solve (the structured
Riccati engine, ``ocp/mhe.py``, or the dense IPM), and the 'filter' or
'smooth' arrival-cost update.  The growing-horizon warmup runs in the same
step from a cold carry (``make_mhe_cold_carry``): a per-stage validity
mask deactivates the window's pad stages while fewer than N_mhe
measurements have arrived.

Layout.  Every field of :class:`MHECarry` (and of its ``sm`` and
``duals``) has a leading batch dimension B; ``steps`` is (B,).  Where the
JAX step selects with ``jnp.where(cond, a, b)`` on one lane (the warmup
mask, the ``full`` gate of the prior update, the dual warm start's
``full_prev`` gate), this one selects per lane.  The model Jacobians of
the prior update are taken by ``jacrev`` (C by ``jacfwd``), as the EKF
does: forward mode through the RK4 sub-steps turns f32 into f64 (ROADMAP
Queue 3, F9).  The 'smooth' update's loops over the window run unrolled
on (B, ., .) tensors, with ``ops/smalllin.py::inv`` (a singular lane gives
NaN for that lane only).

The host ``MHERuntime`` and the hand-off from it (``carry_from_runtime``)
are ROADMAP Queue 1 item 22.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.estimators.linear import build_augmented
from mpc_code_tpu_torch.models.costs import build_mhe_cost
from mpc_code_tpu_torch.models.model import ModelFns, build_mhe_model
from mpc_code_tpu_torch.ocp.mhe import (
    build_mhe_nlp, make_structured_mhe_solver, mhe_dual_zeros, shift_mhe_duals,
)
from mpc_code_tpu_torch.ops.smalllin import inv
from mpc_code_tpu_torch.solver.ipm import make_solver


class MHESmoothState(NamedTuple):
    """Rolling per-stage linearisation buffers of the 'smooth' arrival-cost
    update (length N_mhe-1 stacks; Estimator.py:654-735, the main loop's
    buffers MPC_code.py:417-438), each with a leading B."""

    P_kal: torch.Tensor   # (B,n,n)        bookkeeping-KF prior covariance
    bigA: torch.Tensor    # (B,N-1,n,n)
    bigP: torch.Tensor    # (B,N-1,n,n)    KF priors
    bigPc: torch.Tensor   # (B,N-1,n,n)    KF posteriors
    bigC: torch.Tensor    # (B,N-1,p,n)
    bigG: torch.Tensor    # (B,N-1,n,n_w)
    bigB: torch.Tensor    # (B,N-1,n,m)
    bigf: torch.Tensor    # (B,N-1,n)
    bigh: torch.Tensor    # (B,N-1,p)
    bigQ: torch.Tensor    # (B,N-1,n_w+p,n_w+p)  inverse stage Hessians
    bigU: torch.Tensor    # (B,N-1,m)
    Hbig: torch.Tensor    # (B,p*(N-1))
    Obig: torch.Tensor    # (B,p*(N-1),n)
    Pycondx_inv: torch.Tensor  # (B,p*(N-1),p*(N-1))


class MHECarry(NamedTuple):
    """Sliding-window state of the MHE, every field with a leading B.

    Buffers are back-aligned: during the growing-horizon warmup (steps <
    N_mhe-1) the first slots hold pad values that the window NLP's mask
    deactivates.  ``steps`` counts the completed MHE steps (the
    reference's ksim).  ``duals`` is the
    structured engine's dual/barrier warm start, shifted one window stage
    a step and engaged once the previous solve had a full window (None:
    cold solves, the dense engine)."""

    U: torch.Tensor      # (B,(N-1)*m) post-strip input window
    Y: torch.Tensor      # (B,N*p)
    T: torch.Tensor      # (B,N)
    Xmin: torch.Tensor   # (B,N*n)
    PX: torch.Tensor     # (B,N*npx)
    PY: torch.Tensor     # (B,N*npy)
    X: torch.Tensor      # (B,N*n)   one-step-ahead predictions x(k+1|k)
    V: torch.Tensor      # (B,N*p)   measurement-noise estimates
    W: torch.Tensor      # (B,N*n_w) process-noise estimates
    x_bar: torch.Tensor  # (B,n)     arrival-cost centre
    P: torch.Tensor      # (B,n,n)   arrival-cost covariance
    sm: Any = None       # MHESmoothState (mhe_up='smooth' only)
    steps: Any = None    # (B,) int32 (JAX's None, an always-full window, comes from
                         # the host hand-off, ROADMAP Queue 1 item 22)
    duals: Any = None    # dict zl/zu (B,N+1,nzs), lam (B,N+1,n), nus, mu/sf/ok (B,)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _sel(cond, a, b):
    """Per-lane ``where(cond (B,), a, b)``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def make_mhe_traced(cfg: MPCConfig, model: ModelFns, device=None):
    """The MHE step for a batch, both ``mhe_up`` modes, warmup included.
    Returns ``(step, carry_from_runtime)``:

    - ``step(carry, y_k (B,p), u_k (B,m), xhat_min (B,n), t_k (B,), p_x
      (B,npx), p_y (B,npy), info=None) -> (carry', x_corr (B,n))``: the
      window shift (Estimator.py:475-501), the forward-simulated guess
      (503-512), the window solve (516-530), the solution stacking
      (541-555) and the arrival-cost update: 'filter', one EKF-with-cross-term step on the
      oldest window entries (626-650); 'smooth', the bookkeeping KF with
      the Feng cross-covariance term (558-622), the backward Riccati
      smoother P <- Pis[1] (654-664) and the stacked Abig/Cbig/Qbig/Hbig/
      Obig/Pycondx assembly (686-735).  The prior update engages per lane
      once its window is full.  A dict passed as ``info`` receives the
      window solve's per-lane ``status`` and ``iters`` (the port's own
      addition, for counting the solver's passes).
    - ``carry_from_runtime``: the hand-off from the host ``MHERuntime``,
      not ported (raises, ROADMAP Queue 1 item 22).

    The window solve runs on ``device`` (default ``cuda``), in the carry's
    dtype."""
    dev = resolve_device(device)
    est = cfg.estimator
    if est.mhe_up not in ("filter", "smooth"):
        raise ValueError(f"unknown mhe_up {est.mhe_up!r}")
    smooth = est.mhe_up == "smooth"
    N = est.N_mhe
    if N < 2:
        raise ValueError("make_mhe_traced requires N_mhe >= 2")
    if smooth and N < 3:
        # the reference's stacked-assembly shapes close only for N_mhe >= 3
        # (Estimator.py:697-701)
        raise ValueError("mhe_up='smooth' requires N_mhe >= 3")

    fy_es = build_augmented(cfg, model).fy
    fx_mhe = build_mhe_model(cfg, model)
    f_obj_mhe = build_mhe_cost(est.mhe_cost)
    nx, nd = cfg.nx, cfg.nd
    n = nx + nd if cfg.dist.offree != "no" else nx
    n_w, m, p = n, cfg.nu, cfg.ny
    npx, npy = cfg.npx, cfg.npy
    nxvw = n + p + n_w
    ts = cfg.h
    pidx = p * (N - 1)

    structured = est.structured_mhe
    if structured:
        solve = make_structured_mhe_solver(cfg, fx_mhe, fy_es, f_obj_mhe, N, N,
                                           maskable=True, return_duals=True,
                                           device=dev)
    else:
        spec = build_mhe_nlp(cfg, fx_mhe, fy_es, f_obj_mhe, N, N, maskable=True)
        dense_solve = make_solver(spec.nlp, cfg.sol_opts_mhe)

        def solve(w_guess, par):
            return dense_solve(w_guess, par, spec.lbw, spec.ubw, spec.lbg, spec.ubg)

    v_fx = vmap(fx_mhe, in_dims=(0, 0, None, 0, 0, 0))
    v_jac_x = vmap(jacrev(fx_mhe, argnums=(0, 1, 4)), in_dims=(0, 0, None, 0, 0, 0))
    v_jac_C = vmap(jacfwd(fy_es))
    v_hess_wv = vmap(jacrev(jacrev(lambda wv, t: f_obj_mhe(wv[:n_w], wv[n_w:], t))))

    def step(c: MHECarry, y_k, u_k, xhat_min, t_k, p_x, p_y, info=None):
        Bsz = c.x_bar.shape[0]
        kw = dict(dtype=c.x_bar.dtype, device=c.x_bar.device)
        y_k, u_k, xhat_min, p_x, p_y = (torch.as_tensor(a, **kw).reshape(Bsz, -1)
                                        for a in (y_k, u_k, xhat_min, p_x, p_y))
        t_k = torch.as_tensor(t_k, **kw).reshape(Bsz)

        # growing-horizon warmup (MPC_code.py:591-598): the first N-1 steps
        # mask off the window's leading pad stages
        valid = torch.clamp(c.steps + 1, max=N)                # entries after this shift
        mask = torch.arange(N, device=kw["device"])[None] >= (N - valid)[:, None]
        full = c.steps >= N - 1                                # ksim >= N_mhe-1

        # window shift; the input window ends with the fictitious doubled
        # input [..., u_k, u_k] (Estimator.py:475-501), stripped at the end
        U_s = torch.cat([c.U[:, m:], u_k, u_k], 1)              # (B, N*m)
        Y_n = torch.cat([c.Y[:, p:], y_k], 1)
        T_n = torch.cat([c.T[:, 1:], t_k[:, None]], 1)
        Xmin_n = torch.cat([c.Xmin[:, n:], xhat_min], 1)
        PX_n = torch.cat([c.PX[:, npx:], p_x], 1)
        PY_n = torch.cat([c.PY[:, npy:], p_y], 1)

        # forward-simulated guess from the arrival-cost centre; pad stages
        # hold x_bar (identity dynamics in the masked NLP)
        Um = U_s.reshape(Bsz, N, m)
        PXm = PX_n.reshape(Bsz, N, npx)
        w0 = torch.zeros((Bsz, n_w), **kw)
        xg, Xtail = c.x_bar, []
        for i in range(N):
            xn = v_fx(xg, Um[:, i], ts, T_n[:, i], w0, PXm[:, i])
            xg = _sel(mask[:, i], xn, xg)
            Xtail.append(xg)
        Xg = torch.stack([c.x_bar] + Xtail[:-1], 1)           # stages 0..N-1
        body = torch.cat([Xg, torch.zeros((Bsz, N, nxvw - n), **kw)], -1)
        w_guess = torch.cat([body.reshape(Bsz, -1), xg], 1)

        # the window NLP is built without the smoothing correction (as in
        # JAX's traced step), so Pycondx_inv, Hbig and Obig are not read
        par = dict(U=Um, Y=Y_n.reshape(Bsz, N, p), x_bar=c.x_bar, P_inv=inv(c.P),
                   T=T_n, mask=mask, PX=PXm, PY=PY_n.reshape(Bsz, N, npy))
        if structured:
            ws_in = None
            if c.duals is not None:
                # the dual warm start engages once the PREVIOUS solve had a
                # full window (the host runtime solves cold through its
                # per-horizon warmup)
                ws_in = {**c.duals, "ok": c.duals["ok"] & (c.steps >= N)}
            res, duals_raw = solve(w_guess, par, ws=ws_in)
            duals_out = shift_mhe_duals(duals_raw) if c.duals is not None else None
        else:
            res = solve(w_guess, par)
            duals_out = None
        w_opt = res.w
        if info is not None:
            info.update(status=res.status, iters=res.iters)

        xkp1k = w_opt[:, -n:]
        xhat_corr = w_opt[:, -n - nxvw:-nxvw]
        v_k = w_opt[:, -nxvw:-n - n_w]
        w_k = w_opt[:, -n - n_w:-n]
        X_n = torch.cat([c.X[:, n:], xkp1k], 1)
        V_n = torch.cat([c.V[:, p:], v_k], 1)
        W_n = torch.cat([c.W[:, n_w:], w_k], 1)

        if smooth:
            P_new, x_bar_n, sm_n = _smooth_update(
                c, full, w_opt, xhat_corr, xkp1k, v_k, w_k, y_k, u_k, t_k, p_x, p_y)
        else:
            # 'filter' update from the OLDEST window entries
            # (Estimator.py:626-650); during the warmup the prior passes
            # through unchanged (the reference's ksim >= N_mhe-1 guard)
            H0 = inv(v_hess_wv(torch.cat([W_n[:, :n_w], V_n[:, :p]], 1), T_n[:, 0]))
            Q0, R0, S0 = H0[:, :n_w, :n_w], H0[:, -p:, -p:], H0[:, :n_w, -p:]
            C0 = v_jac_C(Xmin_n[:, :n], U_s[:, :m], T_n[:, 0], PY_n[:, :npy])
            K0 = c.P @ C0.mT @ inv(C0 @ c.P @ C0.mT + R0)
            P_corr = c.P - K0 @ C0 @ c.P
            A0, _, G0 = v_jac_x(X_n[:, :n], U_s[:, :m], ts, T_n[:, 0], W_n[:, :n_w],
                                PX_n[:, :npx])
            M0 = -K0 @ S0.mT
            P_new = _sel(full, A0 @ P_corr @ A0.mT + G0 @ Q0 @ G0.mT
                         + A0 @ M0 @ G0.mT + G0 @ M0 @ A0.mT, c.P)
            x_bar_n = _sel(full, X_n[:, :n], c.x_bar)
            sm_n = None

        c_out = MHECarry(U=U_s[:, :-m], Y=Y_n, T=T_n, Xmin=Xmin_n, PX=PX_n, PY=PY_n,
                         X=X_n, V=V_n, W=W_n, x_bar=x_bar_n, P=P_new, sm=sm_n,
                         steps=c.steps + 1, duals=duals_out)
        return c_out, xhat_corr

    def _smooth_update(c, full, w_opt, xhat_corr, xkp1k, v_k, w_k, y_k, u_k, t_k,
                       p_x, p_y):
        """The 'smooth' update: the bookkeeping KF with the Feng
        cross-covariance term (Estimator.py:558-622), the backward Riccati
        smoother (654-664) and the stacked correction matrices (686-735).
        The KF and the rolling buffers update on every step (the reference
        appends them from ksim=0); the smoother, the stacked assembly and
        the P/x_bar prior updates engage once the lane's window is full."""
        sm = c.sm
        Bsz = w_opt.shape[0]
        kw = dict(dtype=w_opt.dtype, device=w_opt.device)
        # current-stage linearisation
        Hd = v_hess_wv(torch.cat([w_k, v_k], 1), t_k)
        H_k = inv(Hd)
        Q_k, R_k, S_k = H_k[:, :n_w, :n_w], H_k[:, -p:, -p:], H_k[:, :n_w, -p:]
        R_kk = inv(Hd[:, -p:, -p:])                         # Estimator.py:565-566
        C_k = v_jac_C(xhat_corr, u_k, t_k, p_y)
        h_k = y_k - _mv(C_k, xhat_corr) - v_k
        A_k, B_k, G_k = v_jac_x(xhat_corr, u_k, ts, t_k, w_k, p_x)
        f_k = xkp1k - _mv(A_k, xhat_corr) - _mv(B_k, u_k) - _mv(G_k, w_k)

        # bookkeeping KF step (Estimator.py:590-607)
        K_k = sm.P_kal @ C_k.mT @ inv(C_k @ sm.P_kal @ C_k.mT + R_k)
        P_corr_kal = sm.P_kal - K_k @ C_k @ sm.P_kal
        M_k = -K_k @ S_k.mT
        P_kal_n = (A_k @ P_corr_kal @ A_k.mT + G_k @ Q_k @ G_k.mT
                   + A_k @ M_k @ G_k.mT + G_k @ M_k @ A_k.mT)

        # the current stage appended: full-window views (N stages)
        bigA_f = torch.cat([sm.bigA, A_k[:, None]], 1)
        bigP_f = torch.cat([sm.bigP, sm.P_kal[:, None]], 1)
        bigPc_f = torch.cat([sm.bigPc, P_corr_kal[:, None]], 1)

        # backward Riccati smoother (Estimator.py:654-664), down to Pis[1]
        Pis = bigPc_f[:, N - 1]
        for i in range(N - 2, 0, -1):
            Pim = inv(bigP_f[:, i + 1])
            Pc, A = bigPc_f[:, i], bigA_f[:, i]
            Pis = Pc + Pc @ A.mT @ Pim @ (Pis - bigP_f[:, i + 1]) @ Pim @ A @ Pc
        P_new = _sel(full, Pis, c.P)

        # shift-one-forward rolling buffers (Estimator.py:671-684)
        def roll(big, new):
            return torch.cat([big[:, 1:], new[:, None]], 1)

        bigC_n, bigG_n, bigB_n = roll(sm.bigC, C_k), roll(sm.bigG, G_k), roll(sm.bigB, B_k)
        bigf_n, bigh_n = roll(sm.bigf, f_k), roll(sm.bigh, h_k)
        bigQ_n, bigU_n = roll(sm.bigQ, H_k), roll(sm.bigU, u_k)
        bigA_n = bigA_f[:, 1:]

        # stacked matrices of the smoothing correction over the shifted
        # window (Estimator.py:686-735)
        nvars = n + (N - 2) * n_w + (N - 1) * p
        eye_p = torch.eye(p, **kw).expand(Bsz, p, p)
        Hbig = torch.zeros((Bsz, pidx), **kw)
        Cbig = torch.zeros((Bsz, pidx, nvars), **kw)
        Cbig[:, :p, :n + n_w + p] = torch.cat(
            [bigC_n[:, 0], torch.zeros((Bsz, p, n_w), **kw), eye_p], -1)
        Hbig[:, :p] = bigh_n[:, 0]
        Arow = torch.eye(n, **kw).expand(Bsz, n, n)
        Hrow = None
        for i in range(N - 2):
            Apad = torch.zeros((Bsz, n, 0 if i == 0 else p), **kw)
            Arow = torch.cat([bigA_n[:, i] @ Arow, Apad, bigG_n[:, i]], -1)
            Cpad = torch.zeros((Bsz, p, p if i == N - 3 else n_w + p), **kw)
            Crow = torch.cat([bigC_n[:, i + 1] @ Arow, Cpad, eye_p], -1)
            Cbig[:, (i + 1) * p:(i + 2) * p, :Crow.shape[-1]] = Crow
            Bu = _mv(bigB_n[:, i], bigU_n[:, i]) + bigf_n[:, i]
            Hrow = Bu if i == 0 else _mv(bigA_n[:, i], Hrow) + Bu
            Hbig[:, (i + 1) * p:(i + 2) * p] = _mv(bigC_n[:, i + 1], Hrow) + bigh_n[:, i + 1]
        # Qbig = blockdiag(P, bigQ_n[0..N-3], R_kk); its (v, w) part QRbig
        # drops the P block
        sizes = [n_w + p] * (N - 2) + [p]
        QRbig = torch.zeros((Bsz, sum(sizes), sum(sizes)), **kw)
        off = 0
        for j, blk in enumerate([bigQ_n[:, i] for i in range(N - 2)] + [R_kk]):
            QRbig[:, off:off + sizes[j], off:off + sizes[j]] = blk
            off += sizes[j]
        Obig, Gbig = Cbig[:, :, :n], Cbig[:, :, n:]
        Pycondx_inv = inv(Gbig @ QRbig @ Gbig.mT)

        x_bar_n = _sel(full, w_opt[:, nxvw:nxvw + n], c.x_bar)   # Estimator.py:749-752
        sm_n = MHESmoothState(
            P_kal=P_kal_n, bigA=bigA_n, bigP=bigP_f[:, 1:], bigPc=bigPc_f[:, 1:],
            bigC=bigC_n, bigG=bigG_n, bigB=bigB_n, bigf=bigf_n, bigh=bigh_n,
            bigQ=bigQ_n, bigU=bigU_n,
            Hbig=_sel(full, Hbig, sm.Hbig), Obig=_sel(full, Obig, sm.Obig),
            Pycondx_inv=_sel(full, Pycondx_inv, sm.Pycondx_inv))
        return P_new, x_bar_n, sm_n

    def carry_from_runtime(rt, P_k) -> MHECarry:
        raise NotImplementedError(
            "carry_from_runtime needs the host MHERuntime, which is not ported "
            "yet (ROADMAP Queue 1 item 22); start from make_mhe_cold_carry")

    return step, carry_from_runtime


def make_mhe_cold_carry(cfg: MPCConfig, px0=None, py0=None, t0=0.0, u_pad=None,
                        batch: int = 1, device=None, dtype=torch.float64) -> MHECarry:
    """The cold (step-0) :class:`MHECarry` of ``batch`` lanes on ``device``
    (default ``cuda``): the window back-aligned with pad values (x_bar in
    the state slots, identity covariance stacks, the config's u0 in the
    input slots) and ``steps`` 0, so that the step's mask deactivates the
    pad stages through the growing-horizon warmup (MPC_code.py:591-598,
    Estimator.py:475-512).  x_bar0 and P0 as ``MHERuntime.__init__``."""
    dev = resolve_device(device)
    est = cfg.estimator
    N = est.N_mhe
    nx, nd = cfg.nx, cfg.nd
    n = nx + nd if cfg.dist.offree != "no" else nx
    n_w, m, p = n, cfg.nu, cfg.ny
    npx, npy = cfg.npx, cfg.npy
    pidx = p * (N if N == 1 else N - 1)

    def vec(v, size):
        return np.zeros(size) if v is None else np.asarray(v, float).reshape(size)

    x_bar = est.x_bar0
    if x_bar is None:
        x_bar = np.concatenate([vec(cfg.x0_m, nx), vec(cfg.dhat0, nd)])[:n]
    x_bar = vec(x_bar, n)
    P0 = np.asarray(est.P0, float) if est.P0 is not None else np.eye(n)
    u_pad = vec(cfg.u0 if u_pad is None else u_pad, m)
    px0, py0 = vec(px0, npx), vec(py0, npy)
    eye_n = np.tile(np.eye(n), (N - 1, 1, 1))
    lane = dict(U=np.tile(u_pad, N - 1), Y=np.zeros(N * p), T=np.full(N, float(t0)),
                Xmin=np.tile(x_bar, N), PX=np.tile(px0, N), PY=np.tile(py0, N),
                X=np.tile(x_bar, N), V=np.zeros(N * p), W=np.zeros(N * n_w),
                x_bar=x_bar, P=P0)
    kw = dict(dtype=dtype, device=dev)

    def lanes(a):
        a = torch.as_tensor(np.asarray(a, float), **kw)
        return a.expand((batch,) + tuple(a.shape)).clone()

    sm = None
    if est.mhe_up == "smooth":
        sm = MHESmoothState(
            P_kal=lanes(P0), bigA=lanes(eye_n), bigP=lanes(eye_n), bigPc=lanes(eye_n),
            bigC=lanes(np.zeros((N - 1, p, n))), bigG=lanes(np.zeros((N - 1, n, n_w))),
            bigB=lanes(np.zeros((N - 1, n, m))), bigf=lanes(np.zeros((N - 1, n))),
            bigh=lanes(np.zeros((N - 1, p))),
            # identity inverse-Hessian pads keep the (discarded) warmup
            # assembly's inversions well posed
            bigQ=lanes(np.tile(np.eye(n_w + p), (N - 1, 1, 1))),
            bigU=lanes(np.tile(u_pad, (N - 1, 1))),
            Hbig=lanes(np.zeros(pidx)), Obig=lanes(np.zeros((pidx, n))),
            Pycondx_inv=lanes(np.zeros((pidx, pidx))))
    duals = (mhe_dual_zeros(cfg, N, batch=batch, dtype=dtype, device=dev)
             if est.structured_mhe else None)
    return MHECarry(**{k: lanes(v) for k, v in lane.items()}, sm=sm,
                    steps=torch.zeros(batch, dtype=torch.int32, device=dev),
                    duals=duals)
