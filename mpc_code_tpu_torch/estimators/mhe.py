"""The moving-horizon estimator (port of ``mpc_code_tpu/estimators/mhe.py``).

The reference's `mhe` (Estimator.py:388-768) with its wiring in the main
loop (MPC_code.py:367-440, 583-641), in two forms:

- ``MHERuntime``, the host runtime the per-sample loop ``ClosedLoop``
  drives: flat numpy f64 window buffers with the fictitious-input
  doubling, a forward-simulated guess, one window NLP per horizon length
  through the growing-horizon warmup (``_solvers[N]``, built once each;
  the structured Riccati engine of ``ocp/mhe.py`` or the dense IPM), the
  dual warm start across full-window structured solves, the bookkeeping
  Kalman filter with the Feng cross-covariance term, and the 'filter' /
  'smooth' arrival-cost updates in numpy/scipy between solves ('smooth'
  through the native backward Riccati smoother of ``native.py`` when it
  is built, else the same recursion in numpy).  The model maps, their
  derivatives and the solves run in torch on the runtime's device and
  dtype; what they return comes back to the host as f64.
- ``make_mhe_traced``, one fixed-shape step for a batch of B lanes, which
  the batched loop runs: the window shift, the guess, the window solve
  and the 'filter' or 'smooth' update as (B, ...) tensor algebra.  The
  growing-horizon warmup runs in the same step from a cold carry
  (``make_mhe_cold_carry``): a per-stage validity mask deactivates the
  window's pad stages while fewer than N_mhe measurements have arrived.
  ``carry_from_runtime`` hands a warmed ``MHERuntime`` over to it.

Layout of the traced step.  Every field of :class:`MHECarry` (and of its
``sm`` and ``duals``) has a leading batch dimension B; ``steps`` is (B,),
or None for the always-full window that only the hand-off produces.
Where the JAX step selects with ``jnp.where(cond, a, b)`` on one lane (the
warmup mask, the ``full`` gate of the prior update, the dual warm start's
``full_prev`` gate), this one selects per lane.  The model Jacobians of
the prior update are taken by ``jacrev`` (C by ``jacfwd``), as the EKF
does, in both forms: forward mode through the RK4 sub-steps turns f32 into
f64 (ROADMAP Queue 3, F9).  The 'smooth' update's loops over the window
run unrolled on (B, ., .) tensors, with ``ops/smalllin.py::inv`` (a
singular lane gives NaN for that lane only).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import scipy.linalg as scla
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


class MHERuntime:
    """The host MHE (JAX ``estimators/mhe.py:35-377``), driven by
    ``ClosedLoop`` one sample at a time: ``step(ksim, y_k, u_k, xhat_min,
    t_k, p_x, p_y, P_k) -> (x_corr, P_plus)``, numpy in and out.

    Runs its torch work on ``device`` (default ``cuda``) in ``dtype``.
    ``last_nlp`` keeps the latest window NLP's inputs, and (the port's
    own) ``last_status`` and ``last_iters`` the latest window solve's
    status and iterations."""

    def __init__(self, cfg: MPCConfig, model: ModelFns, device=None,
                 dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = dtype
        est = cfg.estimator
        self.cfg = cfg
        self.N_mhe = est.N_mhe
        self.up = est.mhe_up
        self.h = cfg.h

        self.fy_es = build_augmented(cfg, model).fy
        self.fx_mhe = build_mhe_model(cfg, model)     # (csi, u, k, t, w, px)
        self.f_obj_mhe = build_mhe_cost(est.mhe_cost)

        nx, nd = cfg.nx, cfg.nd
        self.n = nx + nd if cfg.dist.offree != "no" else nx
        n = self.n
        self.n_w = n
        self.m = cfg.nu
        self.p = cfg.ny
        self.npx, self.npy = cfg.npx, cfg.npy
        self.nxvw = n + self.p + self.n_w
        self.idx = self.N_mhe if self.N_mhe == 1 else self.N_mhe - 1

        # derivatives (reference: CasADi jacobians, Estimator.py:446-472):
        # A, B, G and the stage Hessian by reverse mode (F9), C forward
        n_w = self.n_w
        self._jac_x = jacrev(self.fx_mhe, argnums=(0, 1, 4))
        self._C = jacfwd(self.fy_es)
        self._hess = jacrev(jacrev(lambda wv, t: self.f_obj_mhe(wv[:n_w], wv[n_w:], t)))

        # persistent buffers (flat, reference layout)
        self.U = np.zeros(0)
        self.Y = np.zeros(0)
        self.T = np.zeros(0)
        self.Xmin = np.zeros(0)
        self.X = np.zeros(0)
        self.V = np.zeros(0)
        self.W = np.zeros(0)
        self.PX = np.zeros(0)
        self.PY = np.zeros(0)
        self.w_k = np.zeros(self.n_w)
        self.v_k = np.zeros(self.p)

        x_bar0 = est.x_bar0
        if x_bar0 is None:
            dh = np.zeros(nd) if cfg.dhat0 is None else np.asarray(cfg.dhat0, float).reshape(-1)
            x_bar0 = np.concatenate([np.asarray(cfg.x0_m, float).reshape(-1), dh])[:n]
        self.x_bar = np.asarray(x_bar0, float).reshape(n)

        P0 = np.asarray(est.P0, float) if est.P0 is not None else np.eye(n)
        self.P_k_kal = P0.copy()
        self.P_corr_kal = P0.copy()
        self.xm_kal = self.x_bar.copy()
        self._xm_init = False

        # smoothing big-matrix state (MPC_code.py:417-438)
        self.bigC, self.bigG, self.bigA, self.bigB = [], [], [], []
        self.bigf, self.bigh, self.bigQk, self.bigRk, self.bigSk = [], [], [], [], []
        self.bigQ, self.bigU, self.bigP, self.bigPc = [], [], [], []
        pidx = self.p * self.idx
        self.Hbig = np.zeros(pidx)
        self.Obig = np.zeros((pidx, n))
        self.Pycondx_inv = np.zeros((pidx, pidx))

        self._solvers: Dict[int, tuple] = {}
        # dual/barrier warm start across full-window structured solves (one
        # lane on the device; None until the first full-window solve)
        self._duals = None
        self.last_nlp: dict = {}
        self.last_status = self.last_iters = None

    # ------------------------------------------------------------------
    def _T(self, a):
        return torch.as_tensor(np.asarray(a, float), dtype=self.dtype, device=self.device)

    @staticmethod
    def _np(t):
        return t.detach().to("cpu", torch.float64).numpy()

    def _solver(self, N: int):
        """The window NLP and its solve at horizon ``N``, built once."""
        if N not in self._solvers:
            cfg = self.cfg
            spec = build_mhe_nlp(cfg, self.fx_mhe, self.fy_es, self.f_obj_mhe, N, self.N_mhe)
            if cfg.estimator.structured_mhe:
                solve = make_structured_mhe_solver(
                    cfg, self.fx_mhe, self.fy_es, self.f_obj_mhe, N, self.N_mhe,
                    return_duals=N == self.N_mhe, device=self.device)
            else:
                solve = make_solver(spec.nlp, cfg.sol_opts_mhe)
            self._solvers[N] = (spec, solve)
        return self._solvers[N]

    # ------------------------------------------------------------------
    def step(self, ksim: int, y_k, u_k, xhat_min, t_k, p_x, p_y, P_k):
        """One MHE estimation step; returns (x_corr, P_plus) as numpy."""
        n, n_w, m, p = self.n, self.n_w, self.m, self.p
        npx, npy = self.npx, self.npy
        N_mhe, nxvw = self.N_mhe, self.nxvw
        ts = self.h
        T_ = self._T
        y_k = np.asarray(y_k, float).reshape(p)
        u_k = np.asarray(u_k, float).reshape(m)
        xhat_min = np.asarray(xhat_min, float).reshape(n)
        p_x = np.asarray(p_x, float).reshape(npx)
        p_y = np.asarray(p_y, float).reshape(npy)
        P_k = np.asarray(P_k, float).reshape(n, n)
        if not self._xm_init:
            self.xm_kal = xhat_min.copy()            # MPC_code.py:586-587
            self._xm_init = True

        N = min(ksim + 1, N_mhe)

        # -- data stacking (Estimator.py:475-501)
        if ksim < N_mhe:
            if ksim == 0:
                self.U = np.concatenate([self.U, u_k])
            else:
                self.U = np.concatenate([self.U, u_k, u_k])  # fictitious double
            self.Y = np.concatenate([self.Y, y_k])
            self.T = np.concatenate([self.T, [t_k]])
            self.Xmin = np.concatenate([self.Xmin, xhat_min])
            self.PX = np.concatenate([self.PX, p_x])
            self.PY = np.concatenate([self.PY, p_y])
        else:
            if N_mhe == 1:
                self.U, self.Y, self.T = u_k.copy(), y_k.copy(), np.array([t_k])
                self.Xmin, self.PX, self.PY = xhat_min.copy(), p_x.copy(), p_y.copy()
            else:
                self.U = np.concatenate([self.U[m:], u_k, u_k])
                self.Y = np.concatenate([self.Y[p:], y_k])
                self.T = np.concatenate([self.T[1:], [t_k]])
                self.Xmin = np.concatenate([self.Xmin[n:], xhat_min])
                self.PX = np.concatenate([self.PX[npx:], p_x])
                self.PY = np.concatenate([self.PY[npy:], p_y])

        # -- forward-simulated initial guess (Estimator.py:503-512), chained
        # on the device and read back once
        Ut, Tt, PXt = T_(self.U), T_(self.T), T_(self.PX)
        w0 = torch.zeros(n_w, dtype=self.dtype, device=self.device)
        xg = T_(self.x_bar)
        Xg = [xg]
        for key in range(N):
            xg = self.fx_mhe(xg, Ut[key * m:(key + 1) * m], ts, Tt[key], w0,
                             PXt[key * npx:(key + 1) * npx])
            Xg.append(xg)
        Xg = self._np(torch.stack(Xg))
        w_guess = np.zeros(N * nxvw + n)
        for key in range(N):
            w_guess[key * nxvw:key * nxvw + n] = Xg[key]
        w_guess[N * nxvw:] = Xg[N]

        # -- solve (Estimator.py:516-530)
        P_k_inv = scla.inv(P_k)
        spec, solve = self._solver(N)
        par = dict(U=self.U[:N * m].reshape(N, m), Y=self.Y.reshape(N, p),
                   x_bar=self.x_bar, P_inv=P_k_inv, T=self.T,
                   PX=self.PX.reshape(N, npx), PY=self.PY.reshape(N, npy),
                   Pycondx_inv=self.Pycondx_inv, Hbig=self.Hbig, Obig=self.Obig)
        # keep the latest NLP inputs for independent solver-parity tests
        self.last_nlp = dict(w0=w_guess.copy(), N=N,
                             par={k: np.array(v) for k, v in par.items()})
        par_t = {k: T_(v)[None] for k, v in par.items()}
        if self.cfg.estimator.structured_mhe and N == N_mhe:
            # full-window structured solve: dual/barrier warm start carried
            # across steps (shifted one window stage), cold while any
            # previous solve was a warmup horizon; the traced step's gate
            # (steps >= N_mhe) mirrors this
            res, duals = solve(T_(w_guess)[None], par_t, ws=self._duals)
            self._duals = shift_mhe_duals(duals)
        else:
            res = solve(T_(w_guess)[None], par_t, spec.lbw, spec.ubw, spec.lbg, spec.ubg)
        w_opt = self._np(res.w[0])
        self.last_status, self.last_iters = int(res.status[0]), int(res.iters[0])

        xkp1k = w_opt[-n:]
        xhat_corr = w_opt[-n - nxvw:-nxvw]                  # Estimator.py:532-534
        self.v_k = w_opt[-nxvw:-n - n_w]
        if ksim != 0 and N_mhe != 1:
            self.w_k = w_opt[-n - n_w:-n]                   # Estimator.py:537-538

        # -- stack solution data (Estimator.py:541-555)
        if ksim < N_mhe:
            self.X = np.concatenate([self.X, xkp1k])
            self.V = np.concatenate([self.V, self.v_k])
            self.W = np.concatenate([self.W, self.w_k])
        else:
            if N_mhe == 1:
                self.X, self.V, self.W = xkp1k.copy(), self.v_k.copy(), self.w_k.copy()
            else:
                self.X = np.concatenate([self.X[n:], xkp1k])
                self.V = np.concatenate([self.V[p:], self.v_k])
                self.W = np.concatenate([self.W[n_w:], self.w_k])

        # -- per-step KF bookkeeping with cross-covariance (Estimator.py:558-622)
        tk, uk, wk = T_(t_k), T_(u_k), T_(self.w_k)
        Hd = self._np(self._hess(T_(np.concatenate([self.w_k, self.v_k])), tk))
        H_k = scla.inv(Hd)
        Q_k = H_k[:n_w, :n_w]
        R_k = H_k[-p:, -p:]
        S_k = H_k[:n_w, -p:]
        R_kk = scla.inv(Hd[-p:, -p:])                        # Estimator.py:565-566

        xc_t, px_t, py_t = T_(xhat_corr), T_(p_x), T_(p_y)
        C_k = self._np(self._C(xc_t, uk, tk, py_t))
        h_k = self.Y[-p:] - C_k @ xhat_corr - self.v_k
        A_k, B_k, G_k = (self._np(a) for a in self._jac_x(xc_t, uk, ts, tk, wk, px_t))
        f_k = xkp1k - A_k @ xhat_corr - B_k @ u_k - G_k @ self.w_k

        inbr = scla.inv(C_k @ self.P_k_kal @ C_k.T + R_k)
        K_k = self.P_k_kal @ C_k.T @ inbr
        self.P_corr_kal = self.P_k_kal - K_k @ C_k @ self.P_k_kal
        Pi = self.P_k_kal.copy()
        yhat = self._np(self.fy_es(T_(self.xm_kal), uk, tk, py_t))
        xc_kal = self.xm_kal + K_k @ (y_k - yhat)
        self.xm_kal = self._np(self.fx_mhe(T_(xc_kal), uk, ts, tk, wk, px_t))
        M_k = -K_k @ S_k.T
        self.P_k_kal = (A_k @ self.P_corr_kal @ A_k.T + G_k @ Q_k @ G_k.T
                        + A_k @ M_k @ G_k.T + G_k @ M_k @ A_k.T)  # Estimator.py:604-607

        self.bigC.append(C_k); self.bigG.append(G_k); self.bigA.append(A_k)  # noqa: E702
        self.bigB.append(B_k); self.bigf.append(f_k); self.bigh.append(h_k)  # noqa: E702
        self.bigQk.append(Q_k); self.bigRk.append(R_k); self.bigSk.append(S_k)  # noqa: E702
        self.bigQ.append(H_k); self.bigU.append(u_k)  # noqa: E702
        self.bigP.append(Pi); self.bigPc.append(self.P_corr_kal.copy())  # noqa: E702

        # -- prior weight update (Estimator.py:626-735)
        if ksim >= N_mhe - 1:
            if self.up == "filter":
                Hd0 = self._np(self._hess(T_(np.concatenate([self.W[:n_w], self.V[:p]])),
                                          T_(self.T[0])))
                H0 = scla.inv(Hd0)
                Q0, R0, S0 = H0[:n_w, :n_w], H0[-p:, -p:], H0[:n_w, -p:]
                C0 = self._np(self._C(T_(self.Xmin[:n]), T_(self.U[:m]), T_(self.T[0]),
                                      T_(self.PY[:npy])))
                inbr0 = scla.inv(C0 @ P_k @ C0.T + R0)
                K0 = P_k @ C0.T @ inbr0
                P_corr = P_k - K0 @ C0 @ P_k
                A0, _, G0 = (self._np(a) for a in self._jac_x(
                    T_(self.X[:n]), T_(self.U[:m]), ts, T_(self.T[0]), T_(self.W[:n_w]),
                    T_(self.PX[:npx])))
                M0 = -K0 @ S0.T
                P_k = (A0 @ P_corr @ A0.T + G0 @ Q0 @ G0.T
                       + A0 @ M0 @ G0.T + G0 @ M0 @ A0.T)     # Estimator.py:647-650
            else:  # smooth
                # backward Riccati smoother (Estimator.py:654-664); the
                # native host-core path when its library is built
                from mpc_code_tpu_torch import native as hostcore

                if hostcore.available() and N_mhe > 1:
                    Pis = list(hostcore.riccati_smoother(
                        self.bigP[:N_mhe], self.bigPc[:N_mhe], self.bigA[:N_mhe]))
                else:
                    Pis = [None] * N_mhe
                    Pis[N_mhe - 1] = self.bigPc[N_mhe - 1]
                    for i in range(N_mhe - 2, -1, -1):
                        Pim = scla.inv(self.bigP[i + 1])
                        Pis[i] = self.bigPc[i] + self.bigPc[i] @ self.bigA[i].T @ Pim @ (
                            Pis[i + 1] - self.bigP[i + 1]) @ Pim @ self.bigA[i] @ self.bigPc[i]
                P_k = Pis[1] if N_mhe > 1 else Pis[0]

                # shift one step forward (Estimator.py:671-684)
                for name in ("bigC", "bigG", "bigA", "bigB", "bigf", "bigh",
                             "bigQk", "bigRk", "bigSk", "bigQ", "bigU", "bigP", "bigPc"):
                    setattr(self, name, getattr(self, name)[1:])

                if N_mhe > 1:
                    self._smoothing_matrices(P_k, R_kk)

            # -- x_bar update (Estimator.py:738-757)
            if self.up == "filter":
                self.x_bar = self.X[:n].copy()
            elif N_mhe == 1:
                self.x_bar = w_opt[:n].copy()
            else:
                self.x_bar = w_opt[nxvw:nxvw + n].copy()

        # -- strip the fictitious input component (Estimator.py:760-764)
        self.U = np.zeros(0) if ksim == 0 else self.U[:-m]
        return xhat_corr, P_k

    def _smoothing_matrices(self, P_k, R_kk):
        """The stacked matrices of the (parametric) smoothing correction
        over the shifted window (Estimator.py:686-735): Obig, Hbig and
        Pycondx_inv."""
        n, n_w, p, N_mhe = self.n, self.n_w, self.p, self.N_mhe
        idx = N_mhe - 1
        nvars = n + (N_mhe - 2) * n_w + (N_mhe - 1) * p
        Qbig = P_k
        Hbig = np.zeros((p * idx, 1))
        Arow = np.eye(n)
        Cbig = np.zeros((p * idx, nvars))
        Cbig[0:p, 0:n + n_w + p] = np.column_stack(
            [self.bigC[0], np.zeros((p, n_w)), np.eye(p)])
        Hbig[:p, 0] = self.bigh[0]
        Hrow = None
        for i in range(N_mhe - 2):
            Apad = np.zeros((n, 0)) if i == 0 else np.zeros((n, p))
            Arow = np.column_stack([self.bigA[i] @ Arow, Apad, self.bigG[i]])
            Cpad = np.zeros((p, p)) if i == N_mhe - 3 else np.zeros((p, n_w + p))
            Crow = np.column_stack([self.bigC[i + 1] @ Arow, Cpad, np.eye(p)])
            Cbig[(i + 1) * p:(i + 2) * p, :Crow.shape[1]] = Crow
            Qbig = scla.block_diag(Qbig, self.bigQ[i])
            if i == 0:
                Hrow = self.bigB[i] @ self.bigU[i] + self.bigf[i]
            else:
                Hrow = self.bigA[i] @ Hrow + self.bigB[i] @ self.bigU[i] + self.bigf[i]
            Hbig[(i + 1) * p:(i + 2) * p, 0] = self.bigC[i + 1] @ Hrow + self.bigh[i + 1]
        Qbig = scla.block_diag(Qbig, R_kk)
        Gbig = Cbig[:, n:]
        QRbig = Qbig[n:, n:]
        self.Obig = Cbig[:, :n]
        self.Hbig = Hbig[:, 0]
        self.Pycondx_inv = scla.inv(Gbig @ QRbig @ Gbig.T)


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
    steps: Any = None    # (B,) int32; None: an always-full window (the host
                         # hand-off, carry_from_runtime)
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
    - ``carry_from_runtime(rt, P_k) -> MHECarry``: the hand-off from a
      warmed host ``MHERuntime`` (one lane, ``steps`` None: the window is
      always full from there on).

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
        # mask off the window's leading pad stages; a carry without a step
        # counter (the hand-off's) has an always-full window
        warm = c.steps is not None
        if warm:
            valid = torch.clamp(c.steps + 1, max=N)            # entries after this shift
            mask = torch.arange(N, device=kw["device"])[None] >= (N - valid)[:, None]
            full = c.steps >= N - 1                            # ksim >= N_mhe-1
        else:
            mask = torch.ones((Bsz, N), dtype=torch.bool, device=kw["device"])
            full = torch.ones(Bsz, dtype=torch.bool, device=kw["device"])

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
                ws_in = ({**c.duals, "ok": c.duals["ok"] & (c.steps >= N)} if warm
                         else c.duals)
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
                         steps=c.steps + 1 if warm else None, duals=duals_out)
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

    def carry_from_runtime(rt: MHERuntime, P_k) -> MHECarry:
        """The carry of one lane from a warmed ``MHERuntime`` whose last
        step had a full window (JAX ``estimators/mhe.py:747-787``), on the
        step's device in the runtime's dtype: the window buffers, the
        smoothing state, ``steps`` None (an always-full window) and the
        runtime's dual warm start (cold zeros when it has none yet)."""
        if rt.N_mhe != N:
            raise ValueError("runtime/config N_mhe mismatch")
        if rt.up != est.mhe_up:
            raise ValueError("runtime/config mhe_up mismatch")
        if rt.U.shape[0] != (N - 1) * m:
            raise ValueError(
                "runtime window not full yet: hand off after the step with "
                f"ksim >= N_mhe - 1 completed (len(U)={rt.U.shape[0]}, "
                f"need {(N - 1) * m})")
        kw = dict(dtype=rt.dtype, device=dev)

        def lane(a):
            return torch.as_tensor(np.asarray(a, float), **kw)[None]

        sm = None
        if smooth:
            if len(rt.bigA) != N - 1:
                raise ValueError("smooth buffers not in post-shift steady "
                                 f"state (len={len(rt.bigA)}, need {N - 1})")
            sm = MHESmoothState(
                P_kal=lane(rt.P_k_kal),
                **{f: lane(np.stack(getattr(rt, f))) for f in (
                    "bigA", "bigP", "bigPc", "bigC", "bigG", "bigB", "bigf", "bigh",
                    "bigQ", "bigU")},
                Hbig=lane(rt.Hbig), Obig=lane(rt.Obig), Pycondx_inv=lane(rt.Pycondx_inv))
        duals = None
        if structured:
            # the runtime's carried duals, so that the continuation's first
            # solve warm-starts as the host loop's next solve would
            duals = ({k: v.to(**kw) if v.is_floating_point() else v.to(dev)
                      for k, v in rt._duals.items()} if rt._duals is not None
                     else mhe_dual_zeros(cfg, N, batch=1, **kw))
        return MHECarry(U=lane(rt.U), Y=lane(rt.Y), T=lane(rt.T), Xmin=lane(rt.Xmin),
                        PX=lane(rt.PX), PY=lane(rt.PY), X=lane(rt.X), V=lane(rt.V),
                        W=lane(rt.W), x_bar=lane(rt.x_bar), P=lane(P_k), sm=sm,
                        steps=None, duals=duals)

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
