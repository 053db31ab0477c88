"""Closed-loop MPC simulator, one sample at a time (port of ``mpc_code_tpu/loop/simulator.py``).

The reference driver script ``MPC_code.py``'s measure -> estimate ->
target -> OCP -> plant sampling-instant sequence (MPC_code.py:485-875)
with all of its observable semantics:

- per-step time-varying parameters over the horizon (MPC_code.py:489-515)
- pre-correction output prediction stored to history (MPC_code.py:524,544)
- estimator family dispatch (kalss/lue, kal, ekf, mhe) with d-hat
  saturation (MPC_code.py:660-665) and NaN guards (MPC_code.py:671,819)
- infeasibility fallbacks: keep previous targets (MPC_code.py:714-718);
  freeze the input and propagate the model on OCP failure
  (MPC_code.py:804-805)
- warm starts: shifted previous OCP solution appended with previous targets
  (MPC_code.py:740-764)
- white process/measurement noise injection (MPC_code.py:537-541, 823-827)
- estimation-only mode (``estimating=True``) skipping target/OCP
  (MPC_code.py:200,675,829)
- modifier adaptation: plant steady state, lambda update, plant optimum
  (MPC_code.py:829-874)

The loop state and the history are numpy f64 on the host, as in the JAX
package, so the host arithmetic is the same; what JAX jits runs in torch on
the loop's ``device`` and ``dtype``: the model and plant maps, the
estimator steps, the dense-IPM solves (one lane, a leading axis of 1) and
their derivatives.  The solvers are built once and reused every instant
(the reference builds its NLPs once too, MPC_code.py:290-336).  Every
``np.asarray`` of a device result is a host synchronisation, as in JAX.
History is returned as a dict of stacked numpy arrays with the JAX
simulator's keys.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_code_tpu_torch.config import LinearModel, MPCConfig
from mpc_code_tpu_torch.device import resolve_device
from mpc_code_tpu_torch.estimators.ekf import ekf
from mpc_code_tpu_torch.estimators.linear import build_augmented, kalman, kalss, kalss_gain
from mpc_code_tpu_torch.loop.schedules import eval_setpoints, eval_step_params
from mpc_code_tpu_torch.models import (
    build_model, build_plant, build_ss_cost, build_stage_cost, build_terminal_cost,
)
from mpc_code_tpu_torch.ocp.shooting import build_ocp
from mpc_code_tpu_torch.ocp.target import (
    build_ssp, build_ssp2, build_target, make_lambda_update,
)
from mpc_code_tpu_torch.ops.linalg import sqrtm_psd
from mpc_code_tpu_torch.solver.ipm import make_solver
from mpc_code_tpu_torch.solver.nlp import STATUS_INFEASIBLE

HISTORY_KEYS = ("Xp", "Yp", "U", "XS", "YS", "US", "X_HAT", "Y_HAT", "D_HAT", "COR",
                "LAMBDA", "TIME_SS", "TIME_DYN", "Ysp", "Usp", "Sl", "X_KF", "Upopt",
                "Ypopt", "STATUS_SS", "STATUS_DYN")


def _vec(v):
    return np.asarray(v, float).reshape(-1)


def _sqrt_psd(M):
    return sqrtm_psd(torch.as_tensor(np.asarray(M, float))).numpy()


class ClosedLoop:
    """Build all solvers once from a config, then ``run()`` the loop.

    Runs on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``) in ``dtype`` (default f64: the fixtures and the host
    state are f64; JAX runs this loop in f32 on a TPU only because the TPU
    has no f64).  ``cfg.Collocation`` without ContForm solves the
    Gauss-Legendre transcription (``ocp/collocation.py``, stride 3nx+nu).

    ``check_numerics`` (the config flag or ``MPC_TPU_CHECK_NUMERICS=1``)
    checks every history array written in a step for non-finite values
    and raises ``FloatingPointError``.  JAX also arms ``jax_debug_nans``
    there, which re-runs a jitted computation that made a NaN op by op;
    torch has no counterpart, so the check here is the per-step one.

    After ``run()``: ``first_nlps`` holds the first successfully solved
    target and OCP inputs, ``final_state`` the end-of-run loop state (for
    handing the simulation off to the batched step, ``loop/batched.py::
    init_carry(state=...)``), and (the port's own) ``step_stats`` per step
    the seconds of each phase, the solvers' iterations and statuses."""

    def __init__(self, cfg: MPCConfig, device=None, dtype=torch.float64):
        dev = resolve_device(device)
        self.device, self.dtype = dev, dtype
        if cfg.ssjacid:
            # auto-linearise the model at its identified steady state
            # (MPC_code.py:84-91 -> SS_JAC_ID.ss_p_jac_id)
            from mpc_code_tpu_torch.ident import apply_ss_jac_id

            cfg = apply_ss_jac_id(cfg, device=dev)
        self.cfg = cfg
        self.first_nlps: dict = {}
        self.step_stats: list = []
        self.check_numerics = bool(
            cfg.check_numerics or os.environ.get("MPC_TPU_CHECK_NUMERICS") == "1")
        self.model = build_model(cfg)
        self.plant = build_plant(cfg, self.model)
        self.aug = build_augmented(cfg, self.model)
        model, plant = self.model, self.plant

        nx, nu = cfg.nx, cfg.nu
        self.nxu = nx + nu
        if not cfg.estimating:
            fss_obj = build_ss_cost(cfg.ss_cost)
            f_obj = build_stage_cost(cfg.stage_cost)
            vfin = build_terminal_cost(cfg)
            self.target_spec = build_target(cfg, model, fss_obj)
            # ContForm wins over Collocation (reference: opt_dyn_CM's
            # ContForm branch never emits the collocation equations,
            # Control_Calc.py:428-436)
            self.colloc = bool(cfg.Collocation) and not cfg.ContForm
            if self.colloc:
                from mpc_code_tpu_torch.ocp.collocation import build_ocp_collocation

                self.ocp_spec = build_ocp_collocation(cfg, model, f_obj, vfin)
                self.stride = 3 * nx + nu   # nxuk (MPC_code.py:51)
            else:
                self.ocp_spec = build_ocp(cfg, model, f_obj, vfin)
                self.stride = nx + nu
            self.target_solve = make_solver(self.target_spec.nlp, cfg.sol_opts_ss)
            self.ocp_solve = make_solver(self.ocp_spec.nlp, cfg.sol_opts_dyn)
            if cfg.Adaptation:
                self.ssp_spec = build_ssp(cfg, plant)
                self.ssp_solve = make_solver(self.ssp_spec.nlp, cfg.sol_opts_ss)
                # economic cost on the plant's state dims when they differ
                fss2 = cfg.ss_cost.f_obj if nx != cfg.nxp else fss_obj
                self.ssp2_spec = build_ssp2(cfg, plant, fss2)
                self.ssp2_solve = make_solver(self.ssp2_spec.nlp, cfg.sol_opts_ss)
                self._lambda_fns = vmap(make_lambda_update(cfg, model, plant))

        est = cfg.estimator
        self.est_kind = est.kind
        if est.kind in ("kalss", "lue"):
            if cfg.StateFeedback and cfg.dist.offree == "no":
                self.K_gain = torch.eye(self.aug.n, dtype=torch.float64)   # MPC_code.py:579-580
            elif est.K is not None:
                self.K_gain = torch.as_tensor(np.asarray(est.K, float))
            else:
                self.K_gain = kalss_gain(cfg, model)
            self._K = self.K_gain.to(dtype=dtype, device=dev)
        elif est.kind in ("kal", "ekf"):
            if est.kind == "kal" and not isinstance(cfg.model, LinearModel):
                # the reference hard-exits: the time-varying KF's gain comes
                # from jacobians that are only exact for linear models
                # (MPC_code.py:643-646)
                raise ValueError(
                    "estimator kind 'kal' requires a LinearModel (reference "
                    "MPC_code.py:643-646); use 'ekf' for nonlinear models")
            self._Q_kf, self._R_kf = (self._T(est.Q_kf), self._T(est.R_kf))
        elif est.kind == "mhe":
            from mpc_code_tpu_torch.estimators.mhe import MHERuntime

            self.mhe_rt = MHERuntime(cfg, model, device=dev, dtype=dtype)
        else:
            raise ValueError(f"unknown estimator kind {est.kind!r}")

        self._Rv = None if cfg.R_wn is None else _sqrt_psd(cfg.R_wn)
        self._Qw = None if cfg.Q_wn is None else _sqrt_psd(cfg.Q_wn)

    # ------------------------------------------------------------------
    def _T(self, a):
        """A host value as a tensor on the loop's device, in its dtype."""
        return torch.as_tensor(np.asarray(a, float), dtype=self.dtype, device=self.device)

    def _L(self, a):
        """A host value as one lane: a leading axis of 1."""
        return self._T(a)[None]

    @staticmethod
    def _np(t):
        return t.detach().to("cpu", torch.float64).numpy()

    def _fy_model(self, x, u, d, t, py):
        T = self._T
        return self._np(self.model.fy(T(x), T(u), T(d), T(t), T(py)))

    def _fx_model(self, x, u, d, t, px):
        T = self._T
        return self._np(self.model.fx(T(x), T(u), self.cfg.h, T(d), T(t), T(px)))

    def _fy_plant(self, x, u, d, t, py, pyp, pymp):
        T = self._T
        if self.plant.nominal:
            return self._np(self.plant.fy(T(x), T(u), T(d), T(t), T(py)))
        return self._np(self.plant.fy(T(x), T(u), T(pyp), T(t), T(pymp)))

    def _fx_plant(self, x, u, d, t, pxp, pxmp):
        T, h = self._T, self.cfg.h
        if self.plant.nominal:
            return self._np(self.plant.fx(T(x), T(u), h, T(d), T(t), T(pxmp)))
        return self._np(self.plant.fx(T(x), T(u), T(pxp), T(t), h, T(pxmp)))

    def _solve(self, solve, spec, w0, par, lbw=None, ubw=None):
        """One lane through a dense-IPM solve: (w, status, iters), host
        values."""
        res = solve(self._L(w0), {k: self._L(v) for k, v in par.items()},
                    spec.lbw if lbw is None else lbw, spec.ubw if ubw is None else ubw,
                    spec.lbg, spec.ubg)
        return self._np(res.w[0]), int(res.status[0]), int(res.iters[0])

    # ------------------------------------------------------------------
    def run(self, Nsim: Optional[int] = None, verbose: bool = False) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        Nsim = Nsim if Nsim is not None else cfg.Nsim
        nx, nu, ny, nd, N = cfg.nx, cfg.nu, cfg.ny, cfg.nd, cfg.N
        nxu = self.nxu
        rng = np.random.default_rng(cfg.noise_seed)
        L, npy_ = self._L, self._np
        x0_m, u0, x0_p = _vec(cfg.x0_m), _vec(cfg.u0), _vec(cfg.x0_p)

        x_k = x0_p.copy()
        u_k = u0.copy()
        xhat_k = x0_m.copy()
        dhat_k = np.zeros(nd) if cfg.dhat0 is None else _vec(cfg.dhat0)
        lam_k = np.zeros((ny, nu))
        est = cfg.estimator
        P_k = (np.asarray(est.P0, float) if est.P0 is not None
               else np.zeros((self.aug.n, self.aug.n)))
        us_k = xs_k = None
        ocp_feasible = True
        w_opt = None
        self.step_stats = []

        H: Dict[str, list] = {k: [] for k in HISTORY_KEYS}

        for ksim in range(Nsim):
            if verbose:
                print(f"Time Iteration {ksim + 1} of {Nsim}")
            t_k = ksim * cfg.h
            stats = dict(step=ksim)
            clock = time.perf_counter()

            # -- time-varying parameters over the horizon (MPC_code.py:489-515)
            px_h, py_h, p_xp, p_yp, p_xmp, p_ymp = eval_step_params(cfg, t_k)
            p_x_k, p_y_k = px_h[0], py_h[0]

            H["Xp"].append(x_k.copy())
            H["X_HAT"].append(xhat_k.copy())

            # -- model output prediction (pre-correction) (MPC_code.py:524)
            yhat_k = self._fy_model(xhat_k, u_k, dhat_k, t_k, p_y_k)

            # -- plant output (MPC_code.py:531-541)
            y_k = self._fy_plant(x_k, u_k, dhat_k, t_k, p_y_k, p_yp, p_ymp)
            if self._Rv is not None:
                y_k = y_k + self._Rv @ rng.standard_normal(ny)

            H["Yp"].append(y_k.copy())
            H["Y_HAT"].append(yhat_k.copy())

            # -- estimator (MPC_code.py:546-668), one lane
            x_es = np.concatenate([xhat_k, dhat_k]) if cfg.dist.offree != "no" else xhat_k
            lane = (L(y_k), L(u_k))
            if self.est_kind in ("kalss", "lue"):
                x_es = npy_(kalss(self.aug, *lane, self._K, L(x_es), L(t_k), L(p_y_k))[0])
            elif self.est_kind in ("kal", "ekf"):
                filt = kalman if self.est_kind == "kal" else ekf
                P_plus, _, x_corr = filt(self.aug, cfg.h, *lane, self._Q_kf, self._R_kf,
                                         L(P_k), L(x_es), L(t_k), L(p_x_k), L(p_y_k))
                P_k, x_es = npy_(P_plus[0]), npy_(x_corr[0])
            else:
                H["X_KF"].append(self.mhe_rt.xm_kal.copy())
                x_es, P_k = self.mhe_rt.step(ksim, y_k, u_k, x_es, t_k, p_x_k, p_y_k, P_k)
                stats.update(mhe_status=self.mhe_rt.last_status,
                             mhe_iters=self.mhe_rt.last_iters)

            if cfg.dist.offree != "no":
                xhat_k = x_es[:nx]
                dhat_k = x_es[nx:nx + nd]
                if cfg.bounds.dmin is not None:           # MPC_code.py:660-665
                    dhat_k = np.clip(dhat_k, _vec(cfg.bounds.dmin), _vec(cfg.bounds.dmax))
            else:
                xhat_k = x_es
            H["D_HAT"].append(dhat_k.copy())

            if np.any(np.isnan(xhat_k)):                   # MPC_code.py:671-673
                raise FloatingPointError(
                    "xhat_k has NaN components — check noise/disturbance magnitudes")
            now = time.perf_counter()
            stats["estimate_s"], clock = now - clock, now

            if not cfg.estimating:
                # -- setpoints (MPC_code.py:677-680)
                ysp_k, usp_k, xsp_k = eval_setpoints(cfg, t_k)
                if cfg.defSP is not None:
                    H["Ysp"].append(ysp_k.copy())
                    H["Usp"].append(usp_k.copy())

                if ksim == 0:
                    us_k = u_k.copy()
                    xs_k = x0_m.copy()
                us_prev = us_k.copy()                      # MPC_code.py:687-688
                xs_prev = xs_k.copy()

                # -- target problem (MPC_code.py:693-718)
                par_ss = dict(usp=usp_k, ysp=ysp_k, xsp=xsp_k, d=dhat_k, us_prev=us_prev,
                              lam=lam_k, t=t_k, px=p_x_k, py=p_y_k)
                wss_guess = np.concatenate(
                    [x0_m, u0, self._fy_model(x0_m, u0, dhat_k, t_k, p_y_k)])
                if "target" not in self.first_nlps:
                    # first successfully solved NLP inputs, kept for
                    # independent solver-parity tests (SURVEY.md §4 item
                    # 3); dropped below if this step's solve fails
                    self.first_nlps["target"] = dict(
                        ksim=ksim, w0=wss_guess.copy(),
                        par={k: np.asarray(v, float) for k, v in par_ss.items()})
                t0 = time.time()
                wss_opt, status_ss, stats["ss_iters"] = self._solve(
                    self.target_solve, self.target_spec, wss_guess, par_ss)
                H["TIME_SS"].append(time.time() - t0)
                H["STATUS_SS"].append(status_ss)
                if (status_ss == STATUS_INFEASIBLE
                        and self.first_nlps.get("target", {}).get("ksim") == ksim):
                    del self.first_nlps["target"]
                if status_ss != STATUS_INFEASIBLE:         # MPC_code.py:714-718
                    xs_k = wss_opt[:nx]
                    us_k = wss_opt[nx:nxu]

                if cfg.Adaptation:
                    cor_k = lam_k @ (us_k - us_prev)       # MPC_code.py:721-724
                    H["COR"].append(cor_k.copy())

                H["XS"].append(xs_k.copy())
                H["US"].append(us_k.copy())
                H["YS"].append(self._fy_model(xs_k, us_k, dhat_k, t_k, p_y_k))  # :730-731
                now = time.perf_counter()
                stats["target_s"], clock = now - clock, now

                # -- OCP (MPC_code.py:733-810)
                lbw = self.ocp_spec.lbw.copy()
                ubw = self.ocp_spec.ubw.copy()
                lbw[:nx] = ubw[:nx] = xhat_k               # MPC_code.py:734
                nw, ns = self.ocp_spec.nw, self.ocp_spec.ns
                st = self.stride
                if ksim == 0 or w_opt is None:
                    w_guess = np.zeros(nw)                 # MPC_code.py:740-756
                    for key in range(1, N + 1):
                        if self.colloc:                    # MPC_code.py:748-751
                            w_guess[key * st - nu - 2 * nx:key * st - nu] = np.tile(x0_m, 2)
                        w_guess[key * st - nu:key * st] = u_k
                        w_guess[key * st:key * st + nx] = x0_m
                    w_guess[:nx] = x0_m
                elif ocp_feasible:
                    if self.colloc:                        # MPC_code.py:759-761
                        w_guess = np.concatenate([w_opt[st:nw - ns], xs_prev, xs_prev,
                                                  us_prev, xs_prev, w_opt[nw - ns:nw]])
                    else:
                        w_guess = np.concatenate([w_opt[st:nw - ns], us_prev, xs_prev,
                                                  w_opt[nw - ns:nw]])  # MPC_code.py:762-764
                par = dict(x0=xhat_k, xs=xs_k, us=us_k, d=dhat_k, um1=u_k, t=t_k,
                           lam=lam_k, px=px_h, py=py_h)
                if "ocp" not in self.first_nlps:
                    self.first_nlps["ocp"] = dict(
                        ksim=ksim, w0=np.asarray(w_guess).copy(),
                        lbw=lbw.copy(), ubw=ubw.copy(),
                        par={k: np.asarray(v, float) for k, v in par.items()})
                t0 = time.time()
                w_res, status_dyn, stats["dyn_iters"] = self._solve(
                    self.ocp_solve, self.ocp_spec, w_guess, par, lbw, ubw)
                H["TIME_DYN"].append(time.time() - t0)
                H["STATUS_DYN"].append(status_dyn)
                ocp_feasible = status_dyn != STATUS_INFEASIBLE
                if (not ocp_feasible
                        and self.first_nlps.get("ocp", {}).get("ksim") == ksim):
                    del self.first_nlps["ocp"]
                if ocp_feasible:                           # MPC_code.py:786-800
                    w_opt = w_res
                    u_k = w_opt[st - nu:st]
                    xhat_k = w_opt[st:st + nx]
                    if cfg.slacks:
                        H["Sl"].append(w_opt[nw - ns:nw].copy())
                else:                                      # MPC_code.py:804-805
                    xhat_k = self._fx_model(xhat_k, u_k, dhat_k, t_k, p_x_k)
                H["U"].append(u_k.copy())
                stats.update(status_ss=status_ss, status_dyn=status_dyn)
                now = time.perf_counter()
                stats["ocp_s"], clock = now - clock, now

            # -- plant update (MPC_code.py:813-827)
            x_k = self._fx_plant(x_k, u_k, dhat_k, t_k, p_xp, p_xmp)
            if np.any(np.isnan(x_k)):                      # MPC_code.py:819-821
                raise FloatingPointError(
                    "x_k has NaN components — check noise/disturbance magnitudes")
            if self._Qw is not None and cfg.G_wn is not None:
                w_wn = self._Qw @ rng.standard_normal(cfg.nxp)
                x_k = x_k + np.asarray(cfg.G_wn, float) @ w_wn

            # -- modifier adaptation (MPC_code.py:829-874)
            if (not cfg.estimating) and cfg.Adaptation:
                xs_kp, _, _ = self._solve(
                    self.ssp_solve, self.ssp_spec, x0_p,
                    dict(t=t_k, us=us_k, pxp=p_xp, pxmp=p_xmp, d=dhat_k))
                lam_k = npy_(self._lambda_fns(
                    L(lam_k), L(xs_kp), L(xs_k), L(us_k), L(dhat_k), L(t_k), L(p_xp),
                    L(p_yp), L(p_x_k), L(p_y_k), L(p_xmp), L(p_ymp))[0])
                H["LAMBDA"].append(lam_k.copy())

                par_ssp2 = dict(usp=usp_k, ysp=ysp_k, xsp=np.zeros(cfg.nxp), pyp=p_yp,
                                t=t_k, pxp=p_xp, pxmp=p_xmp, pymp=p_ymp)
                # the plant's output map with the plant's parameters, as
                # JAX calls it (simulator.py:388-391)
                T = self._T
                y0_p = npy_(self.plant.fy(T(x0_p), T(u0), T(p_yp), T(t_k), T(p_ymp)))
                wss2_guess = np.concatenate([x0_p, u0, y0_p])
                w2, _, _ = self._solve(self.ssp2_solve, self.ssp2_spec, wss2_guess, par_ssp2)
                H["Upopt"].append(w2[cfg.nxp:cfg.nxp + nu].copy())
                H["Ypopt"].append(w2[cfg.nxp + nu:].copy())
            stats["plant_s"] = time.perf_counter() - clock
            self.step_stats.append(stats)

            if self.check_numerics:
                # every history array written this step (the reference only
                # spot-checks xhat and x, MPC_code.py:671, 819)
                for key, vals in H.items():
                    if vals and not np.all(np.isfinite(np.asarray(vals[-1]))):
                        raise FloatingPointError(
                            f"check_numerics: non-finite {key} at step {ksim}")

        # end-of-run loop state, for handing the simulation off to the
        # batched step (e.g. the MHE warmup on the host, the steady state in
        # loop/batched.py with estimators.mhe.make_mhe_traced)
        self.final_state = dict(
            x=x_k.copy(), xhat=xhat_k.copy(), dhat=dhat_k.copy(),
            u=u_k.copy(), P=P_k.copy(),
            xs=None if xs_k is None else np.asarray(xs_k).copy(),
            us=None if us_k is None else np.asarray(us_k).copy(),
            w_opt=None if w_opt is None else np.asarray(w_opt).copy(),
            ocp_feasible=bool(ocp_feasible), t=Nsim * cfg.h,
            lam=np.asarray(lam_k).copy(),
        )
        return {k: np.stack(v) if v else np.zeros((0,)) for k, v in H.items()}
