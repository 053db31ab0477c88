"""Batched primal-dual interior-point NLP solver (port of ``mpc_code_tpu/solver/ipm.py``).

The dense IPM that replaces IPOPT for the small NLPs of the framework (the
steady-state target here): slack reformulation ``g(w) - s = 0`` with box
bounds on ``w`` and ``s``, log-barrier on every finite bound, primal-dual
Newton steps on the KKT system, fraction-to-boundary, the monotone
Fiacco-McCormick barrier schedule, an l1-penalty backtracking line search
with a second-order correction, and inertia regularisation by a ladder of
diagonal shifts of the condensed Hessian.  Fixed variables (lbw == ubw)
are pinned at their bound with identity KKT rows.

Layout.  The JAX solver is written for one lane and batched with ``vmap``;
here ``solve`` takes an explicit leading batch dimension B.  The problem
callables act on one point; their derivatives come from ``torch.func``
(``grad`` and ``jacrev``, reverse mode throughout), vmapped over the lanes.
The JAX ``lax.while_loop``s under ``vmap`` (the outer iteration and the
line search) freeze each lane as soon as its own condition is false; the
masked loops here do the same, so per-lane ``iters`` and ``status`` match.
Deciding whether any lane is still active costs one host synchronisation
per iteration and per line-search trial.

Small linear algebra goes through ``ops/smalllin.py``: a lane whose
Cholesky factorisation or LU solve fails comes back as NaN, as
``jnp.linalg`` gives, and never stops the batch.

``SolverOptions.debug`` prints JAX's per-iteration line for every lane;
``kkt_error`` is JAX's test oracle of a result's residuals.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jacrev, vmap

from mpc_code_tpu_torch.config import SolverOptions
from mpc_code_tpu_torch.ops.smalllin import chol, solve_lu
from mpc_code_tpu_torch.solver.nlp import (
    IPMResult, NLP, STATUS_ACCEPTABLE, STATUS_INFEASIBLE, STATUS_SOLVED, debug_lines,
)

_INF = 1e18          # bounds beyond this are treated as absent (IPOPT: 1e19)
_KAPPA_1 = 1e-2      # interior push (IPOPT kappa_1/kappa_2)
_KAPPA_2 = 1e-2
_KAPPA_SIGMA = 1e10  # dual safeguard corridor (f64; f32 uses 1e6)
_KAPPA_EPS = 10.0    # barrier sufficient-progress factor
_KAPPA_MU = 0.2      # linear mu decrease
_THETA_MU = 1.5      # superlinear mu decrease
_TAU_MIN = 0.99
_ETA_LS = 1e-4       # Armijo constant
_MAX_BACKTRACK = 25
_DELTA_C = 1e-11     # constant dual regularization (f64; f32 uses 1e-6)
_DELTAS = (0.0, 1e-8, 1e-6, 1e-4, 1e-2, 1.0, 1e2, 1e4)   # inertia ladder


def _mdiv(num, den, mask):
    return torch.where(mask, num / torch.where(mask, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _amax0(a):
    """Per-lane max over the trailing dim with 0 included (jnp ``initial=0``)."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.clamp(a.amax(-1), min=0.0)


def _amin_inf(a):
    """Per-lane min over the trailing dim with +inf included."""
    if a.shape[-1] == 0:
        return torch.full((a.shape[0],), float("inf"), dtype=a.dtype, device=a.device)
    return a.amin(-1)


def _lane(v, like):
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _diag(v):
    return torch.diag_embed(v)


def make_solver(nlp: NLP, opts: SolverOptions = SolverOptions()) -> Callable:
    """Build ``solve(w0, p, lbw, ubw, lbg, ubg) -> IPMResult`` for a batch.

    ``w0`` is (B, nw); every entry of the parameter dict ``p`` has a
    leading B; the bounds are given for one lane, (nw,) and (ng,), or with a
    leading B.  The solve runs on the device of ``w0`` in its dtype (f32 or
    f64).  ``hessian='gauss_newton'`` is accepted and, as in the JAX
    package, this dense path always uses the exact Lagrangian Hessian.
    ``opts.debug`` prints JAX's line (ipm.py:490-494) for every lane at
    every iteration, in lane order."""
    if opts.hessian not in ("exact", "gauss_newton"):
        raise ValueError(f"unknown hessian {opts.hessian!r}: "
                         "use 'exact' or 'gauss_newton'")
    nw, ng = nlp.nw, nlp.ng
    nz = nw + ng

    def scaled_lagrangian(w, p, yf, yg):
        # yg . g as a product-sum: torch.func's forward-over-reverse of
        # ``yg @ g`` turns f32 into f64 when g mixes in Python scalars
        if ng > 0:
            return yf * nlp.f(w, p) + (yg * nlp.g(w, p)).sum()
        return yf * nlp.f(w, p)

    def g_aux(w, p):
        v = nlp.g(w, p)
        return v, v

    # reverse mode throughout: torch's forward mode runs Python
    # decompositions for every op that mixes a tensor and a Python number,
    # 4-7x slower than reverse mode through an RK4 shooting OCP on the CPU
    # (N=10, Mx=10: Hessian 0.83 s forward-over-reverse against 0.19 s
    # reverse-over-reverse, Jacobian of g 0.39 s forward against 0.06 s)
    v_f = vmap(nlp.f)
    v_grad_f = vmap(grad(nlp.f))
    v_hess_l = vmap(jacrev(jacrev(scaled_lagrangian)))
    if ng > 0:
        v_g = vmap(nlp.g)
        v_jac_g = vmap(jacrev(nlp.g))
        v_jac_g_val = vmap(jacrev(g_aux, has_aux=True))

    def solve(w0, p, lbw, ubw, lbg, ubg) -> IPMResult:
        w0 = torch.as_tensor(w0)
        dtype = torch.float64 if w0.dtype == torch.float64 else torch.float32
        dev = w0.device
        kw = dict(dtype=dtype, device=dev)
        w0 = w0.to(dtype)
        Bsz = w0.shape[0]
        p = {k: torch.as_tensor(v, **kw) for k, v in p.items()}
        inf = torch.tensor(float("inf"), **kw)

        def T(a, n):
            a = torch.as_tensor(a, **kw)
            return a.reshape(-1, n).expand(Bsz, n) if n else a.new_zeros((Bsz, 0))

        lbw, ubw, lbg_u, ubg_u = T(lbw, nw), T(ubw, nw), T(lbg, ng), T(ubg, ng)
        fixed_w = (ubw - lbw) <= 0.0
        fixed_s = (ubg_u - lbg_u) <= 0.0
        mu0 = torch.full((Bsz,), opts.mu_init, **kw)
        f32 = dtype == torch.float32
        tiny = 1e-30 if f32 else 1e-300
        delta_c = 1e-6 if f32 else _DELTA_C
        kappa_sigma = 1e6 if f32 else _KAPPA_SIGMA

        # --- interior initialization (IPOPT eq. (23)-(24) style push) ---
        def push_interior(z, lb, ub, has_lb, has_ub, fixed):
            pl = torch.minimum(_KAPPA_1 * torch.clamp(lb.abs(), min=1.0),
                               _KAPPA_2 * torch.where(has_ub, ub - lb, inf))
            pu = torch.minimum(_KAPPA_1 * torch.clamp(ub.abs(), min=1.0),
                               _KAPPA_2 * torch.where(has_lb, ub - lb, inf))
            zlo = torch.where(has_lb, lb + pl, -inf)
            zhi = torch.where(has_ub, ub - pu, inf)
            return torch.where(fixed, lb, torch.minimum(torch.maximum(z, zlo), zhi))

        has_lbw = (lbw > -_INF) & ~fixed_w
        has_ubw = (ubw < _INF) & ~fixed_w
        w_init = push_interior(w0, lbw, ubw, has_lbw, has_ubw, fixed_w)

        # --- gradient-based problem scaling (IPOPT gmax=100) ---
        gmax = 100.0
        gf0 = v_grad_f(w_init, p)
        sf = torch.clamp(gmax / torch.clamp(gf0.abs().amax(-1), min=1e-8), max=1.0)
        if ng > 0:
            J0 = v_jac_g(w_init, p)
            sg = torch.clamp(gmax / torch.clamp(J0.abs().amax(-1), min=1e-8), max=1.0)
        else:
            sg = torch.zeros((Bsz, 0), **kw)
        lbg_s, ubg_s = sg * lbg_u, sg * ubg_u

        def grad_f(w):
            return sf[:, None] * v_grad_f(w, p)

        def jac_g(w):
            return sg[:, :, None] * v_jac_g(w, p)

        def jac_g_val(w):
            J, gv = v_jac_g_val(w, p)
            return sg[:, :, None] * J, sg * gv

        def g_scaled(w):
            return sg * v_g(w, p)

        lb = torch.cat([lbw, lbg_s], 1)
        ub = torch.cat([ubw, ubg_s], 1)
        fixed = torch.cat([fixed_w, fixed_s], 1)
        has_lb = (lb > -_INF) & ~fixed
        has_ub = (ub < _INF) & ~fixed

        g0 = g_scaled(w_init) if ng > 0 else torch.zeros((Bsz, 0), **kw)
        s_init = push_interior(g0, lbg_s, ubg_s, has_lb[:, nw:], has_ub[:, nw:], fixed_s)
        z0 = torch.cat([w_init, s_init], 1)
        one = torch.ones_like(z0)
        zl0 = torch.where(has_lb, torch.clamp(_lane(mu0, z0) / torch.where(has_lb, z0 - lb, one),
                                              1e-8, 1e8), 0.0)
        zu0 = torch.where(has_ub, torch.clamp(_lane(mu0, z0) / torch.where(has_ub, ub - z0, one),
                                              1e-8, 1e8), 0.0)

        full = lambda v: torch.full((Bsz,), v, **kw)  # noqa: E731
        st = dict(w=w_init, s=s_init, y=torch.zeros((Bsz, ng), **kw), zl=zl0, zu=zu0,
                  mu=mu0, nu=full(1.0), delta=full(0.0),
                  it=torch.zeros(Bsz, dtype=torch.int32, device=dev),
                  done=torch.zeros(Bsz, dtype=torch.bool, device=dev),
                  kkt0=full(float("inf")), feas=full(float("inf")))

        def barrier_phi(w, s, mu):
            z = torch.cat([w, s], 1)
            zo = torch.ones_like(z)
            tl = torch.where(has_lb, torch.log(torch.where(
                has_lb, torch.clamp(z - lb, min=tiny), zo)), 0.0)
            tu = torch.where(has_ub, torch.log(torch.where(
                has_ub, torch.clamp(ub - z, min=tiny), zo)), 0.0)
            return sf * v_f(w, p) - mu * (tl.sum(1) + tu.sum(1))

        def constraint_res(w, s):
            if ng == 0:
                return torch.zeros((Bsz, 0), **kw)
            return g_scaled(w) - s

        def kkt_errors(w, s, y, zl, zu, mus):
            """(KKT error at each barrier value of ``mus``, feasibility)."""
            z = torch.cat([w, s], 1)
            r_w = grad_f(w)
            if ng > 0:
                r_w = r_w + torch.einsum("bgw,bg->bw", jac_g(w), y)
            r_w = r_w - zl[:, :nw] + zu[:, :nw]
            r_s = -y - zl[:, nw:] + zu[:, nw:]
            r_stat = torch.cat([torch.where(fixed_w, 0.0, r_w),
                                torch.where(fixed_s, 0.0, r_s)], 1)
            r_c = constraint_res(w, s)
            s_max = 100.0
            denom = nz + ng
            s_d = torch.clamp((y.abs().sum(1) + zl.sum(1) + zu.sum(1)) / denom,
                              min=s_max) / s_max
            s_c = torch.clamp((zl.sum(1) + zu.sum(1)) / nz, min=s_max) / s_max
            e_stat = _amax0(r_stat.abs()) / s_d
            e_feas = _amax0(r_c.abs())
            errs = []
            for mu in mus:
                m = _lane(mu, z)
                comp_l = torch.where(has_lb, (z - lb) * zl - m, 0.0)
                comp_u = torch.where(has_ub, (ub - z) * zu - m, 0.0)
                e_comp = torch.maximum(_amax0(comp_l.abs()), _amax0(comp_u.abs())) / s_c
                errs.append(torch.maximum(torch.maximum(e_stat, e_feas), e_comp))
            return errs, e_feas

        free_w = ~fixed_w
        eye_free = _diag(torch.where(free_w, 1.0, 0.0).to(dtype))
        deltas = torch.tensor(_DELTAS, **kw)

        def ftb_primal(dz_v, mu_v, dzl_gap, dzu_gap):
            """Fraction-to-boundary step cap for a primal direction."""
            tau = _lane(torch.clamp(1.0 - mu_v, min=_TAU_MIN), dz_v)
            neg, pos = dz_v < 0, dz_v > 0
            a_l = torch.where(has_lb & neg, -tau * dzl_gap / torch.where(neg, dz_v, -1.0), inf)
            a_u = torch.where(has_ub & pos, tau * dzu_gap / torch.where(pos, dz_v, 1.0), inf)
            return torch.clamp(torch.minimum(_amin_inf(a_l), _amin_inf(a_u)), max=1.0)

        def body(st):
            w, s, y, zl, zu, mu = st["w"], st["s"], st["y"], st["zl"], st["zu"], st["mu"]
            z = torch.cat([w, s], 1)
            m = _lane(mu, z)

            gf = grad_f(w)
            H = v_hess_l(w, p, sf, y * sg)
            if ng > 0:
                J, g_w = jac_g_val(w)
                r_c = g_w - s
                Jty = torch.einsum("bgw,bg->bw", J, y)
            else:
                r_c = torch.zeros((Bsz, 0), **kw)
                Jty = torch.zeros_like(gf)

            dzl_gap = torch.where(has_lb, z - lb, 1.0)
            dzu_gap = torch.where(has_ub, ub - z, 1.0)
            sigma = _mdiv(zl, dzl_gap, has_lb) + _mdiv(zu, dzu_gap, has_ub)
            sigma_w, sigma_s = sigma[:, :nw], sigma[:, nw:]
            ones_z = torch.ones_like(z)
            bgrad = _mdiv(m * ones_z, dzl_gap, has_lb) - _mdiv(m * ones_z, dzu_gap, has_ub)
            bgrad_w, bgrad_s = bgrad[:, :nw], bgrad[:, nw:]

            # condensed Hessian block with fixed-variable masking
            Hbar = H + _diag(sigma_w)
            maskmat = free_w[:, :, None] & free_w[:, None, :]
            Hbar = (torch.where(maskmat, Hbar, 0.0)
                    + _diag(torch.where(fixed_w, 1.0, 0.0).to(dtype)))
            rhs_w = torch.where(free_w, -(gf + Jty) + bgrad_w, 0.0)

            # inertia correction (IPOPT's delta_w ladder) on the Schur
            # complement Hbar + J' D^{-1} J
            if ng > 0:
                sinv = _mdiv(torch.ones_like(sigma_s), sigma_s, (~fixed_s) & (sigma_s > 0))
                Jm = torch.where(free_w[:, None, :], J, 0.0)
                dinv = 1.0 / (sinv + delta_c)
                M_test = (0.5 * (Hbar + Hbar.transpose(1, 2))
                          + torch.einsum("bgi,bg,bgj->bij", Jm, dinv, Jm))
            else:
                M_test = 0.5 * (Hbar + Hbar.transpose(1, 2))
            Lt = chol(M_test[:, None] + deltas[None, :, None, None] * eye_free[:, None])
            ok = torch.isfinite(Lt).flatten(2).all(2)                     # (B, 8)
            first = torch.argmax(ok.to(torch.int8), dim=1)
            delta_w = torch.where(ok.any(1), deltas[first], 1e6) + st["delta"]
            Hbar = Hbar + delta_w[:, None, None] * eye_free

            if ng > 0:
                K = torch.cat([torch.cat([Hbar, Jm.transpose(1, 2)], 2),
                               torch.cat([Jm, -_diag(sinv + delta_c)], 2)], 1)
                rhs_c = -r_c + sinv * (y + bgrad_s)
                sol = solve_lu(K, torch.cat([rhs_w, rhs_c], 1))
                dw, dy = sol[:, :nw], sol[:, nw:]
                ds = torch.where(fixed_s, 0.0, sinv * (dy + y + bgrad_s))
            else:
                dw = solve_lu(Hbar, rhs_w)
                dy = torch.zeros((Bsz, 0), **kw)
                ds = torch.zeros((Bsz, 0), **kw)
            nan0 = lambda a: torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)  # noqa: E731
            dw = nan0(torch.where(fixed_w, 0.0, dw))
            ds, dy = nan0(ds), nan0(dy)

            dz = torch.cat([dw, ds], 1)
            alpha_max = ftb_primal(dz, mu, dzl_gap, dzu_gap)

            # l1 merit with a penalty that may decay geometrically
            nu = torch.maximum(1.5 * _amax0((y + dy).abs()) + 1e-4, 0.5 * st["nu"])
            c_norm = r_c.abs().sum(1)
            psi0 = barrier_phi(w, s, mu) + nu * c_norm
            dphi = (gf * dw).sum(1) - (bgrad * dz).sum(1)
            dpsi = dphi - nu * c_norm

            def merit_of(w_t, s_t, c_t):
                return barrier_phi(w_t, s_t, mu) + nu * c_t.abs().sum(1)

            eps_mach = torch.finfo(dtype).eps
            slack = 10.0 * eps_mach * (psi0.abs() + 1.0)
            near_opt = st["kkt0"] < 1e-5

            # full-step trial + second-order correction (IPOPT's SOC)
            am = alpha_max[:, None]
            c_trial_full = constraint_res(w + am * dw, s + am * ds)
            ok_full = merit_of(w + am * dw, s + am * ds, c_trial_full) <= (
                psi0 + _ETA_LS * alpha_max * dpsi + slack)
            if ng > 0:
                c_soc = am * r_c + c_trial_full
                rhs_c_soc = -c_soc + sinv * (y + bgrad_s)
                sol_soc = solve_lu(K, torch.cat([rhs_w, rhs_c_soc], 1))
                dw_soc = torch.where(fixed_w, 0.0, sol_soc[:, :nw])
                dy_soc = sol_soc[:, nw:]
                ds_soc = torch.where(fixed_s, 0.0, sinv * (dy_soc + y + bgrad_s))
                a_soc = ftb_primal(torch.cat([dw_soc, ds_soc], 1), mu, dzl_gap, dzu_gap)
                a_s = a_soc[:, None]
                w_soc, s_soc = w + a_s * dw_soc, s + a_s * ds_soc
                ok_soc = (~ok_full) & (merit_of(w_soc, s_soc, constraint_res(w_soc, s_soc))
                                       <= psi0 + _ETA_LS * a_soc * dpsi + slack)
            else:
                dw_soc, dy_soc, ds_soc, a_soc = dw, dy, ds, alpha_max
                ok_soc = torch.zeros_like(ok_full)
            use_soc = ok_soc & ~near_opt
            us_ = use_soc[:, None]
            dw = torch.where(us_, dw_soc, dw)
            dy = torch.where(us_, dy_soc, dy)
            ds = torch.where(us_, ds_soc, ds)
            dz = torch.cat([dw, ds], 1)
            alpha_max = torch.where(use_soc, a_soc, alpha_max)

            dzl = torch.where(has_lb, -zl + _mdiv(m - zl * dz, dzl_gap, has_lb), 0.0)
            dzu = torch.where(has_ub, -zu + _mdiv(m + zu * dz, dzu_gap, has_ub), 0.0)
            bad = ~torch.isfinite(torch.cat([dz, dy, dzl, dzu], 1)).all(1)

            tau = _lane(torch.clamp(1.0 - mu, min=_TAU_MIN), z)
            a_zl = torch.where(has_lb & (dzl < 0), -tau * zl / torch.where(dzl < 0, dzl, -1.0), inf)
            a_zu = torch.where(has_ub & (dzu < 0), -tau * zu / torch.where(dzu < 0, dzu, -1.0), inf)
            alpha_dual = torch.clamp(torch.minimum(_amin_inf(a_zl), _amin_inf(a_zu)), max=1.0)

            # backtracking line search: a masked loop, per-lane semantics
            # of the batched lax.while_loop
            psi0_finite = torch.isfinite(psi0)

            def capped(r):
                return torch.nan_to_num(r, posinf=1e30, neginf=-1e30).abs().sum(1)

            c0_capped = capped(r_c)
            j = torch.zeros(Bsz, dtype=torch.int32, device=dev)
            accepted = near_opt | ok_full | use_soc
            alpha = alpha_max
            while True:
                act = (~accepted) & (j < _MAX_BACKTRACK)
                if not bool(act.any()):
                    break
                a_t = alpha_max * torch.pow(torch.full_like(alpha_max, 0.5), j.to(dtype))
                w_t, s_t = w + a_t[:, None] * dw, s + a_t[:, None] * ds
                c_t = constraint_res(w_t, s_t)
                ok_merit = merit_of(w_t, s_t, c_t) <= psi0 + _ETA_LS * a_t * dpsi + slack
                ok_resto = capped(c_t) <= 0.99 * c0_capped
                ok_t = torch.where(psi0_finite, ok_merit, ok_resto)
                j = torch.where(act, j + 1, j)
                accepted = torch.where(act, ok_t, accepted)
                alpha = torch.where(act, a_t, alpha)
            accepted = accepted | near_opt | ok_full | use_soc
            alpha = torch.where(accepted, alpha, alpha_max * 0.5 ** _MAX_BACKTRACK)
            alpha = torch.where(bad, 0.0, alpha)

            a = alpha[:, None]
            w_n, s_n, y_n = w + a * dw, s + a * ds, y + a * dy
            ad = torch.where(bad, 0.0, alpha_dual)[:, None]
            zl_n, zu_n = zl + ad * dzl, zu + ad * dzu

            # dual safeguard corridor (IPOPT kappa_Sigma)
            z_n = torch.cat([w_n, s_n], 1)
            gl = torch.where(has_lb, torch.clamp(z_n - lb, min=tiny), 1.0)
            gu = torch.where(has_ub, torch.clamp(ub - z_n, min=tiny), 1.0)
            zl_n = torch.where(has_lb, torch.minimum(torch.maximum(
                zl_n, m / (kappa_sigma * gl)), kappa_sigma * m / gl), 0.0)
            zu_n = torch.where(has_ub, torch.minimum(torch.maximum(
                zu_n, m / (kappa_sigma * gu)), kappa_sigma * m / gu), 0.0)

            # regularization memory: grow when the step failed, decay otherwise
            delta_n = torch.where(bad | ~accepted,
                                  torch.clamp(st["delta"] * 10.0, min=1e-8),
                                  st["delta"] / 3.0)

            (e_mu, e_0), feas = kkt_errors(w_n, s_n, y_n, zl_n, zu_n,
                                           (mu, torch.zeros_like(mu)))
            mu_n = torch.where(
                e_mu <= _KAPPA_EPS * mu,
                torch.clamp(torch.minimum(_KAPPA_MU * mu, mu ** _THETA_MU),
                            min=opts.tol / 10.0),
                mu)
            if opts.debug:
                debug_lines(
                    "it={it} mu={mu:.2e} a={a:.2e} ad={ad:.2e} amax={am:.2e} acc={acc} "
                    "|dw|={ndw:.2e} nu={nu:.2e} dlt={d:.1e} kkt={k:.3e} feas={f:.2e}",
                    it=st["it"], mu=mu, a=alpha, ad=alpha_dual, am=alpha_max, acc=accepted,
                    ndw=dw.abs().amax(1), nu=nu, d=delta_w, k=e_0, f=feas)
            return dict(w=w_n, s=s_n, y=y_n, zl=zl_n, zu=zu_n, mu=mu_n, nu=nu,
                        delta=delta_n, it=st["it"] + 1, done=e_0 <= opts.tol,
                        kkt0=e_0, feas=feas)

        while True:
            active = (~st["done"]) & (st["it"] < opts.max_iter)
            if not bool(active.any()):       # one host sync per iteration
                break
            new = body(st)
            st = {k: torch.where(_lane(active, v), new[k], v) for k, v in st.items()}

        # unscaled constraint violation for the status decision
        if ng > 0:
            g_u = v_g(st["w"], p)
            feas_u = torch.maximum(_amax0(torch.clamp(g_u - ubg_u, min=0.0)),
                                   _amax0(torch.clamp(lbg_u - g_u, min=0.0)))
        else:
            feas_u = torch.zeros(Bsz, **kw)
        status = torch.where(
            st["kkt0"] <= opts.tol, STATUS_SOLVED,
            torch.where(feas_u <= opts.constr_viol_tol, STATUS_ACCEPTABLE,
                        STATUS_INFEASIBLE)).to(torch.int32)
        return IPMResult(w=st["w"], f=v_f(st["w"], p),
                         lam_g=st["y"] * sg / torch.clamp(sf, min=tiny)[:, None],
                         status=status, iters=st["it"], kkt_err=st["kkt0"],
                         feas_err=feas_u)

    return solve


def kkt_error(nlp: NLP, res: IPMResult, p, lbw, ubw, lbg, ubg) -> dict:
    """Unscaled feasibility of a result's lanes (JAX ipm.py:539-548, the
    test oracle of solver correctness): per lane the largest violation of
    the constraint bounds (``feas_g``) and of the box (``feas_box``), and
    the solver's own KKT error (``kkt``), each (B,).  ``p`` has a leading
    B on every entry; the bounds are given for one lane or per lane."""
    w = res.w
    kw = dict(dtype=w.dtype, device=w.device)
    Bsz = w.shape[0]

    def T(a, n):
        a = torch.as_tensor(a, **kw)
        return a.reshape(-1, n).expand(Bsz, n) if n else a.new_zeros((Bsz, 0))

    p = {k: torch.as_tensor(v, **kw) for k, v in p.items()}
    g = vmap(nlp.g)(w, p) if nlp.ng > 0 else w.new_zeros((Bsz, 0))
    lbw, ubw, lbg, ubg = T(lbw, nlp.nw), T(ubw, nlp.nw), T(lbg, nlp.ng), T(ubg, nlp.ng)
    feas = torch.maximum(_amax0(torch.clamp(g - ubg, min=0.0)),
                         _amax0(torch.clamp(lbg - g, min=0.0)))
    box = torch.maximum(_amax0(torch.clamp(w - ubw, min=0.0)),
                        _amax0(torch.clamp(lbw - w, min=0.0)))
    return {"feas_g": feas, "feas_box": box, "kkt": res.kkt_err}
