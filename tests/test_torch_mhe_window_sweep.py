"""Kernel 5's lowering of the MHE window (the fused stage sweep's plain
version and the lowered programs) against the JAX package, CPU, f64.

Five windows of ``build_structured_mhe`` at Mx_mhe=2, B=5 scenarios with
seeded window data, decision variables and multipliers (lam, nus):

- enmpc: Ex_ENMPC's window (``fx_mhe_cont``, the user cost, offree='lin')
  at N=3 < N_mhe=4, as the host MHE solves it while its window grows;
- linear: ``tests/test_torch_mhe_solve.py``'s linear window with its w box
  (the augmented controller model, the QP cost, the w rows), N=N_mhe=4;
- masked: Ex_ENMPC's window with y, v and w boxes, ``maskable``, scenario
  1's first two window stages and scenario 2's third pads (mask 0), as in
  the batched MHE's warmup;
- corr: Ex_ENMPC's window with ``smooth_correction`` (N=N_mhe=4);
- w_ode: an MHE ODE that reads the noise w and the disturbance d
  nonlinearly, a non-identity G_mhe, a cost with a (w, v) cross term and a
  y box, so that the exact Hessian's dynamics terms are not zero.

Checks:
- ``make_stage_sweep(window, hessian)`` on CPU tensors, fed by its own
  ``inputs`` from the window's batched parameter dict, against JAX's
  ``vmap(make_stage_derivs(js, hessian))`` over (X, U, k, par, lam, nus,
  mu_h), both Hessians jitted in one call per window in a module fixture:
  all nine outputs to 1e-10, the stage-0 (arrival) lanes and the pad lanes
  on their own, H symmetric;
- the lowered stage cost (stage 0 and a live stage; a pad stage where the
  window has one) and rows, and the MHE model's lowered step (the ODE or
  map in a Python RK4, then the terms), by ``Program.execute`` against the
  torch functions by ``torch.func``: value, gradient and Hessian to 1e-12;
  the step in every form of ``build_mhe_model`` (three more windows, port
  only: a dedicated discrete map, the controller's guarded ContinuousModel
  and a DiscreteModel), with the tangents it depends on;
- the window takes its step from ``fx_mhe`` and refuses a map without it;
- the route: the window takes the fused sweep under both Hessians, and an
  exact solve calls it with the window's inputs once a pass;
- exact pins of the kernel's operation count at the full width of the
  batched and the host MHE (Ex_ENMPC's window, Mx_mhe=10, (11, 4, 4)).

``tests/test_torch_mhe_window_host.py`` builds the kernel's window kind on
the host.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

B, MXM, NM = 5, 2, 4
WINDOWS = ("enmpc", "linear", "masked", "corr", "w_ode")
HESSIANS = ("exact", "gauss_newton")
NAMES = ("H", "gc", "A", "B", "E", "ival", "dval", "Cz", "hval")
JAX_ORDER = (0, 1, 2, 3, 4, 5, 8, 6, 7)      # make_stage_derivs' outputs, as NAMES
G_W = np.array([[1.0, 0.5, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.2, 0.0, 1.0]])
A_LIN = np.array([[0.8, 0.1], [0.0, 0.9]])
B_LIN = np.array([[0.5], [1.0]])


def _w_ode(lib):
    def fx(x, u, d, t, px, w):
        return lib.stack([u[0] * (1.0 - x[0]) - x[0] * x[0] + 0.5 * w[0] * x[1] + d[0] * w[1],
                          -u[0] * x[1] + x[0] - 0.05 * x[1] * x[1]
                          + 0.2 * lib.tanh(w[1] + d[1])])
    return fx


def _w_cost(w, v, t):
    return 0.5 * (w @ w + 2.0 * (v @ v)) + 0.1 * w[0] * w[0] * v[0] * v[0]


def _linear_cfgs():
    def cfg(pkg):
        c = __import__(f"{pkg}.config", fromlist=["MPCConfig"])
        return c.MPCConfig(
            nx=2, nu=1, ny=2, nd=2, Nsim=30, N=5, h=1.0,
            model=c.LinearModel(A=A_LIN, B=B_LIN, C=np.eye(2)),
            plant=c.LinearPlant(Ap=A_LIN, Bp=B_LIN, Cp=np.eye(2)),
            dist=c.DisturbanceModel(offree="lin", Bd=np.zeros((2, 2)), Cd=np.eye(2)),
            x0_p=np.array([0.5, -0.2]), x0_m=np.zeros(2), u0=np.zeros(1),
            ss_cost=c.SSCost(Qss=np.eye(2), Rss=np.zeros((1, 1))),
            stage_cost=c.StageCost(Q=np.eye(2), R=0.1 * np.eye(1)),
            estimator=c.EstimatorConfig(
                kind="mhe", N_mhe=NM, mhe_up="filter", structured_mhe=True,
                mhe_cost=c.MHECost(Q=0.1 * np.eye(4), R=0.01 * np.eye(2)), P0=np.eye(4)),
            bounds=c.Bounds(umin=np.array([-3.0]), umax=np.array([3.0]),
                            wmin=-0.7 * np.ones(4), wmax=0.7 * np.ones(4)))
    return cfg("mpc_code_tpu"), cfg("mpc_code_tpu_torch")


def _cfgs(window):
    """(JAX config, port config, N, maskable, smooth_correction)."""
    if window == "linear":
        return _linear_cfgs() + (NM, False, False)
    from mpc_code_tpu.config import MHECost as JMHECost
    from mpc_code_tpu.examples.enmpc import make_config as jmake
    from mpc_code_tpu_torch.config import MHECost
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as pmake

    jcfg, pcfg = jmake(Nsim=4), pmake(Nsim=4)
    jcfg.estimator = dc.replace(jcfg.estimator, N_mhe=NM, Mx_mhe=MXM)
    if window == "masked":
        jcfg.bounds = dc.replace(jcfg.bounds, ymin=np.array([-1.0, -2.0]),
                                 ymax=np.array([3.0, 2.0]), vmin=np.array([-0.5, -0.4]),
                                 vmax=np.array([0.5, 0.6]), wmin=-0.3 * np.ones(4),
                                 wmax=0.4 * np.ones(4))
    if window == "w_ode":
        jcfg.bounds = dc.replace(jcfg.bounds, ymin=np.array([-1.0, -2.0]),
                                 ymax=np.array([3.0, 2.0]))
        jcfg.estimator = dc.replace(jcfg.estimator, fx_mhe_cont=_w_ode(jnp), G_mhe=G_W,
                                    mhe_cost=JMHECost(f_obj=_w_cost))
        pcfg.estimator = dc.replace(pcfg.estimator, fx_mhe_cont=_w_ode(torch),
                                    mhe_cost=MHECost(f_obj=_w_cost))
    N = 3 if window == "enmpc" else NM
    return (jcfg, config_from_numpy(jcfg, pcfg), N, window == "masked", window == "corr")


def _parts(cfg, jax_side):
    """(fx_mhe, fy_es, f_obj_mhe) of either package."""
    if jax_side:
        from mpc_code_tpu.estimators.linear import build_augmented
        from mpc_code_tpu.models import build_model
        from mpc_code_tpu.models.costs import build_mhe_cost
        from mpc_code_tpu.models.model import build_mhe_model
    else:
        from mpc_code_tpu_torch.estimators.linear import build_augmented
        from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    model = build_model(cfg)
    return (build_mhe_model(cfg, model), build_augmented(cfg, model).fy,
            build_mhe_cost(cfg.estimator.mhe_cost))


def _windows(window):
    """(JAX window, port window, port config)."""
    from mpc_code_tpu.ocp.mhe import build_structured_mhe as jbuild
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    jcfg, pcfg, N, maskable, corr = _cfgs(window)
    js, _ = jbuild(jcfg, *_parts(jcfg, True), N, NM, smooth_correction=corr,
                   maskable=maskable)
    ps, _ = build_structured_mhe(pcfg, *_parts(pcfg, False), N, NM, smooth_correction=corr,
                                 maskable=maskable, device="cpu")
    return js, ps, pcfg


def _inputs(ps, cfg, seed=0):
    """Seeded inputs of a window, numpy: the parameter dict of B scenarios
    (window data, x_bar, P_inv; the mask where the window has one; the
    correction's matrices where it reads them), the decision variables in
    scaled units (states x over [0.2, 0.9], d and the noises small), the
    multipliers and sf."""
    rng = np.random.default_rng(seed)
    low = ps.lowering
    N_s, n, Nw, nx = ps.N, ps.nxa, ps.N - 1, low.step.nx
    M = rng.normal(size=(B, n, n))
    par = dict(U=rng.uniform(0.2, 1.5, (B, Nw, low.m)), Y=rng.uniform(0.1, 0.9, (B, Nw, low.p)),
               T=2.0 * np.arange(Nw) + rng.uniform(0.0, 4.0, (B, 1)),
               PX=0.01 * rng.normal(size=(B, Nw, low.npx)),
               PY=0.01 * rng.normal(size=(B, Nw, low.npy)),
               x_bar=np.concatenate([rng.uniform(0.3, 0.8, (B, nx)),
                                     rng.normal(0.0, 0.05, (B, n - nx))], -1),
               P_inv=M @ np.swapaxes(M, 1, 2) + np.eye(n))
    if low.maskable:
        mask = np.ones((B, Nw), bool)
        mask[1, :2] = False
        mask[2, 2] = False
        par["mask"] = mask
    if low.n_corr:
        nc = low.n_corr
        Mc = rng.normal(size=(B, nc, nc))
        par.update(Pycondx_inv=0.01 * Mc @ np.swapaxes(Mc, 1, 2),
                   Hbig=0.1 * rng.normal(size=(B, nc)), Obig=rng.normal(size=(B, nc, n)))
    x = np.concatenate([rng.uniform(0.2, 0.9, (B, N_s, nx)),
                        rng.normal(0.0, 0.05, (B, N_s, n - nx))], -1)
    u = 0.1 * rng.normal(size=(B, N_s, n))
    u[:, 0] += x[:, 1]
    return dict(par=par, X=x / ps.sxa, U=u / ps.su, lam=rng.normal(size=(B, N_s, n)),
                nus=rng.normal(0.0, 0.1, (B, N_s, ps.ni)), sf=rng.uniform(0.5, 1.0, B))


def _batched(ps, a):
    from mpc_code_tpu_torch.solver.riccati import batch_params

    p = batch_params({k: torch.as_tensor(v) for k, v in a["par"].items()}, B,
                     torch.float64, "cpu", ps.params.ndim)
    p["_sf"] = torch.as_tensor(a["sf"])
    return p


def _jax_derivs(js, a):
    """JAX's vmapped make_stage_derivs at the inputs under each Hessian, in
    one jitted call: the nine outputs in NAMES' order, by Hessian."""
    from mpc_code_tpu.solver.riccati import make_stage_derivs

    N_s = a["X"].shape[1]
    p = {k: jnp.asarray(v) for k, v in a["par"].items()}
    p["_sf"] = jnp.asarray(a["sf"])
    ks = jnp.arange(N_s)
    v_stage = {h: jax.vmap(make_stage_derivs(js, h), in_axes=(0, 0, 0, None, 0, 0, 0))
               for h in HESSIANS}

    def ref(X, U, pp, lam, nus, muh):
        return {h: v(X, U, ks, pp, lam, nus, muh) for h, v in v_stage.items()}

    out = jax.device_get(jax.jit(jax.vmap(ref))(
        jnp.asarray(a["X"]), jnp.asarray(a["U"]), p, jnp.asarray(a["lam"]),
        jnp.asarray(a["nus"]), jnp.zeros((B, N_s, 0))))
    return {h: [np.asarray(o[i]) for i in JAX_ORDER] for h, o in out.items()}


def _sweep_args(sw, ps, a):
    T = lambda v: torch.as_tensor(v)  # noqa: E731
    return sw.inputs(T(a["X"]), T(a["U"]), _batched(ps, a), T(a["lam"]), T(a["nus"]),
                     torch.zeros((B, ps.N, 0), dtype=torch.float64))


@pytest.fixture(scope="module")
def windows():
    """Per window: the port's window, its config, the inputs, and per
    Hessian JAX's outputs and the port's plain sweep's."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    out = {}
    for window in WINDOWS:
        js, ps, cfg = _windows(window)
        a = _inputs(ps, cfg)
        ref, res = _jax_derivs(js, a), {}
        for hess in HESSIANS:
            sw = make_stage_sweep(ps, hess)
            res[hess] = (ref[hess], [g.numpy() for g in sw(*_sweep_args(sw, ps, a))])
        out[window] = dict(js=js, ps=ps, cfg=cfg, a=a, res=res)
    return out


def _nerr(a, b):
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0


@pytest.mark.parametrize("hessian", HESSIANS)
@pytest.mark.parametrize("window", WINDOWS)
def test_plain_sweep_matches_jax(windows, window, hessian):
    f = windows[window]
    ps, js = f["ps"], f["js"]
    assert (ps.N, ps.nxa, ps.nu, ps.ni) == (js.N, js.nxa, js.nu, js.ni)
    assert ps.lowering.kind == "mhe"
    ref, got = f["res"][hessian]
    assert len(got) == 9
    # the pad lanes: structured stage i + 1 of a masked-off window stage i
    pads = (np.argwhere(~f["a"]["par"]["mask"]) + [0, 1] if "mask" in f["a"]["par"]
            else np.zeros((0, 2), int))
    assert len(pads) == (3 if window == "masked" else 0)
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert np.isfinite(g).all(), name
        assert _nerr(g, r) <= 1e-10, (name, _nerr(g, r))
        assert _nerr(g[:, 0], r[:, 0]) <= 1e-10, name              # the arrival stage
        for b, k in pads:
            assert _nerr(g[b, k], r[b, k]) <= 1e-10, (name, b, k)
    H = got[0]
    assert np.abs(H - np.swapaxes(H, -1, -2)).max() <= 1e-10 * (1 + np.abs(H).max())


def test_arrival_and_pad_rows_of_the_map(windows):
    """Stage 0 maps the state to its input (A = 0, B = I in the shared
    scale) and a pad stage carries the state (A = I, B = 0); a live stage
    of the w_ode window has the dynamics' curvature in H under the exact
    Hessian and not under Gauss-Newton."""
    f = windows["masked"]
    _, A, Bm, dval = (f["res"]["exact"][1][i] for i in (0, 2, 3, 6))
    a, n = f["a"], f["ps"].nxa
    eye = np.broadcast_to(np.eye(n), A[:, 0].shape)
    assert not A[:, 0].any()
    np.testing.assert_allclose(Bm[:, 0], eye, rtol=0, atol=1e-15)
    np.testing.assert_allclose(dval[:, 0], a["U"][:, 0], rtol=0, atol=1e-15)
    for b, k in np.argwhere(~a["par"]["mask"]) + [0, 1]:
        np.testing.assert_allclose(A[b, k], np.eye(n), rtol=0, atol=1e-15)
        assert not Bm[b, k].any()
        np.testing.assert_allclose(dval[b, k], a["X"][b, k], rtol=0, atol=1e-15)
    w = windows["w_ode"]["res"]
    dH = w["exact"][1][0][:, 1:] - w["gauss_newton"][1][0][:, 1:]
    assert np.abs(dH).max() > 1e-3


def _point(ps, a, b, k):
    """Scenario b's structured stage k: z in user units, the torch
    functions' per-point dict (the window's params hook) and the lowered
    programs' arguments (WINDOW_ARGS, matrices flattened)."""
    pk = ps.params.stage(_batched(ps, a), ps.N)
    pk = {key: v[b * ps.N + k] for key, v in pk.items()}
    z = torch.cat([torch.as_tensor(a["X"][b, k] * ps.sxa), torch.as_tensor(a["U"][b, k] * ps.su)])
    empty = torch.zeros(0, dtype=torch.float64)
    args = dict(um=pk["U"], y=pk["Y"], tw=pk["T"], pyw=pk["PY"],
                mask=pk.get("mask", torch.tensor(True)), k0=pk["k0"], x_bar=pk["x_bar"],
                P_inv=pk["P_inv"].reshape(-1), Yc=pk.get("Yc", empty),
                Obig=pk.get("Obig", empty).reshape(-1), Hbig=pk.get("Hbig", empty),
                Pyc=pk.get("Pycondx_inv", empty).reshape(-1))
    return z, pk, args


def _close(f_lowered, f_direct, z):
    assert torch.allclose(f_lowered(z), f_direct(z), rtol=1e-14, atol=1e-15)
    for d in (torch.func.jacrev, torch.func.hessian):
        assert torch.allclose(d(f_lowered)(z), d(f_direct)(z), rtol=1e-12, atol=1e-14)


def _programs(ps, cfg, hessian="exact"):
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep, window_programs

    sw = make_stage_sweep(ps, hessian)
    return window_programs(ps.lowering, *sw.window_dims())


@pytest.mark.parametrize("window,which", [
    ("masked", "cost"), ("masked", "ineq"), ("corr", "cost"), ("w_ode", "cost"),
    ("w_ode", "ineq"), ("linear", "cost"), ("linear", "ineq")])
def test_lowered_cost_and_rows_match_torch(windows, window, which):
    """The generated statements of the window's stage cost and rows on z =
    (xa, u), run in Python, against the window's torch functions: the
    arrival stage, scenario 1's first stage (a pad stage in the masked
    window) and its last."""
    f = windows[window]
    ps, cfg, a = f["ps"], f["cfg"], f["a"]
    prog = getattr(_programs(ps, cfg), which)
    assert prog is not None
    n = ps.nxa
    sxa, su, si = (torch.as_tensor(v) for v in (ps.sxa, ps.su, ps.si))
    scaled = getattr(ps, which)
    for k in (0, 1, ps.N - 1):
        z, pk, args = _point(ps, a, 1, k)

        def lowered(zz):
            return torch.stack(prog.execute(xa=zz[:n], u=zz[n:], **args)).reshape(-1)

        def direct(zz):
            v = scaled(zz[:n] / sxa, zz[n:] / su, pk).reshape(-1)
            return v * si if which == "ineq" else v

        _close(lowered, direct, z)


def _mhe_dis(x, u, d, t, px, w):
    return torch.stack([0.9 * x[0] + 0.1 * u[0] * x[1] + 0.05 * d[0] * w[0],
                        0.8 * x[1] + 0.2 * torch.sin(x[0] + w[1]) + 0.01 * t])


def _dis_model(x, u, d, t, px):
    return torch.stack([0.9 * x[0] + 0.1 * u[0] * x[1] + 0.05 * torch.tanh(d[0]),
                        0.8 * x[1] + 0.2 * torch.sin(x[0]) + 0.01 * t * d[1]])


def _step_window(form):
    """A port window (no JAX reference) of Ex_ENMPC's config whose MHE
    model takes one of ``build_mhe_model``'s other forms: the dedicated
    discrete map reading w and d ("mhe_dis"), the controller's
    ContinuousModel with its guard ("guard", clipped to boxes that cut the
    seeded states) or a DiscreteModel reading d ("discrete")."""
    from mpc_code_tpu_torch.config import DiscreteModel
    from mpc_code_tpu_torch.examples.enmpc import make_config
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    cfg = make_config(Nsim=4)
    cfg.estimator = dc.replace(cfg.estimator, N_mhe=NM, Mx_mhe=MXM, fx_mhe_cont=None,
                               fx_mhe_dis=_mhe_dis if form == "mhe_dis" else None)
    if form == "guard":
        cfg.model = dc.replace(cfg.model, Mx=MXM, clip_lo=np.array([0.45, 0.0]),
                               clip_hi=np.array([0.55, 0.5]))
    elif form == "discrete":
        cfg.model = DiscreteModel(Fx=_dis_model)
    ps, _ = build_structured_mhe(cfg, *_parts(cfg, False), NM, NM, device="cpu")
    return dict(ps=ps, cfg=cfg, a=_inputs(ps, cfg))


# the tangents each window's step depends on: the state's, d's and w's where
# its ODE or map reads them (a LinearModel's reads d through Bd, zero or not)
STEP_FORMS = {"enmpc": ("rk4", 2), "linear": ("map", 4), "w_ode": ("rk4", 8),
              "mhe_dis": ("map", 8), "guard": ("rk4", 2), "discrete": ("map", 4)}


@pytest.mark.parametrize("window", list(STEP_FORMS))
def test_lowered_step_matches_the_mhe_model(windows, window):
    """The MHE model's lowered step (the ODE's statements in a Python RK4
    with d and w held and the state clipped to the guard's boxes, or the
    map's, then the terms' statements) against ``build_mhe_model``'s map in
    torch, in (csi, w), for each of its forms; and the tangents the step
    depends on, which its bound counts."""
    from mpc_code_tpu_torch.models import build_mhe_model, build_model
    from mpc_code_tpu_torch.ops.integrators import saturate
    from mpc_code_tpu_torch.solver.sweep_kernel import step_tangents

    f = windows[window] if window in windows else _step_window(window)
    ps, cfg, a = f["ps"], f["cfg"], f["a"]
    low = ps.lowering
    st, n = low.step, ps.nxa
    ode, terms = _programs(ps, cfg).step
    fx_mhe = build_mhe_model(cfg, build_model(cfg))
    z, pk, _ = _point(ps, a, 0, 2)
    um, t0, px = pk["U"], pk["T"], pk["PX"]
    if window == "guard":
        x = z[:st.nx]
        assert ((x < torch.as_tensor(st.clip_lo)) | (x > torch.as_tensor(st.clip_hi))).any()
    else:
        assert st.clip_lo is None and st.clip_hi is None

    def lowered(zz):
        x, d, w = zz[:st.nx], zz[st.nx:n], zz[n:]

        def fn(xx, tt):
            xx = saturate(xx, st.clip_lo, st.clip_hi)
            return torch.stack(ode.execute(x=xx, t=tt, w=w, d=d, u=um, px=px))

        if st.kind == "map":
            x = fn(x, t0)
        else:
            dt, tk = low.h / st.Mx, t0
            for _ in range(st.Mx):
                k1 = fn(x, tk)
                k2 = fn(x + dt / 2 * k1, tk + dt / 2)
                k3 = fn(x + dt / 2 * k2, tk + dt / 2)
                k4 = fn(x + dt * k3, tk + dt)
                x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
                tk = tk + dt
        return torch.stack(terms.execute(x=x, d=d, w=w, px=px))

    def direct(zz):
        return fx_mhe(zz[:n], um, cfg.h, t0, zz[n:], px)

    assert (st.kind, step_tangents(low, ps.nu, low.m, low.npx)) == STEP_FORMS[window]
    _close(lowered, direct, z)


def test_the_window_takes_its_step_from_fx_mhe(windows):
    """The window's lowering carries the very parts ``fx_mhe`` is composed
    of, and a map that does not carry them is refused: the kernel and the
    plain version cannot run different models."""
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe

    f = windows["w_ode"]
    cfg = f["cfg"]
    fx_mhe, fy_es, f_obj = _parts(cfg, False)
    ps, _ = build_structured_mhe(cfg, fx_mhe, fy_es, f_obj, NM, NM, device="cpu")
    assert ps.lowering.step is fx_mhe.step

    def other(csi, u, k, t, w, px):
        return fx_mhe(csi, u, k, t, w, px)

    with pytest.raises(TypeError, match="build_mhe_model's map"):
        build_structured_mhe(cfg, other, fy_es, f_obj, NM, NM, device="cpu")


def _counting(monkeypatch):
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    built = []
    real = sk.make_stage_sweep

    def counting(s, hessian="exact"):
        sweep = real(s, hessian)
        built.append((hessian, type(sweep).__name__))
        return sweep

    monkeypatch.setattr(sk, "make_stage_sweep", counting)
    return built


@pytest.mark.parametrize("window", ["masked", "linear"])
def test_the_route_takes_the_fused_sweep(windows, window, monkeypatch):
    """The window has a lowering and no split sweep, so the solver takes
    the fused sweep under both Hessians, as JAX's opt-in route wraps it in
    make_stage_sweep; an exact solve calls it with the window's inputs once
    a pass, a CPU tensor never reaches the kernel's packing, and an OCP
    with neither a split sweep nor a lowering is refused."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import sweep_kernel as sk
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    f = windows[window]
    ps, a = f["ps"], f["a"]
    assert ps.stage_dyn_jac is None and ps.lowering is not None
    built = _counting(monkeypatch)
    make_structured_solver(ps, SolverOptions(hessian="gauss_newton"))
    make_structured_solver(ps, SolverOptions(hessian="exact"))
    assert built == [("gauss_newton", "WindowSweep"), ("exact", "WindowSweep")]
    calls = []
    real_plain = sk.WindowSweep.plain

    def counted(self, *args):
        calls.append([tuple(x.shape) for x in args])
        return real_plain(self, *args)

    monkeypatch.setattr(sk.WindowSweep, "plain", counted)
    solve = make_structured_solver(ps, SolverOptions(hessian="exact", max_iter=2))
    X0 = np.concatenate([a["par"]["x_bar"][:, None], a["X"] * ps.sxa], 1)
    res = solve({k: torch.as_tensor(v) for k, v in a["par"].items()},
                torch.as_tensor(X0), torch.as_tensor(a["U"] * ps.su))
    passes = int((res.iters + (res.status == 0).to(res.iters.dtype)).max())
    assert len(calls) == passes > 0
    Nw, n = ps.N - 1, ps.nxa
    low = ps.lowering
    assert calls[0] == [(B, ps.N, n), (B, ps.N, n), (B, ps.N, n), (B, ps.N, ps.ni),
                        (B, Nw, low.m), (B, Nw, low.p), (B, Nw, 1), (B, Nw, low.npx),
                        (B, Nw, low.npy), (B, Nw, 1), (B,), (B, n), (B, n * n),
                        (B, 0), (B, 0), (B, 0)]
    sw = sk.make_stage_sweep(ps, "exact")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sw.pack(*_sweep_args(sw, ps, a))
    # without its lowering the window has no route: torch.func is no longer one
    with pytest.raises(ValueError, match="needs the fused stage sweep's lowering"):
        make_structured_solver(dc.replace(ps, lowering=None), SolverOptions(hessian="exact"))


@pytest.mark.parametrize("maskable,hessian,ops", [
    (True, "exact", (5145, 3118)), (True, "gauss_newton", (5145, 1606)),
    (False, "exact", (5055, 3118)), (False, "gauss_newton", (5055, 1606))])
def test_operation_count_at_full_width(maskable, hessian, ops):
    """Kernel 5's operations a lane (every lane's, and a stepping lane's
    more) on Ex_ENMPC's window at the batched and the host MHE's full
    width: N_mhe=10 (11 structured stages, n = n_w = 4), Mx_mhe=10, the
    ODE reading neither w nor d, so that the step is counted on the
    state's 2 tangents; and the bytes at 16,384 scenarios."""
    from mpc_code_tpu_torch.examples import enmpc_loop_workload as mw
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    cfg = mw.make_config()
    ps = mw.mhe_ocp(cfg, "cpu", maskable=maskable)
    sw = sk.make_stage_sweep(ps, hessian)
    dims = sw.window_dims()
    assert dims == (4, 4, 0, 1, 2, 2, 2, 0) and ps.N == 11
    assert sk.step_tangents(ps.lowering, 4, 1, 2) == 2
    assert sk.window_ops(ps.lowering, hessian, *dims) == ops
    assert sw.ops_per_lane(*dims) == sum(ops)
    assert sk.window_bytes(16384, 11, *dims, 4) == 4 * (
        16384 * 11 * (12 + 64 + 8 + 16 + 16 + 4) + 16384 * 10 * 9 + 16384 * 21)
